// Native out-of-core IO of mpi_cuda_largescaleknn_torch: the host half of
// the reference's IO layer (readFilePortion and the output writers of the
// unordered pipeline), plus the streaming partitioner that cuts one raw
// .float3 file into spatially coherent parts for the pre-partitioned
// pipeline.
//
// - lsk_read_at: a slab of a file read by 1-64 threads, each a positioned
//   read of its share;
// - lsk_create_sized / lsk_write_at: one output file pre-sized once, then
//   written at disjoint offsets by any number of writers;
// - lsk_partition: three sequential passes over the input (bounds, a
//   histogram over 2^(3*bits) Morton bins, routing), in memory that
//   depends on the bits and the part count, not on the input's size.
//
// A plain shared library with a C interface, bound by ctypes
// (io/native.py), built with -ffp-contract=off: morton3 must round as the
// numpy twin does (io/partition_file.py), so that the parts are the same
// bytes on both paths.

#include <cstdint>
#include <cstdio>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read `count` bytes at byte `offset` from `path` into `out`.
// Returns bytes read, or -1 on error.
int64_t lsk_read_at(const char *path, int64_t offset, int64_t count,
                    void *out, int32_t num_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > 64) num_threads = 64;
  int64_t chunk = (count + num_threads - 1) / num_threads;
  std::vector<std::thread> workers;
  std::vector<int64_t> done(num_threads, 0);
  for (int t = 0; t < num_threads; t++) {
    workers.emplace_back([&, t]() {
      int64_t begin = t * chunk;
      int64_t end = begin + chunk < count ? begin + chunk : count;
      // a thread that starts at or past the end has nothing to read (the
      // JAX package's copy counts end - begin < 0 for it, so a read of
      // fewer bytes than (threads - 1) * chunk comes back short)
      if (begin >= end) return;
      char *dst = (char *)out + begin;
      int64_t pos = begin;
      while (pos < end) {
        ssize_t got = pread(fd, dst + (pos - begin), end - pos, offset + pos);
        if (got <= 0) return;  // short read: done[t] stays short -> error
        pos += got;
      }
      done[t] = end - begin;
    });
  }
  int64_t total = 0;
  for (int t = 0; t < num_threads; t++) {
    workers[t].join();
    total += done[t];
  }
  close(fd);
  return total;
}

// Create (or truncate) `path` at exactly `size` bytes, so a set of
// concurrent lsk_write_at writers covering disjoint slabs produces exactly
// the intended file — without this step, rewriting an existing LONGER file
// would leave stale trailing bytes from the prior run. Call once, before
// the writers start. Returns 0, or -1 on error.
int64_t lsk_create_sized(const char *path, int64_t size) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (ftruncate(fd, size) != 0) { close(fd); return -1; }
  close(fd);
  return 0;
}

// Write `count` bytes from `src` at byte `offset` of `path`, creating the
// file if needed (safe for concurrent writers at disjoint offsets — but the
// file must be pre-sized with lsk_create_sized first when it may already
// exist, since O_CREAT without O_TRUNC keeps stale trailing bytes).
// Returns bytes written, or -1 on error.
int64_t lsk_write_at(const char *path, int64_t offset, int64_t count,
                     const void *src) {
  int fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -1;
  const char *p = (const char *)src;
  int64_t pos = 0;
  while (pos < count) {
    ssize_t put = pwrite(fd, p + pos, count - pos, offset + pos);
    if (put <= 0) { close(fd); return -1; }
    pos += put;
  }
  close(fd);
  return pos;
}

// File size in bytes, or -1.
int64_t lsk_file_size(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseeko(f, 0, SEEK_END);
  int64_t n = ftello(f);
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// Streaming spatial partitioner.
//
// The reference's prepartitioned variant ASSUMES one spatially-coherent file
// per rank already exists (README.md:17-23) and ships no tool to produce
// them. This is that tool: split a raw .float3 file into `num_parts` files
// of near-equal size whose points are spatially coherent, by bucketing on a
// quantized Morton (Z-order) code and cutting the code space into
// equal-count ranges. Out-of-core: three sequential streaming passes
// (bounds, histogram, route), O(bins) memory, any input size.

static inline uint64_t expand_bits21(uint64_t v) {
  // spread the low 21 bits of v so there are 2 zero bits between each
  v &= 0x1fffff;
  v = (v | v << 32) & 0x1f00000000ffffULL;
  v = (v | v << 16) & 0x1f0000ff0000ffULL;
  v = (v | v << 8) & 0x100f00f00f00f00fULL;
  v = (v | v << 4) & 0x10c30c30c30c30c3ULL;
  v = (v | v << 2) & 0x1249249249249249ULL;
  return v;
}

static inline uint64_t morton3(float x, float y, float z, const float *lo,
                               const float *inv_ext, int bits) {
  uint64_t max_q = (1ULL << bits) - 1;
  uint64_t qx = (uint64_t)((x - lo[0]) * inv_ext[0] * (double)max_q);
  uint64_t qy = (uint64_t)((y - lo[1]) * inv_ext[1] * (double)max_q);
  uint64_t qz = (uint64_t)((z - lo[2]) * inv_ext[2] * (double)max_q);
  if (qx > max_q) qx = max_q;
  if (qy > max_q) qy = max_q;
  if (qz > max_q) qz = max_q;
  return (expand_bits21(qx) << 2) | (expand_bits21(qy) << 1) |
         expand_bits21(qz);
}

// Partition `in_path` (raw float3 records) into `num_parts` files named
// `<out_prefix>_%06d.float3`. `bits_per_dim` (<= 10 recommended) sets the
// histogram resolution: bins = 2^(3*bits). `out_counts` (size num_parts)
// receives per-part point counts. Returns total points, or -1 on error.
int64_t lsk_partition(const char *in_path, int32_t num_parts,
                      const char *out_prefix, int32_t bits_per_dim,
                      int64_t *out_counts) {
  if (num_parts < 1 || bits_per_dim < 1 || bits_per_dim > 10) return -1;
  int64_t fsize = lsk_file_size(in_path);
  if (fsize < 0 || fsize % 12 != 0) return -1;
  int64_t n = fsize / 12;

  const size_t CHUNK = 1 << 20;  // points per streaming chunk (12 MB)
  std::vector<float> buf(CHUNK * 3);

  // pass 1: bounds
  float lo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  float hi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  {
    FILE *f = fopen(in_path, "rb");
    if (!f) return -1;
    int64_t seen = 0;
    while (seen < n) {
      size_t want = (size_t)((n - seen) < (int64_t)CHUNK ? (n - seen) : CHUNK);
      if (fread(buf.data(), 12, want, f) != want) { fclose(f); return -1; }
      for (size_t i = 0; i < want; i++)
        for (int d = 0; d < 3; d++) {
          float v = buf[i * 3 + d];
          if (v < lo[d]) lo[d] = v;
          if (v > hi[d]) hi[d] = v;
        }
      seen += want;
    }
    fclose(f);
  }
  float inv_ext[3];
  for (int d = 0; d < 3; d++) {
    float e = hi[d] - lo[d];
    inv_ext[d] = e > 0 ? 1.0f / e : 0.0f;
  }

  // pass 2: histogram over morton bins
  size_t bins = (size_t)1 << (3 * bits_per_dim);
  std::vector<int64_t> hist(bins, 0);
  {
    FILE *f = fopen(in_path, "rb");
    if (!f) return -1;
    int64_t seen = 0;
    while (seen < n) {
      size_t want = (size_t)((n - seen) < (int64_t)CHUNK ? (n - seen) : CHUNK);
      if (fread(buf.data(), 12, want, f) != want) { fclose(f); return -1; }
      for (size_t i = 0; i < want; i++)
        hist[morton3(buf[i * 3], buf[i * 3 + 1], buf[i * 3 + 2], lo, inv_ext,
                     bits_per_dim)]++;
      seen += want;
    }
    fclose(f);
  }

  // cut the code space into num_parts equal-count ranges:
  // part r gets bins [cut[r], cut[r+1]) with prefix(cut[r]) ~= n*r/parts
  std::vector<size_t> cut(num_parts + 1, bins);
  cut[0] = 0;
  {
    int64_t acc = 0;
    int32_t r = 1;
    for (size_t b = 0; b < bins && r < num_parts; b++) {
      acc += hist[b];
      while (r < num_parts && acc >= n * (int64_t)r / num_parts)
        cut[r++] = b + 1;
    }
  }
  std::vector<int32_t> bin_part(bins);
  for (int32_t r = 0; r < num_parts; r++)
    for (size_t b = cut[r]; b < cut[r + 1]; b++) bin_part[b] = r;

  // pass 3: route points to per-part buffered output files
  std::vector<FILE *> outs(num_parts, nullptr);
  auto close_all = [&]() {
    for (int32_t r = 0; r < num_parts; r++)
      if (outs[r]) fclose(outs[r]);
  };
  for (int32_t r = 0; r < num_parts; r++) {
    char name[4096];
    snprintf(name, sizeof name, "%s_%06d.float3", out_prefix, r);
    outs[r] = fopen(name, "wb");
    if (!outs[r]) {
      close_all();
      return -1;
    }
    out_counts[r] = 0;
  }
  std::vector<std::vector<float>> obuf(num_parts);
  const size_t FLUSH = 1 << 16;  // floats (~256 KB per part)
  auto flush_part = [&](int32_t r) {
    size_t nf = obuf[r].size();
    if (nf && fwrite(obuf[r].data(), 4, nf, outs[r]) != nf) return false;
    obuf[r].clear();
    return true;
  };
  int64_t total = 0;
  {
    FILE *f = fopen(in_path, "rb");
    if (!f) {
      close_all();
      return -1;
    }
    int64_t seen = 0;
    while (seen < n) {
      size_t want = (size_t)((n - seen) < (int64_t)CHUNK ? (n - seen) : CHUNK);
      if (fread(buf.data(), 12, want, f) != want) {
        fclose(f);
        close_all();
        return -1;
      }
      for (size_t i = 0; i < want; i++) {
        int32_t r = bin_part[morton3(buf[i * 3], buf[i * 3 + 1],
                                     buf[i * 3 + 2], lo, inv_ext,
                                     bits_per_dim)];
        obuf[r].insert(obuf[r].end(), &buf[i * 3], &buf[i * 3 + 3]);
        out_counts[r]++;
        if (obuf[r].size() >= FLUSH && !flush_part(r)) {
          fclose(f);
          close_all();
          return -1;  // short write (disk full): fail loudly, not silently
        }
      }
      seen += want;
      total += want;
    }
    fclose(f);
  }
  bool ok = true;
  for (int32_t r = 0; r < num_parts; r++) {
    if (!flush_part(r)) ok = false;
    if (fclose(outs[r]) != 0) ok = false;
    outs[r] = nullptr;
  }
  return ok ? total : -1;
}

}  // extern "C"
