"""Wire codecs for the byte-heavy serving paths (quantized exchange).

The port of the JAX package's ``serve/wire.py``, byte for byte in what it
encodes and decodes. At pod scale the routed pod is network-bound: every
routed wave ships full f32 candidate rows (``d2[Q,k]`` f32 + ``idx[Q,k]``
i32 per visited host), and slab pulls move raw f32 rows. Candidate
distances are monotone scores, so the wire can be quantized while the
served results stay **bitwise exact**: quantize the wire, re-merge the
survivors in exact f32 (serve/frontend.py threads the re-merge).

Two codecs, both negotiated per endpoint via the /stats ``wire`` caps
block (absent caps = an old binary = f32 — mixed pods interop):

``q16`` — candidate exchange (``POST /route_knn?wire=q16``)
    Per row: ``n_valid`` (slots with idx >= 0), a per-row f32 **anchor**
    (the last valid distance — the kth — transmitted exact as a varint
    ulp-delta down the batch), the *interior* distances as monotone
    uint16 levels ``u = ceil(d2 / anchor * 65535)`` stored as slot-major
    byte planes (the anchor slot always decodes to level 65535 so its
    column is elided entirely), and the valid ids as one flat zigzag
    varint delta stream in distance order (Morton-sorted indexes make
    neighbor ids cluster, so the deltas stay short). The whole body is
    zlib'd; encode/decode stay vectorized numpy (the varint coder is a
    byte-position scatter, not a per-value loop). Decode returns bounds:
    ``hi = anchor * u / 65535`` rounded UP into f32 and ``lo`` rounded
    down, with the anchor slot and every pad slot exact (``lo == hi``).
    Quantization therefore ceils, never floors: a conservative fold over
    ``hi`` can widen the certified escalation radius but can never prune
    a true neighbor or certify away a host a full-precision fold would
    have visited, and ``lo`` lets the frontend prove when a re-fetch
    cannot change the served row.

``d16`` — slab transfer (``GET /slab_rows?wire=d16``) and cold reads
    Rows are Morton-sorted (the io partitioner's production order), so
    consecutive rows are spatial neighbors. Each coordinate column is
    mapped to the total-order u32 space (sign-flip transform: float
    compare == unsigned compare), delta-coded row-to-row, zigzag'd, and
    stored as byte planes: 16-bit deltas when the chunk's steps fit
    (tight Morton runs), 32-bit next, 64-bit when steps cross zero at
    magnitude > ~1 (zigzag can reach 2^33), raw f32 when the transform
    does not pay — then zlib. The transform is pure integer arithmetic
    in ulp space: **lossless always**, verified by a crc32 fingerprint
    of the raw f32 bytes after decode (torn / corrupt transfers raise
    ``WireError`` instead of materializing a wrong slab).

Shared negotiation state (``WireNegotiator``) and the byte accounting
behind ``knn_wire_bytes_total{path=,codec=}`` (``WireStats``) live here
so every surface (host handler, routed fan-out, replica pull, slab pool)
counts bytes the same way. Determinism: no wallclock, no RNG — codecs
are pure functions of their input bytes.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by

#: codec names by path, in preference order (index 0 = the compressed
#: codec ``wire=auto`` negotiates when both sides support it)
CANDIDATE_CODECS = ("q16", "f32")
SLAB_CODECS = ("d16", "f32")

#: zlib effort for wire bodies: level 1 is ~5x faster than default-6 and
#: within a few percent of its ratio on byte-plane input
_ZLIB_LEVEL = 1

_Q16_MAGIC = b"Kq"
_D16_MAGIC = b"Kd"


class WireError(ValueError):
    """Malformed / torn / fingerprint-mismatched wire payload."""


def wire_caps(mode: str = "auto") -> dict:
    """The capability block a new host advertises at the /stats ROOT
    (deliberately outside the ``engine`` sub-dict: replica fingerprints
    must not change when a codec is added, or mixed old/new pods could
    never bind a handoff). ``mode="f32"`` (host ``--wire f32``)
    advertises — and serves — only the uncompressed codec: the supported
    way to emulate an old binary in a mixed pod, and the kill switch if
    a codec ever misbehaves in production."""
    if mode == "f32":
        return {"candidates": ["f32"], "slab_rows": ["f32"]}
    return {"candidates": list(CANDIDATE_CODECS),
            "slab_rows": list(SLAB_CODECS)}


def negotiate(mode: str, caps: dict | None, path: str) -> str:
    """Pick the codec for one endpoint: ``mode`` is the frontend knob
    (``auto`` | ``f32`` | the compressed codec name); ``caps`` is the
    host's advertised table (None/empty = old binary). Negotiation can
    only ever *fall back* to f32 — a mismatch is never an error."""
    if mode == "f32" or not caps:
        return "f32"
    offered = caps.get(path) or []
    preferred = CANDIDATE_CODECS[0] if path == "candidates" \
        else SLAB_CODECS[0]
    if mode in ("auto", preferred) and preferred in offered:
        return preferred
    return "f32"


# --------------------------------------------------------------- helpers


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)
            ^ -(u & np.uint64(1)).astype(np.int64))


def _planes(a: np.ndarray, width: int) -> bytes:
    """Slot-major byte planes: transpose so same-position values across
    rows are adjacent, then split into little-endian byte planes (plane
    0 = all low bytes, ...). High planes of deltas/levels are near
    constant, which is what zlib's window actually finds."""
    dt = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<u8"}[width]
    b = np.ascontiguousarray(a.T).astype(dt).view(np.uint8)
    b = b.reshape(*a.T.shape, width)
    return b"".join(np.ascontiguousarray(b[..., i]).tobytes()
                    for i in range(width))


def _unplanes(raw: bytes, shape: tuple, width: int) -> np.ndarray:
    """Inverse of ``_planes``; returns an array of ``shape`` (row-major
    view of the original, i.e. transposed back)."""
    n = int(np.prod(shape, dtype=np.int64))
    if len(raw) != n * width:
        raise WireError(f"plane section is {len(raw)} bytes, "
                        f"want {n * width}")
    planes = np.frombuffer(raw, np.uint8).reshape(width, n)
    out = np.zeros(n, np.uint64)
    for i in range(width):
        out |= planes[i].astype(np.uint64) << np.uint64(8 * i)
    shape_t = tuple(reversed(shape))
    return out.reshape(shape_t).T


def _varint_encode(u: np.ndarray) -> bytes:
    """LEB128 varints for a u64 array, vectorized: compute each value's
    byte length, then scatter byte position p of every value with >= p+1
    bytes in one masked assignment per position (10 positions max)."""
    u = np.ascontiguousarray(u, np.uint64).ravel()
    if u.size == 0:
        return b""
    nbits = np.zeros(u.shape, np.int64)
    tmp = u.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = tmp >= (np.uint64(1) << np.uint64(shift))
        nbits += np.where(big, shift, 0)
        tmp = np.where(big, tmp >> np.uint64(shift), tmp)
    nbytes = np.maximum((nbits + 7) // 7, 1)
    ends = np.cumsum(nbytes)
    out = np.zeros(int(ends[-1]), np.uint8)
    starts = ends - nbytes
    for p in range(10):
        sel = nbytes > p
        if not sel.any():
            break
        chunk = (u[sel] >> np.uint64(7 * p)) & np.uint64(0x7F)
        cont = np.where(nbytes[sel] > p + 1, 0x80, 0).astype(np.uint8)
        out[starts[sel] + p] = chunk.astype(np.uint8) | cont
    return out.tobytes()


def _varint_decode(raw: bytes, count: int) -> tuple[np.ndarray, int]:
    """Decode ``count`` LEB128 varints; returns ``(values u64[count],
    bytes_consumed)`` so variable-length sections can be parsed in
    sequence. Truncated / overlong streams raise ``WireError``."""
    if count == 0:
        return np.zeros(0, np.uint64), 0
    b = np.frombuffer(raw, np.uint8)
    ends = np.nonzero((b & 0x80) == 0)[0]
    if len(ends) < count:
        raise WireError(f"varint section truncated: {len(ends)} values, "
                        f"want {count}")
    ends = ends[:count]
    starts = np.concatenate([[0], ends[:-1] + 1])
    lens = ends - starts + 1
    if (lens > 10).any():
        raise WireError("overlong varint")
    out = np.zeros(count, np.uint64)
    for p in range(int(lens.max())):
        sel = lens > p
        out[sel] |= ((b[starts[sel] + p] & np.uint64(0x7F))
                     << np.uint64(7 * p))
    return out, int(ends[-1]) + 1


def float_to_ordered_u32(x: np.ndarray) -> np.ndarray:
    """Map f32 bit patterns to u32 so unsigned integer order == float
    total order (negatives flipped entirely, positives sign-flipped).
    Pure bit transform — exactly invertible for every finite value."""
    bits = np.ascontiguousarray(x, "<f4").view(np.uint32)
    neg = (bits & np.uint32(0x80000000)) != 0
    return np.where(neg, ~bits, bits | np.uint32(0x80000000))


def ordered_u32_to_float(u: np.ndarray) -> np.ndarray:
    neg = (u & np.uint32(0x80000000)) == 0
    bits = np.where(neg, ~u, u & np.uint32(0x7FFFFFFF)).astype("<u4")
    return bits.view("<f4")


# ---------------------------------------------------- q16 candidate codec


def encode_candidates_q16(d2: np.ndarray, idx: np.ndarray) -> bytes | None:
    """Encode one /route_knn response body. Returns None when the rows
    don't fit the codec's preconditions (k > 255, non-prefix pad layout,
    non-uniform pad value, NaN) — the caller then answers f32; the codec
    never guesses."""
    d2 = np.ascontiguousarray(d2, "<f4")
    idx = np.ascontiguousarray(idx, "<i4")
    if d2.ndim != 2 or d2.shape != idx.shape:
        return None
    m, k = d2.shape
    if k > 255 or np.isnan(d2).any():
        return None
    valid = idx >= 0
    n_valid = valid.sum(axis=1).astype(np.uint8)
    # pads must be a suffix of every row (the engine contract) and carry
    # one uniform distance (radius^2, or +inf when unbounded)
    slots = np.arange(k, dtype=np.int64)[None, :]
    if not (valid == (slots < n_valid[:, None])).all():
        return None
    pad_value = np.float32(np.inf)
    if (~valid).any():
        pads = d2[~valid]
        pad_value = pads.flat[0]
        if not (pads == pad_value).all():
            return None
    anchors = np.zeros(m, "<f4")
    has = n_valid > 0
    if has.any():
        rows = np.nonzero(has)[0]
        anchors[rows] = d2[rows, n_valid[rows].astype(np.int64) - 1]
    # monotone uint16 levels against the per-row anchor, computed so the
    # decoder's EXACT f64 expression anchor*u/65535 is >= the true d2
    a64 = anchors.astype(np.float64)[:, None]
    d64 = d2.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.ceil(d64 * 65535.0 / a64)
    u = np.where(np.isfinite(u), u, 0.0)
    u = np.clip(u, 0.0, 65535.0).astype(np.int64)
    live = valid & (anchors[:, None] > 0)
    for _ in range(2):
        with np.errstate(invalid="ignore"):
            low = live & (a64 * u / 65535.0 < d64)
        if not low.any():
            break
        u = np.minimum(u + low.astype(np.int64), 65535)
    else:
        if (live & (a64 * u / 65535.0 < d64)).any():
            return None  # pathological rounding: serve f32 instead
    # only the interior slots (before the anchor) carry levels; the
    # anchor column always decodes to 65535, so it is elided entirely
    interior = slots[:, :k - 1] < (n_valid[:, None].astype(np.int64) - 1)
    u_int = np.where(interior, u[:, :k - 1], 0) if k > 1 \
        else np.zeros((m, 0), np.int64)
    # anchors as zigzag-varint ulp deltas down the batch (consecutive
    # rows of a clustered batch have near-equal kth distances)
    a_ulp = float_to_ordered_u32(anchors).astype(np.int64)
    a_delta = np.diff(a_ulp, prepend=np.int64(0))
    # valid ids as ONE flat zigzag-varint delta stream in distance order
    # (cross-row deltas included: neighbor lists of adjacent queries
    # overlap, which keeps even the row-boundary deltas short)
    flat_ids = idx[valid].astype(np.int64)
    id_delta = np.diff(flat_ids, prepend=np.int64(0))
    body = b"".join([
        _Q16_MAGIC, struct.pack("<BBIf", 1, k, m, pad_value),
        n_valid.tobytes(),
        _planes(u_int.astype(np.uint16), 2),
        _varint_encode(_zigzag(a_delta)),
        _varint_encode(_zigzag(id_delta)),
    ])
    return zlib.compress(body, _ZLIB_LEVEL)


def decode_candidates_q16(
        payload: bytes, m: int,
        k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode to ``(d2_hi f32[m,k], d2_lo f32[m,k], idx i32[m,k])``.
    ``d2_hi`` / ``d2_lo`` bracket the true f32 distance per slot; the
    anchor slot (the row's kth valid distance), every pad slot, and
    exact zeros are bit-exact (``lo == hi``), so a single-contributor
    query's served row needs no re-fetch, and a contribution whose best
    ``lo`` exceeds another's exact kth provably cannot change the fold.
    """
    try:
        body = zlib.decompress(payload)
    except zlib.error as e:
        raise WireError(f"q16 body does not inflate: {e}") from e
    head = 2 + struct.calcsize("<BBIf")
    if len(body) < head or body[:2] != _Q16_MAGIC:
        raise WireError("q16 body missing magic")
    ver, kk, mm, pad_value = struct.unpack("<BBIf", body[2:head])
    if ver != 1 or kk != k or mm != m:
        raise WireError(f"q16 header mismatch: ver={ver} k={kk} (want {k}) "
                        f"m={mm} (want {m})")
    lev_bytes = 2 * m * (k - 1)
    if len(body) < head + m + lev_bytes:
        raise WireError(f"q16 body is {len(body)} bytes, want at least "
                        f"{head + m + lev_bytes}")
    n_valid = np.frombuffer(body[head:head + m], np.uint8).astype(np.int64)
    if (n_valid > k).any():
        raise WireError("q16 n_valid exceeds k")
    off = head + m
    u = np.zeros((m, k), np.int64)
    if k > 1:
        u[:, :k - 1] = _unplanes(body[off:off + lev_bytes],
                                 (m, k - 1), 2).astype(np.int64)
    off += lev_bytes
    a_zz, used = _varint_decode(body[off:], m)
    off += used
    id_zz, used = _varint_decode(body[off:], int(n_valid.sum()))
    off += used
    if off != len(body):
        raise WireError(f"q16 body has {len(body) - off} trailing bytes")
    anchors = ordered_u32_to_float(
        np.cumsum(_unzigzag(a_zz)).astype(np.uint32))
    slots = np.arange(k, dtype=np.int64)[None, :]
    mask = slots < n_valid[:, None]
    # the elided anchor column: level 65535 exactly (0 for a zero anchor)
    has = n_valid > 0
    rows = np.nonzero(has)[0]
    u[rows, n_valid[rows] - 1] = np.where(anchors[rows] > 0, 65535, 0)
    flat_ids = np.cumsum(_unzigzag(id_zz))
    ids = np.full((m, k), -1, np.int64)
    ids[mask] = flat_ids
    # bounds: the exact f64 expression the encoder certified against,
    # rounded outward into f32. Only the row's ACTUAL anchor slot (and
    # level 0 = an exact zero) carries lo == hi: an interior distance
    # within 1/65535 of the anchor also ceils to level 65535, and
    # handing it lo == anchor would overstate its lower bound above the
    # true d2 — the frontend's strict lo > kth test would then serve a
    # row verbatim that an exact fold could still change.
    anchor_slot = np.zeros((m, k), bool)
    anchor_slot[rows, n_valid[rows] - 1] = True
    a64 = anchors.astype(np.float64)[:, None]
    hi64 = a64 * u / 65535.0
    hi32 = hi64.astype(np.float32)
    lift = hi32.astype(np.float64) < hi64
    hi32 = np.where(lift, np.nextafter(hi32, np.float32(np.inf)), hi32)
    hi32 = np.where(u == 65535, anchors[:, None], hi32)
    # lower bound: encode guarantees u < d2*65535/anchor + 1, so the
    # true d2 strictly exceeds anchor*(u-1)/65535 in real arithmetic;
    # round down and shave one extra ulp to absorb the f64 slop
    lo64 = a64 * np.maximum(u - 1, 0) / 65535.0
    lo32 = lo64.astype(np.float32)
    drop = lo32.astype(np.float64) > lo64
    lo32 = np.where(drop, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    lo32 = np.maximum(np.nextafter(lo32, np.float32(-np.inf)),
                      np.float32(0.0))
    exact = anchor_slot | (u == 0)
    lo32 = np.where(exact, hi32, lo32)
    d2_hi = np.where(mask, hi32, np.float32(pad_value)).astype("<f4")
    d2_lo = np.where(mask, lo32, np.float32(pad_value)).astype("<f4")
    idx = np.where(mask, ids, -1).astype("<i4")
    return d2_hi, d2_lo, idx


# -------------------------------------------------------- d16 slab codec


def encode_slab_chunk(pts: np.ndarray, level: int = 6) -> bytes:
    """Encode one chunk of Morton-sorted f32 rows, losslessly. Ladder:
    16-bit zigzag ulp deltas when every step fits, then 32-bit, then
    64-bit (sign-crossing steps zigzag up to 2^33), raw f32 when the
    transform + zlib does not actually shrink the chunk. Default zlib
    level 6 (not the wire default 1): slab pulls are bandwidth-bound,
    not encode-bound, so the extra effort pays."""
    pts = np.ascontiguousarray(pts, "<f4")
    m, dim = pts.shape
    if m == 0:
        return b"\x00"
    raw = memoryview(pts).cast("B")
    u = float_to_ordered_u32(pts).astype(np.int64)
    deltas = np.diff(u, axis=0)
    zz = _zigzag(deltas) if m > 1 else np.zeros((0, dim), np.uint64)
    # zigzag'd steps between ordered-u32 values span [0, 2^33): rows
    # that cross zero with |coord| > ~1 overflow a u32, so the ladder
    # tops out at 8-byte planes (the high planes are near-constant
    # zeros and vanish under zlib; the raw-f32 escape below still
    # catches chunks where the transform does not pay)
    zmax = 0 if zz.size == 0 else int(zz.max())
    width = 2 if zmax < 2 ** 16 else 4 if zmax < 2 ** 32 else 8
    # only the first row rides raw; zigzag ulp deltas carry the rest
    body = (_D16_MAGIC + struct.pack("<BBIH", 1, width, m, dim)
            + u[0].astype("<u4").tobytes()
            + _planes(zz.astype({2: np.uint16, 4: np.uint32,
                                 8: np.uint64}[width]), width))
    enc = zlib.compress(body, level)
    if len(enc) + 1 >= len(raw):
        return b"\x00" + bytes(raw)
    return b"\x01" + enc


def decode_slab_chunk(payload: bytes, m: int, dim: int) -> np.ndarray:
    """Inverse of ``encode_slab_chunk``; returns f32[m, dim] rows."""
    if not payload:
        raise WireError("empty slab chunk")
    flag, payload = payload[0], payload[1:]
    if flag == 0:
        if len(payload) != 4 * m * dim:
            raise WireError(f"raw slab chunk is {len(payload)} bytes, "
                            f"want {4 * m * dim}")
        return np.frombuffer(payload, "<f4").reshape(m, dim).copy()
    if flag != 1:
        raise WireError(f"unknown slab chunk flag {flag}")
    try:
        body = zlib.decompress(payload)
    except zlib.error as e:
        raise WireError(f"d16 chunk does not inflate: {e}") from e
    head = 2 + struct.calcsize("<BBIH")
    if len(body) < head or body[:2] != _D16_MAGIC:
        raise WireError("d16 chunk missing magic")
    ver, width, mm, dd = struct.unpack("<BBIH", body[2:head])
    if ver != 1 or mm != m or dd != dim or width not in (2, 4, 8):
        raise WireError(f"d16 header mismatch: ver={ver} width={width} "
                        f"rows={mm} (want {m}) dim={dd} (want {dim})")
    first_end = head + 4 * dim
    first = np.frombuffer(body[head:first_end], "<u4").astype(np.int64)
    zz = _unplanes(body[first_end:], (max(m - 1, 0), dim), width)
    deltas = _unzigzag(zz)
    u = np.concatenate([first[None, :], deltas], axis=0).cumsum(axis=0)
    if m == 0:
        return np.zeros((0, dim), "<f4")
    return np.ascontiguousarray(
        ordered_u32_to_float(u.astype(np.uint32)))


# ------------------------------------------------- chunked slab framing


def frame_chunk(rows: int, payload: bytes) -> bytes:
    """8-byte frame header for one /slab_rows chunk: the stream is sent
    with HTTP chunked transfer encoding (http.client hides the HTTP
    chunk boundaries), so the application re-frames: u32 payload bytes +
    u32 row count, then the payload."""
    return struct.pack("<II", len(payload), rows) + payload


def read_frames(read, total_rows: int):
    """Yield ``(rows, payload)`` frames from a ``read(n)`` callable until
    ``total_rows`` are consumed. Short reads raise ``WireError`` — a torn
    transfer surfaces as an error, never as a silently-short slab."""
    def read_exact(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            got = read(n - len(buf))
            if not got:
                raise WireError(
                    f"torn slab stream: wanted {n} more bytes, got EOF "
                    f"({total_rows - seen} rows still missing)")
            buf += got
        return buf

    seen = 0
    while seen < total_rows:
        nbytes, rows = struct.unpack("<II", read_exact(8))
        if rows == 0 or seen + rows > total_rows:
            raise WireError(f"bad slab frame: rows={rows} at {seen}"
                            f"/{total_rows}")
        payload = read_exact(nbytes)
        seen += rows
        yield rows, payload


# -------------------------------------------------- shared mutable state


class WireNegotiator:
    """Per-endpoint negotiated-codec table — the pod's shared negotiation
    state. The fan-out reads it on every dispatch; the health monitor /
    replica manager write it when hosts are scraped, adopted, or rebound,
    so access is lock-disciplined (``guarded_by``).
    """

    def __init__(self, mode: str = "auto"):
        if mode not in ("auto", "f32") + CANDIDATE_CODECS + SLAB_CODECS:
            raise ValueError(f"wire mode must be auto|f32|q16|d16, "
                             f"got {mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        #: url -> caps dict as advertised at the host's /stats root
        self.caps: guarded_by("_lock") = {}
        #: url -> {path: codec} resolved table
        self.negotiated: guarded_by("_lock") = {}

    def set_caps(self, url: str, caps: dict | None) -> None:
        url = url.rstrip("/")
        table = {path: negotiate(self.mode, caps, path)
                 for path in ("candidates", "slab_rows")}
        with self._lock:
            self.caps[url] = dict(caps or {})
            self.negotiated[url] = table

    def codec_for(self, url: str, path: str = "candidates") -> str:
        with self._lock:
            return self.negotiated.get(url.rstrip("/"), {}).get(path,
                                                                "f32")

    def snapshot(self) -> dict:
        with self._lock:
            return {"mode": self.mode,
                    "negotiated": {u: dict(t)
                                   for u, t in self.negotiated.items()}}


class WireStats:
    """Byte/row accounting per (path, codec) — the single source behind
    ``knn_wire_bytes_total{path=,codec=}`` on every surface. Handler
    threads and fan-out workers increment concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (path, codec) -> [bytes, rows]
        self.traffic: guarded_by("_lock") = {}

    def add(self, path: str, codec: str, nbytes: int,
            rows: int = 0) -> None:
        with self._lock:
            cell = self.traffic.setdefault((path, codec), [0, 0])
            cell[0] += int(nbytes)
            cell[1] += int(rows)

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self.traffic.items())
        out: dict = {}
        for (path, codec), (nbytes, rows) in items:
            cell = out.setdefault(path, {})
            cell[codec] = {"bytes": nbytes, "rows": rows}
            if rows:
                cell[codec]["bytes_per_row"] = round(nbytes / rows, 2)
        return out

    def prometheus_lines(self) -> list[str]:
        from mpi_cuda_largescaleknn_torch.obs.timers import (
            labeled_metric_lines,
        )

        snap = self.snapshot()
        cells = [({"path": path, "codec": codec}, cell)
                 for path, codecs in snap.items()
                 for codec, cell in codecs.items()]
        return (
            labeled_metric_lines(
                "knn_wire_bytes_total",
                ((lab, cell["bytes"]) for lab, cell in cells))
            + labeled_metric_lines(
                "knn_wire_rows_total",
                ((lab, cell["rows"]) for lab, cell in cells))
            + labeled_metric_lines(
                "knn_wire_bytes_per_row",
                ((lab, cell["bytes_per_row"]) for lab, cell in cells
                 if "bytes_per_row" in cell), kind="gauge"))
