"""mpi_cuda_largescaleknn_torch — the PyTorch / H100 port of
``mpi_cuda_largescaleknn_tpu``.

For every point of a large point set of any dimension D, the distance to
its k-th nearest neighbor, by the unordered pipeline of the reference MPI+CUDA system
(``cudaMpiKNN_unorderedData pts.float3 -o out.float -k K``): slab split,
median-split bucketing, a warm start of each query's own bucket, then per
ring round the nearest-first traversal kernel (``csrc/knn_tiled.cu``),
then extraction in global point order; ``engine="pallas"`` folds whole
shards with the flat brute-force kernel (``csrc/knn_bf.cu``) instead, and
the JAX package's XLA engines run as PyTorch ops: ``tiled`` (the
traversal's twin), ``bruteforce`` and ``tree`` (the stack-free kd-tree
traversal);
``score_dtype="bf16"`` scores the traversal at D >= 16 on the tensor cores
(``csrc/knn_tiled_mxu.cu``) and rescores its survivors exactly. The
pre-partitioned pipeline (``cudaMpiKNN_prePartitionedData``) is
``models/prepartitioned.py`` over the bounds-pruned early-exit ring
``parallel/demand.py``, with ``cli/partition_main.py`` to cut a file into
spatially coherent parts. The JAX package stays the reference; this
package imports neither it nor JAX.

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig  # noqa: F401


def kth_neighbor_distances(points, k, *, max_radius=float("inf"),
                           num_shards: int = 1, engine: str = "auto",
                           score_dtype: str = "f32",
                           return_neighbors: bool = False, device=None,
                           **config_kwargs):
    """One-call API: distance from every point to its k-th nearest neighbor.

    ``points`` is ``f32[N, D]`` (numpy); returns ``f32[N]`` in input order
    (``inf`` where fewer than k neighbors exist within ``max_radius``).
    With ``return_neighbors`` also returns ``i32[N, k]`` neighbor ids.
    ``num_shards`` virtual ring shards run on the one device (0 means 1).
    ``engine`` is one of ``core/config.py`` ``ENGINES``.
    ``score_dtype="bf16"`` scores by the matmul form at D >= 16 and
    rescores the survivors exactly (``pallas`` and ``tree`` refuse it).
    ``device=None`` is the card; without CUDA that raises.
    Other ``KnnConfig`` fields pass through (``bucket_size``,
    ``point_group``).
    """
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN

    cfg = KnnConfig(k=k, max_radius=max_radius, engine=engine,
                    num_shards=num_shards, score_dtype=score_dtype,
                    device=device, **config_kwargs)
    return UnorderedKNN(cfg).run(points, return_neighbors=return_neighbors)
