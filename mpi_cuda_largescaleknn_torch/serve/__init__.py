"""Online kNN serving: the port of the JAX package's ``serve/``, one card
a process, in its single-host form and as a routed pod of host
processes.

- ``engine``    — loads points once, builds the resident partition of R
                  virtual shards and the kernels' prepared point sides
                  once, and one fixed-shape launch plan per shape bucket
                  (powers of two up to ``max_batch``), so steady traffic
                  never builds another; batches run on the engine's CUDA
                  stream, merged on the card or on the host.
- ``batcher``   — dynamic micro-batching with per-request demux;
                  pipelined at ``pipeline_depth > 1`` (the next batch's
                  traversal overlaps the previous batch's fetch and merge).
- ``admission`` — bounded queue, backpressure, deadlines, and the one
                  counted degradation from the traversal kernel to its
                  twin ``tiled``.
- ``server``    — stdlib-HTTP JSON/binary endpoint: /knn, /healthz,
                  /stats, Prometheus-text /metrics.
- ``faults``, ``recall``, ``qcache`` — the JAX package's fault injection,
                  recall-SLO plans (their knobs reach the twin ``tiled``)
                  and certified query cache (exact hits, in-flight dedup,
                  radius seeds that reach the engine as per-row radii),
                  tenant-keyed.
- ``slabpool``  — the tiered slab index: an index larger than the device
                  budget served from a working set of slab engines over a
                  host-RAM pool over the file, byte-equal to a resident
                  engine at every budget.
- ``tenancy``   — many indexes behind one slab pool, one plan cache and
                  one admission controller, with per-tenant quotas.
- ``frontend``  — the routed pod: ``HostSliceServer`` (one independent
                  slab engine a host, ``POST /route_knn``), the
                  bounds-routed fan-out with certified escalation waves,
                  and the public ``FrontendServer`` (``python -m
                  ...serve.frontend``); also the certification slack and
                  the canonical fold the slab pool shares.
- ``health``    — the hosts' lifecycle (healthy, suspect, drained,
                  rejoining) and the monitor that drains and rejoins them.
- ``replica``   — replica groups of a slab and ``pull_slab_rows``.
- ``wire``      — the q16 candidate and d16 slab codecs, byte for byte the
                  JAX package's, and their negotiation.

Not ported yet (ROADMAP.md Queue 1 items 3b and 3c): the replicate pod
(``/shard_knn``, the engine's ``complete_slices``) and slab handoff
(``ReplicaManager``, warm standbys).
"""
