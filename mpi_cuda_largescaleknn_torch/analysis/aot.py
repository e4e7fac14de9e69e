"""The launch-plan contract: run every engine's shape buckets, diff a golden.

The serving engine's shape discipline is that a served shape never meets
a new plan: ``ResidentKnnEngine`` builds one fixed-shape launch plan per
(engine, merge, qpad, query_buckets, score_dtype) key, and
``compile_count`` counts the builds. What that discipline does not catch
by itself is drift in what a plan launches on and returns — a widened
operand dtype, an extra resident operand, a reshaped output — which is
recompile risk and wire-format risk that shows only under load.

The JAX package pins this with ``jax.eval_shape`` (its ``analysis/
aot.py``). PyTorch has no abstract trace, so this pass builds the same
small deterministic fixture engines on the CPU (``device="cpu"``: the
kernels' plain versions), runs one all-padding batch per shape bucket
through ``ResidentKnnEngine._run`` exactly as ``warmup`` does, and
records the resident operands, the batch's ``q`` and ``r`` and the
outputs as ``dtype[shape]``, beside the bucket geometry. The table is
diffed against the committed golden ``analysis/launch_contract.json``.
Any difference — a config gone, a program added or gone, a signature or
a bucket geometry changed — is an ``aot-contract`` finding. An intended
change regenerates the golden (``python tools/torch_lskcheck.py
--write-aot-golden``), and the diff shows up in review as a JSON change.

Shapes depend only on the fixture constants below (never on point values,
the device, or wall-clock), so the table is the same on every machine.
The fixture and the first five configs are the JAX package's; the sixth
is the port's served default, the traversal kernel's engine.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mpi_cuda_largescaleknn_torch.analysis.findings import Finding

CONTRACT_RELPATH = os.path.join("mpi_cuda_largescaleknn_torch", "analysis",
                                "launch_contract.json")
CONTRACT_VERSION = 1

#: fixture constants — part of the contract: changing any of them
#: legitimately regenerates the golden
FIXTURE = {"n_points": 192, "k": 4, "num_shards": 2,
           "max_batch": 16, "min_batch": 8}

#: engine configurations whose plan families the contract pins: the JAX
#: package's five (host vs device merge, exact f32 vs bf16 matmul-form at
#: D=32, the candidates emission, the flat engine) and the port's served
#: default, ``pallas_tiled`` (the CUDA traversal kernel)
CONFIGS = (
    {"engine": "tiled", "merge": "host", "score_dtype": "f32", "dim": 3,
     "emit": "final"},
    {"engine": "tiled", "merge": "device", "score_dtype": "f32", "dim": 3,
     "emit": "final"},
    {"engine": "tiled", "merge": "device", "score_dtype": "bf16", "dim": 32,
     "emit": "final"},
    {"engine": "tiled", "merge": "device", "score_dtype": "f32", "dim": 3,
     "emit": "candidates"},
    {"engine": "bruteforce", "merge": "device", "score_dtype": "f32",
     "dim": 3, "emit": "final"},
    {"engine": "pallas_tiled", "merge": "device", "score_dtype": "f32",
     "dim": 3, "emit": "final"},
)


def fixture_points(n: int, dim: int) -> np.ndarray:
    """Deterministic low-discrepancy points in [0, 1)^dim — a Weyl
    sequence, so no RNG is involved at all (this module must satisfy its
    own determinism rules). The JAX package's fixture, bit for bit."""
    i = np.arange(1, n * dim + 1, dtype=np.float64)
    return ((i * 0.6180339887498949) % 1.0).reshape(
        n, dim).astype(np.float32)


def _sig(t) -> str:
    """``dtype[shape]`` of a tensor, with the JAX package's dtype names."""
    dtype = str(t.dtype).removeprefix("torch.")
    return f"{dtype}[{','.join(str(d) for d in t.shape)}]"


def config_key(cfg: dict) -> str:
    return (f"{cfg['engine']}|{cfg['merge']}|{cfg['score_dtype']}"
            f"|d{cfg['dim']}|emit={cfg['emit']}")


def resident_operands(engine, engine_name: str) -> list:
    """The resident tensors a plan of ``engine_name`` launches on, shard
    by shard: the bucketed partition (points, ids, bucket bounds), the
    matmul-form norms and the traversal kernel's prepared point side on
    the tiled engines; the flat points and ids on ``bruteforce``."""
    if engine_name not in ("tiled", "pallas_tiled"):
        return [engine._flat_pts, engine._flat_ids]
    out = []
    for s, b in enumerate(engine._buckets):
        out += list(b)
        if engine._bucket_norms2 is not None:
            out.append(engine._bucket_norms2[s])
        if engine_name == "pallas_tiled" and engine._prepared is not None:
            p = engine._prepared[s]
            out += list(p.lanes if isinstance(p.lanes, tuple)
                        else (p.lanes,))
            if p.norms is not None:
                out.append(p.norms)
    return out


def trace_contract(device="cpu") -> dict:
    """Build every fixture engine on ``device`` and run its plan family
    once on an all-padding batch per shape bucket."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    out_configs = []
    for cfg in CONFIGS:
        pts = fixture_points(FIXTURE["n_points"], cfg["dim"])
        engine = ResidentKnnEngine(
            pts, FIXTURE["k"], num_shards=FIXTURE["num_shards"],
            engine=cfg["engine"], merge=cfg["merge"],
            score_dtype=cfg["score_dtype"], emit=cfg["emit"],
            max_batch=FIXTURE["max_batch"], min_batch=FIXTURE["min_batch"],
            device=device)
        programs = {}
        with engine._lock:
            for qpad in engine.shape_buckets:
                lp = engine._get_plan(qpad)
                q0 = torch.full((qpad, engine.dim), PAD_SENTINEL,
                                dtype=torch.float32, device=engine.device)
                r0 = torch.full((qpad,), engine.max_radius,
                                dtype=torch.float32, device=engine.device)
                out = engine._run(lp, q0, r0)
                args = resident_operands(engine, lp.engine_name)
                programs[f"q{qpad}|B{lp.qb}"] = {
                    "in": [_sig(a) for a in args] + [_sig(q0), _sig(r0)],
                    "out": [_sig(o) for o in out],
                }
        out_configs.append({
            "key": config_key(cfg), **cfg,
            "shape_buckets": list(engine.shape_buckets),
            "query_buckets": {str(q): b for q, b in
                              sorted(engine.query_buckets.items())},
            "canonical_ties": engine.canonical_ties,
            "score_mode": engine.score_mode,
            "programs": programs,
        })
    return {"version": CONTRACT_VERSION, "fixture": dict(FIXTURE),
            "configs": out_configs}


def write_contract(contract: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(contract, fh, indent=2, sort_keys=True)
        fh.write("\n")


def diff_contract(contract: dict, golden_path: str) -> list[Finding]:
    """Findings for every difference between the traced table and the
    committed golden. The golden missing entirely is itself a finding —
    the gate must fail loudly, not silently pass, on a fresh clone."""
    rel = CONTRACT_RELPATH
    if not os.path.exists(golden_path):
        return [Finding("aot-contract", rel, 1,
                        "golden contract file is missing — generate it "
                        "with `python tools/torch_lskcheck.py "
                        "--write-aot-golden` and commit it")]
    with open(golden_path) as fh:
        golden = json.load(fh)
    findings: list[Finding] = []

    def emit(msg: str) -> None:
        findings.append(Finding("aot-contract", rel, 1, msg))

    if golden.get("version") != contract["version"]:
        emit(f"contract version drifted: golden "
             f"{golden.get('version')} vs traced {contract['version']}")
    if golden.get("fixture") != contract["fixture"]:
        emit(f"fixture constants drifted: golden {golden.get('fixture')} "
             f"vs traced {contract['fixture']}")
    gold_by_key = {c["key"]: c for c in golden.get("configs", ())}
    new_by_key = {c["key"]: c for c in contract["configs"]}
    for key in sorted(gold_by_key.keys() - new_by_key.keys()):
        emit(f"engine config {key} is in the golden but no longer "
             "traced — a serving configuration silently disappeared")
    for key in sorted(new_by_key.keys() - gold_by_key.keys()):
        emit(f"engine config {key} is traced but not in the golden — "
             "regenerate the golden to adopt it")
    for key in sorted(new_by_key.keys() & gold_by_key.keys()):
        g, n = gold_by_key[key], new_by_key[key]
        for fld in ("shape_buckets", "query_buckets", "canonical_ties",
                    "score_mode"):
            if g.get(fld) != n.get(fld):
                emit(f"{key}: {fld} drifted: golden {g.get(fld)} vs "
                     f"traced {n.get(fld)} — AOT bucket geometry changed")
        gp, np_ = g.get("programs", {}), n.get("programs", {})
        for pk in sorted(gp.keys() - np_.keys()):
            emit(f"{key}: program {pk} gone — a shape bucket vanished "
                 "(recompile risk for served shapes)")
        for pk in sorted(np_.keys() - gp.keys()):
            emit(f"{key}: program {pk} is new — regenerate the golden "
                 "to adopt the bucket")
        for pk in sorted(np_.keys() & gp.keys()):
            for side in ("in", "out"):
                if gp[pk].get(side) != np_[pk].get(side):
                    emit(f"{key}: program {pk} {side!r} signature "
                         f"drifted: golden {gp[pk].get(side)} vs traced "
                         f"{np_[pk].get(side)} — dtype/shape drift in "
                         "the AOT program contract")
    return findings
