"""Ring-state checkpointing.

The port of the JAX package's ``utils/checkpoint.py``, in the same format.
The reference has no checkpoint/resume: one pass, outputs written only at
the end. Its candidate rows nevertheless summarize every round folded so
far, so after any round (round index, rows, counts) pin the exact
remaining work, and a preempted multi-hour run resumes instead of
restarting.

Crash safety: everything (arrays, round index, config fingerprint) lives
in ONE ``.npz`` written to a temporary path and atomically renamed, so
the round index and the arrays never disagree. The fingerprint includes
a sampled digest of the input data, so resuming against edited inputs
fails loudly; a completed run clears its checkpoint, so stale results
are never replayed as fresh ones.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

_STATE = "ring_state.npz"


def host_array(a) -> np.ndarray:
    """A numpy view of ``a`` (numpy, or a tensor on any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def data_digest(*arrays, sample_bytes: int = 1 << 16) -> str:
    """Content fingerprint of input arrays (numpy or tensors), sampled so
    it stays O(sample) for billion-point inputs: shape and dtype, the first
    and last ``sample_bytes``, and an even stride through the middle."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(host_array(a))
        h.update(repr((a.shape, str(a.dtype))).encode())
        b = a.reshape(-1).view(np.uint8)
        if b.nbytes <= 3 * sample_bytes:
            h.update(b.tobytes())
        else:
            h.update(b[:sample_bytes].tobytes())
            h.update(b[-sample_bytes:].tobytes())
            stride = max(1, b.nbytes // sample_bytes)
            h.update(b[::stride].tobytes())
    return h.hexdigest()


def fingerprint(**kv) -> dict:
    """Config identity a checkpoint is valid for (all jsonable scalars)."""
    return {k: (v if isinstance(v, (int, str, bool)) else float(v))
            for k, v in kv.items()}


def save_ring_state(ckpt_dir: str, round_idx: int, arrays: dict,
                    manifest: dict) -> None:
    """Atomically persist ``arrays`` (name -> array) at ``round_idx``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # np.savez appends ".npz" to names lacking it: keep the suffix last
    tmp = os.path.join(ckpt_dir, f".tmp.{os.getpid()}.{_STATE}")
    np.savez(tmp,
             __round__=np.int64(round_idx),
             __fingerprint__=np.frombuffer(
                 json.dumps(manifest, sort_keys=True).encode(), np.uint8),
             **{k: host_array(v) for k, v in arrays.items()})
    os.replace(tmp, os.path.join(ckpt_dir, _STATE))


def _check_fp(z, manifest: dict, ckpt_dir: str) -> None:
    saved_fp = json.loads(z["__fingerprint__"].tobytes().decode())
    want_fp = json.loads(json.dumps(manifest, sort_keys=True))
    if saved_fp != want_fp:
        raise ValueError(
            f"checkpoint at {ckpt_dir} was written for config "
            f"{saved_fp}, not {want_fp}; remove it (or pass a different "
            f"--checkpoint-dir) to start fresh")


def peek_round(ckpt_dir: str, manifest: dict):
    """Round index of a valid checkpoint, or None, without loading the
    arrays (``np.load`` reads entries lazily): a caller decides whether it
    resumes before it pays for init work the resume would discard."""
    spath = os.path.join(ckpt_dir, _STATE)
    if not os.path.exists(spath):
        return None
    with np.load(spath) as z:
        _check_fp(z, manifest, ckpt_dir)
        return int(z["__round__"])


def load_ring_state(ckpt_dir: str, manifest: dict):
    """Returns (round_idx, arrays dict) or None if absent. Raises
    ValueError when a checkpoint exists but was written for a different
    run configuration or different input data."""
    spath = os.path.join(ckpt_dir, _STATE)
    if not os.path.exists(spath):
        return None
    with np.load(spath) as z:
        _check_fp(z, manifest, ckpt_dir)
        rnd = int(z["__round__"])
        return rnd, {k: z[k] for k in z.files
                     if k not in ("__round__", "__fingerprint__")}


def clear(ckpt_dir: str) -> None:
    p = os.path.join(ckpt_dir, _STATE)
    if os.path.exists(p):
        os.remove(p)


def save_tensors(ckpt_dir: str, round_idx: int, tensors: list,
                 manifest: dict) -> None:
    """Snapshot a flat list of tensors (keyed by position). The copies to
    the host wait for the device's pending work on them, so the snapshot
    holds every fold issued before it. Shared by the stepwise ring and
    demand loops, so their snapshot format cannot drift apart."""
    save_ring_state(ckpt_dir, round_idx,
                    {f"a{i}": t for i, t in enumerate(tensors)}, manifest)


def load_tensors(ckpt_dir: str, manifest: dict, device):
    """Restore the list saved by ``save_tensors`` onto ``device``. Returns
    (round_idx, tensors) or None."""
    got = load_ring_state(ckpt_dir, manifest)
    if got is None:
        return None
    round_idx, arrs = got
    return round_idx, [torch.from_numpy(arrs[f"a{i}"]).to(device)
                       for i in range(len(arrs))]
