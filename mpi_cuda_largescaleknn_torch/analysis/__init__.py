"""lskcheck: the port's static analysis of its serving stack and tools.

The port's copy of the JAX package's ``analysis/``: the same passes, the
same rule ids and messages, and the same comment grammar, run over this
package and ``tools/torch_*.py`` / ``tools/probe_*.py``
(``runner.DEFAULT_ROOTS``). Entry point: ``tools/torch_lskcheck.py``
(``--no-aot`` for the AST passes only, ``--write-aot-golden`` to adopt an
intended launch-plan change, ``--json PATH``, ``--list-rules``); it exits
0 only with zero unwaived findings and no contract drift.

Passes:

- ``locks``       — the ``guarded_by("_lock")`` annotation convention for
                    shared attributes (``analysis/annotations.py``), a
                    proof that every read/write of a guarded attribute
                    happens inside ``with self._lock``, and a lock-
                    acquisition-order graph that flags potential
                    inversions between threads.
- ``determinism`` — wall-clock and unseeded RNG in deterministic paths,
                    float ``==`` on distances, unstable sorts in tie-
                    sensitive code, dict-order folds, swallowed errors;
                    each rule in its numpy/JAX and its PyTorch spellings.
- ``aot``         — the launch-plan contract: PyTorch has no
                    ``jax.eval_shape``, so the pass builds the fixture
                    engines on the CPU, runs one all-padding batch per
                    shape bucket through ``ResidentKnnEngine._run`` and
                    diffs the operand/output table and the bucket geometry
                    against ``analysis/launch_contract.json``.

Rule catalog (``findings.RULES``):

================  =========================================================
rule              flags
================  =========================================================
lock-guard        a ``guarded_by`` attribute read or written outside its
                  lock (``__init__`` exempt)
lock-holds        a call of a ``# lsk: holds[lock]`` method without the lock
lock-order        a cycle in the acquisition-order graph, or a plain
                  ``Lock`` re-acquired while held
wallclock         ``time.time``/``time_ns``, ``datetime.now/utcnow/today``
rng-unseeded      ``random.*`` module calls, ``random.Random()`` and
                  ``np.random.default_rng()`` without a seed, the
                  ``np.random.*`` global generator; a ``torch.Generator()``
                  the module never ``manual_seed``s; ``torch.rand`` /
                  ``randn`` / ``randint`` / ``randperm`` without
                  ``generator=``
float-eq          ``==``/``!=`` on a distance-like name (``d2``, ``dist*``,
                  ``kth*``, ``radius*``) or against a float literal
sort-unstable     ``np.argsort`` without ``kind='stable'``; ``lax.sort``
                  without ``is_stable=True`` or ``num_keys >= 2``;
                  ``torch.sort`` / ``torch.argsort`` / ``Tensor.sort`` /
                  ``Tensor.argsort`` without ``stable=True``; any
                  ``torch.topk`` / ``Tensor.topk`` (tie order undocumented)
                  — each over distance-like operands
dict-order-fold   a ``for`` over ``.keys()``/``.values()`` in a
                  fold/merge/reduce/assemble/combine function
except-swallow    a bare or ``Exception`` handler that only passes
waiver            a malformed ``# lsk:`` directive, an unknown rule, an
                  ``allow`` without a reason
aot-contract      the traced launch-plan table or bucket geometry differs
                  from the golden, or the golden is missing
================  =========================================================

Every suppression is auditable: ``# lsk: allow[rule] reason`` (trailing,
or alone on the line above; a reason is required), and method contracts
are ``# lsk: holds[_lock]`` on the ``def`` line (``analysis/waivers.py``).
The lock proof is per class and ``self``-rooted: a cross-object access
goes through a locked snapshot method of the owning class.

This module stays import-light (no torch, no numpy) so serving code can
import ``guarded_by`` for free.
"""

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by

__all__ = ["guarded_by", "run_repo"]


def run_repo(*args, **kwargs):
    """Lazy alias for :func:`analysis.runner.run_repo` (keeps the package
    root import-light for the serving modules that only need
    ``guarded_by``)."""
    from mpi_cuda_largescaleknn_torch.analysis.runner import run_repo as _run

    return _run(*args, **kwargs)
