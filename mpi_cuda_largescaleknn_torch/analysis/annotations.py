"""Source-level annotations the static-analysis passes key on.

``guarded_by`` is used as a PEP 526 attribute annotation::

    from mpi_cuda_largescaleknn_torch.analysis import guarded_by

    class Batcher:
        def __init__(self):
            self._cond = threading.Condition()
            self.batches: guarded_by("_cond") = 0

Every module in ``serve/`` has ``from __future__ import annotations``, so
the annotation is never evaluated at runtime — it costs nothing and adds
no import-order hazards; it exists purely for ``analysis/locks.py``,
which proves (per class) that every read/write of an annotated attribute
happens inside the declared ``with self.<lock>`` block. The function is
still a real callable so the convention also works in modules WITHOUT
deferred annotations (it returns ``object``, a valid if vacuous type).

Method-level contracts ride comments instead (a ``def`` cannot carry a
PEP 526 annotation): ``# lsk: holds[_lock]`` on the ``def`` line declares
"callers must hold ``self._lock``" — the checker then verifies the body
AS IF the lock were held and flags any same-class call site that invokes
the method without it (analysis/waivers.py parses the grammar).
"""

from __future__ import annotations


def guarded_by(lock_attr: str, *_extra) -> type:
    """Annotation marker: the attribute may only be read or written while
    holding ``self.<lock_attr>`` (a ``threading.Lock`` / ``RLock`` /
    ``Condition`` attribute of the same instance). Checked statically by
    ``analysis/locks.py``; a no-op at runtime."""
    if not isinstance(lock_attr, str) or not lock_attr:
        raise TypeError("guarded_by() takes the lock attribute NAME, "
                        f"e.g. guarded_by('_lock'); got {lock_attr!r}")
    return object
