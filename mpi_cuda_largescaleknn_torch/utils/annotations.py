"""``guarded_by``: the lock annotation of the serving modules.

Used as a PEP 526 attribute annotation (``self.n: guarded_by("_lock") =
0``) to say that the attribute is read and written only while holding
``self.<lock>``. Every serving module has ``from __future__ import
annotations``, so it is never evaluated at runtime. The JAX package's
static checker of it (``analysis/locks.py``) is not ported yet
(ROADMAP.md Queue 1); here it is documentation.
"""

from __future__ import annotations


def guarded_by(lock_attr: str, *_extra) -> type:
    """Annotation marker: the attribute may only be read or written while
    holding ``self.<lock_attr>``. A no-op at runtime."""
    if not isinstance(lock_attr, str) or not lock_attr:
        raise TypeError("guarded_by() takes the lock attribute NAME, "
                        f"e.g. guarded_by('_lock'); got {lock_attr!r}")
    return object
