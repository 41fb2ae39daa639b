"""The part of the reference's public surface that the port has not reached."""

from __future__ import annotations


class NotPortedSurface:
    """Base of the port's public classes: a method of the reference's
    surface that is listed in ``_NOT_PORTED`` (method name → ROADMAP item)
    raises NotImplementedError naming that item, instead of degrading to
    something else or failing with an AttributeError."""

    _NOT_PORTED: dict[str, str] = {}

    def __getattr__(self, name):
        item = type(self)._NOT_PORTED.get(name)
        if item is None:
            raise AttributeError(name)
        raise NotImplementedError(
            f"{type(self).__name__}.{name} is not ported to lancedb_tpu_torch yet (ROADMAP {item})"
        )
