"""Support constraints and ``biject_to``, which maps a support to its
unconstraining bijector.  Counterpart of ``gwinferno_tpu/ppl/constraints.py``
for real, positive and interval supports."""

from __future__ import annotations

from .transforms import ExpTransform
from .transforms import IdentityTransform
from .transforms import IntervalTransform

__all__ = ["Constraint", "real", "positive", "unit_interval", "interval", "biject_to"]


class Constraint:
    """A support descriptor with a factory for its bijector."""

    is_discrete = False

    def __init__(self, name, transform_factory):
        self.name = name
        self._transform_factory = transform_factory

    def transform(self):
        return self._transform_factory()

    def __repr__(self):
        return f"Constraint({self.name})"


class _Interval(Constraint):
    def __init__(self, low, high):
        self.low, self.high = low, high
        super().__init__(f"interval({low}, {high})", lambda: IntervalTransform(low, high))


real = Constraint("real", IdentityTransform)
positive = Constraint("positive", ExpTransform)
unit_interval = _Interval(0.0, 1.0)


def interval(low, high):
    return _Interval(low, high)


def biject_to(constraint):
    """The unconstrained -> constrained bijector for ``constraint``."""
    return constraint.transform()
