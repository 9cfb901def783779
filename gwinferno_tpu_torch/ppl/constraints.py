"""Support constraints and ``biject_to``, which maps a support to its
unconstraining bijector.  Counterpart of ``gwinferno_tpu/ppl/constraints.py``:
real, real vector, positive, interval, simplex, ordered and integer
supports.  ``is_discrete`` marks supports NUTS cannot sample."""

from __future__ import annotations

from .transforms import ExpTransform
from .transforms import IdentityTransform
from .transforms import IntervalTransform
from .transforms import OrderedTransform
from .transforms import StickBreakingTransform

__all__ = [
    "Constraint",
    "real",
    "real_vector",
    "positive",
    "unit_interval",
    "interval",
    "simplex",
    "ordered",
    "integer",
    "biject_to",
]


class Constraint:
    """A support descriptor with a factory for its bijector."""

    def __init__(self, name, transform_factory, event_dims=0, is_discrete=False):
        self.name = name
        self._transform_factory = transform_factory
        self.event_dims = event_dims
        self.is_discrete = is_discrete

    def transform(self):
        return self._transform_factory()

    def __repr__(self):
        return f"Constraint({self.name})"


class _Interval(Constraint):
    def __init__(self, low, high):
        self.low, self.high = low, high
        super().__init__(f"interval({low}, {high})", lambda: IntervalTransform(low, high))


real = Constraint("real", IdentityTransform)
real_vector = Constraint("real_vector", IdentityTransform, event_dims=1)
positive = Constraint("positive", ExpTransform)
unit_interval = _Interval(0.0, 1.0)
simplex = Constraint("simplex", StickBreakingTransform, event_dims=1)
ordered = Constraint("ordered", OrderedTransform, event_dims=1)
integer = Constraint("integer", IdentityTransform, is_discrete=True)


def interval(low, high):
    return _Interval(low, high)


def biject_to(constraint):
    """The unconstrained -> constrained bijector for ``constraint``."""
    return constraint.transform()
