"""Effect handlers: ``trace``, ``seed``, ``substitute``, ``condition``,
``block`` and ``collect_deterministic``.

Counterpart of ``gwinferno_tpu/ppl/handlers.py``.  Handlers are context
managers that push onto the primitive handler stack and reinterpret the
messages of ``sample`` / ``deterministic`` / ``factor``; they compose by
nesting (the innermost sees a message first).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from . import primitives


class Messenger:
    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        primitives._HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        if primitives._HANDLER_STACK[-1] is not self:
            raise RuntimeError("handler stack corrupted: handlers must exit in reverse order")
        primitives._HANDLER_STACK.pop()
        return False

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return self.fn(*args, **kwargs)


class trace(Messenger):
    """Record every site into an ordered dict ``name -> message``."""

    def __enter__(self):
        super().__enter__()
        self.trace = OrderedDict()
        return self

    def postprocess_message(self, msg):
        if msg["type"] in ("sample", "deterministic"):
            name = msg["name"]
            if name in self.trace:
                raise ValueError(f"duplicate site name '{name}'")
            self.trace[name] = msg.copy()

    def get_trace(self, *args, **kwargs):
        self(*args, **kwargs)
        return self.trace


class seed(Messenger):
    """Give un-valued sample sites a ``torch.Generator`` to draw from
    (``rng_seed``: a generator, or an int that seeds a new CPU generator)."""

    def __init__(self, fn=None, rng_seed=None):
        super().__init__(fn)
        if isinstance(rng_seed, int):
            rng_seed = torch.Generator().manual_seed(rng_seed)
        if not isinstance(rng_seed, torch.Generator):
            raise TypeError("seed needs an int or a torch.Generator")
        self.generator = rng_seed

    def next_key(self):
        """A fresh generator on this handler's device, seeded from a draw of
        its generator (which advances it, as splitting advances a JAX key)."""
        g = self.generator
        sub = int(torch.randint(0, 2**63 - 1, (1,), generator=g, device=g.device))
        return torch.Generator(device=g.device).manual_seed(sub)

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["value"] is None and msg["generator"] is None:
            msg["generator"] = self.generator


class substitute(Messenger):
    """Fix sample-site values from a dict (or a callable ``msg -> value``)."""

    def __init__(self, fn=None, data=None, substitute_fn=None):
        super().__init__(fn)
        self.data = data or {}
        self.substitute_fn = substitute_fn

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        if msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
        elif self.substitute_fn is not None:
            value = self.substitute_fn(msg)
            if value is not None:
                msg["value"] = value


class condition(Messenger):
    """Fix site values and mark them observed (they contribute density)."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class block(Messenger):
    """Hide matching sites from outer handlers."""

    def __init__(self, fn=None, hide_fn=None, hide=None):
        super().__init__(fn)
        if hide_fn is None:
            hide_set = set(hide or [])
            hide_fn = lambda msg: msg["name"] in hide_set if hide_set else True  # noqa: E731
        self.hide_fn = hide_fn

    def process_message(self, msg):
        if self.hide_fn(msg):
            msg["stop"] = True


class collect_deterministic(Messenger):
    """Mark a run of the model whose deterministic sites are read
    (``site_names``: the names read, None for all).  A model computes sites
    that cost more than its density, and that the density does not need
    (the posterior-predictive draws), only inside such a run: see
    :func:`deterministic_requested`."""

    def __init__(self, fn=None, site_names=None):
        super().__init__(fn)
        self.site_names = None if site_names is None else set(site_names)


def deterministic_requested(names):
    """Whether an enclosing :class:`collect_deterministic` reads any of
    ``names``; False at once when none is active (a potential's gradient)."""
    active = [h for h in primitives._HANDLER_STACK if isinstance(h, collect_deterministic)]
    if not active:
        return False
    if any(h.site_names is None for h in active):
        return True
    wanted = set().union(*(h.site_names for h in active))
    return any(n in wanted for n in names)
