"""PPL primitives: ``sample``, ``deterministic``, ``factor``, ``plate``.

Counterpart of ``gwinferno_tpu/ppl/primitives.py``.  Effectful
interpretation happens through a handler stack; with no handler active a
latent ``sample`` site has no value and raises, unless it carries its own
``rng_key``.
"""

from __future__ import annotations

import torch

from .distributions import Unit

_HANDLER_STACK = []
_PLATE_STACK = []


def apply_stack(msg):
    """Send a message through the active handler stack (innermost first)."""
    for handler in reversed(_HANDLER_STACK):
        handler.process_message(msg)
        if msg.get("stop"):
            break
    default_process_message(msg)
    for handler in _HANDLER_STACK:
        handler.postprocess_message(msg)
    return msg


def default_process_message(msg):
    if msg["value"] is None:
        if msg["type"] == "sample":
            if msg["generator"] is None:
                raise ValueError(
                    f"site '{msg['name']}' has no value: seed the model with "
                    "handlers.seed(...) or substitute a value"
                )
            msg["value"] = msg["fn"].sample(msg["generator"], _plate_sample_shape(msg))
        elif msg["type"] == "deterministic":
            raise ValueError(f"deterministic site '{msg['name']}' missing value")


def _plate_sample_shape(msg):
    """One iid draw per element of the enclosing plate (a single plate at
    ``dim=-1``, the only layout supported); other layouts raise."""
    frames = msg.get("cond_indep_stack") or []
    sample_shape = msg["sample_shape"]
    if not frames or sample_shape:
        return sample_shape
    if len(frames) > 1:
        raise NotImplementedError(f"site '{msg['name']}' is inside {len(frames)} nested plates; one is supported")
    _, size, dim = frames[0]
    if dim != -1:
        raise NotImplementedError(f"site '{msg['name']}': plate dim={dim} is not supported (only dim=-1)")
    if tuple(msg["fn"].batch_shape)[-1:] == (size,):
        return sample_shape
    return (int(size),)


def _event_ndim(fn):
    ev = getattr(fn, "event_shape", None) or ()
    return int(getattr(fn, "event_ndim", len(ev)))


def _validate_plate_shape(msg):
    """Raise when a site's value lacks the plate's size at the plate's dim,
    counted from the value's right (so a leading chain axis passes: ``(C,
    N)`` and ``(N,)`` both carry ``N`` at dim -1)."""
    frames = msg.get("cond_indep_stack") or []
    if not frames or msg["value"] is None:
        return
    _, size, dim = frames[-1]
    shape = tuple(torch.as_tensor(msg["value"]).shape)
    batch_event = len(shape) - _event_ndim(msg["fn"]) if msg["fn"] is not None else len(shape)
    axis = batch_event + dim
    if axis < 0 or axis >= len(shape) or shape[axis] != size:
        raise ValueError(
            f"site '{msg['name']}' inside plate(size={size}, dim={dim}) has value "
            f"shape {shape}: expected size {size} at batch axis {dim}"
        )


def _key_generator(rng_key):
    """A new generator for a site's own key: an int seeds a new CPU
    generator; a generator is copied (same device, same state), so the
    caller's is never advanced.  A key is a value, as a JAX key is: every
    run of the model draws the same values from it."""
    if isinstance(rng_key, torch.Generator):
        g = torch.Generator(device=rng_key.device)
        g.set_state(rng_key.get_state())
        return g
    if isinstance(rng_key, int) and not isinstance(rng_key, bool):
        return torch.Generator().manual_seed(rng_key)
    raise TypeError(f"rng_key must be an int or a torch.Generator, got {type(rng_key).__name__}")


def sample(name, fn, obs=None, rng_key=None, sample_shape=()):
    """Declare a random variable ``name`` distributed as ``fn``; ``obs``
    marks it observed (its density counts, its value is fixed).

    ``rng_key`` (an int seed or a ``torch.Generator``) draws the site from
    its own key at once, as the JAX package's explicit key does: the draw
    is the same in every run of the model and the caller's generator is
    not advanced.  Such a site is marked ``explicit_rng``; unless observed
    or given a value, it adds no density (the potential skips it)."""
    msg = {
        "type": "sample",
        "name": name,
        "fn": fn,
        "value": obs,
        "is_observed": obs is not None,
        "generator": None if rng_key is None else _key_generator(rng_key),
        "explicit_rng": rng_key is not None,
        "sample_shape": tuple(sample_shape),
        "cond_indep_stack": list(_PLATE_STACK),
    }
    apply_stack(msg)
    _validate_plate_shape(msg)
    return msg["value"]


def deterministic(name, value):
    """Record a named deterministic quantity in the trace."""
    msg = {
        "type": "deterministic",
        "name": name,
        "fn": None,
        "value": value,
        "is_observed": True,
        "generator": None,
        "sample_shape": (),
        "cond_indep_stack": [],
    }
    apply_stack(msg)
    return msg["value"]


def factor(name, log_factor):
    """Add an arbitrary log-probability term to the joint density."""
    msg = {
        "type": "sample",
        "name": name,
        "fn": Unit(log_factor),
        "value": torch.zeros(()),
        "is_observed": True,
        "generator": None,
        "sample_shape": (),
        "cond_indep_stack": [],
    }
    apply_stack(msg)


class plate:
    """Conditionally independent batch context, ``with plate("n", N) as idx``:
    yields ``arange(N)``; a drawn site inside gets one iid copy per element,
    and every site's value must carry ``N`` at the plate's dim (else
    ``ValueError``)."""

    def __init__(self, name, size, dim=None):
        self.name, self.size, self.dim = name, size, dim if dim is not None else -1

    def __enter__(self):
        _PLATE_STACK.append((self.name, self.size, self.dim))
        return torch.arange(self.size)

    def __exit__(self, *exc):
        _PLATE_STACK.pop()
        return False
