"""Joint log-density and the unconstrained-space potential energy that the
samplers differentiate, batched over a leading chain axis.

Counterpart of ``gwinferno_tpu/ppl/infer_util.py``.  Site values carry a
leading chain axis ``(C, *site_shape)``; every density term is reduced to
``(C,)`` by summing over its other axes.  :class:`ModelPotential` flattens
the latent sites into ``(C, D)`` vectors in sorted site-name order, the order
in which the JAX engine's ``ravel_pytree`` flattens its site dict.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import handlers
from .constraints import biject_to
from .primitives import _plate_sample_shape

__all__ = [
    "ModelPotential",
    "log_density",
    "potential_energy",
    "unconstrain_fn",
    "constrain_fn",
    "transform_fn",
    "init_to_uniform",
    "find_valid_initial_params",
]


def _chain_sum(name, term, num_chains):
    """Reduce one site's log-density term to ``(num_chains,)``."""
    term = torch.as_tensor(term)
    if term.ndim == 0:
        return term.expand(num_chains)
    if term.shape[0] in (num_chains, 1):
        return term.reshape(term.shape[0], -1).sum(-1).expand(num_chains)
    raise ValueError(
        f"site '{name}': log-density term of shape {tuple(term.shape)} has no leading chain axis of size {num_chains}"
    )


def _num_chains(params):
    for v in params.values():
        return int(torch.as_tensor(v).shape[0])
    return 1


def _drawn_with_key(site, params):
    """A site drawn from its own key (``sample(..., rng_key=...)``), neither
    observed nor given a value: it adds no density, as in the JAX package."""
    return site.get("explicit_rng", False) and not site["is_observed"] and site["name"] not in params


def _joint(tr, num_chains, params):
    total = 0.0
    for name, site in tr.items():
        if site["type"] == "sample" and not _drawn_with_key(site, params):
            total = total + _chain_sum(name, site["fn"].log_prob(site["value"]), num_chains)
    return total


def log_density(model, model_args=(), model_kwargs=None, params=None):
    """Joint log-density of ``model`` at constrained ``params`` (each
    ``(C, *site_shape)``).  Returns ``(log_joint (C,), trace)``."""
    params = params or {}
    with handlers.trace() as tr, handlers.substitute(data=params):
        model(*model_args, **(model_kwargs or {}))
    return _joint(tr.trace, _num_chains(params), params), tr.trace


def potential_energy(model, model_args=(), model_kwargs=None, params=None):
    """Negative log-joint at unconstrained ``params`` (each
    ``(C, *site_shape)``), including the log-Jacobians of the constraining
    transforms.  Returns ``(C,)``."""
    params = params or {}
    num_chains = _num_chains(params)
    jac = []

    def substitute_fn(msg):
        name = msg["name"]
        if name not in params:
            return None
        t = biject_to(msg["fn"].support)
        u = params[name]
        y = t(u)
        jac.append(_chain_sum(name, t.log_abs_det_jacobian(u, y), num_chains))
        return y

    with handlers.trace() as tr, handlers.substitute(substitute_fn=substitute_fn):
        model(*model_args, **(model_kwargs or {}))
    return -(_joint(tr.trace, num_chains, params) + sum(jac))


def _site_transforms(model, model_args, model_kwargs, params, constrained):
    """Latent site -> bijector, from one run of the model at ``params``
    (constrained values, or unconstrained ones mapped through the bijector)."""

    def substitute_fn(msg):
        if msg["name"] not in params:
            return None
        v = params[msg["name"]]
        return v if constrained else biject_to(msg["fn"].support)(v)

    with handlers.trace() as tr, handlers.substitute(substitute_fn=substitute_fn):
        model(*model_args, **(model_kwargs or {}))
    return {
        name: biject_to(site["fn"].support)
        for name, site in tr.trace.items()
        if site["type"] == "sample" and not site["is_observed"] and not _drawn_with_key(site, params)
    }


def unconstrain_fn(model, model_args=(), model_kwargs=None, params=None):
    """Map constrained site values to unconstrained space."""
    transforms = _site_transforms(model, model_args, model_kwargs, params, constrained=True)
    return {k: transforms[k].inv(v) if k in transforms else v for k, v in params.items()}


def constrain_fn(model, model_args=(), model_kwargs=None, params=None):
    """Map unconstrained site values back to constrained space."""
    transforms = _site_transforms(model, model_args, model_kwargs, params, constrained=False)
    return {k: transforms[k](v) if k in transforms else v for k, v in params.items()}


def transform_fn(transforms, params, invert=False):
    """Apply ``transforms`` (``{site: bijector}``) to ``params``, or their
    inverses with ``invert``; sites without a transform pass through."""
    out = {}
    for k, v in params.items():
        t = transforms.get(k)
        out[k] = v if t is None else (t.inv(v) if invert else t(v))
    return out


def init_to_uniform(radius=2.0):
    """Init strategy: ``init(generator, shape, dtype=None)`` draws uniformly
    in ``(-radius, radius)`` in unconstrained space from ``generator``, on
    its device."""

    def init(generator, shape, dtype=None):
        u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype or torch.get_default_dtype())
        return (2.0 * u - 1.0) * radius

    return init


class ModelPotential:
    """The potential energy of ``model`` as a function of flat unconstrained
    points ``z`` of shape ``(C, D)``.

    Construction runs the model once (one chain, every latent site at the
    image of 0 under its bijector) to find the latent sites, their shapes and
    their supports.  A site's unconstrained coordinates may have another
    shape than its values (a simplex of K values has K - 1): ``shapes`` holds
    the constrained shapes, ``unconstrained_shapes`` the ones ``z`` is cut
    into.  Sites are flattened in sorted name order.  A discrete latent site
    raises, as it does in the JAX package's engine, unless it is drawn from
    its own key (``sample(..., rng_key=...)``): such a site is not a latent
    coordinate and adds no density.
    """

    def __init__(self, model, model_args=(), model_kwargs=None, device=None, dtype=torch.float32):
        self.model, self.model_args, self.model_kwargs = model, tuple(model_args), dict(model_kwargs or {})
        self.device = resolve_device(device)
        self.dtype = dtype

        def probe(msg):
            if msg["is_observed"] or msg.get("explicit_rng"):
                return None
            support = msg["fn"].support
            if support.is_discrete:
                raise ValueError(
                    f"discrete latent site '{msg['name']}' is not supported by NUTS: "
                    "marginalize it or condition on it"
                )
            t = biject_to(support)
            shape = t.unconstrained_shape((1,) + tuple(_plate_sample_shape(msg)) + msg["fn"].shape)
            return t(torch.zeros(shape, dtype=dtype, device=self.device))

        with torch.no_grad(), handlers.trace() as tr, handlers.substitute(substitute_fn=probe):
            model(*self.model_args, **self.model_kwargs)
        latent = {
            name: site for name, site in tr.trace.items()
            if site["type"] == "sample" and not site["is_observed"] and not site.get("explicit_rng")
        }
        self.names = sorted(latent)
        self.shapes = {k: tuple(latent[k]["value"].shape[1:]) for k in self.names}
        self.transforms = {k: biject_to(latent[k]["fn"].support) for k in self.names}
        self.unconstrained_shapes = {k: self.transforms[k].unconstrained_shape(self.shapes[k]) for k in self.names}
        sizes = [int(torch.Size(self.unconstrained_shapes[k]).numel()) for k in self.names]
        self.slices = {}
        off = 0
        for k, n in zip(self.names, sizes):
            self.slices[k] = slice(off, off + n)
            off += n
        self.dim = off

    def unravel(self, z):
        """``(C, D)`` -> ``{site: (C, *shape)}`` (unconstrained)."""
        return {k: z[:, self.slices[k]].reshape((z.shape[0],) + self.unconstrained_shapes[k]) for k in self.names}

    def ravel(self, u):
        """``{site: (C, *shape)}`` -> ``(C, D)``."""
        return torch.cat([u[k].reshape(u[k].shape[0], -1) for k in self.names], dim=1)

    def __call__(self, z):
        return potential_energy(self.model, self.model_args, self.model_kwargs, self.unravel(z))

    def value_and_grad(self, z):
        """Potential ``(C,)`` and its gradient ``(C, D)``: chains are
        independent, so one backward pass of the summed potential gives every
        chain's gradient."""
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            pe = self(zz)
            (grad,) = torch.autograd.grad(pe.sum(), zz)
        return pe.detach(), grad

    def constrain(self, z):
        """``(C, D)`` -> ``{site: (C, *shape)}`` constrained values."""
        return {k: self.transforms[k](v) for k, v in self.unravel(z).items()}

    def unconstrain(self, params, num_chains):
        """Constrained ``{site: value}`` -> ``(num_chains, D)``.  A value is
        either site-shaped (shared by every chain) or ``(num_chains, *shape)``."""
        missing = set(self.names) - set(params)
        if missing:
            raise ValueError(f"init params miss sites {sorted(missing)}")
        u = {}
        for k in self.names:
            v = torch.as_tensor(params[k], dtype=self.dtype, device=self.device)
            if tuple(v.shape) == self.shapes[k]:
                v = v.expand((num_chains,) + self.shapes[k])
            elif tuple(v.shape) != (num_chains,) + self.shapes[k]:
                raise ValueError(f"site '{k}': value of shape {tuple(v.shape)} for {num_chains} chains of shape {self.shapes[k]}")
            u[k] = self.transforms[k].inv(v)
        return self.ravel(u)


def find_valid_initial_params(potential, num_chains, generator, rounds=24):
    """Unconstrained starts ``(num_chains, D)`` with finite potential and
    gradient.

    Round ``k`` draws every chain uniformly in ``[-r_k, r_k]^D`` with radii
    shrinking toward the transforms' midpoints (``r_k = max(2 * 0.85^k,
    0.125)``): for hierarchical likelihoods with n_eff walls, flat-population
    points are the reliably valid region.  A chain keeps its first candidate
    that is off the walls (``|potential| < 1e30``), else its first finite
    one; rounds stop once every chain has an off-wall start.
    """
    C, D = num_chains, potential.dim
    dev, dtype = potential.device, potential.dtype
    strict = torch.zeros(C, dtype=torch.bool, device=dev)
    loose = torch.zeros(C, dtype=torch.bool, device=dev)
    z_strict = torch.zeros(C, D, dtype=dtype, device=dev)
    z_loose = torch.zeros(C, D, dtype=dtype, device=dev)
    for k in range(rounds):
        radius = max(2.0 * 0.85**k, 0.125)
        u = torch.rand(C, D, generator=generator, device=dev, dtype=dtype)
        cand = (2.0 * u - 1.0) * radius
        pe, grad = potential.value_and_grad(cand)
        finite = torch.isfinite(pe) & torch.isfinite(grad).all(-1)
        off_wall = finite & (pe.abs() < 1e30)
        z_strict = torch.where((off_wall & ~strict)[:, None], cand, z_strict)
        z_loose = torch.where((finite & ~loose)[:, None], cand, z_loose)
        strict |= off_wall
        loose |= finite
        if bool(strict.all()):
            return z_strict
    if not bool(loose.all()):
        raise RuntimeError("could not find valid initial parameters for all chains")
    return torch.where(strict[:, None], z_strict, z_loose)
