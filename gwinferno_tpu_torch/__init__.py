"""gwinferno_tpu_torch: the PyTorch/CUDA port of ``gwinferno_tpu``.

The package mirrors the JAX package's module paths so each counterpart is
easy to find (``gwinferno_tpu/pipeline/analysis.py`` ->
``gwinferno_tpu_torch/pipeline/analysis.py``).  It imports ``torch``, numpy
and scipy only: never JAX, never the JAX package, and ``h5py`` only inside
the catalog loader.

Conventions shared by every module:

- entry points take an explicit ``device`` that defaults to CUDA and raise
  when CUDA is absent (:func:`gwinferno_tpu_torch.device.resolve_device`);
  nothing falls back to the CPU unless the caller asks for ``"cpu"``;
- chains are an explicit leading axis: a potential takes ``(C, D)``
  unconstrained points and returns ``(C,)``, and every sampled site value
  carries that leading chain axis;
- random draws take an explicit ``torch.Generator``; a site with its own
  key (``sample(..., rng_key=...)``) takes an int seed or a generator and
  draws the same values in every run of the model;
- every TPU (Pallas) kernel on the port's path is a hand-written CUDA kernel
  under ``ops/csrc/`` with a plain-torch version beside it, which is what a
  CPU tensor runs.
"""

__version__ = "0.1.0"
