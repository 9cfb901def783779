"""The README's quick-start examples on the port.

Counterparts of ``examples/`` by name: ``utils.py`` (the result directory
and the analysis runners), ``simple_powerlaw_peak_example.py`` (the
14-hyperparameter powerlaw+peak model, its run, PPDs, plots and files) and
``simple_bspline_example.py`` (the B-spline run's PPDs, plots and files).
Each example runs as

    python -m gwinferno_tpu_torch.examples.<name> --pe-inj-file CATALOG.h5 [--device cpu --dtype float64]

on CUDA unless ``--device cpu`` is given.
"""
