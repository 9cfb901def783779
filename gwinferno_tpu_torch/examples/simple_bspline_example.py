"""B-spline population analysis: the README's second quick-start example.

Counterpart of ``examples/simple_bspline_example.py``: the B-spline mass,
spin and redshift model (:class:`~gwinferno_tpu_torch.pipeline.bspline_model.
BSplineModel`) run by NUTS, then the posterior file, the B-spline mass, spin
and rate(z) PPDs, their plots and the PPD file.  ``--fused`` reduces both
banks with K3 (``ops/csrc/flw.cu``); without it the log weights are
materialised and reduced with K1 (``ops/csrc/dlse.cu``).

Run:  python -m gwinferno_tpu_torch.examples.simple_bspline_example --pe-inj-file CATALOG.h5 \\
          --m-nsplines 50 --q-nsplines 30 --a-nsplines 16 --tilt-nsplines 16 --z-nsplines 20 \\
          --reparam whitened [--fused] [--device cpu --dtype float64]
"""

from __future__ import annotations

import torch

from ..device import host_array
from ..device import resolve_device
from ..pipeline.utils import load_base_parser
from ..pipeline.utils import load_pe_and_injections_as_dict
from ..pipeline.utils import pdf_dict_to_xarray
from ..pipeline.utils import posterior_dict_to_xarray
from ..postprocess.calculations import calculate_bspline_mass_ppds
from ..postprocess.calculations import calculate_bspline_spin_ppds
from ..postprocess.calculations import calculate_powerlaw_spline_rate_of_z_ppds
from ..postprocess.plot import plot_mass_pdfs
from ..postprocess.plot import plot_rate_of_z_pdfs
from ..postprocess.plot import plot_spin_pdfs
from .utils import add_device_arguments
from .utils import run_bspline_analysis
from .utils import setup_result_dir

__all__ = ["bspline_ppds", "main"]


def bspline_ppds(posterior, models, args):
    """The example's B-spline mass, spin and rate(z) PPDs from the
    ``posterior`` draws (the coefficient blocks ``mass_cs``, ``q_cs``,
    ``a_cs``, ``tilt_cs``, ``z_cs``, with ``lamb`` and ``rate``) at ``args``'
    knot counts, on the redshift model's device in its dtype: ``(pdf_dict,
    param_dict)`` as ``pdf_dict_to_xarray`` files them."""
    post = {k: host_array(v) for k, v in posterior.items()}
    z_model = models["z"]
    on = dict(device=z_model.zs.device, dtype=z_model.zs.dtype)
    nspline_dict = {"m1": args.m_nsplines, "q": args.q_nsplines, "a": args.a_nsplines, "tilt": args.tilt_nsplines,
                    "redshift": args.z_nsplines}
    print("calculating mass ppds:")
    mass, m1s, mass_ratio, qs = calculate_bspline_mass_ppds(post["mass_cs"], post["q_cs"], nspline_dict, args.mmin,
                                                            args.mmax, **on)
    print("calculating spin ppds:")
    apdfs, mags, ctpdfs, tilts = calculate_bspline_spin_ppds(post["a_cs"], post["tilt_cs"], nspline_dict, **on)
    print("calculating rate(z) ppds:")
    r_of_z, zs = calculate_powerlaw_spline_rate_of_z_ppds(post["lamb"], post["z_cs"], post["rate"], z_model)
    pdf_dict = {"a1": apdfs, "cos_tilt1": ctpdfs, "mass_1": mass, "mass_ratio": mass_ratio, "redshift": r_of_z}
    param_dict = {"a1": mags, "cos_tilt1": tilts, "mass_1": m1s, "mass_ratio": qs, "redshift": zs}
    return pdf_dict, param_dict


def main(argv=None):
    parser = load_base_parser()
    add_device_arguments(parser)
    args = parser.parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    pedict, injdict, constants, param_names = load_pe_and_injections_as_dict(args.pe_inj_file)
    label, result_dir = setup_result_dir(args, default_label="bspline")

    posterior, models, _ = run_bspline_analysis(pedict, injdict, constants, param_names, args, device=device,
                                             dtype=dtype)
    posterior_dict_to_xarray(posterior).to_hdf5(result_dir + f"/{label}_posterior_samples.h5")
    print(f"posteriors file saved: {result_dir}/{label}_posterior_samples.h5")

    pdf_dict, param_dict = bspline_ppds(posterior, models, args)
    names, colors = ["BSpline"], ["tab:blue"]
    print("plotting:")
    plot_mass_pdfs([pdf_dict["mass_1"]], [pdf_dict["mass_ratio"]], param_dict["mass_1"], param_dict["mass_ratio"],
                   names, label, result_dir, save=args.save_plots, colors=colors)
    plot_spin_pdfs([pdf_dict["a1"]], [pdf_dict["cos_tilt1"]], param_dict["a1"], param_dict["cos_tilt1"], names, label,
                   result_dir, save=args.save_plots, colors=colors)
    plot_rate_of_z_pdfs(pdf_dict["redshift"], param_dict["redshift"], label, result_dir, save=args.save_plots)

    pdf_dict_to_xarray(pdf_dict, param_dict, args.samples).to_hdf5(result_dir + f"/{label}_pdfs.h5")
    print(f"pdfs saved: {result_dir}/{label}_pdfs.h5")


if __name__ == "__main__":
    main()
