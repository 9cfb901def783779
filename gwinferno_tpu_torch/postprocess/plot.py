"""Plots of a run: median + 90% bands of the population PPDs, and traces.

Counterpart of ``gwinferno_tpu/postprocess/plot.py``: the same figures and
file names.  Every plotter takes numpy arrays or tensors (CUDA tensors are
copied to the host).  ``matplotlib`` is imported inside the functions, with
the Agg backend, so the port imports on a machine without it.
"""

from __future__ import annotations

import numpy as np

from ..device import host_array

__all__ = ["plot_pdf", "plot_mass_pdfs", "plot_spin_pdfs", "plot_rate_of_z_pdfs", "plot_trace"]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pdf(x, pdf, label, color="blue", loglog=True, alpha=1.0):
    """The median of ``pdf`` (draws, grid) over ``x`` with its 5-95% band,
    on the current axes."""
    plt = _pyplot()
    x, pdf = host_array(x), host_array(pdf)
    med = np.median(pdf, axis=0)
    low = np.percentile(pdf, 5, axis=0)
    high = np.percentile(pdf, 95, axis=0)
    if loglog:
        plt.loglog(x, med, lw=2, color=color, label=label, alpha=alpha)
    else:
        plt.plot(x, med, lw=2, color=color, label=label, alpha=alpha)
    plt.fill_between(x, low, high, color=color, alpha=0.1)


def plot_mass_pdfs(mpdfs, qpdfs, m1, q, names, label, result_dir, save=True, colors=("red", "blue", "green")):
    """``{result_dir}/mass_pdf_{label}.png`` and
    ``mass_ratio_pdf_{label}.png``: one band per entry of ``names``."""
    plt = _pyplot()
    m1, q = host_array(m1), host_array(q)
    plt.figure(figsize=(15, 5))
    for i in range(len(mpdfs)):
        plot_pdf(m1, mpdfs[i], names[i], color=colors[i])
    plt.ylim(1e-5, 1e0)
    plt.xlabel("m1")
    plt.legend()
    plt.xlim(m1[0], m1[-1])
    if save:
        plt.savefig(result_dir + f"/mass_pdf_{label}.png", dpi=100)
    plt.close()

    plt.figure(figsize=(10, 7))
    for i in range(len(mpdfs)):
        plot_pdf(q, qpdfs[i], names[i], color=colors[i], loglog=False)
    plt.ylim(1e-2, 1e1)
    plt.yscale("log")
    plt.xlabel("q")
    plt.legend()
    plt.xlim(0, 1)
    if save:
        plt.savefig(result_dir + f"/mass_ratio_pdf_{label}.png", dpi=100)
    plt.close()


def plot_spin_pdfs(a_pdfs, tilt_pdfs, aa, cc, names, label, result_dir, save=True, colors=("red", "blue", "green"),
                   secondary=False):
    """``{result_dir}/spin_mag{1|2}_pdf_{label}.png`` and
    ``cos_tilt{1|2}_pdf_{label}.png`` (2 with ``secondary``)."""
    plt = _pyplot()
    comp = "2" if secondary else "1"
    plt.figure(figsize=(10, 7))
    for i in range(len(a_pdfs)):
        plot_pdf(aa, a_pdfs[i], names[i], loglog=False, color=colors[i])
    plt.ylim(0, 4)
    plt.xlabel(f"a{comp}")
    plt.legend()
    plt.xlim(0, 1)
    if save:
        plt.savefig(result_dir + f"/spin_mag{comp}_pdf_{label}.png", dpi=100)
    plt.close()

    plt.figure(figsize=(10, 7))
    for i in range(len(tilt_pdfs)):
        plot_pdf(cc, tilt_pdfs[i], names[i], loglog=False, color=colors[i])
    plt.ylim(0, 1.2)
    plt.xlabel(rf"cos$\theta${comp}")
    plt.legend()
    plt.xlim(-1, 1)
    if save:
        plt.savefig(result_dir + f"/cos_tilt{comp}_pdf_{label}.png", dpi=100)
    plt.close()


def plot_rate_of_z_pdfs(z_pdfs, z, label, result_dir, save=True):
    """``{result_dir}/redshift_pdf_{label}.png``: R(z) up to z = 1.5."""
    plt = _pyplot()
    z = host_array(z)
    plt.figure(figsize=(10, 7))
    plot_pdf(z, z_pdfs, "redshift")
    plt.xlabel("z")
    plt.ylabel("R(z)")
    plt.legend()
    plt.xlim(z[0], 1.5)
    plt.ylim(5, 1e3)
    if save:
        plt.savefig(result_dir + f"/redshift_pdf_{label}.png", dpi=100)
    plt.close()


def plot_trace(samples_by_chain, label="run", result_dir=".", save=True, max_params=30):
    """A marginal histogram and a trace per chain for each scalar site of
    ``samples_by_chain`` (``{site: (chains, draws)}``, at most
    ``max_params`` sites).  Saves ``{result_dir}/trace_{label}.png`` and
    returns its path, or returns the figure with ``save=False``; None when
    no site is scalar."""
    plt = _pyplot()
    arrays = {k: host_array(v) for k, v in samples_by_chain.items()}
    names = [k for k, v in arrays.items() if v.ndim == 2][:max_params]
    if not names:
        return None
    fig, axes = plt.subplots(len(names), 2, figsize=(10, 2.2 * len(names)), squeeze=False)
    for i, name in enumerate(names):
        for chain in arrays[name]:
            axes[i, 0].hist(chain, bins=40, histtype="step", density=True)
            axes[i, 1].plot(chain, lw=0.5, alpha=0.8)
        axes[i, 0].set_ylabel(name, fontsize=8)
        axes[i, 0].tick_params(labelsize=7)
        axes[i, 1].tick_params(labelsize=7)
    fig.tight_layout()
    if save:
        path = result_dir + f"/trace_{label}.png"
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path
    return fig
