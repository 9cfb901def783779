"""Plots of a run.

Counterpart of ``plot_trace`` in ``gwinferno_tpu/postprocess/plot.py`` (the
other plotters are not ported yet).  ``matplotlib`` is imported inside the
function, with the Agg backend, so the port imports on a machine without it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_trace"]


def plot_trace(samples_by_chain, label="run", result_dir=".", save=True, max_params=30):
    """A marginal histogram and a trace per chain for each scalar site of
    ``samples_by_chain`` (``{site: (chains, draws)}``, at most
    ``max_params`` sites).  Saves ``{result_dir}/trace_{label}.png`` and
    returns its path, or returns the figure with ``save=False``; None when
    no site is scalar."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for k, v in samples_by_chain.items()}
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
