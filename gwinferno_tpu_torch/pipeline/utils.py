"""Loading the PE + injection catalog.

Counterpart of ``gwinferno_tpu/pipeline/utils.py::load_pe_and_injections_as_dict``.
The loader returns host numpy dicts; :func:`to_tensors` moves them to the
asked device once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.dataset import load_groups

__all__ = ["load_pe_and_injections_as_dict", "to_tensors"]


def load_pe_and_injections_as_dict(file, ignore=None):
    """Load the PE + injection catalog.

    Returns ``(pedict {param: (N_obs, N_samp)}, injdict {param: (N_found,)},
    constants {total_inj, obs_time, nObs}, param_names)``, all host numpy.
    """
    groups = load_groups(file)
    pe, inj = groups["pe_data"], groups["inj_data"]

    pe_arr = pe["posteriors"]
    params = [str(p) for p in pe_arr.coords["param"]]
    events = np.asarray(pe_arr.coords["event"])
    sel = ~np.isin(events, np.asarray(ignore)) if ignore is not None else np.ones(len(events), dtype=bool)
    p_axis = pe_arr.dims.index("param")
    pedict = {
        k: np.ascontiguousarray(np.take(pe_arr.data[sel], i, axis=p_axis)) for i, k in enumerate(params)
    }

    inj_arr = inj["injections"]
    inj_params = [str(p) for p in inj_arr.coords["param"]]
    injdict = {k: np.ascontiguousarray(inj_arr.data[i]) for i, k in enumerate(inj_params)}

    attrs = dict(inj_arr.attrs) or dict(inj.attrs)
    constants = {
        "total_inj": float(attrs["total_generated"]),
        "obs_time": float(attrs["analysis_time"]),
        "nObs": int(sel.sum()),
    }
    return pedict, injdict, constants, params


def to_tensors(arrays, device=None, dtype=torch.float32):
    """``{name: numpy array}`` -> ``{name: tensor}`` on ``device`` (CUDA
    unless asked otherwise) in ``dtype``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=dev) for k, v in arrays.items()}
