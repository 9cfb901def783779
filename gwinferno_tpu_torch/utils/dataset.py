"""A lightweight labeled-array container.

Counterpart of ``gwinferno_tpu/utils/dataset.py``: named dims, coords and
attrs, written to and read from the JAX package's HDF5 group layout (one
dataset per variable with a ``dims`` attribute, one ``_coord_{dim}`` dataset
per coordinate).  ``h5py`` is imported inside the readers and writers only,
so the port imports on a machine that has no ``h5py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataArray", "Dataset", "save_groups", "load_groups"]


class DataArray:
    """n-d array + dim names + per-dim coordinate arrays + attrs."""

    def __init__(self, data, dims, coords=None, attrs=None):
        self.data = np.asarray(data)
        self.dims = tuple(dims)
        if self.data.ndim != len(self.dims):
            raise ValueError(f"data of shape {self.data.shape} does not match dims {self.dims}")
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    def sel(self, **labels):
        """Select by coordinate label along named dims (exact match; a
        missing label raises ``KeyError``).  Each selected dim is dropped."""
        out = self.data
        dims = list(self.dims)
        for dim, label in labels.items():
            axis = dims.index(dim)
            idx = np.nonzero(np.asarray(self.coords[dim]) == label)[0]
            if len(idx) == 0:
                raise KeyError(f"label {label!r} not found in dim {dim!r}")
            out = np.take(out, idx[0], axis=axis)
            dims.pop(axis)
        return DataArray(out, dims, {d: self.coords[d] for d in dims if d in self.coords}, self.attrs)

    @property
    def shape(self):
        return self.data.shape

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)


class Dataset:
    """Dict of DataArrays + shared attrs."""

    def __init__(self, variables=None, attrs=None):
        self.variables = dict(variables or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, name):
        return self.variables[name]

    def __setitem__(self, name, value):
        self.variables[name] = value

    def __contains__(self, name):
        return name in self.variables

    def keys(self):
        return self.variables.keys()

    def to_hdf5(self, path_or_group, group=None):
        """Write to a file path (replacing it) or into an open h5py group,
        under ``group`` if given."""
        if isinstance(path_or_group, str):
            import h5py

            with h5py.File(path_or_group, "w") as f:
                self._write(f.create_group(group) if group else f)
        else:
            self._write(path_or_group.create_group(group) if group else path_or_group)

    def _write(self, g):
        for k, v in self.attrs.items():
            g.attrs[k] = v
        written_coords = set()
        for name, arr in self.variables.items():
            d = g.create_dataset(name, data=arr.data)
            d.attrs["dims"] = np.array([s.encode() for s in arr.dims])
            for k, v in arr.attrs.items():
                d.attrs[k] = v
            for dim, coord in arr.coords.items():
                if dim in written_coords:
                    continue
                coord = np.asarray(coord)
                if coord.dtype.kind in ("U", "S", "O"):
                    coord = np.array([str(c).encode() for c in coord])
                g.create_dataset(f"_coord_{dim}", data=coord)
                written_coords.add(dim)

    @classmethod
    def from_hdf5(cls, path, group=None):
        import h5py

        with h5py.File(path, "r") as f:
            return cls._read(f[group] if group else f)

    @classmethod
    def _read(cls, g):
        coords = {}
        for name in g:
            if name.startswith("_coord_"):
                vals = g[name][()]
                if vals.dtype.kind == "S":
                    vals = np.array([v.decode() for v in vals])
                coords[name[len("_coord_"):]] = vals
        data_vars = {}
        for name in g:
            if name.startswith("_coord_"):
                continue
            d = g[name]
            dims_attr = d.attrs.get("dims")
            if dims_attr is None:
                dims = tuple(f"dim{i}" for i in range(d.ndim))
            else:
                dims = tuple(s.decode() if isinstance(s, bytes) else str(s) for s in dims_attr)
            attrs = {k: v for k, v in d.attrs.items() if k != "dims"}
            data_vars[name] = DataArray(d[()], dims, {dim: coords[dim] for dim in dims if dim in coords}, attrs)
        return cls(data_vars, dict(g.attrs))


def save_groups(path, groups):
    """Write ``{group_name: Dataset}`` to one HDF5 file."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, ds in groups.items():
            ds.to_hdf5(f, group=name)


def load_groups(path):
    """Read all top-level groups of an HDF5 file as Datasets."""
    import h5py

    with h5py.File(path, "r") as f:
        return {name: Dataset._read(f[name]) for name in f if isinstance(f[name], h5py.Group)}
