"""Training-grid tooling: standard and HDF5 readers, downsample and fragment.

Port of ``nmma_tpu/training/grids.py`` (the 'standard'/'hdf5' branches of
the reference's ``read_photometry_files``, nmma/em/io.py:378-454, and its
HDF5 ``Grid``, nmma/em/lightcurve_handling.py:486-531). Host code: tables
are read by the native loader (``native.py``; numpy without it), and
``h5py`` is imported only inside the HDF5 readers.
The bulla reader is ``training.svd.read_bulla_grid``.
"""

from __future__ import annotations

import os

import numpy as np

STANDARD_COLUMNS = ["t", "u", "g", "r", "i", "z", "y", "J", "H", "K",
                    "U", "B", "V", "R", "I"]

# survey column-name synonyms in published HDF5 grids (reference io.py:406-442)
HDF5_RENAMES = {
    "2MASS_J": "2massj", "2MASS_H": "2massh", "2MASS_Ks": "2massks",
    "SDSS_u": "sdssu", "ZTF_g": "ztfg", "ZTF_i": "ztfi", "ZTF_r": "ztfr",
    "atlas_c": "atlasc", "atlas_o": "atlaso",
    "ps_g": "ps1::g", "ps_r": "ps1::r", "ps_i": "ps1::i", "ps_z": "ps1::z",
    "ps_y": "ps1::y",
    "sU": "bessellux", "sB": "bessellb", "sV": "bessellv", "sR": "bessellr",
    "sI": "besselli",
    "uvot_b": "uvot::b", "uvot_u": "uvot::u", "uvot_v": "uvot::v",
    "uvot_uvm2": "uvot::uvm2", "uvot_uvw1": "uvot::uvw1",
    "uvot_uvw2": "uvot::uvw2", "uvot_white": "uvot::white",
    "time": "t",
}


def read_standard_grid_file(path):
    """10- or 15-column whitespace grid file -> {'t': ..., filt: ...}."""
    from ..native import parse_table
    arr = parse_table(path)
    cols = STANDARD_COLUMNS[:arr.shape[1]]
    return {c: arr[:, i] for i, c in enumerate(cols)}


def read_hdf5_grid(path, filters=None):
    """HDF5 grid, one group or table a grid point, survey column names ->
    {key: {'t': ..., filt: ...}} with names normalised via HDF5_RENAMES."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        for key in f.keys():
            table = f[key]
            names = (table.dtype.names if hasattr(table, "dtype")
                     and table.dtype.names else table.keys())
            entry = {HDF5_RENAMES.get(name, name): np.asarray(table[name])
                     for name in names}
            if filters is not None:
                entry = {k: v for k, v in entry.items()
                         if k == "t" or k in filters}
            out[key] = entry
    return out


class Grid:
    """HDF5 grid downsampling and fragmentation (reference Grid :486-531).
    Output goes under ``base_dirname``, relative to the working directory
    unless it is absolute."""

    def __init__(self, gridpath, base_dirname="lcs_grid",
                 base_filename="lcs", random_seed=21):
        import h5py
        self.path = os.path.abspath(gridpath)
        self.file = h5py.File(self.path, "r")
        self.keys = list(self.file.keys())
        self.base_dirname = base_dirname
        self.base_filename = base_filename
        self.rng = np.random.default_rng(random_seed)

    def close(self):
        """Release the HDF5 handle."""
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _setup(self, tag, shuffle):
        keys = self.keys.copy()
        if shuffle:
            self.rng.shuffle(keys)
            tag = f"shuffled_{tag}"
        dirname = os.path.join(self.base_dirname, tag)
        os.makedirs(dirname, exist_ok=True)
        return dirname, keys, tag

    def _save(self, keys, filename):
        import h5py
        with h5py.File(filename, "w") as new_file:
            for key in keys:
                new_file.copy(self.file[key], key)

    def downsample(self, factor=10, shuffle=False):
        save_dir, keys, tag = self._setup(f"downsampled_{factor}x", shuffle)
        out = os.path.join(save_dir, f"{self.base_filename}_{tag}.h5")
        self._save(keys[::factor], out)
        return out

    def fragment(self, factor=10, shuffle=False):
        save_dir, keys, tag = self._setup("fragmented", shuffle)
        outs = []
        for i, chunk in enumerate(np.array_split(keys, factor)):
            out = os.path.join(
                save_dir,
                f"{self.base_filename}_{tag}_{i + 1}_of_{factor}.h5")
            self._save(list(chunk), out)
            outs.append(out)
        return outs
