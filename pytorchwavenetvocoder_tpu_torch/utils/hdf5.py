"""HDF5 feature-file I/O.

Keeps the reference's on-disk contract (per-utterance ``.h5`` files holding
datasets like ``/world``, ``/melspc``, ``/mcep``; ``stats.h5`` holding
``/<ft>/mean`` and ``/<ft>/scale``): reference
``wavenet_vocoder/utils/utils.py:18-126``.  Semantics preserved:
``write_hdf5`` deletes and recreates an existing dataset on overwrite.

``h5py`` is imported inside each function, so a caller that never touches
an ``.h5`` file (``chip_smoke.py``, a decode fed from memory) does not
need it installed.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np


def check_hdf5(hdf5_name: str, hdf5_path: str) -> bool:
    """Return True iff ``hdf5_path`` dataset exists inside ``hdf5_name``."""
    import h5py

    if not os.path.exists(hdf5_name):
        return False
    with h5py.File(hdf5_name, "r") as f:
        return hdf5_path in f


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    """Read a dataset; hard-exits on missing file/dataset (reference behavior)."""
    import h5py

    if not os.path.exists(hdf5_name):
        logging.error("there is no such a hdf5 file. (%s)", hdf5_name)
        sys.exit(1)
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            logging.error("there is no such a data in hdf5 file. (%s in %s)",
                          hdf5_path, hdf5_name)
            sys.exit(1)
        return f[hdf5_path][()]


def shape_hdf5(hdf5_name: str, hdf5_path: str) -> tuple:
    """Return dataset shape without reading the data."""
    import h5py

    if not os.path.exists(hdf5_name):
        logging.error("there is no such a hdf5 file. (%s)", hdf5_name)
        sys.exit(1)
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            logging.error("there is no such a data in hdf5 file. (%s in %s)",
                          hdf5_path, hdf5_name)
            sys.exit(1)
        return tuple(f[hdf5_path].shape)


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data) -> None:
    """Write a dataset, replacing any existing one of the same name."""
    import h5py

    write_data = np.asarray(write_data)
    folder = os.path.dirname(hdf5_name)
    if folder and not os.path.exists(folder):
        os.makedirs(folder, exist_ok=True)
    with h5py.File(hdf5_name, "a") as f:
        if hdf5_path in f:
            del f[hdf5_path]
        f.create_dataset(hdf5_path, data=write_data)
