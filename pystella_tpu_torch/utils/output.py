"""Provenance-rich HDF5 run output.

PyTorch counterpart of ``OutputFile`` in ``pystella_tpu/utils/output.py``:
an append-only HDF5 time-series file recording run provenance (device
info, hostname, the invoking script's own source, dependency versions)
plus appendable datasets created lazily on first output. ``h5py`` is
imported when a file is opened, never at import, so the package loads on
a machine without it (the GPU machine has none: there ``OutputFile`` is
for the host that has it). ``ShardedSnapshot`` waits for ROADMAP queue 1
item 6, with ``checkpoint.py``.
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np

__all__ = ["OutputFile"]


class OutputFile:
    """Appendable HDF5 output with run provenance.

    :arg context: unused (API parity with the reference's pyopencl context);
        device info comes from ``torch.cuda`` (or the CPU) instead.
    :arg name: output filename stem; defaults to ``"output"`` with a
        numeric suffix chosen to avoid collisions.
    :arg runfile: path to the invoking script, whose text is stored
        (defaults to ``sys.argv[0]``).
    :arg out_dir: directory the file (and the collision scan for the
        default name) lives in; created if missing. Defaults to the cwd.
        Ignored when ``name`` is already a path with a directory component.

    Any other keyword arguments are recorded as file attributes.
    """

    def __init__(self, context=None, name=None, runfile=None,
                 out_dir=None, **kwargs):
        import h5py

        if out_dir and not (name and os.path.dirname(name)):
            os.makedirs(out_dir, exist_ok=True)
        else:
            out_dir = None
        if name is None:
            i = 0
            while os.path.exists(os.path.join(out_dir or ".",
                                              f"output-{i}.h5")):
                i += 1
            name = f"output-{i}"
        filename = name if name.endswith(".h5") else name + ".h5"
        if out_dir:
            filename = os.path.join(out_dir, filename)
        self.filename = filename
        self.file = h5py.File(self.filename, "a")

        # run provenance
        import torch
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            self.file.attrs["device"] = ", ".join(
                torch.cuda.get_device_name(i) for i in range(min(n, 8)))
            self.file.attrs["platform"] = "gpu"
            self.file.attrs["num_devices"] = n
        else:
            self.file.attrs["device"] = "cpu"
            self.file.attrs["platform"] = "cpu"
            self.file.attrs["num_devices"] = 1
        self.file.attrs["hostname"] = socket.gethostname()

        for key, val in kwargs.items():
            try:
                self.file.attrs[key] = val
            except TypeError:
                self.file.attrs[key] = str(val)

        runfile = runfile if runfile is not None else (
            sys.argv[0] if sys.argv and os.path.exists(sys.argv[0]) else None)
        if runfile:
            try:
                with open(runfile) as f:
                    self.file.attrs["runfile"] = f.read()
            except OSError:
                pass

        for mod in ("torch", "numpy", "h5py"):
            self.file.attrs[f"{mod}_version"] = str(
                __import__(mod).__version__)

    def output(self, group, **kwargs):
        """Append one record per keyword to (lazily created) resizable
        datasets under ``group``."""
        if group not in self.file:
            grp = self.file.create_group(group)
        else:
            grp = self.file[group]

        for key, val in kwargs.items():
            arr = np.asarray(val)
            if key not in grp:
                grp.create_dataset(key, shape=(0,) + arr.shape,
                                   maxshape=(None,) + arr.shape,
                                   dtype=arr.dtype)
            dset = grp[key]
            dset.resize(dset.shape[0] + 1, axis=0)
            dset[-1] = arr

    def close(self):
        if self.file:  # an h5py File is falsy once closed; idempotent
            self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
