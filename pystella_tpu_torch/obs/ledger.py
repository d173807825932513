"""The environment fingerprint of a run record.

The port's copy of ``environment_fingerprint``
(pystella_tpu/obs/ledger.py:130-155): everything needed to decide whether
two run records are comparable, reported for PyTorch on CUDA (the torch
version, the CUDA runtime it was built for, the device name and count)
where the JAX package reports jax, jaxlib, libtpu and the XLA flags. The
rest of the JAX module, ``PerfLedger`` and its report, waits for ROADMAP
queue 1 item 7.
"""

from __future__ import annotations

import os
import platform as _platform
import socket
import sys

__all__ = ["environment_fingerprint"]


def environment_fingerprint():
    """``{"python", "torch", "cuda", "hostname", "platform",
    "device_kind", "num_devices", "num_processes", "pystella_flags"}``:
    device fields from an already-imported torch (``None`` when torch is
    not loaded; ``platform`` is ``"gpu"`` or ``"cpu"``), the process count
    from an initialized ``torch.distributed`` group (else 1), and the
    ``PYSTELLA_HALO_OVERLAP`` setting, the one scheduling flag the port
    reads."""
    env = {
        "python": _platform.python_version(),
        "torch": None,
        "cuda": None,
        "hostname": socket.gethostname(),
        "platform": None,
        "device_kind": None,
        "num_devices": None,
        "num_processes": None,
        "pystella_flags": {},
    }
    setting = os.environ.get("PYSTELLA_HALO_OVERLAP")
    if setting is not None:
        env["pystella_flags"]["PYSTELLA_HALO_OVERLAP"] = setting
    torch = sys.modules.get("torch")
    if torch is None:
        return env
    try:
        env["torch"] = torch.__version__
        env["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            env["platform"] = "gpu"
            env["device_kind"] = torch.cuda.get_device_name(0)
            env["num_devices"] = torch.cuda.device_count()
        else:
            env["platform"] = "cpu"
            env["device_kind"] = "cpu"
            env["num_devices"] = 1
        dist = torch.distributed
        env["num_processes"] = (dist.get_world_size()
                                if dist.is_available()
                                and dist.is_initialized() else 1)
    except Exception:
        pass
    return env
