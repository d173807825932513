"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the GPU
(``"cuda"``): the port is written for the card, and a CPU run is only ever
what the caller asked for (``device="cpu"``, as the tests do). Nothing here
falls back to the CPU on its own.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The :class:`torch.device` an entry point runs on.

    :arg device: ``None`` (the default GPU), a string or a
        :class:`torch.device`.
    :raises RuntimeError: when a CUDA device is asked for (explicitly or by
        default) and PyTorch sees none.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pystella_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:  # the index tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_NUMPY_TO_TORCH = {
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """Normalize a numpy or torch floating or complex dtype to a
    :class:`torch.dtype` (complex64 and complex128: the k-space arrays of
    :mod:`~pystella_tpu_torch.fourier`).

    bfloat16 is recognized by name: numpy has no bfloat16 of its own, and
    the one a JAX array converts to (``np.asarray`` of a bf16 array)
    comes from a package the port does not import."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        npd = np.dtype(dtype)
    except TypeError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None
    if npd.name == "bfloat16":
        return torch.bfloat16
    try:
        return _NUMPY_TO_TORCH[npd]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None
