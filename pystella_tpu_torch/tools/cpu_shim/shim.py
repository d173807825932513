"""Build the port's CUDA sources with g++ behind a CPU stand-in for
the CUDA runtime (``include/``), and launch their kernels on CPU tensors
through the port's own launch code: a rehearsal of the kernels'
arithmetic where no card is at hand. Nothing here times anything or runs
on a card, and the port never imports it.

A source is rewritten before g++ sees it: the dynamic shared buffer
becomes the stand-in's per-thread buffer (filled with 0xff before each
block, so a read of an element no thread wrote shows as NaN),
``__shared__`` becomes ``static thread_local``, and every
``kernel<<<grid, block, smem, stream>>>(args)`` becomes ``pk_launch(grid,
block, smem, stream, lambda)``. With ``-ffp-contract=off`` the kernels
then round as the card's ``-fmad=false`` builds do. The port's package is
copied and its ``ops/fused.py``, ``ops/derivs.py``,
``ops/histogram.py`` and ``multigrid/relax.py`` patched so that their
card branches also take CPU tensors; everything is written under
``pystella_tpu_torch/ops/_build/cpu_shim/`` of the checkout.

Importing this module sets that up and exposes ``pt``, ``tfused``,
``tderivs``, ``thist`` and ``trelax`` (the patched package, its
``ops.fused``, ``ops.derivs``, ``ops.histogram`` and
``multigrid.relax``), :func:`build`, :func:`built` and
:func:`shim`.
"""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
CSRC = ROOT / "pystella_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "pystella_tpu_torch" / "ops" / "_build" / "cpu_shim"


def transform(text):
    """A CUDA source rewritten for g++ behind the stand-in."""
    text = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                  r"unsigned char* \1 = pk_dyn_smem;", text)
    text = text.replace("__shared__", "static thread_local")
    return re.sub(r"(\b[\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"pk_launch(\2, [&]() { \1(\3); });", text, flags=re.S)


#: g++'s flags; -fno-gnu-unique keeps each library's ``static
#: thread_local`` locals of a template (a kernel's static shared memory)
#: its own, where the loader would otherwise bind every loaded library's
#: copy of one instantiation to the first one's, whatever its size
GXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread", "-w", "-fno-gnu-unique"]


def build(csrc, source, header):
    """The shared library of ``source`` from the directory ``csrc`` with
    the model header ``header``, built once and kept by a hash of all
    three and the stand-in."""
    csrc = Path(csrc)
    texts = [(csrc / source).read_text(), (csrc / "pk_common.cuh").read_text()]
    key = hashlib.sha1("\0".join(
        [str(csrc), source, header] + texts + GXX_FLAGS
        + [(HERE / "include" / n).read_text()
           for n in ("cuda_runtime.h", "cuda_bf16.h")]).encode()
    ).hexdigest()[:16]
    out = OUT / "lib" / f"{source}-{key}"
    lib = out / "lib.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    (out / "src.cpp").write_text(transform(texts[0]))
    (out / "pk_common.cuh").write_text(transform(texts[1]))
    (out / "pk_model.cuh").write_text(header)
    cmd = ["g++"] + GXX_FLAGS + [f"-I{HERE / 'include'}", f"-I{out}",
                                 str(out / "src.cpp"), "-o",
                                 str(out / "tmp.so")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed for {source}:\n{r.stderr[-6000:]}")
    os.replace(out / "tmp.so", lib)
    return lib


def _package():
    """Copy the port's package and let the card branches of ops/fused.py,
    ops/derivs.py, ops/histogram.py and multigrid/relax.py take CPU
    tensors while :func:`shim` is on."""
    dst = OUT / "pkg" / "pystella_tpu_torch"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "pystella_tpu_torch", dst, ignore=(
        shutil.ignore_patterns("_build", "__pycache__", "tools")))
    flag = ("\nimport ctypes\n", "\nimport ctypes\n_SHIM = False\n")
    for name, subs in (
            ("fused.py", (flag, ('if dev.type == "cuda":',
                                 'if dev.type == "cuda" or _SHIM:'),
                          ('d.devices[0].type == "cuda"',
                           'd.devices[0].type in ("cuda", "cpu")'))),
            ("derivs.py", (flag, ('if win.device.type == "cuda":',
                                  'if win.device.type == "cuda" or _SHIM:'))),
            ("histogram.py", (flag, ('return types.pop() == "cuda"',
                                     'return types.pop() == "cuda" or _SHIM'))),
            ("../multigrid/relax.py", (
                flag, ('if dev.type == "cpu" or hz is not None:',
                       'if (dev.type == "cpu" and not _SHIM) '
                       'or hz is not None:'),
                ('if dev.type != "cuda":',
                 'if dev.type != "cuda" and not _SHIM:')))):
        path = dst / "ops" / name
        s = path.read_text()
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"ops/{name} no longer holds {a!r}")
            s = s.replace(a, b)
        path.write_text(s)
    return dst.parent


sys.path.insert(0, str(_package()))
import torch  # noqa: E402

torch.cuda.device = lambda d=None: contextlib.nullcontext()
torch.cuda.current_stream = lambda d=None: types.SimpleNamespace(
    cuda_stream=0)
torch.cuda.current_device = lambda: None
import pystella_tpu_torch as pt  # noqa: E402
from pystella_tpu_torch.multigrid import relax as trelax  # noqa: E402
from pystella_tpu_torch.ops import derivs as tderivs  # noqa: E402
from pystella_tpu_torch.ops import fused as tfused  # noqa: E402
from pystella_tpu_torch.ops import histogram as thist  # noqa: E402


def built(stepper, csrc=CSRC, defines=""):
    """Give a stepper made with ``device="cpu"`` the g++ libraries of the
    sources in ``csrc`` (another checkout's, for a comparison), its model
    header followed by ``defines``. The x-march tiles are held to
    ``march_tile`` and ``chunk_tile`` for this checkout's sources only."""
    def build_kernels(sources, header):
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = list(pool.map(
                lambda s: build(csrc, s, header + defines), sources))
        return {s: ctypes.CDLL(str(p)) for s, p in zip(sources, libs)}

    keep = tfused._stencil.build_kernels
    tfused._stencil.build_kernels = build_kernels
    if Path(csrc).resolve() != CSRC:
        stepper._march_sources = lambda: []
        stepper.chunk_kernel_tile = lambda dtype: tfused.chunk_tile(
            stepper.F, stepper.h, dtype.itemsize, stepper._chunk_depth)
    try:
        stepper.build_kernels()
    finally:
        tfused._stencil.build_kernels = keep
        vars(stepper).pop("_march_sources", None)
        vars(stepper).pop("chunk_kernel_tile", None)
    return stepper


@contextlib.contextmanager
def shim(on=True):
    """Within, a stepper's (a FiniteDifferencer's, a relaxation
    solver's) launches on CPU tensors run its built libraries instead of
    its plain versions."""
    tfused._SHIM = tderivs._SHIM = trelax._SHIM = thist._SHIM = on
    try:
        yield
    finally:
        tfused._SHIM = tderivs._SHIM = trelax._SHIM = thist._SHIM = False
