"""Fused Runge-Kutta stages for Klein-Gordon-form systems, on CUDA.

PyTorch counterpart of ``FusedScalarStepper`` and ``FusedPreheatStepper``
of ``pystella_tpu/ops/fused.py``, in the parts that the 2-field preheating
hot loop, the energy-coupled science driver and the gravitational-wave
system run. A stage of ``f'' = lap f - 2 H f' - a^2 dV/df`` under a
low-storage (2N) Runge-Kutta tableau is one kernel: each site reads f (with
its stencil neighbours), dfdt, kf and kdfdt once, computes the Laplacian,
the right-hand side with the model's ``dV/df`` (printed into the kernel
source by :mod:`~pystella_tpu_torch.ops.codegen`) and the 2N update, and
writes the four new arrays. :class:`FusedPreheatStepper` adds the tensor
perturbations ``h_ij'' = lap h_ij - 2 H h_ij' + 16 pi S_ij`` to the same
kernel, ``S_ij`` printed from the gradients of the same f window.

Hand-written CUDA kernels (``ops/csrc``):

- ``fused_stage`` (K2): one stage (an x-march, the tile K5 shares:
  :func:`march_tile` with ``nh=0, values=1``);
- ``fused_pair`` (K3): two consecutive stages in one pass, the second
  stage's Laplacian recomposed from the raw taps. :meth:`multi_step` pairs
  stages across step boundaries (legal when ``A[0] == 0``), so RK54 runs
  5 pair launches per 2 steps and no single stage at all;
- ``fused_chunk`` (K10): ``chunk_stages`` (4) consecutive stages in one
  pass, an x-march in two levels of shared-memory plane rings (stages 1-2,
  then 3-4); :meth:`multi_step`
  runs chunks first, then pairs, then a single stage, across step
  boundaries;
- ``fused_stage_energy`` (K5): K2 that also emits the energy sums of its
  entry state, for :meth:`coupled_multi_step` (an x-march: :func:`
  march_tile` with ``nh=0, values=1``);
- ``coupled_pair`` / ``coupled_pair_deferred`` (K6): the deferred-drag
  stage pair of :meth:`coupled_multi_step`, which emits both stages' energy
  sums and leaves the second stage's Hubble drag to the next launch;
- ``preheat_stage`` (K7), ``preheat_pair`` (K8), ``preheat_stage_energy``
  (K5') and ``preheat_coupled_pair`` / ``preheat_coupled_pair_deferred``
  (K9): the same five for the scalar + gravitational-wave system, a
  template flag on each scalar kernel that adds the tensor stages after the
  scalar ones (K7 and K5', like the pairs, an x-march: :func:`march_tile`
  with ``values=1``; K5', K7, K5 and K2 one template).

Every kernel also comes with ``carry_dtype=torch.bfloat16``: the same kernel
storing the k-carries in bfloat16 (widened on load, rounded on store, the
energy sums taken from the widened values), counted as ``<name>:bf16``.

With ``decomp=`` (a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`
of an ``(px, py, 1)`` mesh) both steppers step
:class:`~pystella_tpu_torch.parallel.ShardedArray` states: per launch the
window inputs (those the JAX package pads, :data:`_WINDOWS`) are exchanged
on a side CUDA stream into persistent padded buffers, one launch per block
reads them (``<kernel>:xpad`` / ``:ypad`` / ``:xypad``: the JAX package's
halo-input kernel), or, for a kernel without sums on an x-only mesh with
the overlap on, an interior launch per block on the raw block runs while
the x slabs are copied, then two shell launches per block (``:interior``,
``:shell``: ``OverlapStreamingStencil``). Every sharded launch equals the
unsharded kernel on the whole lattice bit for bit. A sum kernel's blocks
write their partial sums where the whole lattice's launch puts them, and
one second launch after every shard's reduces them, so its sums are the
unsharded kernel's too (:meth:`~FusedScalarStepper.sum_order`). A sharded
:meth:`~FusedScalarStepper.multi_step` or
:meth:`~FusedScalarStepper.coupled_multi_step` on one card therefore equals
the single-device one. The sharded tier also comes with bfloat16 carries
(``<kernel>:bf16:<kind>``, and ``<kernel>:bf16_fin:<kind>`` for the energy
stages on finalized carries): the carry windows are exchanged in bfloat16,
so they move half the bytes.

Beside each kernel sits its plain PyTorch version (``_scalar_body``,
``_scalar_pair_core``, ``_chunk_body``, ``_esums``, ``_deferred_pair_core``;
for the GW system ``_preheat_body``, ``_pair_body``, ``_deferred_body``), the
same per-site arithmetic in the same order on
:class:`~pystella_tpu_torch.ops.stencil.RollTaps`. A launch wrapper runs
the kernel for CUDA tensors and the plain version for CPU tensors; it
never substitutes one for the other. Kernel and plain version agree to
rounding: PyTorch's CUDA division by a scalar multiplies by the reciprocal
(one rounding more than the kernel's division), which the model's
``dV/df`` can reach, and the lattice sums add in another order; everything
else is op-for-op identical.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from pystella_tpu_torch import config as _config
from pystella_tpu_torch import field as _field
from pystella_tpu_torch import step as _step
from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import metrics as _metrics
from pystella_tpu_torch.ops import codegen as _codegen
from pystella_tpu_torch.ops import stencil as _stencil
from torch.profiler import record_function

from pystella_tpu_torch.models.sectors import tensor_index
from pystella_tpu_torch.ops.derivs import _grad_coefs, _lap_coefs, PAD_KINDS
from pystella_tpu_torch.parallel import overlap as _overlap
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["FusedScalarStepper", "FusedPreheatStepper", "LAUNCHES",
           "reset_launch_counts", "KERNELS", "SHARDED_KERNELS", "SUM_SETS",
           "march_tile"]

#: kernel name -> (CUDA source in ops/csrc, the Pallas body it replaces)
KERNELS = {
    "fused_stage": ("fused_stage.cu",
                    "pystella_tpu/ops/fused.py:549 (_scalar_body)"),
    "fused_pair": ("fused_pair.cu",
                   "pystella_tpu/ops/fused.py:920 (_scalar_pair_core)"),
    "fused_chunk": ("fused_chunk.cu",
                    "pystella_tpu/ops/fused.py:699 (_chunk_body + "
                    "_compose_scalar_stage :679, _lap_at :663, _memo_taps "
                    ":642)"),
    "fused_stage_energy": (
        "fused_stage.cu",
        "pystella_tpu/ops/fused.py:995 (_ensure_energy_call: "
        "_scalar_body(energy=True) + _esums)"),
    "coupled_pair": (
        "fused_coupled_pair.cu",
        "pystella_tpu/ops/fused.py:1321 (_deferred_pair_core, "
        "normal input)"),
    "coupled_pair_deferred": (
        "fused_coupled_pair.cu",
        "pystella_tpu/ops/fused.py:1321 (_deferred_pair_core + "
        "_completed_taps, deferred input)"),
    "preheat_stage": (
        "fused_stage.cu",
        "pystella_tpu/ops/fused.py:1746 (FusedPreheatStepper._preheat_body "
        "+ _gw_stage :1720, _sij_eval :1732)"),
    "preheat_pair": (
        "fused_pair.cu",
        "pystella_tpu/ops/fused.py:1771 (FusedPreheatStepper._pair_body)"),
    "preheat_stage_energy": (
        "fused_stage.cu",
        "pystella_tpu/ops/fused.py:1932 (FusedPreheatStepper."
        "_ensure_energy_call: _preheat_body(energy=True))"),
    "preheat_coupled_pair": (
        "fused_coupled_pair.cu",
        "pystella_tpu/ops/fused.py:1891 (FusedPreheatStepper._deferred_body, "
        "normal input)"),
    "preheat_coupled_pair_deferred": (
        "fused_coupled_pair.cu",
        "pystella_tpu/ops/fused.py:1891 (FusedPreheatStepper._deferred_body, "
        "deferred input)"),
}

#: kernel name -> number of (2F+1,) energy-sum vectors it emits
SUM_SETS = {"fused_stage": 0, "fused_pair": 0, "fused_chunk": 0,
            "fused_stage_energy": 1,
            "coupled_pair": 2, "coupled_pair_deferred": 2,
            "preheat_stage": 0, "preheat_pair": 0, "preheat_stage_energy": 1,
            "preheat_coupled_pair": 2, "preheat_coupled_pair_deferred": 2}

#: the kernels that need a model whose V and dV/df (and S_ij) do not read
#: hubble
_COUPLED = ("coupled_pair", "coupled_pair_deferred", "preheat_coupled_pair",
            "preheat_coupled_pair_deferred")

#: kernel name -> its scalars, in the order the C entry point takes them
#: (the Laplacian weights follow them; for the GW kernels, then the
#: gradient weights)
_STAGE_PARAMS = ("dt", "a", "hubble", "A", "B")
_COUPLED_PARAMS = ("dt", "a1", "hubble1", "A1", "B1", "a2", "A2", "B2")
_PARAMS = {
    "fused_stage": _STAGE_PARAMS,
    "fused_stage_energy": _STAGE_PARAMS,
    "fused_pair": ("dt", "a1", "hubble1", "A1", "B1",
                   "a2", "hubble2", "A2", "B2"),
    "coupled_pair": _COUPLED_PARAMS,
    "coupled_pair_deferred": _COUPLED_PARAMS + ("hubfix", "B2p"),
}
#: the chunk depths fused_chunk.cu instantiates
CHUNK_DEPTHS = (4,)
_PARAMS["fused_chunk"] = ("dt",) + tuple(
    f"{n}{i}" for i in range(1, CHUNK_DEPTHS[0] + 1)
    for n in ("a", "hubble", "A", "B"))
#: the GW kernels take their scalar counterparts' scalars
_GW_OF = {"preheat_stage": "fused_stage", "preheat_pair": "fused_pair",
          "preheat_stage_energy": "fused_stage_energy",
          "preheat_coupled_pair": "coupled_pair",
          "preheat_coupled_pair_deferred": "coupled_pair_deferred"}
_PARAMS.update({gw: _PARAMS[sc] for gw, sc in _GW_OF.items()})

#: every kernel also comes with bfloat16 carries; a launch of that variant
#: counts under ``name + BF16``
BF16 = ":bf16"
#: the energy stages, which with bfloat16 carries also come in a variant
#: (``_bf16_fin``, counted as ``<name>:bf16_fin``) that reads the velocity
#: carries in the working dtype: the coupled driver's odd trailing stage,
#: after the finalize that completed the last pair's deferred drag (see
#: ``_finalize_deferred``)
_FINALIZED = ("fused_stage_energy", "preheat_stage_energy")
FIN = "_fin"

#: the kernels of the sharded tier and, per kernel, which of its lattice
#: inputs (in launch order) are windows, read with a halo and so padded on a
#: sharded mesh: the windows the JAX package's ``_make_call`` pads
#: (pystella_tpu/ops/fused.py:426-456, the coupled pairs' ``_def_win_defs``
#: :1272 and :1847, the GW kernels' :1700-1771, :1932). The others, and the
#: outputs, are read and written at the site only.
_WINDOWS = {"fused_stage": (0,), "fused_pair": (0, 1, 2),
            "fused_stage_energy": (0,),
            "coupled_pair": (0, 1, 2), "coupled_pair_deferred": (0, 1, 2, 3),
            "preheat_stage": (0, 4), "preheat_pair": (0, 1, 2, 4, 5, 6),
            "preheat_stage_energy": (0, 4),
            "preheat_coupled_pair": (0, 1, 2, 4, 5, 6),
            "preheat_coupled_pair_deferred": tuple(range(8))}
#: the launch kinds of the overlapped path; a kernel with sums never takes
#: them (the JAX package's rule, pystella_tpu/ops/fused.py:493-496: the
#: split would change the sums' order), so it runs padded on every mesh
_OVERLAP_KINDS = ("interior", "shell")
#: sharded kernel name (``<kernel>[:bf16[_fin]]:<kind>``, ``kind`` in
#: :data:`~pystella_tpu_torch.ops.derivs.PAD_KINDS`; ``:bf16`` with bfloat16
#: carries, ``:bf16_fin`` the energy stages on finalized carries) -> (CUDA
#: source, the TPU kernel it replaces)
SHARDED_KERNELS = {
    f"{name}{variant}:{kind}": (KERNELS[name][0], (
        "pystella_tpu/ops/pallas_stencil.py:993 (OverlapStreamingStencil."
        "__call__, class :931" if kind in _OVERLAP_KINDS else
        "pystella_tpu/ops/pallas_stencil.py:789 (StreamingStencil."
        "_build_xhalo, call :840") + f"; body {KERNELS[name][1]}" + (
        "; carries under _quantize_carries pystella_tpu/ops/fused.py:76"
        if variant else "") + ")")
    for name in _WINDOWS
    for variant in ("", BF16) + ((BF16 + FIN,) if name in _FINALIZED
                                 else ())
    for kind in PAD_KINDS
    if not (SUM_SETS[name] and kind in _OVERLAP_KINDS)}
#: the threads of a kernel block along y (pk_common.cuh: PK_BLOCK_Y): a
#: sharded sum launch lands its partials at their whole-lattice places when
#: every shard's y blocks are the lattice's
_BLOCK_Y = 8
#: the entry point of each padding (interior and shell: the x-padded one)
_PAD_SUFFIX = {1: "_xpad", 2: "_ypad", 3: "_xypad"}

#: kernel name (and ``<name>:bf16``, and the sharded ``<name>:<kind>``,
#: ``<name>:bf16:<kind>``) ->
#: number of launches since the last reset; each wrapper adds one where it
#: launches its kernel, and nowhere else
LAUNCHES = {name: 0 for name in
            list(KERNELS) + [n + BF16 for n in KERNELS]
            + [n + BF16 + FIN for n in _FINALIZED] + list(SHARDED_KERNELS)}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: the most dynamic shared memory a block may use on sm_90
_SMEM_MAX = 232448
#: the chunk kernel's x-march (fused_chunk.cu: PkChunkMarch): the x planes a
#: block marches (PK_CHUNK_LX), the rows of its first y-z tile
#: (PK_CHUNK_ROWS, 32 columns) and the lower rungs of its ladder of tiles
#: (rows, columns), in order of preference
CHUNK_LX = 64
CHUNK_ROWS = 8
_CHUNK_RUNGS = ((4, 32), (8, 16), (4, 16), (2, 16), (2, 8), (1, 8), (2, 4))


def chunk_tile(F, h, itemsize, depth, lx=None, rows=None):
    """The chunk kernel's x-march for ``F`` fields, stencil radius ``h``, a
    working type of ``itemsize`` bytes and ``depth`` stages: ``((lx, rows,
    columns), bytes)`` -- the x planes a block marches, its y-z tile and
    the dynamic shared memory a block -- or ``None`` when no kernel of
    that depth exists or no tile fits. ``lx`` and ``rows`` (the first
    rung's) default to the source's constants. The rule of fused_chunk.cu:
    the first tile of the ladder whose planes fit the most a block may
    use, where per field f and f1 keep a ring of 2h+1 planes of the tile
    grown by ``h`` and the centre plane grown by ``2h`` (level 0), f2 and
    f3 a ring of 2h+1 planes of the tile grown by ``h`` (level 1), and
    dfdt2, kf2 and kdfdt2 a ring of h+1 planes of the tile."""
    if depth not in CHUNK_DEPTHS:
        return None
    rungs = ((CHUNK_ROWS if rows is None else rows, 32),) + _CHUNK_RUNGS
    for ty, tz in rungs:
        g1 = (ty + 2 * h) * (tz + 2 * h)
        g2 = (ty + 4 * h) * (tz + 4 * h)
        nbytes = itemsize * F * (2 * (2 * (2 * h + 1) * g1 + g2)
                                 + 3 * (h + 1) * ty * tz)
        if nbytes <= _SMEM_MAX:
            return (CHUNK_LX if lx is None else lx, ty, tz), nbytes
    return None


#: the x-march of the pair kernels and of the single stages that march
#: (pk_common.cuh: PkMarchTile): the x planes a block of the GW pairs K8, K9
#: marches (PK_MARCH_LX), those of the scalar pairs K3, K6
#: (PK_SCALAR_MARCH_LX), those of K5' and K7 (PK_STAGE_MARCH_LX) and those
#: of K5 and K2 (PK_SCALAR_STAGE_MARCH_LX); a tile is 32 z columns by 8 y
#: rows
MARCH_LX = 32
SCALAR_MARCH_LX = 24
STAGE_MARCH_LX = 16
SCALAR_STAGE_MARCH_LX = 32


def march_tile(F, h, itemsize, nh=6, lx=None, values=2):
    """The x-march tile of the pair kernels for ``F`` fields, ``nh``
    tensor components (6: the GW pairs; 0: the scalar pairs), stencil
    radius ``h`` and a working type of ``itemsize`` bytes -- or, with
    ``values=1``, of the single stages (K5' and K7 with ``nh``
    components, K5 and K2 with none), which hold one array per tapped
    value (f, h) where a pair holds two (f and f1, h and h1):
    ``((lx, gf, g, joint), bytes)`` -- the x planes a block marches, the
    fields a scalar pass holds, the tensor components a pass holds, the
    layout (1 joint, 0 split) and the dynamic shared memory a block.
    ``lx`` defaults to the sources' constant. The rule of pk_common.cuh:
    each tapped array keeps the tile's centre plane with its y-z halo and
    a ring of 2h+1 planes of the tile, in dynamic shared memory, and what
    is left of the most a block may use must hold K6's or K9's static
    per-warp partials of one plane's 2 (2F + 1) sum terms. Joint: every
    pass holds all ``F`` fields and ``g`` components, ``g`` the first of
    ``nh``, 3, 2, 1 that divides ``nh`` and fits (``nh = 0``: one pass,
    where every field fits). Split, where no ``g`` fits beside the fields:
    scalar passes of the most fields that fit (``gf``), then tensor passes
    of the first ``g`` that fits alone."""
    if lx is None:
        lx = ((STAGE_MARCH_LX if nh else SCALAR_STAGE_MARCH_LX)
              if values == 1 else MARCH_LX if nh else SCALAR_MARCH_LX)
    v = values
    sites = (8 + 2 * h) * (32 + 2 * h) + (2 * h + 1) * 8 * 32
    sums = 2 * (2 * F + 1) * 8

    def fits(arrays):
        return (arrays * sites + sums) * itemsize <= _SMEM_MAX

    def tensors(arrays):
        return next((g for g in (nh, 3, 2, 1)
                     if 0 < g <= nh and nh % g == 0
                     and fits(arrays + v * g)), 0)

    g = tensors(v * F)
    if g or (not nh and fits(v * F)):
        gf, joint, arrays = F, 1, v * F + v * g
    else:
        gf = max(k for k in range(1, F + 1) if fits(v * k))
        g, joint = tensors(0), 0
        arrays = v * max(gf, g)
    return (lx, gf, g, joint), arrays * sites * itemsize


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _float(v):
    return float(v.item() if isinstance(v, torch.Tensor) else v)


class FusedScalarStepper(_step.Stepper):
    """One-kernel-per-stage low-storage RK for a
    :class:`~pystella_tpu_torch.models.sectors.ScalarSector` on one device.

    :arg sector: the :class:`ScalarSector`; its potential is differentiated
        symbolically and printed into the kernels.
    :arg grid_shape: the lattice shape ``(X, Y, Z)``; any shape runs.
    :arg dx: lattice spacing (scalar or 3-tuple).
    :arg halo_shape: stencil radius ``h`` (1..4).
    :arg tableau: a :class:`~pystella_tpu_torch.step.LowStorageRKStepper`
        subclass providing ``_A``/``_B``/``_C``; default ``LowStorageRK54``.
    :arg dtype: ``torch.float32`` or ``torch.float64``.
    :arg pair_stages: when True (default) :meth:`step`, :meth:`multi_step`
        and :meth:`coupled_multi_step` fuse consecutive stage pairs into one
        kernel; :meth:`stage` always runs the single-stage kernel.
    :arg carry_dtype: ``None`` (default: the k-carries in ``dtype``) or
        ``torch.bfloat16``: the 2N-storage k arrays are stored in bfloat16
        while every kernel computes in ``dtype`` (carries widen on load and
        round to nearest even on store) -- the JAX package's memory flag for
        the 512^3 GW system, at an accuracy cost bounded by the carry
        quantization. Every entry point takes it: :meth:`step`,
        :meth:`multi_step`, :meth:`coupled_multi_step`, the per-stage calls
        and :class:`FusedPreheatStepper`'s.
    :arg chunk_stages: whole-RK-chunk depth: an even number >= 4 of
        consecutive stages advanced by one kernel (K10), which
        :meth:`step` and :meth:`multi_step` dispatch first, then pairs,
        then single stages. ``None`` (default) reads
        ``PYSTELLA_CHUNK_STAGES`` (:mod:`~pystella_tpu_torch.config`); ``0``
        keeps the pair tier. A stepper without a chunk body
        (:class:`FusedPreheatStepper`), a tableau with ``A[0] != 0`` and a
        depth beyond its stages, a depth the kernel is not instantiated for
        (:data:`CHUNK_DEPTHS`) or a model whose shared-memory planes fit
        no tile (:func:`chunk_tile`) warns and runs pairs instead, on the CPU
        as on the GPU.
    :arg device: ``None`` (the GPU), ``"cuda"`` or ``"cpu"``. On a CUDA
        device the kernels are built here (first use; cached on disk).
    :arg decomp: a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`
        of an ``(px, py, 1)`` mesh: the states are then dicts of
        :class:`~pystella_tpu_torch.parallel.ShardedArray` s (see
        :func:`~pystella_tpu_torch.convert.shard_state`), and the stepper
        runs on the decomposition's devices. :meth:`stage`,
        :meth:`stage_pair`, :meth:`step`, :meth:`multi_step`,
        :meth:`multi_step_fn` and :meth:`coupled_multi_step` take them; a
        chunk request runs pairs (the JAX package's rule: a chunk's windows
        would need wider halos); ``carry_dtype`` works there too, the carry
        windows exchanged in bfloat16.
    :arg overlap: on an x-only mesh, split every launch into an interior
        launch that runs while the halos are copied and two x-shell
        launches (:func:`~pystella_tpu_torch.parallel.overlap.enabled`:
        ``None`` reads ``PYSTELLA_HALO_OVERLAP``, auto on for sharded
        meshes); bit-exact with the padded launch, which runs where no
        split exists (a y-sharded mesh, a block thinner than ``3h``) and
        for the kernels with sums.

    States are dicts ``{"f": (F, X, Y, Z), "dfdt": (F, X, Y, Z)}``. A stencil
    cannot write its own input, so every launch writes into one of two
    preallocated sets of arrays (the other set, or the caller's arrays,
    being its input). The tensors a call returns are therefore the
    stepper's own buffers, overwritten by the call after next at the
    latest -- clone what must outlive it (the JAX package's ``multi_step``
    donates its input for the same reason).
    """

    #: the kernel each role runs
    _KERNEL = {"stage": "fused_stage", "pair": "fused_pair",
               "chunk": "fused_chunk",
               "stage_energy": "fused_stage_energy",
               "coupled_pair": "coupled_pair",
               "coupled_pair_deferred": "coupled_pair_deferred"}
    #: (field, velocity) state names of each system a kernel updates; a
    #: launch takes, per system, the field, velocity and their two k-carries
    _SYSTEMS = (("f", "dfdt"),)
    #: the anisotropic-stress expressions printed into the kernels (none)
    _sij_exprs = None
    #: whether the stepper has a whole-RK-chunk body (the GW stepper does
    #: not, as in the JAX package: a chunk request there runs pairs)
    _chunk_supported = True

    def __init__(self, sector, grid_shape, dx, halo_shape=2, tableau=None,
                 dtype=torch.float32, dt=None, pair_stages=True,
                 carry_dtype=None, chunk_stages=None, device=None,
                 decomp=None, overlap=None):
        self.decomp = decomp
        if decomp is not None:
            if decomp.proc_shape[2] != 1:
                raise NotImplementedError(
                    "fused steppers support x/y sharding (proc_shape "
                    "(px, py, 1)); the z axis is the VMEM lane dimension "
                    "(kept whole per device) -- use the generic LowStorageRK "
                    "steppers with FiniteDifferencer for z-sharded meshes "
                    "(pystella_tpu.advise_shapes lists which meshes keep "
                    "the fused tier available)")
            types = {d.type for d in decomp.devices}
            if len(types) != 1 or (device is not None and torch.device(
                    device).type not in types):
                raise ValueError(f"the decomposition's devices "
                                 f"{decomp.devices} are not all of one type"
                                 f"{'' if device is None else ' ' + str(device)}")
            device = decomp.devices[0]
        self.device = resolve_device(device)
        self._overlap = _overlap.enabled(decomp, override=overlap)
        tableau = tableau or _step.LowStorageRK54
        self._A = tableau._A
        self._B = tableau._B
        self._C = tableau._C
        self.num_stages = tableau.num_stages
        self.expected_order = tableau.expected_order
        self.dt = dt
        self.sector = sector
        self.grid_shape = tuple(int(n) for n in grid_shape)
        if len(self.grid_shape) != 3:
            raise ValueError("grid_shape must have three axes")
        #: the lattice of one block (the whole lattice when unsharded)
        self.local_shape = (self.grid_shape if decomp is None
                            else decomp.rank_shape(self.grid_shape))
        if np.isscalar(dx):
            dx = (dx,) * 3
        self.dx = tuple(float(d) for d in dx)
        self.h = int(halo_shape)
        if self.h not in _lap_coefs:
            raise ValueError(f"halo_shape must be one of {sorted(_lap_coefs)}")
        self.dtype = torch_dtype(dtype)
        if self.dtype not in _SUFFIX:
            raise TypeError("the fused kernels take float32 or float64")
        cd = None if carry_dtype is None else torch_dtype(carry_dtype)
        if cd not in (None, self.dtype, torch.bfloat16):
            raise TypeError("carry_dtype must be None, the working dtype or "
                            f"torch.bfloat16; got {carry_dtype!r}")
        #: the k-carries' storage dtype when it differs from ``dtype``
        self.carry_dtype = None if cd == self.dtype else cd

        F = sector.nscalars
        self.F = F
        f = sector.f
        self._V = sector.potential(f)
        self._dvdf = [_field.diff(self._V, f[i]) for i in range(F)]
        self._pair_stages = bool(pair_stages) and self.num_stages >= 2

        inv_dx2 = [1.0 / d**2 for d in self.dx]
        coefs = _lap_coefs[self.h]
        # the Laplacian weights exactly as lap_from_taps forms them
        self._lap_weights = (
            [coefs[0] * sum(inv_dx2)]
            + [coefs[s] * inv_dx2[ax] for ax in range(3)
               for s in range(1, self.h + 1)])
        #: the weights a launch passes after its scalars
        self._weights = list(self._lap_weights)
        #: component count and dtype of each array a kernel reads (and
        #: writes): per system field, velocity and their two carries
        self._comps = (F,) * 4
        self._dtypes = (self.dtype,) * 2 + (self.carry_dtype
                                            or self.dtype,) * 2

        if chunk_stages is None:
            chunk_stages = _config.get_int("PYSTELLA_CHUNK_STAGES")
        depth = int(chunk_stages or 0)
        if depth and (depth % 2 or depth < 4):
            raise ValueError(
                f"chunk_stages must be an even number >= 4 (got {depth}); "
                "depth 2 is the pair tier (pair_stages=True)")
        #: the chunk depth multi_step dispatches (0: no chunk kernel)
        self._chunk_depth = 0
        #: entry points whose kernel_tier event was emitted
        self._tier_emitted = set()
        self._maybe_build_chunk(depth)

        self._buffers = None  # two sets of arrays, made at first use
        # the sharded tier's persistent exchange buffers, per window slot
        # (_WINDOWS), dtype and block: padded windows, or the x shells'
        # inputs
        self._pad_bufs = {}
        self._shell_bufs = {}
        # the velocity carries a sharded finalize completes, in the working
        # dtype (bfloat16 carries only; _finalize_deferred)
        self._fin_carries = {}
        self._partials = {}  # the sum kernels' partials, per device
        self._libs = None
        self._built = None  # {source: the loaded library}
        self._num_blocks = None
        if self.device.type == "cuda":
            self.build_kernels()

    # -- kernels -------------------------------------------------------------

    @property
    def _hubble_free(self):
        """True when V and every dV/df are hubble-independent (the
        deferred-drag factorization's soundness condition)."""
        return all("hubble" not in _field.field_names(e)
                   for e in [self._V] + list(self._dvdf))

    @property
    def coupled_pair_available(self):
        """Whether :meth:`coupled_multi_step` can run the deferred-drag
        pair kernels: pairing is on, the tableau's ``A[0] == 0`` (the
        cross-boundary k-carry reset is a no-op) and the potential does not
        read ``hubble``."""
        return self._pair_stages and self._A[0] == 0 and self._hubble_free

    def _kernel_bases(self):
        """The kernels (by :data:`KERNELS` name) this stepper's model can
        run: the chunk kernel when a chunk depth is in force, the coupled
        pairs when :attr:`coupled_pair_available`."""
        return [n for role, n in self._KERNEL.items()
                if (role != "chunk" or self._chunk_depth)
                and (n not in _COUPLED or self.coupled_pair_available)]

    def kernel_names(self):
        """The kernels this stepper's model can run, as their launches
        count (:data:`LAUNCHES`: ``<name>:bf16`` with bfloat16 carries)."""
        return [self.counted_name(n) for n in self._kernel_bases()]

    def counted_name(self, name, finalized=False, kind=None):
        """The key of :data:`LAUNCHES` a launch of kernel ``name`` on this
        stepper counts under (``<name>:bf16`` with bfloat16 carries,
        ``<name>:bf16_fin`` for an energy stage on finalized carries,
        :meth:`_finalized`), with ``:<kind>`` for a launch of the sharded
        tier (:meth:`launch_block`)."""
        if self.carry_dtype is not None:
            name += BF16 + (FIN if finalized else "")
        return name if kind is None else f"{name}:{kind}"

    def kernel_header(self):
        """The generated C header the kernels are compiled against."""
        return _codegen.model_header(self._dvdf, self._V, self.F, self.h,
                                     field_name=self.sector.f.name,
                                     hubble_free=self._hubble_free,
                                     sij=self._sij_exprs)

    def build_kernels(self):
        """Compile (or load from the build cache) this model's kernels for
        float32 and float64, one ``nvcc`` per source, all in parallel;
        raises if ``nvcc`` fails."""
        names = self._kernel_bases()
        libs = _stencil.build_kernels(
            sorted({KERNELS[n][0] for n in names}), self.kernel_header())
        fns = {}
        for name in names:
            src = KERNELS[name][0]
            # input and output pointer arrays, X, Y, Z, params, [partials,
            # sums], stream
            argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
            argtypes += [ctypes.c_void_p] * (4 if SUM_SETS[name] else 2)
            # (carry dtype, velocity carries in the working dtype)
            variants = [(None, False), (torch.bfloat16, False)]
            if name in _FINALIZED:
                variants.append((torch.bfloat16, True))
            for dtype, suffix in _SUFFIX.items():
                for cd, fin in variants:
                    entry = (f"pk_{name}_{suffix}"
                             + ("_bf16" if cd is not None else "")
                             + (FIN if fin else ""))
                    fn = getattr(libs[src], entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name, dtype, cd, fin] = fn
                    # the sharded tier: params, then partials, nblocks, Nb,
                    # Nw, Ys, x0, yb0, GYb (PkGeom), stream
                    for bits, psuffix in (_PAD_SUFFIX.items()
                                          if name in _WINDOWS else ()):
                        fn = getattr(libs[src], entry + psuffix)
                        fn.argtypes = argtypes[:6] + [
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64] + [ctypes.c_int] * 4 + [
                            ctypes.c_void_p]
                        fn.restype = ctypes.c_int
                        fns[name, dtype, cd, fin, bits] = fn
                if SUM_SETS[name]:
                    # the sums' second launch alone: partials, sums,
                    # nterms, nblocks, stream
                    fn = getattr(libs[src], f"pk_finish_sums_{suffix}")
                    fn.argtypes = [ctypes.c_void_p] * 2 + [
                        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    fns[name, dtype, "finish"] = fn
        if self._chunk_depth:
            # the kernel's compile-time tile must be the one chunk_tile
            # predicts (the CPU path's fallback decisions rest on it)
            query = libs[KERNELS["fused_chunk"][0]].pk_fused_chunk_tile
            query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            query.restype = ctypes.c_int
            self._chunk_query = query
            for dtype in _SUFFIX:
                got = self.chunk_kernel_tile(dtype)
                want = chunk_tile(self.F, self.h, dtype.itemsize,
                                  self._chunk_depth)
                if got != want:
                    raise RuntimeError(
                        f"fused_chunk.cu instantiates the tile {got} for "
                        f"{dtype}; ops/fused.py:chunk_tile predicts {want}")
        self._built = libs
        for src, values in self._march_sources():
            for dtype in _SUFFIX:
                # the kernel's compile-time x-march tile must be the one
                # march_tile predicts
                got = self.march_kernel_tile(dtype, src)
                want = march_tile(self.F, self.h, dtype.itemsize,
                                  self._march_nh, values=values)
                if got != want:
                    raise RuntimeError(
                        f"{src} instantiates the x-march tile {got} for "
                        f"{dtype}; ops/fused.py:march_tile predicts {want}")
        num_blocks = libs[KERNELS[self._KERNEL["stage"]][0]].pk_num_blocks
        num_blocks.argtypes = [ctypes.c_int] * 3
        num_blocks.restype = ctypes.c_longlong
        self._num_blocks = num_blocks
        self._libs = fns

    def chunk_kernel_tile(self, dtype):
        """The built chunk kernel's x-march for working type ``dtype``, as
        the library reports it: ``((lx, rows, columns), bytes)``
        (:func:`chunk_tile`), or ``None`` without one."""
        out = (ctypes.c_int * 4)()
        if self._chunk_query(self._chunk_depth,
                             int(dtype == torch.float64), out) != 0:
            return None
        return tuple(out[:3]), out[3]

    #: the tensor components of this stepper's pairs' x-march (K3, K6)
    _march_nh = 0

    def _march_sources(self):
        """The built sources of this stepper's x-marching kernels, each
        with the values its march holds per tapped array (:func:`
        march_tile`): the pairs' (K3 and K6; for the GW system K8 and K9)
        2, the stages' (K5 and K2; for the GW system K5' and K7) 1."""
        srcs = [(KERNELS[n][0], 2) for n in self._kernel_bases()
                if n in (self._KERNEL["pair"], self._KERNEL["coupled_pair"])]
        srcs.append((KERNELS[self._KERNEL["stage_energy"]][0], 1))
        return sorted(set(srcs))

    def march_kernel_tile(self, dtype, source="fused_pair.cu"):
        """The x-march tile of this stepper's built kernels in ``source``
        for working type ``dtype``, as the library reports it
        (``pk_scalar_march_tile``, and ``pk_scalar_stage_march_tile`` in
        fused_stage.cu, that of K5 and K2; for the GW system
        ``pk_preheat_march_tile`` and ``pk_stage_march_tile``, that of K5'
        and K7): ``((lx, gf, g, joint), bytes)`` (:func:`march_tile`)."""
        lib = self._built[source]
        if source == KERNELS[self._KERNEL["stage_energy"]][0]:
            name = ("pk_stage_march_tile" if self._march_nh
                    else "pk_scalar_stage_march_tile")
        else:
            name = ("pk_preheat_march_tile" if self._march_nh
                    else "pk_scalar_march_tile")
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 5)()
        fn(int(dtype == torch.float64), out)
        return tuple(out[:4]), out[4]

    def _finalized(self, name, ins):
        """Whether a launch of ``name`` takes its velocity carries (kdfdt,
        kdhijdt) in the working dtype while the other carries are stored in
        ``carry_dtype``: the energy stage after the coupled driver's
        finalize (:meth:`_finalize_deferred`), the ``_bf16_fin`` kernels."""
        return (self.carry_dtype is not None and name in _FINALIZED
                and len(ins) > 3 and ins[3].dtype == self.dtype)

    def _in_dtypes(self, finalized):
        """The storage dtype of each lattice input of a launch."""
        if not finalized:
            return self._dtypes
        return tuple(self.dtype if j % 4 == 3 else d
                     for j, d in enumerate(self._dtypes))

    def _check(self, ins, outs, in_dtypes):
        n = len(self._comps)
        if len(ins) != n or len(outs) != n:
            raise ValueError(f"the fused kernels take {n} arrays in and {n} "
                             f"out; got {len(ins)} and {len(outs)}")
        ref = ins[0]
        for t, c, dt in zip(list(ins) + list(outs), self._comps * 2,
                            tuple(in_dtypes) + self._dtypes):
            shape = (c,) + self.local_shape
            if (t.device != ref.device or t.dtype != dt
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"the fused kernels take contiguous {dt} tensors "
                    f"of shape {shape} on one device; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ' (non-contiguous)'}")

    def _partials_buffer(self, n, ref):
        """The sum kernels' scratch on ``ref``'s device: ``n`` partials
        (one per sum term and thread block of a launch, or of the whole
        lattice's launch in the sharded tier). One buffer a device serves
        every launch: each launch's second kernel has consumed it before
        the next launch (same stream) writes it."""
        buf = self._partials.get(ref.device)
        if buf is None or buf.numel() < n or buf.dtype != ref.dtype:
            buf = self._partials[ref.device] = torch.empty(
                n, dtype=ref.dtype, device=ref.device)
        return buf

    def _finish_sums(self, name, partials, nblocks, device):
        """The second launch of kernel ``name``'s sums on its own: the
        ``(terms, nblocks)`` partials on ``device`` -> a new vector of the
        terms, split into its ``(2F+1,)`` sum sets."""
        nsums = SUM_SETS[name] * (2 * self.F + 1)
        flat = torch.empty(nsums, dtype=self.dtype, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._libs[name, self.dtype, "finish"](
                partials.data_ptr(), flat.data_ptr(), nsums, nblocks, stream)
        if rc != 0:
            raise RuntimeError(f"{name} sums' second launch failed with CUDA "
                               f"error {rc}")
        return list(flat.split(2 * self.F + 1))

    def launch(self, name, ins, outs, params):
        """Run kernel ``name`` on CUDA tensors (counting the launch) or its
        plain version on CPU tensors.

        :arg ins: the lattice inputs: per system (:attr:`_SYSTEMS`) the
            field, the velocity and their k-carries (the deferred pairs:
            field, velocity, velocity carry, field carry). The energy stage
            also takes the velocity carries in the working dtype with the
            others in ``carry_dtype`` (:meth:`_finalized`).
        :arg outs: as many lattice outputs, written.
        :arg params: the scalars, in the order of ``_PARAMS[name]``.
        :returns: ``outs``, followed by the kernel's ``SUM_SETS[name]``
            energy-sum vectors of ``2F + 1`` entries each (new tensors).
        """
        if name not in self._KERNEL.values():
            raise ValueError(f"{name} is not a kernel of this stepper")
        if isinstance(ins[0], ShardedArray):
            return self._launch_sharded(name, ins, outs, params)
        fin = self._finalized(name, ins)
        self._check(ins, outs, self._in_dtypes(fin))
        if len(params) != len(_PARAMS[name]):
            raise ValueError(f"{name} takes the scalars {_PARAMS[name]}; got "
                             f"{len(params)} values")
        nsums = SUM_SETS[name] * (2 * self.F + 1)
        dev = ins[0].device
        if dev.type == "cuda":
            fn = (self._libs or {}).get((name, self.dtype, self.carry_dtype,
                                         fin))
            if fn is None:
                raise RuntimeError(
                    f"kernel {name} is not built on this stepper (construct "
                    "it with a CUDA device; the coupled pair kernels need a "
                    "hubble-free potential)")
            X, Y, Z = self.local_shape
            if X > 65535 or (Y + 7) // 8 > 65535:
                raise ValueError(f"lattice {self.local_shape} exceeds the "
                                 "kernels' launch grid")
            prm = (ctypes.c_double * (len(params) + len(self._weights)))(
                *params, *self._weights)
            ptrs = ctypes.c_void_p * len(ins)
            args = [ptrs(*(t.data_ptr() for t in ins)),
                    ptrs(*(t.data_ptr() for t in outs)), X, Y, Z, prm]
            sums = []
            if nsums:
                flat = torch.empty(nsums, dtype=self.dtype, device=dev)
                args += [self._partials_buffer(
                    nsums * self._num_blocks(X, Y, Z), flat).data_ptr(),
                    flat.data_ptr()]
                sums = list(flat.split(2 * self.F + 1))
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(*args, stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed with CUDA "
                                   f"error {rc}")
            LAUNCHES[self.counted_name(name, fin)] += 1
            return list(outs) + sums
        if dev.type == "cpu":
            res = self.plain(name, ins, params)
            for o, r in zip(outs, res):
                o.copy_(r)
            return list(outs) + res[len(outs):]
        raise ValueError(f"no fused kernel for device {dev}")

    def _new_set(self, device):
        """One set of a launch's lattice outputs, in :meth:`_inputs`
        order and storage dtypes (``device`` ``"sharded"``: of
        :class:`ShardedArray` s on the decomposition's devices)."""
        if device == "sharded":
            return [ShardedArray(
                [torch.empty((c,) + self.local_shape, dtype=d, device=dev)
                 for dev in self.decomp.devices], self.decomp)
                for c, d in zip(self._comps, self._dtypes)]
        return [torch.empty((c,) + self.local_shape, dtype=d, device=device)
                for c, d in zip(self._comps, self._dtypes)]

    @staticmethod
    def _storages(arrays):
        return {b.untyped_storage().data_ptr() for a in arrays
                for b in (a.blocks if isinstance(a, ShardedArray) else [a])}

    def _out_set(self, ins):
        """A buffer set sharing no storage with the launch's inputs. The
        sets are made in the outputs' dtypes, so an input in another dtype
        (the velocity carries after a finalize) reuses them."""
        device = ("sharded" if isinstance(ins[0], ShardedArray)
                  else ins[0].device)
        if self._buffers is None or self._buffers[0] != device:
            self._buffers = None  # release the old sets first
            self._buffers = (device, [self._new_set(device)
                                      for _ in range(2)])
        used = self._storages(ins)
        for bufs in self._buffers[1]:
            if not used & self._storages(bufs):
                return bufs
        # inputs mixed from both sets: write fresh arrays instead
        return self._new_set(device)

    # -- the sharded tier ------------------------------------------------------

    def launch_block(self, name, kind, ins, outs, params, x0=0,
                     partials=None):
        """One launch of the sharded tier on one block: kernel ``name``
        (a key of :data:`_WINDOWS`) of ``kind`` (a key of
        :data:`~pystella_tpu_torch.ops.derivs.PAD_KINDS`; ``interior`` and
        ``shell`` only for a kernel without sums). ``ins`` are the lattice
        inputs in kernel order: at the window slots windows ``(C, X + 2 hx,
        Y + 2 hy, Z)``, ``hx`` (``hy``) the radius where ``kind`` pads x (y)
        -- the padded block, or for the overlapped path the raw block
        (interior) or a ``(C, 3h, Y, Z)`` shell input --, elsewhere the full
        block, as ``outs``. The launch computes the ``(X, Y, Z)`` region and
        writes its rows of ``outs`` from x row ``x0`` on: the kernel on CUDA
        tensors (counted as :meth:`counted_name` gives it:
        ``<name>[:bf16[_fin]]:<kind>``), the plain version on CPU
        tensors. Every array is in its slot's storage dtype (the carries in
        ``carry_dtype``; :meth:`_in_dtypes`), a window's too. Returns
        ``outs``, followed, for a kernel with sums, by the
        region's own energy-sum vectors -- unless ``partials`` (CUDA only)
        is ``(buffer, nblocks, x0, yb0, GYb)``: then the launch writes its
        blocks' partial sums into ``buffer`` at their places in a launch
        over ``nblocks`` blocks (PkGeom in pk_common.cuh: the region's
        first x row and y block there, and its y-block count), and the
        caller runs the second launch (:meth:`_finish_sums`) once every
        block has written."""
        wins = _WINDOWS.get(name)
        if wins is None or name not in self._KERNEL.values() or (
                SUM_SETS[name] and kind in _OVERLAP_KINDS):
            raise ValueError(f"{name} has no {kind} launch on this stepper")
        bits = PAD_KINDS[kind]
        hx, hy = (self.h if bits & 1 else 0), (self.h if bits & 2 else 0)
        Xb, Y, Z = self.local_shape
        Xw, Yw = ins[wins[0]].shape[1:3]
        X = Xw - 2 * hx
        dev = ins[0].device
        n = len(self._comps)
        if len(ins) != n or len(outs) != n:
            raise ValueError(f"{name}:{kind} takes {n} arrays in and {n} "
                             f"out; got {len(ins)} and {len(outs)}")
        fin = self._finalized(name, ins)
        dtypes = tuple(self._in_dtypes(fin)) + self._dtypes
        for j, t in enumerate(list(ins) + list(outs)):
            c = self._comps[j % n]
            shape = ((c, Xw, Yw, Z) if j in wins else (c,) + self.local_shape)
            if (tuple(t.shape) != shape or t.dtype != dtypes[j]
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(
                    f"{name}:{kind} takes contiguous tensors on one device, "
                    f"windows {(c, Xw, Yw, Z)} and blocks "
                    f"{(c,) + self.local_shape}, array {j} in {dtypes[j]}; "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if Yw - 2 * hy != Y or X < 1 or x0 < 0 or x0 + X > Xb:
            raise ValueError(f"{name}:{kind}: a window of {Xw} x {Yw} rows "
                             f"has no region of {self.local_shape} at x row "
                             f"{x0}")
        nsums = SUM_SETS[name] * (2 * self.F + 1)
        if dev.type == "cuda":
            fn = (self._libs or {}).get((name, self.dtype, self.carry_dtype,
                                         fin, bits))
            if fn is None:
                raise RuntimeError(f"kernel {name} is not built on this "
                                   "stepper (construct it with a CUDA "
                                   "device)")
            # the region's first element of each array, in bytes of the
            # array's own storage dtype
            woff, boff = (hx * Yw + hy) * Z, x0 * Y * Z
            ptrs = ctypes.c_void_p * n
            prm = (ctypes.c_double * (len(params) + len(self._weights)))(
                *params, *self._weights)
            own = nsums and partials is None
            if own:
                nb = self._num_blocks(X, Y, Z)
                partials = (self._partials_buffer(nsums * nb, ins[0]), nb,
                            0, 0, -(-Y // _BLOCK_Y))
            buf, nb, *geo = partials if nsums else (None, 0, 0, 0, 0)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(ptrs(*(t.data_ptr() + t.element_size() * (
                    woff if j in wins else boff) for j, t in enumerate(ins))),
                        ptrs(*(o.data_ptr() + o.element_size() * boff
                               for o in outs)), X, Y, Z,
                        prm, None if buf is None else buf.data_ptr(), nb,
                        Xb * Y * Z, Xw * Yw * Z, Yw, *geo, stream)
            if rc != 0:
                raise RuntimeError(f"{name}:{kind} kernel launch failed "
                                   f"with CUDA error {rc}")
            LAUNCHES[self.counted_name(name, fin, kind)] += 1
            if own:
                return list(outs) + self._finish_sums(name, buf, nb, dev)
            return list(outs)
        if dev.type == "cpu":
            res = self.plain(name, [t if j in wins else t.narrow(1, x0, X)
                                    for j, t in enumerate(ins)], params,
                             pad=(hx, hy))
            for o, r in zip(outs, res):
                o.narrow(1, x0, X).copy_(r)
            return list(outs) + res[len(outs):]
        raise ValueError(f"no fused kernel for device {dev}")

    def sharded_kinds(self, name=None):
        """The launches one kernel launch of this stepper makes per block,
        by kind: ``{}`` unsharded; ``{None: 1}`` on a mesh that shards
        nothing (the unsharded kernels, per block); ``{"interior": 1,
        "shell": 2}`` on the overlapped path; else the padding's kind. For
        a kernel ``name`` with sums, the padding's kind even where the
        others overlap."""
        if self.decomp is None:
            return {}
        overlap = self._overlap and not (name and SUM_SETS[name])
        return _stencil.launch_kinds(self.decomp, self.h, self.local_shape,
                                     overlap)

    def sum_order(self):
        """How a sharded sum kernel's sums come together: ``"single-device"``
        when every block lies on one card and its y blocks are the
        lattice's (y unsharded, or a local Y that is a multiple of the
        kernel block's 8 rows) -- every block writes its partials where the
        whole lattice's launch does and one second launch reduces them, so
        the sums are the unsharded kernel's bit for bit --, else
        ``"rank"``: each block's sums finished apart and added in rank
        order (the JAX package's ``psum``; the plain versions, on the CPU,
        always). ``None`` unsharded."""
        d = self.decomp
        if d is None:
            return None
        if (len(set(d.devices)) == 1 and d.devices[0].type == "cuda"
                and (d.proc_shape[1] == 1
                     or self.local_shape[1] % _BLOCK_Y == 0)):
            return "single-device"
        return "rank"

    def _exchange_buffers(self, cache, slot, shape, dtype):
        """Persistent per-block tensors of ``shape`` and ``dtype`` (the
        window's own: bfloat16 for a carry window with bfloat16 carries)
        for window slot ``slot`` (reused by every launch; the exchange
        overwrites them). A slot's buffers serve whichever window a kernel
        has there (the deferred pair's kf sits where the normal pair has
        none; with bfloat16 carries both are carries), so a stepper holds
        one padded set per slot and dtype, up to its widest kernel's windows
        (the GW deferred pair's eight: 4F + 24 components)."""
        key = (slot, dtype)
        bufs = cache.get(key)
        if bufs is None or tuple(bufs[0].shape) != shape:
            cache[key] = None  # release the old set first
            bufs = cache[key] = [
                torch.empty(shape, dtype=dtype, device=dev)
                for dev in self.decomp.devices]
        return bufs

    def _combine_sums(self, per_block):
        """Per-block lists of sum vectors -> one list, each vector the
        blocks' added in rank order."""
        return [self.decomp.psum([p[k] for p in per_block])
                for k in range(len(per_block[0]))]

    def _launch_sharded(self, name, ins, outs, params):
        """Kernel ``name`` on every block of the :class:`ShardedArray`
        inputs ``ins``, into ``outs``: the window inputs exchanged on a side
        stream into persistent buffers, then one padded launch per block;
        or, on the overlapped path, the x slabs copied on the side stream
        while an interior launch per block reads the raw blocks, then two
        shell launches per block. A kernel with sums then reduces them as
        :meth:`sum_order` says. Returns ``outs`` and the sums."""
        d = self.decomp
        if d is None or any(not isinstance(a, ShardedArray)
                            or a.decomp is not d for a in list(ins) + outs):
            raise ValueError("sharded inputs need the stepper of their "
                             "decomposition (decomp=)")
        kinds = self.sharded_kinds(name)
        nsums = SUM_SETS[name]

        def blocks(r, subst=None):
            ins_r = [a.blocks[r] for a in ins]
            for j, t in (subst or {}).items():
                ins_r[j] = t
            return ins_r, [o.blocks[r] for o in outs]

        if None in kinds:
            res = [self.launch(name, *blocks(r), params)
                   for r in range(d.nshards)]
            sums = self._combine_sums([r[len(outs):] for r in res]) \
                if nsums else []
            return list(outs) + sums
        wins = _WINDOWS[name]
        raw = [ins[j] for j in wins]
        reads = [b for a in raw for b in a.blocks]
        (X, Y, Z), h = self.local_shape, self.h
        comps = self._comps
        if "interior" in kinds:
            shells = [tuple(self._exchange_buffers(
                self._shell_bufs, (j, side), (comps[j], 3 * h, Y, Z),
                ins[j].dtype) for side in (0, 1)) for j in wins]
            with record_function("halo_overlap"):
                with d.side_exchange(reads, [t for lo, hi in shells
                                             for t in lo + hi]) as ex:
                    for a, (lo, hi) in zip(raw, shells):
                        d.x_shells_into(a.blocks, lo, hi, h)
                with record_function("halo_overlap_interior"):
                    for r in range(d.nshards):
                        self.launch_block(name, "interior", *blocks(r),
                                          params, x0=h)
                ex.wait()
                with record_function("halo_overlap_shells"):
                    for r in range(d.nshards):
                        for side, x0 in ((0, 0), (1, X - h)):
                            self.launch_block(name, "shell", *blocks(r, {
                                j: sh[side][r] for j, sh in zip(wins, shells)
                            }), params, x0=x0)
            return list(outs)
        (kind,) = kinds
        halo = _stencil.sharded_halo(h, *d.proc_shape[:2])
        pads = [self._exchange_buffers(self._pad_bufs, j, (
            comps[j], X + 2 * halo[0], Y + 2 * halo[1], Z), ins[j].dtype)
            for j in wins]
        with d.side_exchange(reads, [t for p in pads for t in p]) as ex:
            for a, p in zip(raw, pads):
                d.pad_into(a.blocks, p, halo)
        ex.wait()

        def padded(r, **kw):
            return self.launch_block(name, kind, *blocks(r, {
                j: p[r] for j, p in zip(wins, pads)}), params, **kw)

        if not nsums:
            for r in range(d.nshards):
                padded(r)
            return list(outs)
        if self.sum_order() == "rank":
            per = [padded(r)[len(outs):] for r in range(d.nshards)]
            return list(outs) + self._combine_sums(per)
        # every block's partials at their places in the whole lattice's
        # launch, then one second launch
        Xg, Yg, Zg = self.grid_shape
        nb = self._num_blocks(Xg, Yg, Zg)
        dev = d.devices[0]
        buf = self._partials_buffer(nsums * (2 * self.F + 1) * nb,
                                    outs[0].blocks[0])
        for r in range(d.nshards):
            cx, cy, _ = d.coords(r)
            padded(r, partials=(buf, nb, cx * X, cy * Y // _BLOCK_Y,
                                -(-Yg // _BLOCK_Y)))
        return list(outs) + self._finish_sums(name, buf, nb, dev)

    # -- plain PyTorch versions (the kernels' arithmetic) --------------------

    def _scalars(self, values, ref):
        """Scalars as 0-d tensors of the working dtype, so the plain bodies
        round where the kernels (which take them as ``T``) round."""
        return {n: torch.tensor(v, dtype=ref.dtype, device=ref.device)
                for n, v in values.items()}

    def plain(self, name, ins, params, pad=None):
        """Kernel ``name``'s plain version on ``ins`` (any device): the
        lattice outputs, then its energy-sum vectors. Carries stored in
        ``carry_dtype`` are widened first and the carry outputs rounded to
        it last, as the kernels load and store them (in PyTorch a 0-d
        float32 scalar times a bfloat16 tensor stays bfloat16, so without
        the widening the arithmetic would run in bfloat16). With ``pad =
        (hx, hy)`` the window inputs are padded by that many rows along x
        and y (:class:`~pystella_tpu_torch.ops.stencil.PaddedTaps`), the
        sharded tier's plain version."""
        if name not in self._KERNEL.values():
            raise ValueError(f"{name} is not a kernel of this stepper")
        n = len(ins)
        taps = _stencil.RollTaps
        if pad is not None and tuple(pad) != (0, 0):
            def taps(w):
                return _stencil.PaddedTaps(w, pad)
        res = self._plain(name, [t.to(self.dtype) for t in ins], params,
                          taps)
        return [r.to(dt) for r, dt in zip(res[:n], self._dtypes)] + res[n:]

    def _plain(self, name, ins, params, taps=_stencil.RollTaps):
        sc = self._scalars(dict(zip(_PARAMS[name], params)), ins[0])
        R = taps
        if name == "fused_chunk":
            outs = self._chunk_body(ins, sc, self._chunk_depth)
            keys = ("f", "dfdt", "kf", "kdfdt")
        elif name in ("fused_stage", "fused_stage_energy"):
            f, dfdt, kf, kdf = ins
            energy = name == "fused_stage_energy"
            outs = self._scalar_body(
                R(f), {"dfdt": dfdt, "kf": kf, "kdfdt": kdf}, sc,
                energy=energy)
            keys = ("f", "dfdt", "kf", "kdfdt")
            if energy:
                keys += ("esums",)
        elif name == "fused_pair":
            f, dfdt, kf, kdf = ins
            outs, _ = self._scalar_pair_core(
                {"f": R(f), "dfdt": R(dfdt), "kf": R(kf)}, {"kdfdt": kdf},
                sc)
            keys = ("f", "dfdt", "kf", "kdfdt")
        else:
            deferred = name == "coupled_pair_deferred"
            if deferred:
                f, dfp, kdfp, kf = ins
                taps = {"f": R(f), "dfp": R(dfp), "kdfp": R(kdfp),
                        "kf": R(kf)}
                extras = {}
            else:
                f, dfdt, kf, kdf = ins
                taps = {"f": R(f), "dfdt": R(dfdt), "kf": R(kf)}
                extras = {"kdfdt": kdf}
            outs, _ = self._deferred_pair_core(taps, extras, sc, deferred)
            keys = ("f", "dfp", "kf", "kdfp", "esums1", "esums2")
        return [outs[k] for k in keys]

    def _scalar_body(self, taps, extras, scalars, energy=False):
        inv_dx2 = [1.0 / d**2 for d in self.dx]
        coefs = _lap_coefs[self.h]
        dt, a, hub = scalars["dt"], scalars["a"], scalars["hubble"]
        A, B = scalars["A"], scalars["B"]

        fint = taps()
        lap = _stencil.lap_from_taps(taps, coefs, inv_dx2)
        dfdt, kf, kdf = extras["dfdt"], extras["kf"], extras["kdfdt"]

        dV = self._dV(fint, a, hub)

        rhs_f = dfdt
        rhs_df = lap - 2 * hub * dfdt - a * a * dV

        kf2 = A * kf + dt * rhs_f
        f2 = fint + B * kf2
        kdf2 = A * kdf + dt * rhs_df
        df2 = dfdt + B * kdf2
        outs = {"f": f2, "dfdt": df2, "kf": kf2, "kdfdt": kdf2}
        if energy:
            outs["esums"] = self._esums(fint, dfdt, lap, a, hub)
        return outs

    def _esums(self, fv, dfdt, lap, a, hub):
        """Raw energy sums of a stage's ENTRY state: per component
        ``sum(dfdt**2)`` and ``sum(-f * lap f)``, then ``sum(V(f))`` (a V
        that does not depend on f is broadcast over the lattice first) --
        the inputs of ``get_rho_and_p`` up to the ``1/(2 a**2)`` factors
        :meth:`_combine_esums` applies. Summed in the lattice dtype."""
        kin = torch.sum(dfdt * dfdt, dim=(1, 2, 3))
        grad = torch.sum(-fv * lap, dim=(1, 2, 3))
        env = {self.sector.f.name: fv, "a": a, "hubble": hub}
        V = torch.as_tensor(_field.evaluate(self._V, env), dtype=fv.dtype,
                            device=fv.device)
        pot = torch.sum(torch.broadcast_to(V, fv.shape[1:]))
        return torch.cat([kin, grad, pot.reshape(1)])

    def _dV(self, fv, a, hub):
        env = {self.sector.f.name: fv, "a": a, "hubble": hub}
        out = []
        for e in self._dvdf:
            v = _field.evaluate(e, env)
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(v, dtype=fv.dtype, device=fv.device)
            out.append(torch.broadcast_to(v.to(fv.dtype), fv.shape[1:]))
        return torch.stack(out)

    @staticmethod
    def _axpy_taps(t_y, t_k, t_dy, B, A, dt, y1):
        """Taps-like view of a 2N stage-updated array
        ``y1 = y + B*(A*k + dt*dy)`` without materializing its halo: x/y
        shifts compose from the raw taps at the same offsets (the identical
        arithmetic as shifting a materialized y1), z shifts are rolls of
        ``y1`` itself."""
        def taps(sx=0, sy=0, sz=0):
            if sz:
                if sx or sy:
                    raise ValueError("taps must be axis-aligned")
                return t_y.roll(y1, sz)
            if sx == 0 and sy == 0:
                return y1
            return t_y(sx, sy) + B * (A * t_k(sx, sy) + dt * t_dy(sx, sy))
        return taps

    def _scalar_pair_core(self, taps, extras, scalars):
        """Two consecutive 2N-storage scalar stages; returns the four
        outputs plus the stage-1 field's composed taps."""
        tf, tdf, tkf = taps["f"], taps["dfdt"], taps["kf"]
        kdf0 = extras["kdfdt"]
        inv_dx2 = [1.0 / d**2 for d in self.dx]
        coefs = _lap_coefs[self.h]
        dt = scalars["dt"]
        a1, hub1 = scalars["a1"], scalars["hubble1"]
        A1, B1 = scalars["A1"], scalars["B1"]
        a2, hub2 = scalars["a2"], scalars["hubble2"]
        A2, B2 = scalars["A2"], scalars["B2"]

        # stage 1 on the block (identical arithmetic to _scalar_body)
        f0, df0 = tf(), tdf()
        lap_f = _stencil.lap_from_taps(tf, coefs, inv_dx2)
        kf1 = A1 * tkf() + dt * df0
        f1 = f0 + B1 * kf1
        kdf1 = A1 * kdf0 + dt * (lap_f - 2 * hub1 * df0
                                 - a1 * a1 * self._dV(f0, a1, hub1))
        df1 = df0 + B1 * kdf1

        f1_taps = self._axpy_taps(tf, tkf, tdf, B1, A1, dt, f1)
        lap_f1 = _stencil.lap_from_taps(f1_taps, coefs, inv_dx2)

        # stage 2 on the block
        kf2 = A2 * kf1 + dt * df1
        f2 = f1 + B2 * kf2
        kdf2 = A2 * kdf1 + dt * (lap_f1 - 2 * hub2 * df1
                                 - a2 * a2 * self._dV(f1, a2, hub2))
        df2 = df1 + B2 * kdf2
        outs = {"f": f2, "dfdt": df2, "kf": kf2, "kdfdt": kdf2}
        return outs, f1_taps

    def _chunk_body(self, ins, scalars, depth):
        """``depth`` consecutive stages: the plain version of K10, written
        as the ``depth / 2`` pair bodies it must equal, on whole-lattice
        rolls. With ``carry_dtype`` the carries are rounded to it at every
        interior pair boundary -- where the pair-kernel sequence stores, and
        so rounds, them; the last pair's carries round when they are
        stored (:meth:`plain`). The JAX package's ``_chunk_body`` composes
        memoized whole-window views instead; at 512^3 each memoized offset
        would be a 1 GiB array, so the port keeps the pair sequence, whose
        per-element arithmetic is the same."""
        f, dfdt, kf, kdf = ins
        R = _stencil.RollTaps
        cd = self.carry_dtype
        for j in range(0, depth, 2):
            sc = {"dt": scalars["dt"]}
            for k, i in ((1, j + 1), (2, j + 2)):
                for n in ("a", "hubble", "A", "B"):
                    sc[f"{n}{k}"] = scalars[f"{n}{i}"]
            outs, _ = self._scalar_pair_core(
                {"f": R(f), "dfdt": R(dfdt), "kf": R(kf)}, {"kdfdt": kdf}, sc)
            f, dfdt, kf, kdf = (outs[n] for n in ("f", "dfdt", "kf", "kdfdt"))
            if cd is not None and j + 2 < depth:
                kf, kdf = (k.to(cd).to(self.dtype) for k in (kf, kdf))
        return {"f": f, "dfdt": dfdt, "kf": kf, "kdfdt": kdf}

    @staticmethod
    def _completed_taps(tdfp, tkdfp, dt, hubfix, B2p):
        """Taps-like view of the previous pair's completed velocity
        ``df = dfp + B2p (kdfp - 2 dt hubfix dfp)``, composed from the
        deferred inputs at each offset."""
        def taps(sx=0, sy=0, sz=0):
            dfp = tdfp(sx, sy, sz)
            return dfp + B2p * (tkdfp(sx, sy, sz) - 2 * dt * hubfix * dfp)
        return taps

    def _deferred_pair_core(self, taps, extras, scalars, in_deferred):
        """The deferred-drag coupled pair: the stage-pair arithmetic of
        :meth:`_scalar_pair_core` with (a) the incoming state optionally
        reconstructed from the previous pair's deferred representation
        (``in_deferred``: taps ``f, dfp, kdfp, kf`` and scalars ``hubfix,
        B2p``) and (b) the second stage's Hubble drag left out, its ``dV``
        and ``V`` evaluated with no ``hubble``. Returns ``f, dfp (= df1),
        kf, kdfp`` and the energy sums ``esums1`` (entry state) and
        ``esums2`` (the stage-1 state, with the recomposed lap f1), and the
        stage-1 field's composed taps."""
        tf, tkf = taps["f"], taps["kf"]
        inv_dx2 = [1.0 / d**2 for d in self.dx]
        coefs = _lap_coefs[self.h]
        dt = scalars["dt"]
        a1, hub1 = scalars["a1"], scalars["hubble1"]
        A1, B1 = scalars["A1"], scalars["B1"]
        a2 = scalars["a2"]
        A2, B2 = scalars["A2"], scalars["B2"]

        if in_deferred:
            tdf = self._completed_taps(taps["dfp"], taps["kdfp"], dt,
                                       scalars["hubfix"], scalars["B2p"])
            kdf0 = (taps["kdfp"]() - 2 * dt * scalars["hubfix"]
                    * taps["dfp"]())
        else:
            tdf = taps["dfdt"]
            kdf0 = extras["kdfdt"]

        # stage 1 (identical arithmetic to _scalar_body, exact scalars)
        f0, df0 = tf(), tdf()
        lap_f = _stencil.lap_from_taps(tf, coefs, inv_dx2)
        kf1 = A1 * tkf() + dt * df0
        f1 = f0 + B1 * kf1
        kdf1 = A1 * kdf0 + dt * (lap_f - 2 * hub1 * df0
                                 - a1 * a1 * self._dV(f0, a1, hub1))
        df1 = df0 + B1 * kdf1

        f1_taps = self._axpy_taps(tf, tkf, tdf, B1, A1, dt, f1)
        lap_f1 = _stencil.lap_from_taps(f1_taps, coefs, inv_dx2)

        # stage 2: everything but the Hubble drag (deferred; a2 is exact,
        # its update never touches rho); hubble=None, so a potential that
        # read it would fail here (coupled_pair_available gates on that)
        kf2 = A2 * kf1 + dt * df1
        f2 = f1 + B2 * kf2
        kdfp = A2 * kdf1 + dt * (lap_f1 - a2 * a2 * self._dV(f1, a2, None))
        return ({"f": f2, "dfp": df1, "kf": kf2, "kdfp": kdfp,
                 "esums1": self._esums(f0, df0, lap_f, a1, hub1),
                 "esums2": self._esums(f1, df1, lap_f1, a2, None)}, f1_taps)

    def _finalize_deferred(self, carry, dt, hubfix, B2p):
        """Complete the deferred stage-2 Hubble drag of a pair with the (by
        now exact) ``hubfix``: one elementwise pass, in the working dtype,
        with the arithmetic the next deferred kernel would have applied.

        With bfloat16 carries the completed velocity carry is left in the
        working dtype, unrounded, as the JAX package's finalize leaves it
        (``k["dfdt"] - 2 * dt * hubfix * state["dfdt"]`` promotes the bf16
        carry); the odd trailing energy stage reads it so (the ``_bf16_fin``
        kernels). The JAX package with x64 enabled takes the two products in
        float64 (its ``hubfix`` is a float64 scalar there); here they are
        taken in the working dtype, as with x64 off.

        A sharded carry is completed block by block, in place: the
        velocities and their carries are the last pair's outputs, the
        stepper's own buffers, and the padded windows already hold the
        memory new arrays would take (the same arithmetic, so the same
        bits). With bfloat16 carries the completed velocity carry goes to
        a working-dtype :class:`ShardedArray` of the stepper's own, one per
        system, reused by every finalize: completed in place, it would be
        rounded to bfloat16."""
        state, k = carry
        values = {"dt": dt, "hubfix": hubfix, "B2p": B2p}
        state, k = dict(state), dict(k)
        for _, v in self._SYSTEMS:
            if isinstance(state[v], ShardedArray):
                kout = k[v]
                if self.carry_dtype is not None:
                    kout = self._fin_carries.get(v)
                    if kout is None:
                        kout = self._fin_carries[v] = state[v].map(
                            torch.empty_like)
                for sb, kb, ob in zip(state[v].blocks, k[v].blocks,
                                      kout.blocks):
                    sc = self._scalars(values, sb)
                    torch.sub(kb, 2 * sc["dt"] * sc["hubfix"] * sb, out=ob)
                    sb.add_(sc["B2p"] * ob)
                k[v] = kout
                continue
            sc = self._scalars(values, state[v])
            kv = k[v] - 2 * sc["dt"] * sc["hubfix"] * state[v]
            state[v] = state[v] + sc["B2p"] * kv
            k[v] = kv
        return state, k

    # -- Stepper interface -------------------------------------------------

    def init_carry(self, state):
        """``(state, k)`` with zero k-carries, stored in ``carry_dtype``
        when one is set."""
        cd = self.carry_dtype

        def zeros(v):
            return (torch.zeros_like(v) if cd is None
                    else torch.zeros_like(v, dtype=cd))
        k = {n: v.map(zeros) if isinstance(v, ShardedArray) else zeros(v)
             for n, v in state.items()}
        return (state, k)

    def extract(self, carry):
        return carry[0]

    def current(self, carry):
        return carry[0]

    def _inputs(self, carry):
        state, k = carry
        ins = [a for y, v in self._SYSTEMS
               for a in (state[y], state[v], k[y], k[v])]
        if self.decomp is not None:
            if any(not isinstance(a, ShardedArray) or a.decomp is not
                   self.decomp for a in ins):
                raise ValueError("a sharded stepper steps ShardedArrays of "
                                 "its decomposition (convert.shard_state)")
        elif isinstance(ins[0], ShardedArray) or ins[0].device != self.device:
            raise ValueError(f"state is on {getattr(ins[0], 'device', ins[0])}"
                             f", but this stepper runs on {self.device}")
        return ins

    def _carry_of(self, outs):
        """The carry a launch's lattice outputs (in :meth:`_inputs` order)
        make; anything after them is ignored."""
        state, k = {}, {}
        for j, (y, v) in enumerate(self._SYSTEMS):
            state[y], state[v], k[y], k[v] = outs[4 * j:4 * j + 4]
        return state, k

    def _stage_params(self, s, dt, rhs_args):
        return (_float(dt), _float(rhs_args.get("a", 1.0)),
                _float(rhs_args.get("hubble", 0.0)),
                float(self._A[s]), float(self._B[s]))

    def stage(self, s, carry, t, dt, rhs_args):
        ins = self._inputs(carry)
        outs = self.launch(self._KERNEL["stage"], ins, self._out_set(ins),
                           self._stage_params(s, dt, rhs_args))
        return self._carry_of(outs)

    def _pair_params(self, s, dt, rhs_args, rhs_args2=None, s2=None):
        s2 = s + 1 if s2 is None else s2
        args2 = rhs_args2 if rhs_args2 is not None else rhs_args
        return (_float(dt),
                _float(rhs_args.get("a", 1.0)),
                _float(rhs_args.get("hubble", 0.0)),
                float(self._A[s]), float(self._B[s]),
                _float(args2.get("a", 1.0)),
                _float(args2.get("hubble", 0.0)),
                float(self._A[s2]), float(self._B[s2]))

    def _check_pair(self, s, s2):
        """Validate a ``stage_pair`` request: pairing must be enabled, and
        a wrapped pairing (``s2 < s``, i.e. crossing a step boundary) is
        only sound when the tableau's stage-``s2`` carry scale is zero --
        the skipped per-step k-carry reset must be a no-op."""
        if not self._pair_stages:
            raise RuntimeError(
                "stage-pair fusion is not available on this stepper "
                "(pair_stages=False or a single-stage tableau); use stage() "
                "or step()")
        if s2 < s and self._A[s2] != 0:
            raise ValueError(
                f"cross-boundary pairing needs A[{s2}] == 0 so the "
                f"step-boundary k-carry reset is a no-op; this tableau "
                f"has A[{s2}] = {self._A[s2]}")

    def stage_pair(self, s, carry, t, dt, rhs_args, rhs_args2=None,
                   s2=None):
        """Run stages ``s`` and ``s2`` (default ``s+1``) as one fused
        kernel. ``rhs_args2`` supplies second-stage expansion scalars
        (defaults to ``rhs_args``). ``s2`` may wrap to stage 0 of the NEXT
        step when ``A[0] == 0`` -- see :meth:`multi_step`."""
        self._check_pair(s, s + 1 if s2 is None else s2)
        ins = self._inputs(carry)
        outs = self.launch(self._KERNEL["pair"], ins, self._out_set(ins),
                           self._pair_params(s, dt, rhs_args, rhs_args2, s2))
        return self._carry_of(outs)

    # -- whole-RK-chunk tier (K10) -------------------------------------------

    def _chunk_fallback(self, reason):
        """The chunk tier's fallback, in the JAX package's words: a
        warning and a ``kernel_fallback`` event, and the stepper runs pairs
        (or single stages)."""
        to = "pair" if self._pair_stages else "single"
        warnings.warn(
            f"whole-RK-chunk fusion disabled ({reason}); step() will run "
            f"{to}-stage fused kernels", stacklevel=4)
        _events.emit("kernel_fallback", tier="chunk", to=to,
                     reason=str(reason),
                     local_shape=list(self.local_shape),
                     label=type(self).__name__)

    def _maybe_build_chunk(self, depth):
        """Put the requested chunk depth in force, or warn and leave the
        stepper on pairs: without a chunk body, for a wrapped chunk the
        tableau cannot take (``A[0] != 0``), for a depth the kernel has no
        instantiation for and for a model whose planes fit no tile. The
        same decisions on the CPU and on the GPU."""
        if not depth:
            return
        px, py = (1, 1) if self.decomp is None else self.decomp.proc_shape[:2]
        if not self._chunk_supported:
            self._chunk_fallback(f"no chunk body for {type(self).__name__}")
        elif px > 1 or py > 1:
            # the JAX package's rule: a chunk would need ceil(depth/2)*h-wide
            # halos, and the overlap split does not compose with composed-
            # stage windows -- the sharded hot loop stays on the pair tier
            self._chunk_fallback(
                f"sharded mesh ({px},{py}): chunk windows need "
                "ceil(depth/2)*h-wide halos")
        elif self._A[0] != 0 and depth > self.num_stages:
            self._chunk_fallback(
                f"tableau A[0] != 0: a depth-{depth} chunk would cross a "
                "step boundary whose k-carry reset is not a no-op")
        elif depth not in CHUNK_DEPTHS:
            self._chunk_fallback(
                f"no depth-{depth} chunk kernel: fused_chunk.cu instantiates "
                f"depths {CHUNK_DEPTHS}")
        elif chunk_tile(self.F, self.h, self.dtype.itemsize, depth) is None:
            self._chunk_fallback(
                f"no shared-memory tile holds F={self.F}, h={self.h} in "
                f"{self.dtype} at depth {depth}")
        else:
            self._chunk_depth = depth

    def _check_chunk(self, stages):
        if not self._chunk_depth:
            raise RuntimeError(
                "whole-RK-chunk fusion is not available on this stepper "
                "(chunk_stages unset/0, or a model or depth the chunk kernel "
                "cannot take); use stage_pair()/stage()/step()")
        if len(stages) != self._chunk_depth:
            raise ValueError(
                f"stage_chunk takes exactly {self._chunk_depth} stage "
                f"indices (got {len(stages)})")
        for prev, cur in zip(stages, stages[1:]):
            if cur < prev and self._A[cur] != 0:
                raise ValueError(
                    f"cross-boundary chunking needs A[{cur}] == 0 so the "
                    "step-boundary k-carry reset is a no-op; this tableau "
                    f"has A[{cur}] = {self._A[cur]}")

    def _chunk_params(self, stages, dt, rhs_args_seq):
        params = [_float(dt)]
        for s, ra in zip(stages, rhs_args_seq):
            ra = ra or {}
            params += [_float(ra.get("a", 1.0)),
                       _float(ra.get("hubble", 0.0)),
                       float(self._A[s]), float(self._B[s])]
        return tuple(params)

    def stage_chunk(self, stages, carry, t, dt, rhs_args_seq):
        """Run the listed stages (``len == chunk_stages``) as one kernel.
        ``rhs_args_seq`` gives each stage's expansion scalars; stage
        indices may wrap to the next step as in :meth:`stage_pair` (when
        the wrapped stage's ``A == 0``)."""
        stages = list(stages)
        self._check_chunk(stages)
        ins = self._inputs(carry)
        outs = self.launch(self._KERNEL["chunk"], ins, self._out_set(ins),
                           self._chunk_params(stages, dt, rhs_args_seq))
        return self._carry_of(outs)

    def kernel_tier_report(self):
        """Which kernels :meth:`multi_step` dispatches and the lattice
        traffic they imply: ``tier`` ("chunk", "pair" or "single"),
        ``chunk_depth``, ``kernels_per_2_steps`` (counts by role: "chunk",
        "pair", "single", consumed chunks first across step boundaries when
        ``A[0] == 0``, as :meth:`multi_step` does), ``kernel_names`` (the
        :data:`LAUNCHES` key of each role), ``bytes_per_launch`` (each
        array read once and written once, carries at their storage width)
        and ``bytes_per_step``. The JAX package's report, without its
        autotune record."""
        sites = int(np.prod(self.grid_shape))
        per_launch = 2 * sites * sum(
            c * dt.itemsize for c, dt in zip(self._comps, self._dtypes))
        if self._A[0] == 0:
            plan = self._plan(2 * self.num_stages)  # across the boundary
        else:
            plan = self._plan(self.num_stages) * 2  # per-step carry reset
        kernels = {}
        for role, _, _ in plan:
            kernels[role] = kernels.get(role, 0) + 1
        D = self._chunk_depth
        tier = "chunk" if D else "pair" if self._pair_stages else "single"
        names = {r: self.counted_name(self._KERNEL[self._ROLE[r]])
                 for r in kernels}
        report = {
            "tier": tier,
            "chunk_depth": D or None,
            "kernels_per_2_steps": kernels,
            "kernel_names": names,
            "bytes_per_launch": per_launch,
            "bytes_per_step": per_launch * len(plan) // 2,
            "grid_shape": list(self.grid_shape),
        }
        if self.decomp is not None:
            # every launch runs on each block, as sharded_kinds says
            report["proc_shape"] = list(self.decomp.proc_shape)
            report["sharded_launches_per_2_steps"] = {
                names[r] + ("" if kind is None else f":{kind}"):
                    c * m * self.decomp.nshards
                for r, c in kernels.items()
                for kind, m in self.sharded_kinds().items()}
            # coupled_multi_step's kernels (they have sums): their launch
            # kind per block and how their sums come together
            report["sum_kernel_launch_kinds"] = self.sharded_kinds(
                self._KERNEL["stage_energy"])
            report["sum_order"] = self.sum_order()
        return report

    def _emit_tier(self, entrypoint):
        """One ``kernel_tier`` event per (stepper, entry point), emitted at
        its first dispatch: the record of the tier actually run, not
        merely built (the JAX package's ``_emit_tier``)."""
        if entrypoint in self._tier_emitted:
            return
        self._tier_emitted.add(entrypoint)
        _events.emit("kernel_tier", entrypoint=entrypoint,
                     label=type(self).__name__,
                     **self.kernel_tier_report())

    #: the kernel role (:attr:`_KERNEL`) of each entry of a plan
    _ROLE = {"chunk": "chunk", "pair": "pair", "single": "stage"}

    def _plan(self, n):
        """The launches that run ``n`` consecutive flat stages, as
        ``(role, first, count)`` with role "chunk", "pair" or "single":
        chunks first, then pairs, then single stages (the order of the JAX
        package's ``_multi_step_impl``)."""
        D, i, plan = self._chunk_depth, 0, []
        while D and i + D <= n:
            plan.append(("chunk", i, D))
            i += D
        while self._pair_stages and i + 1 < n:
            plan.append(("pair", i, 2))
            i += 2
        while i < n:
            plan.append(("single", i, 1))
            i += 1
        return plan

    def _run_stages(self, carry, stages, t, dt, args_of, cross=False):
        """Run the flat stage list ``stages`` from ``carry`` as
        :meth:`_plan` schedules it; ``args_of(i)`` gives flat stage ``i``'s
        expansion scalars. ``cross``: the list crosses step boundaries,
        so each pair names its second stage."""
        for role, i, n in self._plan(len(stages)):
            if role == "chunk":
                carry = self.stage_chunk(stages[i:i + n], carry, t, dt,
                                         [args_of(i + j) for j in range(n)])
            elif role == "pair":
                s2 = {"s2": stages[i + 1]} if cross else {}
                carry = self.stage_pair(stages[i], carry, t, dt, args_of(i),
                                        rhs_args2=args_of(i + 1), **s2)
            else:
                carry = self.stage(stages[i], carry, t, dt, args_of(i))
        return carry

    def _step_impl(self, state, t, dt, rhs_args):
        carry = self._run_stages(self.init_carry(state),
                                 list(range(self.num_stages)), t, dt,
                                 lambda i: rhs_args)
        return self.extract(carry)

    def step(self, state, t=0.0, dt=None, rhs_args=None):
        """Advance ``state`` by one full RK step: a chunk, then stage
        pairs, then the odd stage left over (RK54: 2 pair launches + 1
        single; with ``chunk_stages=4``, 1 chunk + 1 single). Counts one
        on the ``steps`` counter; the first call emits ``kernel_tier``."""
        dt = dt if dt is not None else self.dt
        _metrics.counter("steps").inc()
        self._emit_tier("step")
        return self._step_impl(state, t, dt, rhs_args or {})

    def multi_step(self, state, nsteps, t=0.0, dt=None, rhs_args=None,
                   rhs_seq=None, sentinel=None):
        """Advance ``nsteps`` full RK steps, running chunks, then pairs,
        then single stages ACROSS step boundaries when ``A[0] == 0``: RK54
        runs ``ceil(5 * nsteps / 2)`` pair launches and, for odd
        ``nsteps``, one trailing single stage; with ``chunk_stages=4``,
        ``5 * nsteps // 4`` chunks before them. Equal, launch for launch in
        arithmetic, to the JAX package's ``FusedScalarStepper.multi_step``.

        ``rhs_seq`` maps scalar names (``"a"``, ``"hubble"``) to per-stage
        values, one per flat stage (``nsteps * num_stages``), overlaying the
        static ``rhs_args``.

        With ``sentinel`` (a :class:`~pystella_tpu_torch.obs.Sentinel`),
        the health vector of the final state is computed right after the
        chunk's last launch, on the same stream (K15 and its finish; no host
        sync), and ``(state, health_vector)`` is returned; the state is
        the one the call gives without it, bit for bit.

        Counts ``nsteps`` on the ``steps`` counter; the first call emits
        ``kernel_tier``."""
        dt = dt if dt is not None else self.dt
        nsteps = int(nsteps)
        _metrics.counter("steps").inc(nsteps)
        self._emit_tier("multi_step")
        state = self._multi_step_impl(state, nsteps, t, dt, rhs_args,
                                      rhs_seq)
        if sentinel is None:
            return state
        return state, sentinel.compute_jit(state)

    def _multi_step_impl(self, state, nsteps, t, dt, rhs_args, rhs_seq):
        """:meth:`multi_step`'s launches, without its counter, event and
        sentinel."""
        rhs_args = rhs_args or {}
        nstages = self.num_stages
        seq = {}
        for n, v in (rhs_seq or {}).items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            v = np.asarray(v, dtype=np.float64)
            if v.shape[0] != nsteps * nstages:
                raise ValueError(
                    f"rhs_seq[{n!r}] has {v.shape[0]} entries; need "
                    f"one per stage ({nsteps} steps x {nstages} stages "
                    f"= {nsteps * nstages})")
            seq[n] = v

        def args_at(i):
            """rhs_args for flat stage index ``i``."""
            if not seq:
                return rhs_args
            return {**rhs_args, **{n: float(v[i]) for n, v in seq.items()}}

        if (not self._pair_stages and not self._chunk_depth) \
                or self._A[0] != 0:
            # no cross-boundary fusion possible: sequential steps, each
            # with its own k-carry reset, chunking and pairing within it
            for step in range(nsteps):
                base = step * nstages
                carry = self._run_stages(
                    self.init_carry(state), list(range(nstages)), t, dt,
                    lambda i, base=base: args_at(base + i))
                state = self.extract(carry)
            return state
        # across step boundaries: the stage-0 update multiplies the stale
        # k-carry by A[0] == 0, so skipping the per-step zero reset changes
        # nothing
        flat = [s for _ in range(nsteps) for s in range(nstages)]
        carry = self._run_stages(self.init_carry(state), flat, t, dt,
                                 args_at, cross=True)
        return self.extract(carry)

    def multi_step_fn(self, nsteps):
        """The fused chunk body as a ``(state, t, dt, rhs_args) -> state``
        function: :meth:`multi_step` without ``rhs_seq`` (stages chunked and
        paired across step boundaries), the single-member body of the JAX
        package's ensemble tier. It runs :meth:`multi_step`'s launches, so
        a member advanced through it is bit-equal to one advanced by
        :meth:`multi_step`."""
        nsteps = int(nsteps)

        def fn(state, t, dt, rhs_args):
            return self._multi_step_impl(
                state, nsteps, t, dt if dt is not None else self.dt,
                rhs_args, None)
        return fn

    # -- energy-coupled driver (Friedmann background on the host) -----------
    #
    # The JAX package integrates (a, adot) on traced scalars between kernels,
    # on the device. Here the kernels hand their energy sums to the host
    # (one read of 2F+1 values, or 2(2F+1) for a pair, per launch) and the
    # background advances in Python floats (float64) in exactly the
    # operation order of the JAX package's _combine_esums and
    # _friedmann_stage, so that both packages feed bit-equal scalars to
    # bit-equal sums. No predictor, no stale background.

    def _stage_energy(self, s, carry, t, dt, rhs_args):
        """Like :meth:`stage` (K5 in place of K2), additionally returning
        the raw energy sums of the stage's entry state (:meth:`_esums`)."""
        ins = self._inputs(carry)
        outs = self.launch(self._KERNEL["stage_energy"], ins,
                           self._out_set(ins),
                           self._stage_params(s, dt, rhs_args))
        return self._carry_of(outs), outs[len(ins)]

    def _coupled_pair(self, carry, deferred, params):
        """One K6 launch on a normal or deferred carry; returns the carry
        in the deferred representation and the two energy-sum vectors."""
        ins = self._inputs(carry)
        if deferred:
            # per system the previous pair's field, dfp, kdfp, field carry
            ins = [ins[g + j] for g in range(0, len(ins), 4)
                   for j in (0, 1, 3, 2)]
        name = self._KERNEL["coupled_pair_deferred" if deferred
                            else "coupled_pair"]
        outs = self.launch(name, ins, self._out_set(ins), params)
        n = len(ins)
        return self._carry_of(outs), outs[n], outs[n + 1]

    def _combine_esums(self, es, a, grid_size):
        """Raw energy sums -> (rho, p) with the CURRENT scale factor: the
        arithmetic of ``get_rho_and_p`` on the energy a per-stage driver
        loop reduces after every stage."""
        F = self.F
        es = es.double().tolist()
        inv = 1.0 / (2.0 * a * a * grid_size)
        kin = sum(es[:F]) * inv
        grad = sum(es[F:2 * F]) * inv
        pot = es[2 * F] / grid_size
        return kin + grad + pot, kin - grad / 3.0 - pot

    def _friedmann_stage(self, s, a, adot, ka, kadot, rho, p, dt, mpl):
        """One 2N-storage stage of the expansion ODE (the JAX package's
        ``_friedmann_stage``; ``a**3`` there is ``lax.integer_pow``, i.e.
        ``a * (a * a)``)."""
        addot = 4 * np.pi * (a * a * a) / 3 / mpl**2 * (rho - 3 * p)
        ka = self._A[s] * ka + dt * adot
        kadot = self._A[s] * kadot + dt * addot
        return a + self._B[s] * ka, adot + self._B[s] * kadot, ka, kadot

    def _coupled_impl(self, state, t, dt, a, adot, nsteps, grid_size, mpl):
        """``nsteps`` steps of single-stage energy kernels (K5): each
        stage's entry-state sums feed the matching expansion stage -- the
        arithmetic sequence of the per-stage driver loop."""
        carry = self.init_carry(state)
        ka = kadot = 0.0
        for _ in range(nsteps):
            for s in range(self.num_stages):
                if s == 0:  # fresh expansion k-carry each step
                    ka = kadot = 0.0
                hub = adot / a
                carry, es = self._stage_energy(s, carry, t, dt,
                                               {"a": a, "hubble": hub})
                rho, p = self._combine_esums(es, a, grid_size)
                a, adot, ka, kadot = self._friedmann_stage(
                    s, a, adot, ka, kadot, rho, p, dt, mpl)
        return self.extract(carry), a, adot

    def _coupled_pair_impl(self, state, t, dt, a, adot, nsteps, grid_size,
                           mpl):
        """The pair-fused energy-coupled chunk (K6), exact by deferred
        drag: each pair runs its first stage with exact scalars (and the
        rho-independent ``a2``), leaves the second stage's Hubble drag out
        and emits both stages' entry-state sums; the Friedmann ODE then
        advances through both stages, giving the exact ``hubble2`` the next
        pair (or the finalize) completes the drag with. Pairs cross step
        boundaries (``A[0] == 0``); an odd trailing stage finalizes and runs
        K5. The schedule of the JAX package's ``_coupled_pair_impl``."""
        carry = self.init_carry(state)
        ka = kadot = 0.0
        ns = self.num_stages
        flat = [s for _ in range(nsteps) for s in range(ns)]
        deferred = False
        hubfix = None  # exact hub completing the pending deferred stage
        B2p = 0.0      # that stage's tableau B

        i = 0
        while i < len(flat):
            s = flat[i]
            if s == 0:
                ka = kadot = 0.0
            hub = adot / a
            if i + 1 >= len(flat):
                # odd trailing stage: complete the pending deferred drag,
                # then one exact single-stage energy kernel
                if deferred:
                    carry = self._finalize_deferred(carry, dt, hubfix, B2p)
                    deferred = False
                carry, es = self._stage_energy(s, carry, t, dt,
                                               {"a": a, "hubble": hub})
                rho, p = self._combine_esums(es, a, grid_size)
                a, adot, ka, kadot = self._friedmann_stage(
                    s, a, adot, ka, kadot, rho, p, dt, mpl)
                i += 1
                continue
            s2 = flat[i + 1]
            # a2 never touches rho: computed at launch with the operations
            # of the Friedmann stage below, so the two agree bitwise
            a2 = a + self._B[s] * (self._A[s] * ka + dt * adot)
            params = (dt, a, hub, self._A[s], self._B[s],
                      a2, self._A[s2], self._B[s2])
            if deferred:
                params += (hubfix, B2p)
            carry, es1, es2 = self._coupled_pair(carry, deferred, params)
            deferred = True
            # exact background integration from the true esums
            rho, p = self._combine_esums(es1, a, grid_size)
            a, adot, ka, kadot = self._friedmann_stage(
                s, a, adot, ka, kadot, rho, p, dt, mpl)
            if s2 == 0:
                ka = kadot = 0.0
            hubfix = adot / a  # exact hub entering stage s2
            B2p = self._B[s2]
            rho2, p2 = self._combine_esums(es2, a, grid_size)
            a, adot, ka, kadot = self._friedmann_stage(
                s2, a, adot, ka, kadot, rho2, p2, dt, mpl)
            i += 2
        if deferred:
            carry = self._finalize_deferred(carry, dt, hubfix, B2p)
        return self.extract(carry), a, adot

    def coupled_multi_step(self, state, nsteps, expansion, t=0.0, dt=None,
                           grid_size=None, pair=None, sentinel=None):
        """Advance ``nsteps`` steps with the scale factor evolved
        self-consistently: every stage's entry-state energy, summed inside
        the stage kernel, feeds the matching stage of the Friedmann ODE,
        whose exact ``a`` and ``hubble`` the next stage runs with. The
        counterpart of the JAX package's ``coupled_multi_step``.

        By default (``pair=None``) the chunk runs the deferred-drag
        stage-pair kernels (K6) when :attr:`coupled_pair_available`, else
        the single-stage energy kernel (K5) at every stage; ``pair=False``
        forces K5; ``pair=True`` requires K6 and raises ``RuntimeError``
        when it is unavailable (pairing disabled, ``A[0] != 0`` or a
        potential that reads ``hubble``). Both paths reproduce the
        per-stage driver loop (field stage, expansion stage on the entering
        energy, re-reduce) to rounding.

        :arg expansion: an :class:`~pystella_tpu_torch.Expansion`; provides
            the entry ``(a, adot)`` and is ADVANCED to the chunk end
            (``a``, ``adot``, ``hubble``).
        :arg grid_size: the energy sums' divisor; default the number of
            sites.

        With ``carry_dtype`` the pairs store their carries (``kf``,
        ``kdfp``) in bfloat16 like every other kernel; the finalize leaves
        the velocity carry in the working dtype, and an odd trailing stage
        reads it so (:meth:`_finalize_deferred`).

        On a sharded stepper (``decomp=``) every launch is the padded one
        of its kernel, whose sums come together as :meth:`sum_order` says
        (on one card, the unsharded kernel's bit for bit); the host reads
        them once per launch, as unsharded, and the background advances in
        the same order, so the chunk equals the single-device one where the
        sums do.

        With ``sentinel``, the health vector of the final state is computed
        right after the chunk's last launch, on the same stream, with the
        chunk-end background ``{"a": a, "adot": adot}`` as the sentinel's
        ``aux`` (so invariants such as
        :meth:`~pystella_tpu_torch.Expansion.constraint_residual` see it),
        and ``(state, health_vector)`` is returned; the state is bit for bit
        the one the call gives without it. Counts ``nsteps`` on the
        ``steps`` counter.

        The returned tensors are the stepper's buffers (see the class
        docstring)."""
        dt = _float(dt if dt is not None else self.dt)
        nsteps = int(nsteps)
        if grid_size is None:
            grid_size = float(np.prod(self.grid_shape))
        if pair is None:
            pair = self.coupled_pair_available
        elif pair and not self.coupled_pair_available:
            raise RuntimeError(
                "pair=True but the deferred-drag coupled pair kernels are "
                "unavailable on this stepper (pair_stages=False, A[0] != 0, "
                "or a hubble-referencing potential)")
        _metrics.counter("steps").inc(nsteps)
        impl = self._coupled_pair_impl if pair else self._coupled_impl
        state, a, adot = impl(state, t, dt, float(expansion.a),
                              float(expansion.adot), nsteps,
                              float(grid_size), float(expansion.mpl))
        expansion.a = expansion.dtype.type(a)
        expansion.adot = expansion.dtype.type(adot)
        expansion.hubble = expansion.adot / expansion.a
        if sentinel is None:
            return state
        return state, sentinel.compute_jit(state, {"a": a, "adot": adot})


class FusedPreheatStepper(FusedScalarStepper):
    """Fused stages for the full preheating system: scalar fields plus
    transverse metric perturbations sourced by their anisotropic stress,
    ``h_ij'' = lap h_ij - 2 H h_ij' + 16 pi S_ij``.

    Each stage (and each stage pair) is **one** kernel over both systems:
    the scalar Laplacian, the gradients ``S_ij`` is printed from and the
    tensor Laplacian all read the same f and hij taps. The f -> hij coupling
    is one-way and uses the stage-entry ``f``. The energy sums the coupled
    driver reads cover the scalar sector only (the expansion couples to the
    f energy), as in the JAX package.

    :arg gw_sector: a
        :class:`~pystella_tpu_torch.models.sectors.TensorPerturbationSector`.

    The other arguments are :class:`FusedScalarStepper`'s, ``carry_dtype``
    included: with ``torch.bfloat16`` the tensor carries ``khij``,
    ``kdhijdt`` (``kdhp``) are stored in bfloat16 too, the JAX package's
    512^3-on-one-device configuration; and ``decomp``/``overlap``: the
    windows of the GW kernels take hij (the stage) and hij, dhijdt, khij
    (the pairs; the deferred pair every input) beside the scalar ones.
    States are dicts ``{"f", "dfdt": (F, X, Y, Z), "hij", "dhijdt": (6, X,
    Y, Z)}``.
    """

    _KERNEL = {"stage": "preheat_stage", "pair": "preheat_pair",
               "stage_energy": "preheat_stage_energy",
               "coupled_pair": "preheat_coupled_pair",
               "coupled_pair_deferred": "preheat_coupled_pair_deferred"}
    _SYSTEMS = (("f", "dfdt"), ("hij", "dhijdt"))
    _chunk_supported = False

    def __init__(self, sector, gw_sector, grid_shape, dx, halo_shape=2,
                 tableau=None, dtype=torch.float32, dt=None,
                 pair_stages=True, carry_dtype=None, chunk_stages=None,
                 device=None, decomp=None, overlap=None):
        # set before super().__init__, which builds the kernels
        self.gw_sector = gw_sector
        self.n_hij = gw_sector.hij.shape[0]
        # symbolic anisotropic-stress components S_ij in terms of dfdx
        self._sij = {}
        for i in range(1, 4):
            for j in range(i, 4):
                self._sij[tensor_index(i, j)] = sum(
                    sec.stress_tensor(i, j, drop_trace=True)
                    for sec in gw_sector.sectors)
        self._sij_exprs = [self._sij[c] for c in range(self.n_hij)]
        super().__init__(sector, grid_shape, dx, halo_shape=halo_shape,
                         tableau=tableau, dtype=dtype, dt=dt,
                         pair_stages=pair_stages, carry_dtype=carry_dtype,
                         chunk_stages=chunk_stages, device=device,
                         decomp=decomp, overlap=overlap)
        self._comps = (self.F,) * 4 + (self.n_hij,) * 4
        self._dtypes = self._dtypes * 2
        # the gradient weights exactly as grad_from_taps forms them
        inv_dx = [1.0 / d for d in self.dx]
        coefs = _grad_coefs[self.h]
        self._weights += [coefs[s] * inv_dx[ax] for ax in range(3)
                          for s in range(1, self.h + 1)]

    @property
    def _march_nh(self):
        return self.n_hij

    @property
    def _hubble_free(self):
        exprs = [self._V] + list(self._dvdf) + self._sij_exprs
        return all("hubble" not in _field.field_names(e) for e in exprs)

    # -- plain PyTorch versions (the kernels' arithmetic) --------------------

    def _plain(self, name, ins, params, taps=_stencil.RollTaps):
        sc = self._scalars(dict(zip(_PARAMS[name], params)), ins[0])
        R = taps
        keys = ("f", "dfdt", "kf", "kdfdt", "hij", "dhijdt", "khij",
                "kdhijdt")
        if name in ("preheat_stage", "preheat_stage_energy"):
            f, dfdt, kf, kdf, h, dh, kh, kdh = ins
            energy = name == "preheat_stage_energy"
            outs = self._preheat_body(
                {"f": R(f), "hij": R(h)},
                {"dfdt": dfdt, "kf": kf, "kdfdt": kdf, "dhijdt": dh,
                 "khij": kh, "kdhijdt": kdh}, sc, energy=energy)
            if energy:
                keys += ("esums",)
        elif name == "preheat_pair":
            f, dfdt, kf, kdf, h, dh, kh, kdh = ins
            outs = self._pair_body(
                {"f": R(f), "dfdt": R(dfdt), "kf": R(kf), "hij": R(h),
                 "dhijdt": R(dh), "khij": R(kh)},
                {"kdfdt": kdf, "kdhijdt": kdh}, sc)
        else:
            deferred = name == "preheat_coupled_pair_deferred"
            if deferred:
                names = ("f", "dfp", "kdfp", "kf", "hij", "dhp", "kdhp",
                         "khij")
                taps = {n: R(t) for n, t in zip(names, ins)}
                extras = {}
            else:
                f, dfdt, kf, kdf, h, dh, kh, kdh = ins
                taps = {"f": R(f), "dfdt": R(dfdt), "kf": R(kf),
                        "hij": R(h), "dhijdt": R(dh), "khij": R(kh)}
                extras = {"kdfdt": kdf, "kdhijdt": kdh}
            outs = self._deferred_body(taps, extras, sc, deferred)
            keys = ("f", "dfp", "kf", "kdfp", "hij", "dhp", "khij", "kdhp",
                    "esums1", "esums2")
        return [outs[k] for k in keys]

    @staticmethod
    def _gw_stage(h0, dh0, kh0, kdh0, lap_h, sij, A, B, dt, hub):
        """One 2N-storage tensor-sector stage (the identical arithmetic
        sequence everywhere it appears: single-stage body and both halves
        of the pair body)."""
        kh1 = A * kh0 + dt * dh0
        h1 = h0 + B * kh1
        kdh1 = A * kdh0 + dt * (lap_h - 2 * hub * dh0
                                + 16 * np.pi * sij)
        dh1 = dh0 + B * kdh1
        return h1, dh1, kh1, kdh1

    def _dfdx(self, ftaps_like):
        """The field gradients ``(F, 3, X, Y, Z)`` taken through
        ``ftaps_like`` (raw taps or a composed intermediate field's view),
        in ``grad_from_taps`` order."""
        inv_dx = [1.0 / d for d in self.dx]
        return torch.stack(_stencil.grad_from_taps(
            ftaps_like, _grad_coefs[self.h], inv_dx), dim=1)

    def _sij_at(self, c, dfdx, a, hub, ref):
        """Anisotropic-stress component ``c`` from the gradients, shaped
        like ``ref`` (one component, ``(1, X, Y, Z)``)."""
        v = _field.evaluate(self._sij_exprs[c],
                            {"dfdx": dfdx, "a": a, "hubble": hub})
        return torch.broadcast_to(torch.as_tensor(
            v, dtype=ref.dtype, device=ref.device), ref.shape)

    def _per_component(self, ref, update):
        """The tensor outputs ``(hij, dhijdt, khij, kdhijdt)`` (or their
        deferred counterparts), each ``(n_hij, X, Y, Z)`` like ``ref``,
        from ``update(c)``, which returns the four for component ``c``.
        Every operation is elementwise across components, so taking them
        one at a time changes no value; it keeps the whole-lattice rolls of
        one component alive at a time, not of six (at 512^3 those of all
        six at once would not fit beside the inputs)."""
        outs = [torch.empty_like(ref) for _ in range(4)]
        for c in range(self.n_hij):
            for o, r in zip(outs, update(c)):
                o[c] = r[0]
        return outs

    def _preheat_body(self, taps, extras, scalars, energy=False):
        ftaps, htaps = taps["f"], taps["hij"]

        # scalar-system update from the f taps (inherited body; the
        # expansion couples to the scalar-sector energy only, so the esums
        # come from the f parts)
        souts = self._scalar_body(
            ftaps, {n: extras[n] for n in ("dfdt", "kf", "kdfdt")},
            scalars, energy=energy)

        inv_dx2 = [1.0 / d**2 for d in self.dx]
        lap_coefs = _lap_coefs[self.h]
        dt, a, hub = scalars["dt"], scalars["a"], scalars["hubble"]
        A, B = scalars["A"], scalars["B"]
        dh, kh, kdh = extras["dhijdt"], extras["khij"], extras["kdhijdt"]
        dfdx = self._dfdx(ftaps)

        def update(c):
            th = htaps.component(c)
            h0 = th()
            lap_h = _stencil.lap_from_taps(th, lap_coefs, inv_dx2)
            return self._gw_stage(h0, dh[c:c + 1], kh[c:c + 1],
                                  kdh[c:c + 1], lap_h,
                                  self._sij_at(c, dfdx, a, hub, h0), A, B, dt,
                                  hub)
        h2, dh2, kh2, kdh2 = self._per_component(htaps(), update)
        return {**souts,
                "hij": h2, "dhijdt": dh2, "khij": kh2, "kdhijdt": kdh2}

    def _pair_body(self, taps, extras, scalars):
        """Two consecutive stages of the full scalar+GW system (the
        stage-1 fields are pointwise axpys of the taps, so their Laplacians
        and gradients compose from the same taps)."""
        souts, f1_taps = self._scalar_pair_core(taps, extras, scalars)

        kdh = extras["kdhijdt"]
        inv_dx2 = [1.0 / d**2 for d in self.dx]
        lap_coefs = _lap_coefs[self.h]
        dt = scalars["dt"]
        a1, hub1 = scalars["a1"], scalars["hubble1"]
        A1, B1 = scalars["A1"], scalars["B1"]
        a2, hub2 = scalars["a2"], scalars["hubble2"]
        A2, B2 = scalars["A2"], scalars["B2"]
        dfdx1 = self._dfdx(taps["f"])
        dfdx2 = self._dfdx(f1_taps)

        def update(c):
            th, tdh, tkh = (taps[n].component(c)
                            for n in ("hij", "dhijdt", "khij"))
            # stage 1 (identical arithmetic to _preheat_body)
            h0, dh0 = th(), tdh()
            lap_h = _stencil.lap_from_taps(th, lap_coefs, inv_dx2)
            h1, dh1, kh1, kdh1 = self._gw_stage(
                h0, dh0, tkh(), kdh[c:c + 1], lap_h,
                self._sij_at(c, dfdx1, a1, hub1, h0), A1, B1, dt, hub1)

            h1_taps = self._axpy_taps(th, tkh, tdh, B1, A1, dt, h1)
            lap_h1 = _stencil.lap_from_taps(h1_taps, lap_coefs, inv_dx2)

            # stage 2
            return self._gw_stage(h1, dh1, kh1, kdh1, lap_h1,
                                  self._sij_at(c, dfdx2, a2, hub2, h0), A2, B2,
                                  dt, hub2)
        h2, dh2, kh2, kdh2 = self._per_component(taps["hij"](), update)
        return {**souts,
                "hij": h2, "dhijdt": dh2, "khij": kh2, "kdhijdt": kdh2}

    def _deferred_body(self, taps, extras, scalars, in_deferred):
        """The deferred-drag coupled pair of the full system: the scalar
        core (:meth:`_deferred_pair_core`) and the tensor pair with the
        same deferral (stage 2 without its Hubble drag, ``S_ij2`` without
        ``hubble``)."""
        souts, f1_taps = self._deferred_pair_core(
            taps, extras, scalars, in_deferred)

        inv_dx2 = [1.0 / d**2 for d in self.dx]
        lap_coefs = _lap_coefs[self.h]
        dt = scalars["dt"]
        a1, hub1 = scalars["a1"], scalars["hubble1"]
        A1, B1 = scalars["A1"], scalars["B1"]
        a2 = scalars["a2"]
        A2, B2 = scalars["A2"], scalars["B2"]
        dfdx1 = self._dfdx(taps["f"])
        dfdx2 = self._dfdx(f1_taps)

        def update(c):
            th, tkh = taps["hij"].component(c), taps["khij"].component(c)
            if in_deferred:
                tdhp, tkdhp = (taps[n].component(c) for n in ("dhp", "kdhp"))
                tdh = self._completed_taps(tdhp, tkdhp, dt,
                                           scalars["hubfix"], scalars["B2p"])
                kdh0 = tkdhp() - 2 * dt * scalars["hubfix"] * tdhp()
            else:
                tdh = taps["dhijdt"].component(c)
                kdh0 = extras["kdhijdt"][c:c + 1]

            # tensor stage 1 (exact scalars; identical arithmetic to
            # _preheat_body)
            h0, dh0 = th(), tdh()
            lap_h = _stencil.lap_from_taps(th, lap_coefs, inv_dx2)
            h1, dh1, kh1, kdh1 = self._gw_stage(
                h0, dh0, tkh(), kdh0, lap_h,
                self._sij_at(c, dfdx1, a1, hub1, h0), A1, B1, dt, hub1)

            h1_taps = self._axpy_taps(th, tkh, tdh, B1, A1, dt, h1)
            lap_h1 = _stencil.lap_from_taps(h1_taps, lap_coefs, inv_dx2)

            # tensor stage 2 with the Hubble drag deferred
            kh2 = A2 * kh1 + dt * dh1
            h2 = h1 + B2 * kh2
            kdhp = A2 * kdh1 + dt * (lap_h1 + 16 * np.pi
                                     * self._sij_at(c, dfdx2, a2, None, h0))
            return h2, dh1, kh2, kdhp
        h2, dhp, kh2, kdhp = self._per_component(taps["hij"](), update)
        return {**souts, "hij": h2, "dhp": dhp, "khij": kh2, "kdhp": kdhp}
