"""Relaxation (smoothing) solvers for boundary-value problems L(f) = rho.

PyTorch counterpart of ``pystella_tpu/multigrid/relax.py``. Equations are
specified as there (``lhs_dict`` mapping unknown
:class:`~pystella_tpu_torch.Field`\\ s to ``(lhs, rho)`` pairs), with the
Laplacian appearing *symbolically* as ``Field("lap_<name>")`` and supplied
by the solver from the order-``2h`` centered stencil, so the smoother's
operator is exactly consistent with
:class:`~pystella_tpu_torch.FiniteDifferencer`. The Jacobi/Newton diagonal
is ``diff(lhs, f) + diff(lhs, lap_f) * lap_diag`` where
``lap_diag = sum_d c_0 / dx_d**2`` is the stencil's centre weight.

On a CUDA device a sweep, a residual and a FAS coarse right-hand side are
each one launch of a hand-written kernel (``ops/csrc/mg_relax.cu``, K11:
the JAX package's ``RelaxationBase._pallas_level`` body; an x-march of a
shared-memory y-z tile, or one thread a site on the small levels:
:func:`mg_tile`), compiled against
a header that :func:`~pystella_tpu_torch.ops.codegen.relax_header` prints
from the solver's expression trees; ``smooth(nu)`` is ``nu`` launches that
ping-pong two sets of arrays, with no host sync between them. The kernel
wraps periodically by index arithmetic, so it takes every level down to
``2**3``: there is no fallback tier. Beside it sits the plain PyTorch
version (:meth:`RelaxationBase.plain`): the same Laplacian
(``lap_from_taps`` on periodic rolls) and the same symbolic update through
:func:`~pystella_tpu_torch.field.evaluate`. A launch wrapper runs the
kernel for CUDA tensors and the plain version for CPU tensors; it never
substitutes one for the other. Kernel and plain version round every
operation alike (``-fmad=false``), in the same order.

With ``decomp=`` (a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`)
a level whose :class:`LevelSpec` is ``sharded`` holds its arrays as
:class:`~pystella_tpu_torch.parallel.ShardedArray` s, and every sweep,
residual and coarse right-hand side runs once per block, as the JAX
package's ``_pallas_level`` runs them under ``shard_map``. Each sweep
exchanges the halos anew (the JAX ``fori_loop`` of ``pad_with_halos`` and
the kernel): on an ``(px, py, 1)`` mesh the unknowns are copied into a
padded window per block (``pad_into``) and the kernel reads it
(``mg_<kind>:xpad``, ``:ypad``, ``:xypad``: the halo-input kernel
``StreamingStencil._build_xhalo``); on an x-only mesh with the overlap on
(``overlap=``; by default on the large blocks only) an interior launch on
the raw block runs while the x shells are copied on the side stream, then
two shell launches (``:interior``, ``:shell``: ``OverlapStreamingStencil``),
each writing its rows of the full output block in place. Each block's
launches run on its own device. On the CPU the
plain version runs per block on the same windows. On a mesh that shards z
the plain version runs per block on the device on windows padded along
every sharded axis, as the JAX package runs its XLA halo tier there
(relax.py:310-314): :meth:`RelaxationBase.level_tier` names the tier,
chosen by the mesh before any launch. Every sharded result equals the
whole lattice's bit for bit (the same taps, the same update).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
from torch.profiler import record_function

from pystella_tpu_torch import field as _field
from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.field import Field, Var, diff, evaluate
from pystella_tpu_torch.ops import codegen as _codegen
from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.ops.derivs import (
    PAD_KINDS, SecondCenteredDifference)
from pystella_tpu_torch.parallel import overlap as _overlap
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["LevelSpec", "RelaxationBase", "JacobiIterator", "NewtonIterator",
           "LAUNCHES", "reset_launch_counts", "KERNELS",
           "AUTO_OVERLAP_MIN_SITES"]

_SOURCE = "mg_relax.cu"
_JAX_SITE = ("pystella_tpu/multigrid/relax.py:289 "
             "(RelaxationBase._pallas_level, body :324, kind")
#: kernel name -> (CUDA source in ops/csrc, the Pallas body it replaces)
KERNELS = {f"mg_{kind}": (_SOURCE, f'{_JAX_SITE} "{kind}")')
           for kind in ("smooth", "residual", "tau")}

_XHALO_SITE = ("pystella_tpu/ops/pallas_stencil.py:789 (StreamingStencil."
               "_build_xhalo, call :840")
_OVERLAP_SITE = ("pystella_tpu/ops/pallas_stencil.py:993 ("
                 "OverlapStreamingStencil.__call__, class :931")
#: the sharded levels' launches, counted apart as ``<kernel>:<kind>`` (the
#: kinds of ops/derivs.py's ``PAD_KINDS``) -> (CUDA source, the TPU kernel
#: it replaces: the halo-input builder, or the overlapped launch, on the
#: body of multigrid/relax.py:324, as relax.py:366-402 runs it)
SHARDED_KERNELS = {
    f"{name}:{kind}": (_SOURCE, (_OVERLAP_SITE if kind in (
        "interior", "shell") else _XHALO_SITE)
        + f"; body {name}, multigrid/relax.py:366-402)")
    for name in KERNELS for kind in PAD_KINDS}

#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel (once per sweep and block), and nowhere
#: else
LAUNCHES = {name: 0 for name in list(KERNELS) + list(SHARDED_KERNELS)}

#: the smallest block, in sites, on which ``overlap=None`` (auto) splits a
#: sweep into interior and shells. The split saves the padded launch's
#: centre copy but makes three launches and a side-stream hand-off where
#: that makes one launch; below this size a sweep's device time is shorter
#: than the host needs to issue them, so the split only adds host time.
#: At 2**24 the 512^3 lattice's blocks on (2, 1, 1) and (4, 1, 1) split
#: and its coarser levels do not (PERF.md, PR 9: overlapping every level
#: of that cycle made it slower than the padded one).
AUTO_OVERLAP_MIN_SITES = 2**24

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the entry point of each padding (interior and shell: the x-padded one)
_PAD_SUFFIX = {1: "_xpad", 2: "_ypad", 3: "_xypad"}

#: the sweeps' x-march (mg_relax.cu: MgTile, MG_MARCH_LX, MG_MARCH_AHEAD,
#: MG_MARCH_MIN_SITES): the x planes a block covers, whether its next
#: plane's loads go a step ahead, and the fewest sites of a region on which
#: a launch marches (a smaller one -- a level of 128^3 or less, a shell --
#: runs the per-site kernel, faster there on an H100)
MG_LX = 32
MG_AHEAD = 1
MG_MIN_SITES = 2**22
#: the most static shared memory a block may declare
_STATIC_SMEM = 48 * 1024


def mg_tile(h, itemsize, nf, shape=None, lx=None):
    """The sweeps' x-march tile at stencil radius ``h`` for ``nf``
    unknowns of ``itemsize`` bytes: ``(lx, bytes)`` -- the x planes a block
    marches and its static shared memory, one 32 x 8 tile's centre plane
    with its y-z halo per unknown, ``nf (8 + 2h) (32 + 2h)`` elements (the
    +-x taps live in registers) -- or None where those planes do not fit
    the 48 KB a block may declare statically, or where a launch over a
    region of ``shape`` ``(X, Y, Z)`` runs the per-site kernel instead
    (fewer than :data:`MG_MIN_SITES` sites). ``lx`` defaults to the
    source's constant."""
    nbytes = nf * (8 + 2 * h) * (32 + 2 * h) * itemsize
    if nbytes > _STATIC_SMEM or (
            shape is not None and math.prod(shape) < MG_MIN_SITES):
        return None
    return (MG_LX if lx is None else lx), nbytes


def reported_mg_tile(query, dtype):
    """What a library's ``pk_mg_tile`` entry point ``query`` reports for
    working type ``dtype``: ``(lx, bytes, min_sites, ahead)``, bytes 0
    where the per-site kernel runs every launch."""
    query.argtypes = [ctypes.c_int, ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    query(int(dtype == torch.float64), out)
    return tuple(out)


def bind_kernels(lib):
    """The sweep entry points of a loaded mg_relax library, typed:
    ``{(kernel name, dtype, padding bits): C function}``."""
    fns = {}
    # f, rho, aux, out pointer arrays, X, Y, Z, params, [Yw], stream
    base = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for name in KERNELS:
        for dtype, suffix in _SUFFIX.items():
            for bits, psuffix in [(0, "")] + list(_PAD_SUFFIX.items()):
                fn = getattr(lib, f"{name}_{suffix}{psuffix}")
                fn.argtypes = base + ([ctypes.c_int] if bits else []) + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[name, dtype, bits] = fn
    return fns


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Geometry of one multigrid level: global lattice shape, spacing, and
    whether its arrays are sharded over the solver's decomposition
    (:class:`~pystella_tpu_torch.parallel.ShardedArray` s, one block per
    rank) or held whole on its first device (a replicated level: the
    coarse levels whose blocks would drop below the halo, and every level
    without a decomposition)."""

    grid_shape: tuple
    dx: tuple
    sharded: bool = False


def _field_name(f):
    if isinstance(f, _field.Field):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError(f"lhs_dict keys must be Field or str, got {type(f)}")


def _residual_norms(rn):
    """(Linf, L2) norms of a residual, as 0-d tensors on its device."""
    return torch.max(torch.abs(rn)), torch.sqrt(torch.mean(rn * rn))


class RelaxationBase:
    """Base class for relaxation solvers.

    :arg lhs_dict: dict ``{Field(f): (lhs, rho)}``; ``lhs`` is a symbolic
        expression in ``Field(f)``, ``Field("lap_" + f)`` and any auxiliary
        names; ``rho`` must be a :class:`~pystella_tpu_torch.Field`.
    :arg halo_shape: stencil radius ``h`` of the order-``2h`` Laplacian.
    :arg omega: relaxation damping factor (``fixed_parameters=dict(omega=
        ...)`` is also accepted).
    :arg dtype: when given, every array a call receives is cast to it.
    :arg smoother: ``"kernel"`` (the default on a CUDA device: the
        hand-written sweep kernels; a kernel that does not build or launch
        raises) or ``"plain"`` (the default on the CPU: the plain PyTorch
        version, which the card runs only when named here).
    :arg device: ``None`` (the GPU), ``"cuda"`` or ``"cpu"``; every array a
        call receives is placed there. With a ``decomp``, its devices
        (``device`` may name their type): replicated levels live on its
        first.
    :arg decomp: a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`
        over which sharded levels (``LevelSpec.sharded``) hold their arrays.
        The JAX package takes it as the first positional argument; the
        port keeps ``lhs_dict`` first, as its single-device signature has
        it, and takes ``decomp`` by keyword, as ``FiniteDifferencer`` and
        the fused steppers do.
    :arg overlap: the interior/shell split on x-sharded levels:
        ``True`` on every level where the split exists, ``False`` never;
        ``None`` reads ``PYSTELLA_HALO_OVERLAP`` (``1``/``0`` as ``True``/
        ``False``) and is otherwise auto: the split on blocks of at least
        :data:`AUTO_OVERLAP_MIN_SITES` sites, the padded launch on smaller
        ones, whose sweeps the host paces (:meth:`level_kinds`). Where no
        split exists (a y-sharded mesh, a block thinner than ``3h`` along
        x) the padded launch runs, as in the JAX package.
    """

    def __init__(self, lhs_dict, halo_shape=1, omega=1.0, dtype=None,
                 smoother=None, device=None, decomp=None, overlap=None,
                 **kwargs):
        self.decomp = decomp
        if decomp is not None:
            types = {d.type for d in decomp.devices}
            if len(types) != 1 or (device is not None and torch.device(
                    device).type not in types):
                raise ValueError(
                    f"the decomposition's devices {decomp.devices} are not "
                    f"all of one type{'' if device is None else ' ' + str(device)}")
            device = decomp.devices[0]
        self.device = resolve_device(device)
        if overlap is None:
            overlap = _overlap.env_setting()
        #: True, False, or None: auto (:meth:`level_kinds`)
        self.overlap = None if overlap is None else bool(overlap)
        self.halo_shape = int(halo_shape)
        self.omega = float(kwargs.pop("fixed_parameters", {}).get(
            "omega", omega))
        self.dtype = None if dtype is None else torch_dtype(dtype)
        if smoother is None:
            smoother = "kernel" if self.device.type == "cuda" else "plain"
        if smoother not in ("kernel", "plain"):
            raise ValueError(f"unknown smoother {smoother}")
        self.smoother = smoother
        self.stencil = SecondCenteredDifference(self.halo_shape)

        self.f_to_rho_dict = {}
        self.step_exprs = {}
        self.resid_exprs = {}
        self.lhs_exprs = {}
        for f, (lhs, rho) in lhs_dict.items():
            name = _field_name(f)
            if not isinstance(rho, _field.Field):
                raise TypeError("rho must be a Field naming the source array")
            self.f_to_rho_dict[name] = rho.name
            fsym = f if isinstance(f, _field.Field) else Field(name)
            self.step_exprs[name] = self.step_operator(fsym, lhs, rho)
            self.resid_exprs[name] = rho - lhs
            self.lhs_exprs[name] = lhs
        #: aux routing -> {(kind, dtype, padding bits): C entry point},
        #: built at first use
        self._libs = {}
        known = {"omega", "_lap_diag", *self.f_to_rho_dict.values()}
        for name in self.f_to_rho_dict:
            known |= {name, "lap_" + name}
        #: names the equations read besides the unknowns: auxiliary inputs,
        #: whose routing (lattice or scalar) only a call's arrays tell
        self.aux_names = sorted(set().union(*(
            _field.field_names(e) for e in self.step_exprs.values())) - known)
        if (self.device.type == "cuda" and self.smoother == "kernel"
                and not self.aux_names):
            self.build_kernels()

    # -- subclass hook ------------------------------------------------------

    def step_operator(self, f, lhs, rho):
        """Symbolic relaxation update for unknown ``f``."""
        raise NotImplementedError

    def _diagonal(self, f, lhs):
        """d lhs / d f including the Laplacian's centre weight."""
        lap = Field("lap_" + f.name)
        return diff(lhs, f) + diff(lhs, lap) * Var("_lap_diag")

    def _lap_diag(self, dx):
        return float(sum(self.stencil.coefs[0] / d ** 2 for d in dx))

    def _lap_weights(self, dx):
        """The Laplacian weights exactly as ``lap_from_taps`` forms them."""
        coefs = self.stencil.coefs
        inv_dx2 = [1.0 / d**2 for d in dx]
        return ([coefs[0] * sum(inv_dx2)]
                + [coefs[s] * inv_dx2[ax] for ax in range(3)
                   for s in range(1, self.halo_shape + 1)])

    # -- arrays in ------------------------------------------------------------

    def _place(self, level, v):
        """A lattice value (numpy, a tensor or a :class:`ShardedArray`) as
        the level holds it, in ``dtype`` when one was given: sharded over
        the decomposition on a sharded level, else one tensor on the
        solver's device (a :class:`ShardedArray` assembled there device to
        device). Python numbers stay as they are."""
        if isinstance(v, (int, float)):
            return v
        if level is not None and level.sharded:
            if self.decomp is None:
                raise ValueError("a sharded level needs the solver's "
                                 "decomposition (decomp=)")
            v = self.decomp.shard(v)
            if v.decomp is not self.decomp:
                raise ValueError("the array is sharded over another "
                                 "decomposition than the solver's")
            if self.dtype is not None and v.dtype != self.dtype:
                v = v.map(lambda b: b.to(self.dtype))
            return v
        if isinstance(v, ShardedArray):
            v = v.decomp.unshard(v, self.device)
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _cast(self, arrays, level=None):
        """Arrays (numpy, tensors or :class:`ShardedArray` s) as ``level``
        holds them (:meth:`_place`; without a level, tensors on the
        solver's device)."""
        return {k: self._place(level, v) for k, v in arrays.items()}

    def _aux_struct(self, aux):
        """Static routing of auxiliary values: lattice-shaped arrays are
        read per site, scalars ride the launch parameters."""
        struct = []
        for k in sorted(aux):
            ndim = getattr(aux[k], "ndim", 0)
            struct.append((k, "lattice" if ndim >= 3 else "scalar"))
        return tuple(struct)

    def _operands(self, level, fs, rhos, aux):
        """The operands of a sweep in kernel order: the unknowns, their
        sources and the lattice aux arrays as contiguous ``(X, Y, Z)``
        tensors (blocks, on a sharded level: one list per rank) of one
        dtype on one device, and the aux scalars as given."""
        names = list(self.f_to_rho_dict)
        ref = fs[names[0]]
        if ref.dtype not in _SUFFIX:
            raise TypeError("the multigrid solvers take float32 or float64")
        shape = tuple(level.grid_shape)

        def lattice(v, what):
            if level.sharded:
                if not isinstance(v, ShardedArray) or \
                        v.decomp is not self.decomp:
                    raise ValueError(f"{what} is not sharded over the "
                                     "solver's decomposition")
                if tuple(v.shape) != shape:
                    raise ValueError(f"{what} is {v}; the level's lattice "
                                     f"is {shape}")
                return [b.to(ref.dtype).contiguous() for b in v.blocks]
            v = torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
            if tuple(v.shape) != shape:
                raise ValueError(f"{what} has shape {tuple(v.shape)}; the "
                                 f"level's lattice is {shape}")
            return v.contiguous()

        struct = self._aux_struct(aux)
        f_list = [lattice(fs[n], n) for n in names]
        rho_list = [lattice(rhos[self.f_to_rho_dict[n]],
                            self.f_to_rho_dict[n]) for n in names]
        aux_lat = {k: lattice(aux[k], k) for k, kk in struct
                   if kk == "lattice"}
        aux_scal = {k: aux[k] for k, kk in struct if kk == "scalar"}
        return names, f_list, rho_list, aux_lat, aux_scal, struct

    # -- the kernel ---------------------------------------------------------

    def kernel_header(self, aux_struct=()):
        """The generated C header the sweep kernels are compiled against,
        for auxiliary values routed as ``aux_struct``."""
        names = list(self.f_to_rho_dict)
        return _codegen.relax_header(
            names, [self.f_to_rho_dict[n] for n in names], self.step_exprs,
            self.resid_exprs, self.lhs_exprs, self.halo_shape,
            aux_lattice=[k for k, kk in aux_struct if kk == "lattice"],
            aux_scalar=[k for k, kk in aux_struct if kk == "scalar"])

    def build_kernels(self, aux_struct=()):
        """Compile (or load from the build cache) the three sweep kernels
        of this solver's equations, unpadded and padded along x, y or
        both, for float32 and float64; raises if ``nvcc`` fails."""
        fns = self._libs.get(aux_struct)
        if fns is None:
            lib = _stencil.build_kernels(
                [_SOURCE], self.kernel_header(aux_struct))[_SOURCE]
            self.check_tile(lib)
            fns = self._libs[aux_struct] = bind_kernels(lib)
        return fns

    def check_tile(self, lib, lx=None, ahead=None, min_sites=None):
        """Raise unless the march tile a built library reports
        (``pk_mg_tile``) is the one :func:`mg_tile` predicts for these
        equations in both dtypes (at run length ``lx``, look-ahead
        ``ahead`` and site threshold ``min_sites`` when given; the
        source's constants by default)."""
        nf = len(self.f_to_rho_dict)
        for dtype in _SUFFIX:
            tile = mg_tile(self.halo_shape, dtype.itemsize, nf, lx=lx)
            want = (MG_LX if lx is None else lx,
                    tile[1] if tile else 0,
                    MG_MIN_SITES if min_sites is None else min_sites,
                    MG_AHEAD if ahead is None else ahead)
            got = reported_mg_tile(lib.pk_mg_tile, dtype)
            if got != want:
                raise RuntimeError(
                    f"mg_relax.cu instantiates the march tile {got} for "
                    f"{dtype}; multigrid/relax.py:mg_tile predicts {want}")

    def _launcher(self, kind, level, ref, aux_scal, struct, hz=None):
        """``bind(wins, rhos, auxs, outs, pad=None, x0=0)``: a call of no
        arguments that makes one launch of ``mg_<kind>`` on ``level`` on
        ``ref``'s device, counted under ``mg_<kind>[:<pad>]``
        (:data:`LAUNCHES`), or runs its plain version on CPU tensors, or,
        with ``hz`` given (the plain tier, on any device), the plain
        version on windows also padded by ``hz`` rows along z. Its
        arguments are fixed when it is bound, so a smoother binds each
        ping-pong step once and calls it for every sweep; operands on
        another device than ``ref``'s are refused there. ``wins`` are the
        unknowns' windows, ``(X + 2 hx, Y + 2 hy, Z + 2 hz)`` with ``hx``
        (``hy``) the radius where the launch kind ``pad`` pads x (y), else
        0 (the padded blocks, or for the overlapped path the raw blocks
        and the ``(3h, Y, Z)`` shell inputs); ``rhos``, ``auxs`` (the
        lattice aux arrays in routing order) and ``outs`` are full blocks;
        the launch computes the ``(X, Y, Z)`` region of ``outs`` from x row
        ``x0`` on."""
        name = f"mg_{kind}"
        h = self.halo_shape
        dev = ref.device

        def radii(pad, tensors):
            """``(hx, hy)`` of launch kind ``pad``, once the operands are
            found on the launcher's device."""
            others = {t.device for t in tensors} - {dev}
            if others:
                raise ValueError(f"{name} is bound on {dev}; operands on "
                                 f"{sorted(map(str, others))}")
            bits = PAD_KINDS[pad] if pad else 0
            return (h if bits & 1 else 0), (h if bits & 2 else 0)

        if dev.type == "cpu" or hz is not None:
            lattice = [k for k, kk in struct if kk == "lattice"]

            def bind(wins, rhos, auxs, outs, pad=None, x0=0):
                hx, hy = radii(pad, [*wins, *rhos, *auxs, *outs])
                X = wins[0].shape[0] - 2 * hx

                def run():
                    res = self.plain(
                        kind, level, wins, [r.narrow(0, x0, X) for r in rhos],
                        {k: a.narrow(0, x0, X) for k, a in zip(lattice, auxs)},
                        aux_scal, pad=(hx, hy, hz or 0))
                    for o, r in zip(outs, res):
                        o.narrow(0, x0, X).copy_(r)
                    return outs
                return run
            return bind
        if dev.type != "cuda":
            raise ValueError(f"no multigrid kernel for device {dev}")
        fns = self.build_kernels(struct)
        params = ([self.omega, self._lap_diag(level.dx)]
                  + self._lap_weights(level.dx)
                  + [float(v) for v in aux_scal.values()])
        prm = (ctypes.c_double * len(params))(*params)
        item = ref.element_size()
        nptr = ctypes.c_void_p * len(self.f_to_rho_dict)
        naux = ctypes.c_void_p * max(1, sum(kk == "lattice"
                                            for _, kk in struct))

        def bind(wins, rhos, auxs, outs, pad=None, x0=0):
            hx, hy = radii(pad, [*wins, *rhos, *auxs, *outs])
            bits = PAD_KINDS[pad] if pad else 0
            Xw, Yw, Z = wins[0].shape
            X, Y = Xw - 2 * hx, Yw - 2 * hy
            if X > 65535 or (Y + 7) // 8 > 65535:
                raise ValueError(f"region {(X, Y, Z)} exceeds the kernels' "
                                 "launch grid")
            woff = (hx * Yw + hy) * Z * item
            boff = x0 * Y * Z * item
            fn = fns[name, ref.dtype, bits]
            label = name + (f":{pad}" if pad else "")
            args = (nptr(*(w.data_ptr() + woff for w in wins)),
                    nptr(*(r.data_ptr() + boff for r in rhos)),
                    naux(*(a.data_ptr() + boff for a in auxs)),
                    nptr(*(o.data_ptr() + boff for o in outs)),
                    X, Y, Z, prm, *((Yw,) if bits else ()),
                    torch.cuda.current_stream(dev).cuda_stream)

            def run():
                if dev.index != torch.cuda.current_device():
                    with torch.cuda.device(dev):
                        rc = fn(*args)
                else:
                    rc = fn(*args)
                if rc != 0:
                    raise RuntimeError(f"{label} kernel launch failed with "
                                       f"CUDA error {rc}")
                LAUNCHES[label] += 1
                return outs
            return run
        return bind

    def launch(self, kind, level, fs, rhos, aux, iterations=1):
        """Kernel ``mg_<kind>`` (``"smooth"``, ``"residual"``, ``"tau"``) on
        CUDA tensors, counting each launch, or its plain version on CPU
        tensors. ``smooth`` runs ``iterations`` sweeps, each launch writing
        the set of arrays the next one reads; for ``tau`` ``rhos`` holds
        the restricted residuals under the rho names. On a sharded level
        each sweep exchanges the halos and launches per block
        (:meth:`level_tier`). Returns the list of outputs, one per unknown,
        as new tensors (:class:`ShardedArray` s on a sharded level)."""
        name = f"mg_{kind}"
        if name not in KERNELS:
            raise ValueError(f"unknown kind {kind}")
        names, f_list, rho_list, aux_lat, aux_scal, struct = self._operands(
            level, fs, rhos, aux)
        nu = int(iterations) if kind == "smooth" else 1
        if level.sharded:
            out = self._sweeps(kind, level, f_list, rho_list, aux_lat,
                               aux_scal, struct, nu)
            return [ShardedArray(b, self.decomp) for b in out]
        # the whole lattice as the one block
        out = self._sweeps(kind, level, [[f] for f in f_list],
                           [[r] for r in rho_list],
                           {k: [a] for k, a in aux_lat.items()}, aux_scal,
                           struct, nu)
        return [b[0] for b in out]

    def launch_block(self, kind, level, wins, rhos, aux, outs, pad=None,
                     x0=0):
        """One launch of ``mg_<kind>`` on one block (``pad`` a launch kind
        of :data:`SHARDED_KERNELS`, ``None``: the unsharded kernel on the
        whole of ``wins``): ``wins`` the unknowns' windows (a list of ``(X
        + 2 hx, Y + 2 hy, Z)`` tensors, ``hx`` and ``hy`` the radius along
        the axes ``pad`` pads), ``rhos`` (under the unknowns' order), the
        lattice values of ``aux`` and ``outs`` full blocks; the launch
        writes the ``(X, Y, Z)`` region of ``outs`` from x row ``x0`` on.
        The kernel on CUDA tensors (counted), the plain version on CPU
        tensors. Returns ``outs``."""
        if f"mg_{kind}" not in KERNELS:
            raise ValueError(f"unknown kind {kind}")
        bits = PAD_KINDS[pad] if pad else 0
        h = self.halo_shape
        hx, hy = (h if bits & 1 else 0), (h if bits & 2 else 0)
        nf = len(self.f_to_rho_dict)
        struct = self._aux_struct(aux)
        auxs = [aux[k] for k, kk in struct if kk == "lattice"]
        aux_scal = {k: aux[k] for k, kk in struct if kk == "scalar"}
        ref = wins[0]
        Xw, Yw, Z = ref.shape
        X, Y = Xw - 2 * hx, Yw - 2 * hy
        block = tuple(outs[0].shape)
        tensors = list(wins) + list(rhos) + auxs + list(outs)
        if (len(wins) != nf or len(rhos) != nf or len(outs) != nf
                or X < 1 or x0 < 0 or x0 + X > block[0]
                or block[1:] != (Y, Z) or ref.dtype not in _SUFFIX
                or any(tuple(w.shape) != (Xw, Yw, Z) for w in wins)
                or any(tuple(t.shape) != block
                       for t in list(rhos) + auxs + list(outs))
                or any(t.dtype != ref.dtype or t.device != ref.device
                       or not t.is_contiguous() for t in tensors)):
            raise ValueError(
                f"windows {[tuple(w.shape) for w in wins]} and blocks "
                f"{[tuple(t.shape) for t in list(rhos) + auxs + list(outs)]}"
                f" do not hold the region of {X} x rows from row {x0} of "
                f"mg_{kind} ({pad or 'unpadded'}) for {nf} unknowns")
        level = LevelSpec(block, tuple(level.dx), False)
        return self._launcher(kind, level, ref, aux_scal, struct)(
            wins, rhos, auxs, outs, pad, x0)()

    # -- the sharded levels -------------------------------------------------

    def level_tier(self, level):
        """How a sweep on ``level`` runs: ``"kernel"`` or ``"plain"`` on a
        replicated level (the solver's smoother); on a sharded one
        ``"kernel:<kinds>"`` (the launches per block, :meth:`level_kinds`:
        ``xpad``, ``ypad``, ``xypad``, or ``interior+shell``; on the CPU
        their plain versions on the same windows) or ``"plain:halo"`` (the
        plain version per block on windows padded along every sharded axis:
        a mesh that shards z, as the JAX package's XLA halo tier there, or
        ``smoother="plain"``). Decided by the mesh and the block, before
        any launch."""
        if not level.sharded:
            return self.smoother
        if self.decomp.proc_shape[2] > 1 or self.smoother == "plain":
            return "plain:halo"
        return "kernel:" + "+".join(k or "unpadded"
                                    for k in self.level_kinds(level))

    def level_kinds(self, level):
        """The launches one sweep makes per block of the sharded ``level``,
        by kind (:func:`~pystella_tpu_torch.ops.stencil.launch_kinds`):
        the interior and two shells where the overlap is on and the split
        exists, else the padded launch. With ``overlap=None`` (auto) the
        split is taken on blocks of at least :data:`AUTO_OVERLAP_MIN_SITES`
        sites only."""
        d = self.decomp
        block = d.rank_shape(level.grid_shape)
        split = self.overlap
        if split is None:
            split = math.prod(block) >= AUTO_OVERLAP_MIN_SITES
        return _stencil.launch_kinds(d, self.halo_shape, block, split)

    def _sweeps(self, kind, level, f_list, rho_list, aux_lat, aux_scal,
                struct, nu):
        """``nu`` sweeps (or one residual, one tau) on the blocks of
        ``f_list`` (one list of blocks per unknown: a block per rank on a
        sharded level, the whole lattice as the one block on another): per
        sweep the halo exchange of a sharded level, then a launch per block
        (or the plain version per block, :meth:`level_tier`), each bound
        on its block's device. The exchanges and launches between the
        inputs and the two ping-pong sets of output blocks are built once
        (:class:`~pystella_tpu_torch.parallel.decomp.HaloPlan`, bound
        launches) and run for every sweep. Returns one list of blocks per
        unknown: the set the last sweep wrote."""
        d = self.decomp
        nf, R = len(f_list), len(f_list[0])
        if nu == 0:
            return f_list
        h = self.halo_shape
        block = tuple(f_list[0][0].shape)
        # per rank: the unknowns' blocks, sources and lattice aux arrays;
        # the sweeps read the inputs, then the two sets in turn
        rhos = [[b[r] for b in rho_list] for r in range(R)]
        auxs = [[b[r] for b in aux_lat.values()] for r in range(R)]
        srcs = [[[f[r] for f in f_list] for r in range(R)]] + [
            [[torch.empty_like(f[r]) for f in f_list] for r in range(R)]
            for _ in range(min(nu, 2))]
        # sweep k reads srcs[order[k]] and writes srcs[order[k + 1]]
        order = [0] + [1 + k % 2 for k in range(nu)]

        halo, hz, kinds = (0, 0, 0), None, {None: 1}
        if level.sharded:
            if self.level_tier(level) == "plain:halo":
                # the plain version on windows padded along every sharded
                # axis
                hz = h if d.proc_shape[2] > 1 else 0
                kinds = _stencil.launch_kinds(d, h, block, False)
            else:
                kinds = self.level_kinds(level)
            halo = _stencil.sharded_halo(h, *d.proc_shape[:2])[:2] + (
                hz or 0,)
        binds = [self._launcher(kind, level, f_list[0][r], aux_scal, struct,
                                hz) for r in range(R)]
        if "interior" in kinds:
            return self._overlapped(srcs, order, rhos, auxs, binds)
        (pad,) = kinds
        if any(halo):
            shape = tuple(n + 2 * w for n, w in zip(block, halo))
            padded = [[b.new_empty(shape) for b in srcs[0][r]]
                      for r in range(R)]
        steps = {}
        for k in range(nu):
            a, b = order[k], order[k + 1]
            if (a, b) not in steps:
                plans, wins = [], srcs[a]
                if any(halo):
                    plans = [d.pad_plan([s[i] for s in srcs[a]],
                                        [w[i] for w in padded], halo)
                             for i in range(nf)]
                    wins = padded
                steps[a, b] = plans, [
                    binds[r](wins[r], rhos[r], auxs[r], srcs[b][r], pad)
                    for r in range(R)]
            plans, runs = steps[a, b]
            for plan in plans:
                plan()
            for run in runs:
                run()
        return [[s[i] for s in srcs[order[-1]]] for i in range(nf)]

    def _overlapped(self, srcs, order, rhos, auxs, binds):
        """The sweeps of :meth:`_sweeps` on the overlapped path: per sweep
        the x shells' inputs copied on the side stream while the interior
        launches run on the raw blocks, then the two shell launches of
        every block, each writing its rows of the output block in
        place."""
        d = self.decomp
        h, R, nf = self.halo_shape, d.nshards, len(srcs[0][0])
        block = tuple(srcs[0][0][0].shape)
        X = block[0]
        slab = (3 * h,) + block[1:]
        lows = [[b.new_empty(slab) for b in srcs[0][r]] for r in range(R)]
        highs = [[b.new_empty(slab) for b in srcs[0][r]] for r in range(R)]
        ex = d.side_exchange([b for src in srcs for s in src for b in s],
                             [b for s in lows + highs for b in s])
        steps = {}
        for k in range(len(order) - 1):
            a, b = order[k], order[k + 1]
            if (a, b) not in steps:
                steps[a, b] = (
                    [d.x_shells_plan([s[i] for s in srcs[a]],
                                     [lo[i] for lo in lows],
                                     [hi[i] for hi in highs], h)
                     for i in range(nf)],
                    [binds[r](srcs[a][r], rhos[r], auxs[r], srcs[b][r],
                              "interior", h) for r in range(R)],
                    [binds[r](side[r], rhos[r], auxs[r], srcs[b][r],
                              "shell", x0) for r in range(R)
                     for side, x0 in ((lows, 0), (highs, X - h))])
            plans, interiors, shells = steps[a, b]
            with record_function("halo_overlap"):
                with ex:
                    for plan in plans:
                        plan()
                with record_function("halo_overlap_interior"):
                    for run in interiors:
                        run()
                ex.wait()
                with record_function("halo_overlap_shells"):
                    for run in shells:
                        run()
        return [[s[i] for s in srcs[order[-1]]] for i in range(nf)]

    # -- the plain PyTorch version ------------------------------------------

    def plain(self, kind, level, f_list, rho_list, aux_lat, aux_scal,
              iterations=1, pad=None):
        """The kernels' plain version (any device): per sweep the
        Laplacian of the stacked unknowns from periodic rolls in
        ``lap_from_taps`` order, then every unknown's update evaluated
        from the OLD values of all of them. ``omega`` enters as a Python
        float and ``_lap_diag`` as a 0-d float64 tensor on the arrays'
        device: arithmetic among them stays in double and meets a lattice
        value in its type, as in the kernel, and a division by such a
        diagonal is a division (PyTorch's CUDA division by a Python scalar
        multiplies by the reciprocal instead: one rounding more than the
        kernel's). The aux scalars are 0-d tensors of the working dtype
        (the kernel takes them as ``T``). With ``pad = (hx, hy[, hz])``
        the unknowns are windows padded by that many rows along x, y (and
        z) (:class:`~pystella_tpu_torch.ops.stencil.PaddedTaps`), the
        other arrays the region they compute, and one sweep runs."""
        names = list(self.f_to_rho_dict)
        exprs = {"smooth": self.step_exprs, "residual": self.resid_exprs,
                 "tau": self.lhs_exprs}[kind]
        coefs = self.stencil.coefs
        inv_dx2 = [1.0 / d**2 for d in level.dx]
        fs = torch.stack(f_list)
        aux_scal = {k: torch.as_tensor(v, dtype=fs.dtype, device=fs.device)
                    for k, v in aux_scal.items()}
        lap_diag = torch.tensor(self._lap_diag(level.dx),
                                dtype=torch.float64, device=fs.device)
        if pad is not None and any(pad):
            nu, taps = 1, _stencil.PaddedTaps(fs, pad)
        else:
            nu = int(iterations) if kind == "smooth" else 1
            taps = _stencil.RollTaps(fs)
        for _ in range(nu):
            lap = _stencil.lap_from_taps(taps, coefs, inv_dx2)
            centre = taps()
            env = {"omega": self.omega, "_lap_diag": lap_diag,
                   **aux_lat, **aux_scal}
            for i, n in enumerate(names):
                env[n] = centre[i]
                env["lap_" + n] = lap[i]
                if kind != "tau":
                    env[self.f_to_rho_dict[n]] = rho_list[i]
            vals = [torch.broadcast_to(
                torch.as_tensor(evaluate(exprs[n], env), dtype=fs.dtype,
                                device=fs.device), centre.shape[1:])
                for n in names]
            if kind == "tau":
                vals = [rho_list[i] + v for i, v in enumerate(vals)]
            fs = torch.stack(vals)
            taps = _stencil.RollTaps(fs)
        return list(fs.unbind(0))

    # -- per-level operations -------------------------------------------------

    def _run(self, kind, level, fs, rhos, aux, iterations=1):
        if self.smoother == "kernel" or level.sharded:
            return self.launch(kind, level, fs, rhos, aux, iterations)
        _, f_list, rho_list, aux_lat, aux_scal, _ = self._operands(
            level, fs, rhos, aux)
        if kind == "smooth" and int(iterations) == 0:
            return f_list
        return self.plain(kind, level, f_list, rho_list, aux_lat, aux_scal,
                          iterations)

    def smooth(self, level, fs, rhos, aux, iterations):
        """Run ``iterations`` relaxation sweeps; returns the updated
        unknowns (new tensors, or :class:`ShardedArray` s on a sharded
        level; the inputs are not written)."""
        fs, rhos = self._cast(fs, level), self._cast(rhos, level)
        aux = self._cast(aux, level)
        out = self._run("smooth", level, fs, rhos, aux, iterations)
        return dict(zip(self.f_to_rho_dict, out))

    def residual(self, level, fs, rhos, aux):
        """``rho - L(f)`` per unknown."""
        fs, rhos = self._cast(fs, level), self._cast(rhos, level)
        aux = self._cast(aux, level)
        out = self._run("residual", level, fs, rhos, aux)
        return dict(zip(self.f_to_rho_dict, out))

    def tau_rhs(self, level, fs, restricted_resid, aux):
        """Coarse-level rho with the FAS tau correction: the restricted
        fine residual plus the coarse operator applied to the restricted
        unknowns, keyed by the rho names."""
        fs = self._cast(fs, level)
        rr = self._cast(restricted_resid, level)
        aux = self._cast(aux, level)
        out = self._run("tau", level, fs,
                        {self.f_to_rho_dict[n]: rr[n] for n in fs}, aux)
        return dict(zip(self.f_to_rho_dict.values(), out))

    def _norms(self, rn):
        """(Linf, L2) norms of a residual as 0-d tensors on its (first)
        device; of a :class:`ShardedArray` the max of the block maxima
        (exact) and the per-block sums of squares added in rank order (the
        JAX ``psum``)."""
        if not isinstance(rn, ShardedArray):
            return _residual_norms(rn)
        d = rn.decomp
        linf = d.allreduce(rn.map(torch.abs), "max")
        squares = d.psum([torch.sum(b * b) for b in rn.blocks])
        return linf, torch.sqrt(squares / math.prod(rn.shape[-3:]))

    def error_arrays(self, level, fs, rhos, aux):
        """Residual norms as 0-d tensors on the device: no host sync, so a
        cycle can record errors without stalling the launch queue (it
        fetches them once at the end)."""
        r = self.residual(level, fs, rhos, aux)
        return {n: list(self._norms(rn)) for n, rn in r.items()}

    def get_error(self, level, fs, rhos, aux):
        """L-infinity and L2 norms of the residual per unknown."""
        return {n: [float(a), float(b)] for n, (a, b) in
                self.error_arrays(level, fs, rhos, aux).items()}

    # -- standalone relaxation ----------------------------------------------

    def __call__(self, iterations=100, dx=None, **arrays):
        """Relax for ``iterations`` sweeps on whole arrays (sharded over
        the solver's decomposition when it shards an axis: numpy arrays
        and tensors are cut into blocks, :class:`ShardedArray` s taken as
        they are). Unknowns, rho and auxiliary arrays are passed by
        keyword; returns the dict of updated unknowns."""
        if dx is None:
            raise ValueError("dx is required")
        if np.isscalar(dx):
            dx = (float(dx),) * 3
        fs = {n: arrays.pop(n) for n in self.f_to_rho_dict}
        rhos = {r: arrays.pop(r) for r in self.f_to_rho_dict.values()}
        first = next(iter(fs.values()))
        sharded = (self.decomp is not None
                   and any(p > 1 for p in self.decomp.proc_shape))
        level = LevelSpec(tuple(first.shape[-3:]), tuple(dx), sharded)
        return self.smooth(level, fs, rhos, arrays, iterations)


class JacobiIterator(RelaxationBase):
    """Damped Jacobi iteration for linear systems:
    ``f <- (1-omega) f + omega D^{-1} (rho - (L-D) f)``."""

    def step_operator(self, f, lhs, rho):
        omega = Var("omega")
        D = self._diagonal(f, lhs)
        R_y = lhs - D * f  # valid for linear equations
        return (1 - omega) * f + omega * (rho - R_y) / D


class NewtonIterator(RelaxationBase):
    """Newton iteration for arbitrary (nonlinear) systems:
    ``f <- f - omega (L(f) - rho) / (dL/df)``."""

    def step_operator(self, f, lhs, rho):
        omega = Var("omega")
        D = self._diagonal(f, lhs)
        return f - omega * (lhs - rho) / D
