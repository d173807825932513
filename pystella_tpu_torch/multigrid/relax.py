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
the JAX package's ``RelaxationBase._pallas_level`` body), compiled against
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
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pystella_tpu_torch import field as _field
from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.field import Field, Var, diff, evaluate
from pystella_tpu_torch.ops import codegen as _codegen
from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.ops.derivs import SecondCenteredDifference

__all__ = ["LevelSpec", "RelaxationBase", "JacobiIterator", "NewtonIterator",
           "LAUNCHES", "reset_launch_counts", "KERNELS"]

_SOURCE = "mg_relax.cu"
_JAX_SITE = ("pystella_tpu/multigrid/relax.py:289 "
             "(RelaxationBase._pallas_level, body :324, kind")
#: kernel name -> (CUDA source in ops/csrc, the Pallas body it replaces)
KERNELS = {f"mg_{kind}": (_SOURCE, f'{_JAX_SITE} "{kind}")')
           for kind in ("smooth", "residual", "tau")}

#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel (once per sweep), and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Geometry of one multigrid level: lattice shape, spacing, and whether
    its arrays are sharded over several devices (always ``False`` here: the
    port holds every level whole on one device)."""

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
        call receives is placed there.
    """

    def __init__(self, lhs_dict, halo_shape=1, omega=1.0, dtype=None,
                 smoother=None, device=None, **kwargs):
        self.device = resolve_device(device)
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
        #: aux routing -> {(kind, dtype): C entry point}, built at first use
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

    def _cast(self, arrays):
        """Arrays (tensors or numpy) as tensors on the solver's device, in
        ``dtype`` when one was given; Python numbers stay as they are."""
        return {k: v if isinstance(v, (int, float)) else
                torch.as_tensor(v, dtype=self.dtype, device=self.device)
                for k, v in arrays.items()}

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
        tensors of one dtype on one device, and the aux scalars as
        given."""
        names = list(self.f_to_rho_dict)
        ref = fs[names[0]]
        if ref.dtype not in _SUFFIX:
            raise TypeError("the multigrid solvers take float32 or float64")
        shape = tuple(level.grid_shape)

        def lattice(v, what):
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
        of this solver's equations for float32 and float64; raises if
        ``nvcc`` fails."""
        fns = self._libs.get(aux_struct)
        if fns is None:
            lib = _stencil.build_kernels(
                [_SOURCE], self.kernel_header(aux_struct))[_SOURCE]
            fns = {}
            for name in KERNELS:
                for dtype, suffix in _SUFFIX.items():
                    fn = getattr(lib, f"{name}_{suffix}")
                    # f, rho, aux, out pointer arrays, X, Y, Z, params,
                    # stream
                    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p] * 2)
                    fn.restype = ctypes.c_int
                    fns[name, dtype] = fn
            self._libs[aux_struct] = fns
        return fns

    def launch(self, kind, level, fs, rhos, aux, iterations=1):
        """Kernel ``mg_<kind>`` (``"smooth"``, ``"residual"``, ``"tau"``) on
        CUDA tensors, counting each launch, or its plain version on CPU
        tensors. ``smooth`` runs ``iterations`` sweeps, each launch writing
        the set of arrays the next one reads; for ``tau`` ``rhos`` holds
        the restricted residuals under the rho names. Returns the list of
        outputs, one per unknown, as new tensors."""
        name = f"mg_{kind}"
        if name not in KERNELS:
            raise ValueError(f"unknown kind {kind}")
        names, f_list, rho_list, aux_lat, aux_scal, struct = self._operands(
            level, fs, rhos, aux)
        nu = int(iterations) if kind == "smooth" else 1
        if nu == 0:
            return f_list
        dev = f_list[0].device
        if dev.type == "cpu":
            return self.plain(kind, level, f_list, rho_list, aux_lat,
                              aux_scal, nu)
        if dev.type != "cuda":
            raise ValueError(f"no multigrid kernel for device {dev}")
        fn = self.build_kernels(struct)[name, f_list[0].dtype]
        X, Y, Z = level.grid_shape
        if X > 65535 or (Y + 7) // 8 > 65535:
            raise ValueError(f"lattice {level.grid_shape} exceeds the "
                             "kernels' launch grid")
        params = ([self.omega, self._lap_diag(level.dx)]
                  + self._lap_weights(level.dx)
                  + [float(v) for v in aux_scal.values()])
        prm = (ctypes.c_double * len(params))(*params)
        ptrs = ctypes.c_void_p * len(names)

        def pointers(tensors):
            return ptrs(*(t.data_ptr() for t in tensors))

        rho_p = pointers(rho_list)
        aux_p = (ctypes.c_void_p * max(1, len(aux_lat)))(
            *(t.data_ptr() for t in aux_lat.values()))
        # two sets of outputs: sweep k reads what sweep k - 1 wrote
        sets = [[torch.empty_like(t) for t in f_list]
                for _ in range(min(nu, 2))]
        src = f_list
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for k in range(nu):
                dst = sets[k % 2]
                rc = fn(pointers(src), rho_p, aux_p, pointers(dst), X, Y, Z,
                        prm, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} kernel launch failed with "
                                       f"CUDA error {rc}")
                LAUNCHES[name] += 1
                src = dst
        return src

    # -- the plain PyTorch version ------------------------------------------

    def plain(self, kind, level, f_list, rho_list, aux_lat, aux_scal,
              iterations=1):
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
        (the kernel takes them as ``T``)."""
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
        for _ in range(int(iterations) if kind == "smooth" else 1):
            lap = _stencil.lap_from_taps(_stencil.RollTaps(fs), coefs,
                                         inv_dx2)
            env = {"omega": self.omega, "_lap_diag": lap_diag,
                   **aux_lat, **aux_scal}
            for i, n in enumerate(names):
                env[n] = fs[i]
                env["lap_" + n] = lap[i]
                if kind != "tau":
                    env[self.f_to_rho_dict[n]] = rho_list[i]
            vals = [torch.broadcast_to(
                torch.as_tensor(evaluate(exprs[n], env), dtype=fs.dtype,
                                device=fs.device), fs.shape[1:])
                for n in names]
            if kind == "tau":
                vals = [rho_list[i] + v for i, v in enumerate(vals)]
            fs = torch.stack(vals)
        return list(fs.unbind(0))

    # -- per-level operations -------------------------------------------------

    def _run(self, kind, level, fs, rhos, aux, iterations=1):
        if self.smoother == "kernel":
            return self.launch(kind, level, fs, rhos, aux, iterations)
        _, f_list, rho_list, aux_lat, aux_scal, _ = self._operands(
            level, fs, rhos, aux)
        if kind == "smooth" and int(iterations) == 0:
            return f_list
        return self.plain(kind, level, f_list, rho_list, aux_lat, aux_scal,
                          iterations)

    def smooth(self, level, fs, rhos, aux, iterations):
        """Run ``iterations`` relaxation sweeps; returns the updated
        unknowns (new tensors; the inputs are not written)."""
        fs, rhos, aux = self._cast(fs), self._cast(rhos), self._cast(aux)
        out = self._run("smooth", level, fs, rhos, aux, iterations)
        return dict(zip(self.f_to_rho_dict, out))

    def residual(self, level, fs, rhos, aux):
        """``rho - L(f)`` per unknown."""
        fs, rhos, aux = self._cast(fs), self._cast(rhos), self._cast(aux)
        out = self._run("residual", level, fs, rhos, aux)
        return dict(zip(self.f_to_rho_dict, out))

    def tau_rhs(self, level, fs, restricted_resid, aux):
        """Coarse-level rho with the FAS tau correction: the restricted
        fine residual plus the coarse operator applied to the restricted
        unknowns, keyed by the rho names."""
        fs = self._cast(fs)
        rr = self._cast(restricted_resid)
        aux = self._cast(aux)
        out = self._run("tau", level, fs,
                        {self.f_to_rho_dict[n]: rr[n] for n in fs}, aux)
        return dict(zip(self.f_to_rho_dict.values(), out))

    def error_arrays(self, level, fs, rhos, aux):
        """Residual norms as 0-d tensors on the device: no host sync, so a
        cycle can record errors without stalling the launch queue (it
        fetches them once at the end)."""
        r = self.residual(level, fs, rhos, aux)
        return {n: list(_residual_norms(rn)) for n, rn in r.items()}

    def get_error(self, level, fs, rhos, aux):
        """L-infinity and L2 norms of the residual per unknown."""
        return {n: [float(a), float(b)] for n, (a, b) in
                self.error_arrays(level, fs, rhos, aux).items()}

    # -- standalone relaxation ----------------------------------------------

    def __call__(self, iterations=100, dx=None, **arrays):
        """Relax for ``iterations`` sweeps on whole arrays. Unknowns, rho
        and auxiliary arrays are passed by keyword; returns the dict of
        updated unknowns."""
        if dx is None:
            raise ValueError("dx is required")
        if np.isscalar(dx):
            dx = (float(dx),) * 3
        fs = {n: arrays.pop(n) for n in self.f_to_rho_dict}
        rhos = {r: arrays.pop(r) for r in self.f_to_rho_dict.values()}
        first = next(iter(fs.values()))
        level = LevelSpec(tuple(first.shape[-3:]), tuple(dx), False)
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
