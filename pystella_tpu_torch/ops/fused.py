"""Fused Runge-Kutta stages for Klein-Gordon-form systems, on CUDA.

PyTorch counterpart of the ``FusedScalarStepper`` subset of
``pystella_tpu/ops/fused.py`` that the 2-field preheating hot loop runs.
A stage of ``f'' = lap f - 2 H f' - a^2 dV/df`` under a low-storage (2N)
Runge-Kutta tableau is one kernel: each site reads f (with its stencil
neighbours), dfdt, kf and kdfdt once, computes the Laplacian, the
right-hand side with the model's ``dV/df`` (printed into the kernel source
by :mod:`~pystella_tpu_torch.ops.codegen`) and the 2N update, and writes
the four new arrays.

Two hand-written CUDA kernels (``ops/csrc``):

- ``fused_stage`` (K2): one stage;
- ``fused_pair`` (K3): two consecutive stages in one pass, the second
  stage's Laplacian recomposed from the raw taps. :meth:`multi_step` pairs
  stages across step boundaries (legal when ``A[0] == 0``), so RK54 runs
  5 pair launches per 2 steps and no single stage at all.

Beside each kernel sits its plain PyTorch version (``_scalar_body``,
``_scalar_pair_core``), the same per-site arithmetic in the same order on
:class:`~pystella_tpu_torch.ops.stencil.RollTaps`. A launch wrapper runs
the kernel for CUDA tensors and the plain version for CPU tensors; it
never substitutes one for the other. Kernel and plain version agree to
rounding: PyTorch's CUDA division by a scalar multiplies by the reciprocal
(one rounding more than the kernel's division), which the model's
``dV/df`` can reach; everything else is op-for-op identical.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pystella_tpu_torch import field as _field
from pystella_tpu_torch import step as _step
from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.ops import codegen as _codegen
from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.ops.derivs import _lap_coefs

__all__ = ["FusedScalarStepper", "LAUNCHES", "reset_launch_counts",
           "KERNELS"]

#: kernel name -> number of launches since the last reset; each wrapper
#: adds one where it launches its kernel, and nowhere else
LAUNCHES = {"fused_stage": 0, "fused_pair": 0}

#: kernel name -> (CUDA source in ops/csrc, the Pallas body it replaces)
KERNELS = {
    "fused_stage": ("fused_stage.cu",
                    "pystella_tpu/ops/fused.py:549 (_scalar_body)"),
    "fused_pair": ("fused_pair.cu",
                   "pystella_tpu/ops/fused.py:920 (_scalar_pair_core)"),
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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
    :arg pair_stages: when True (default) :meth:`step` and
        :meth:`multi_step` fuse consecutive stage pairs into one kernel;
        :meth:`stage` always runs the single-stage kernel.
    :arg device: ``None`` (the GPU), ``"cuda"`` or ``"cpu"``. On a CUDA
        device the kernels are built here (first use; cached on disk).

    States are dicts ``{"f": (F, X, Y, Z), "dfdt": (F, X, Y, Z)}``. A stencil
    cannot write its own input, so every launch writes into one of two
    preallocated sets of four arrays (the other set, or the caller's
    arrays, being its input). The tensors a call returns are therefore the
    stepper's own buffers, overwritten by the call after next at the
    latest -- clone what must outlive it (the JAX package's ``multi_step``
    donates its input for the same reason).
    """

    def __init__(self, sector, grid_shape, dx, halo_shape=2, tableau=None,
                 dtype=torch.float32, dt=None, pair_stages=True,
                 device=None):
        self.device = resolve_device(device)
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
        if np.isscalar(dx):
            dx = (dx,) * 3
        self.dx = tuple(float(d) for d in dx)
        self.h = int(halo_shape)
        if self.h not in _lap_coefs:
            raise ValueError(f"halo_shape must be one of {sorted(_lap_coefs)}")
        self.dtype = torch_dtype(dtype)
        if self.dtype not in _SUFFIX:
            raise TypeError("the fused kernels take float32 or float64")

        F = sector.nscalars
        self.F = F
        f = sector.f
        V = sector.potential(f)
        self._dvdf = [_field.diff(V, f[i]) for i in range(F)]
        self._pair_stages = bool(pair_stages) and self.num_stages >= 2

        inv_dx2 = [1.0 / d**2 for d in self.dx]
        coefs = _lap_coefs[self.h]
        # the Laplacian weights exactly as lap_from_taps forms them
        self._lap_weights = (
            [coefs[0] * sum(inv_dx2)]
            + [coefs[s] * inv_dx2[ax] for ax in range(3)
               for s in range(1, self.h + 1)])

        self._buffers = None  # two sets of four arrays, made at first use
        self._libs = None
        if self.device.type == "cuda":
            self.build_kernels()

    # -- kernels -------------------------------------------------------------

    def kernel_header(self):
        """The generated C header the kernels are compiled against."""
        return _codegen.dvdf_header(self._dvdf, self.F, self.h,
                                    field_name=self.sector.f.name)

    def build_kernels(self):
        """Compile (or load from the build cache) both kernels for float32
        and float64; raises if ``nvcc`` fails."""
        libs = _stencil.build_kernels(
            [src for src, _ in KERNELS.values()], self.kernel_header())
        fns = {}
        argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_void_p])
        for name, (src, _) in KERNELS.items():
            for dtype, suffix in _SUFFIX.items():
                fn = getattr(libs[src], f"pk_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name, dtype] = fn
        self._libs = fns

    def _check(self, tensors):
        ref = tensors[0]
        shape = (self.F,) + self.grid_shape
        for t in tensors:
            if (t.device != ref.device or t.dtype != self.dtype
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"the fused kernels take contiguous {self.dtype} tensors "
                    f"of shape {shape} on one device; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ' (non-contiguous)'}")

    def launch(self, name, ins, outs, params):
        """Run kernel ``name`` on CUDA tensors (counting the launch) or its
        plain version on CPU tensors, writing ``outs``."""
        self._check(list(ins) + list(outs))
        dev = ins[0].device
        if dev.type == "cuda":
            if self._libs is None:
                raise RuntimeError("kernels not built: construct the "
                                   "stepper with a CUDA device")
            X, Y, Z = self.grid_shape
            if X > 65535 or (Y + 7) // 8 > 65535:
                raise ValueError(f"lattice {self.grid_shape} exceeds the "
                                 "kernels' launch grid")
            prm = (ctypes.c_double * (len(params) + len(self._lap_weights)))(
                *params, *self._lap_weights)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = self._libs[name, self.dtype](
                    *(t.data_ptr() for t in ins),
                    *(t.data_ptr() for t in outs), X, Y, Z, prm, stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed with CUDA "
                                   f"error {rc}")
            LAUNCHES[name] += 1
        elif dev.type == "cpu":
            for o, r in zip(outs, self.plain(name, ins, params)):
                o.copy_(r)
        else:
            raise ValueError(f"no fused kernel for device {dev}")
        return outs

    def _out_set(self, ins):
        """A buffer set sharing no storage with the launch's inputs."""
        ref = ins[0]
        key = (tuple(ref.shape), ref.dtype, ref.device)
        if self._buffers is None or self._buffers[0] != key:
            self._buffers = (key, [[torch.empty_like(ref) for _ in range(4)]
                                   for _ in range(2)])
        used = {t.untyped_storage().data_ptr() for t in ins}
        for bufs in self._buffers[1]:
            if not used & {b.untyped_storage().data_ptr() for b in bufs}:
                return bufs
        # inputs mixed from both sets: write fresh arrays instead
        return [torch.empty_like(ref) for _ in range(4)]

    # -- plain PyTorch versions (the kernels' arithmetic) --------------------

    def _scalars(self, values, ref):
        """Scalars as 0-d tensors of the working dtype, so the plain bodies
        round where the kernels (which take them as ``T``) round."""
        return {n: torch.tensor(v, dtype=ref.dtype, device=ref.device)
                for n, v in values.items()}

    def plain(self, name, ins, params):
        """Kernel ``name``'s plain version on ``ins`` (any device); returns
        the four outputs."""
        return (self.plain_stage if name == "fused_stage"
                else self.plain_pair)(ins, params)

    def plain_stage(self, ins, params):
        """K2's plain version: ``_scalar_body`` on :class:`RollTaps`."""
        f, dfdt, kf, kdf = ins
        names = ("dt", "a", "hubble", "A", "B")
        outs = self._scalar_body(
            _stencil.RollTaps(f), {"dfdt": dfdt, "kf": kf, "kdfdt": kdf},
            self._scalars(dict(zip(names, params)), f))
        return [outs[n] for n in ("f", "dfdt", "kf", "kdfdt")]

    def plain_pair(self, ins, params):
        """K3's plain version: ``_scalar_pair_core`` on :class:`RollTaps`."""
        f, dfdt, kf, kdf = ins
        names = ("dt", "a1", "hubble1", "A1", "B1",
                 "a2", "hubble2", "A2", "B2")
        taps = {"f": _stencil.RollTaps(f), "dfdt": _stencil.RollTaps(dfdt),
                "kf": _stencil.RollTaps(kf)}
        outs, _ = self._scalar_pair_core(
            taps, {"kdfdt": kdf}, self._scalars(dict(zip(names, params)), f))
        return [outs[n] for n in ("f", "dfdt", "kf", "kdfdt")]

    def _scalar_body(self, taps, extras, scalars):
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
        return {"f": f2, "dfdt": df2, "kf": kf2, "kdfdt": kdf2}

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

    # -- Stepper interface -------------------------------------------------

    def init_carry(self, state):
        k = {n: torch.zeros_like(v) for n, v in state.items()}
        return (state, k)

    def extract(self, carry):
        return carry[0]

    def current(self, carry):
        return carry[0]

    def _inputs(self, carry):
        state, k = carry
        ins = [state["f"], state["dfdt"], k["f"], k["dfdt"]]
        if ins[0].device != self.device:
            raise ValueError(f"state is on {ins[0].device}, but this "
                             f"stepper runs on {self.device}")
        return ins

    @staticmethod
    def _carry_of(outs):
        return ({"f": outs[0], "dfdt": outs[1]},
                {"f": outs[2], "dfdt": outs[3]})

    def _stage_params(self, s, dt, rhs_args):
        return (_float(dt), _float(rhs_args.get("a", 1.0)),
                _float(rhs_args.get("hubble", 0.0)),
                float(self._A[s]), float(self._B[s]))

    def stage(self, s, carry, t, dt, rhs_args):
        ins = self._inputs(carry)
        outs = self.launch("fused_stage", ins, self._out_set(ins),
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
        outs = self.launch("fused_pair", ins, self._out_set(ins),
                            self._pair_params(s, dt, rhs_args, rhs_args2, s2))
        return self._carry_of(outs)

    def _step_impl(self, state, t, dt, rhs_args):
        carry = self.init_carry(state)
        s = 0
        if self._pair_stages:
            while s + 1 < self.num_stages:
                carry = self.stage_pair(s, carry, t, dt, rhs_args)
                s += 2
        while s < self.num_stages:
            carry = self.stage(s, carry, t, dt, rhs_args)
            s += 1
        return self.extract(carry)

    def step(self, state, t=0.0, dt=None, rhs_args=None):
        """Advance ``state`` by one full RK step: stage pairs, then the odd
        stage left over (RK54: 2 pair launches + 1 single)."""
        dt = dt if dt is not None else self.dt
        return self._step_impl(state, t, dt, rhs_args or {})

    def multi_step(self, state, nsteps, t=0.0, dt=None, rhs_args=None,
                   rhs_seq=None):
        """Advance ``nsteps`` full RK steps, pairing stages ACROSS step
        boundaries when ``A[0] == 0``: RK54 then runs
        ``ceil(5 * nsteps / 2)`` pair launches and, for odd ``nsteps``,
        one trailing single stage. Equal, launch for launch in arithmetic,
        to the JAX package's ``FusedScalarStepper.multi_step``.

        ``rhs_seq`` maps scalar names (``"a"``, ``"hubble"``) to per-stage
        values, one per flat stage (``nsteps * num_stages``), overlaying the
        static ``rhs_args``."""
        dt = dt if dt is not None else self.dt
        nsteps = int(nsteps)
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

        if not self._pair_stages or self._A[0] != 0:
            # no cross-boundary fusion possible: sequential steps, each
            # with its own k-carry reset, pairing within the step
            for step in range(nsteps):
                carry = self.init_carry(state)
                s, base = 0, step * nstages
                if self._pair_stages:
                    while s + 1 < nstages:
                        carry = self.stage_pair(
                            s, carry, t, dt, args_at(base + s),
                            rhs_args2=args_at(base + s + 1))
                        s += 2
                while s < nstages:
                    carry = self.stage(s, carry, t, dt, args_at(base + s))
                    s += 1
                state = self.extract(carry)
            return state
        carry = self.init_carry(state)
        flat = [s for _ in range(nsteps) for s in range(nstages)]
        i = 0
        # pair across step boundaries: the stage-0 update multiplies the
        # stale k-carry by A[0] == 0, so skipping the per-step zero reset
        # changes nothing
        while i + 1 < len(flat):
            carry = self.stage_pair(flat[i], carry, t, dt, args_at(i),
                                    rhs_args2=args_at(i + 1),
                                    s2=flat[i + 1])
            i += 2
        while i < len(flat):
            carry = self.stage(flat[i], carry, t, dt, args_at(i))
            i += 1
        return self.extract(carry)
