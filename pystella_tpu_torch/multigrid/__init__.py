"""Geometric multigrid solvers on 3-D periodic lattices.

PyTorch counterpart of ``pystella_tpu/multigrid/__init__.py``. Cycles are
the same ``(level, iterations)`` walks; the Full Approximation Scheme and
linear multigrid keep the JAX package's transfer semantics (restrict
unknowns + tau-corrected right-hand side going down, correction
interpolation going up) and are *functional*: a cycle maps input arrays to
output arrays. Sweeps, residuals and coarse right-hand sides are the
solver's kernels (:mod:`~pystella_tpu_torch.multigrid.relax`), transfers
plain tensor operations (:mod:`~pystella_tpu_torch.multigrid.transfer`).

Without a decomposition every level lives whole on the solver's device.
With one (the solver's ``decomp=``) the levels are placed by the JAX
package's rule: a level is sharded (its arrays
:class:`~pystella_tpu_torch.parallel.ShardedArray` s) when the mesh shards
an axis and every block is even and at least as wide as every halo pad;
the coarser levels, from the first that is not, are replicated: held whole
on the decomposition's first device, assembled there by device-to-device
copies and cut back into blocks going up. Transfers between sharded levels
run per block with the neighbours' rows as halos. A sharded cycle equals
the single-device one bit for bit, but for the L2 error norms (per-block
sums added in rank order).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from pystella_tpu_torch.multigrid.relax import (
    LevelSpec, RelaxationBase, JacobiIterator, NewtonIterator)
from pystella_tpu_torch.multigrid.transfer import (
    RestrictionBase, FullWeighting, Injection,
    InterpolationBase, LinearInterpolation, CubicInterpolation,
    periodic_pad)
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = [
    "mu_cycle", "v_cycle", "w_cycle", "f_cycle",
    "FullApproximationScheme", "MultiGridSolver",
    "RelaxationBase", "JacobiIterator", "NewtonIterator",
    "RestrictionBase", "FullWeighting", "Injection",
    "InterpolationBase", "LinearInterpolation", "CubicInterpolation",
    "LevelSpec", "periodic_pad",
]


def mu_cycle(mu, i, nu1, nu2, max_depth):
    """Generic recursive mu-cycle as a list of ``(level, iterations)``.
    Level ``i`` has ``2**i`` fewer points per axis than the finest grid."""
    if i == max_depth:
        return [(i, nu2)]
    x = mu_cycle(mu, i + 1, nu1, nu2, max_depth)
    return [(i, nu1)] + x + x[1:] * (mu - 1) + [(i, nu2)]


def v_cycle(nu1, nu2, max_depth):
    """V-cycle."""
    return mu_cycle(1, 0, nu1, nu2, max_depth)


def w_cycle(nu1, nu2, max_depth):
    """W-cycle."""
    return mu_cycle(2, 0, nu1, nu2, max_depth)


def _updown(i, j, k, nu1, nu2):
    down = [(a, nu1) for a in range(i, j)]
    up = [(a, nu2) for a in range(j, k - 1, -1)]
    return down + up


def f_cycle(nu1, nu2, max_depth):
    """F-cycle."""
    cycle = _updown(0, max_depth, max_depth - 1, nu1, nu2)
    for top in range(max_depth - 1, 0, -1):
        cycle += _updown(top + 1, max_depth, top - 1, nu1, nu2)
    return cycle


class FullApproximationScheme:
    """Nonlinear multigrid via the Full Approximation Scheme.

    :arg solver: a :class:`RelaxationBase` subclass instance
        (:class:`JacobiIterator` or :class:`NewtonIterator`); its device,
        or its decomposition (``decomp=``), is where the cycle runs.
    :arg halo_shape: stencil/transfer halo width; defaults to the solver's.
    :arg Restrictor: defaults to :class:`FullWeighting`.
    :arg Interpolator: defaults to :class:`LinearInterpolation`.
    :arg defer_errors: error-norm materialization. ``True`` keeps the
        per-smooth residual norms as 0-d tensors on the device until the
        cycle's end (one fetch; a ``float()`` per norm would stall the
        launch queue twice per level visit); ``False`` converts them as
        they are taken. Default ``None``: deferred on a CUDA device, eager
        on the CPU.

    Unknown keyword arguments raise ``TypeError``.

    Call with the fine grid spacing, an optional cycle, and all arrays by
    keyword; returns ``(errors, unknowns)`` where ``errors`` is the list of
    ``(level, {name: [Linf, L2]})`` entries and ``unknowns`` the updated
    solution arrays (functional: the inputs are not written). With a
    decomposition the arrays may be numpy arrays, tensors or
    :class:`ShardedArray` s, and the unknowns come back as the finest
    level holds them (:class:`ShardedArray` s where it is sharded). The
    JAX package takes the decomposition as the call's first argument; the
    port takes the solver's.
    """

    def __init__(self, solver, halo_shape=None, **kwargs):
        self.solver = solver
        self.halo_shape = (int(halo_shape) if halo_shape is not None
                           else solver.halo_shape)
        Restrictor = kwargs.pop("Restrictor", FullWeighting)
        self.restrictor = Restrictor(halo_shape=self.halo_shape)
        Interpolator = kwargs.pop("Interpolator", LinearInterpolation)
        self.interpolator = Interpolator(halo_shape=self.halo_shape)
        self._defer_errors = kwargs.pop("defer_errors", None)
        if kwargs:
            raise TypeError(
                f"{type(self).__name__}() got unexpected keyword "
                f"argument(s): {', '.join(sorted(kwargs))}")

    # -- level geometry -----------------------------------------------------

    def _make_levels(self, grid_shape, dx0, depth):
        """The levels' geometry; with a decomposition, the JAX package's
        placement: sharded iff the mesh shards an axis and every block is
        even and at least ``max(h, restriction pad, interpolation pad,
        2)`` wide; once a level is replicated, so are the coarser ones."""
        if np.isscalar(dx0):
            dx0 = (float(dx0),) * 3
        dx0 = tuple(float(d) for d in dx0)
        decomp = self.solver.decomp
        min_block = max(self.halo_shape, self.restrictor.pad,
                        self.interpolator.pad, 2)
        levels = []
        for i in range(depth + 1):
            shape_i = tuple(n >> i for n in grid_shape)
            if any(n << i != g for n, g in zip(shape_i, grid_shape)):
                raise ValueError(
                    f"grid {grid_shape} not divisible by 2**{i} for "
                    f"multigrid depth {depth}")
            sharded = decomp is not None and any(
                p > 1 for p in decomp.proc_shape) and all(
                n % p == 0 and n // p >= min_block and (n // p) % 2 == 0
                for n, p in zip(shape_i, decomp.proc_shape))
            if levels and not levels[-1].sharded:
                sharded = False
            levels.append(LevelSpec(
                shape_i, tuple(d * 2 ** i for d in dx0), sharded))
        return levels

    def kernel_tier_report(self, grid_shape, dx0, depth):
        """Per level of a cycle of ``depth`` on ``grid_shape``: its lattice,
        whether it is sharded, the block a rank holds and how its sweeps
        run (:meth:`RelaxationBase.level_tier`)."""
        decomp = self.solver.decomp
        return [{"grid_shape": lv.grid_shape, "sharded": lv.sharded,
                 "block": (decomp.rank_shape(lv.grid_shape) if lv.sharded
                           else lv.grid_shape),
                 "tier": self.solver.level_tier(lv)}
                for lv in self._make_levels(grid_shape, dx0, depth)]

    # -- transfers ----------------------------------------------------------

    def _transfer(self, op, src, dst, x):
        """``op`` of ``x`` from level ``src`` to level ``dst``: per block
        between sharded levels, else on the whole array (a sharded input
        assembled on the solver's device first, a sharded output cut into
        blocks after), as the JAX package's cases. Under the profiler label
        ``mg_transfer``."""
        with record_function("mg_transfer"):
            if src.sharded and dst.sharded:
                return op(x, decomp=self.solver.decomp)
            if isinstance(x, ShardedArray):
                x = x.decomp.unshard(x, self.solver.device)
            out = op.apply_local(x)
            return self.solver.decomp.shard(out) if dst.sharded else out

    def _restrict(self, lf, lc, x):
        """Restrict ``x`` from (fine) level ``lf`` to (coarse) ``lc``."""
        return self._transfer(self.restrictor, lf, lc, x)

    def _interpolate(self, lc, lf, x):
        """Interpolate ``x`` from (coarse) level ``lc`` to (fine) ``lf``."""
        return self._transfer(self.interpolator, lc, lf, x)

    # -- cycle steps ----------------------------------------------------------

    def transfer_down(self, levels, i, unknowns, rhos, aux):
        """Restrict unknowns and build the tau-corrected coarse rho."""
        solver = self.solver
        unknowns[i] = {n: self._restrict(levels[i - 1], levels[i], f)
                       for n, f in unknowns[i - 1].items()}
        r_fine = solver.residual(levels[i - 1], unknowns[i - 1],
                                 rhos[i - 1], aux[i - 1])
        rr = {n: self._restrict(levels[i - 1], levels[i], r)
              for n, r in r_fine.items()}
        rhos[i] = solver.tau_rhs(levels[i], unknowns[i], rr, aux[i])

    def transfer_up(self, levels, i, unknowns, rhos, aux):
        """Correct the finer level ``i`` by the coarse-grid change: the
        smoothed coarse solution minus the restricted fine one, interpolated
        up and added."""
        for n, f_fine in unknowns[i].items():
            corr = (unknowns[i + 1][n]
                    - self._restrict(levels[i], levels[i + 1], f_fine))
            unknowns[i][n] = f_fine + self._interpolate(
                levels[i + 1], levels[i], corr)

    def smooth(self, levels, i, nu, unknowns, rhos, aux):
        """Relax level ``i`` for ``nu`` sweeps, recording errors before and
        after. Deferred, the norms stay 0-d tensors on the device until the
        cycle's end (``__call__`` fetches them once)."""
        solver = self.solver
        defer = (self._defer_errors if self._defer_errors is not None
                 else solver.device.type == "cuda")
        err_fn = solver.error_arrays if defer else solver.get_error
        errs1 = err_fn(levels[i], unknowns[i], rhos[i], aux[i])
        unknowns[i] = solver.smooth(levels[i], unknowns[i], rhos[i],
                                    aux[i], nu)
        errs2 = err_fn(levels[i], unknowns[i], rhos[i], aux[i])
        return [(i, errs1), (i, errs2)]

    @staticmethod
    def _materialize_errors(errors):
        """Convert any deferred 0-d tensor norms to floats with ONE
        transfer to the host of the whole record."""
        deferred = [v for _, errs in errors for pair in errs.values()
                    for v in pair if isinstance(v, torch.Tensor)]
        fetched = iter(torch.stack(deferred).tolist() if deferred else ())
        return [(i, {n: [next(fetched) if isinstance(v, torch.Tensor)
                         else float(v) for v in pair]
                     for n, pair in errs.items()})
                for i, errs in errors]

    # -- entry point --------------------------------------------------------

    def __call__(self, dx0=None, cycle=None, **kwargs):
        solver = self.solver
        unknowns0 = {n: kwargs.pop(n) for n in solver.f_to_rho_dict}
        rhos0 = {r: kwargs.pop(r) for r in solver.f_to_rho_dict.values()}
        grid_shape = tuple(next(iter(unknowns0.values())).shape[-3:])
        if dx0 is None:
            raise ValueError("dx0 is required")

        if cycle is None:
            depth = max(1, int(np.log2(min(grid_shape) / 8)))
            cycle = v_cycle(25, 50, depth)
        depth = max(i for i, _ in cycle)

        levels = self._make_levels(grid_shape, dx0, depth)
        unknowns0 = solver._cast(unknowns0, levels[0])
        rhos0 = solver._cast(rhos0, levels[0])
        aux0 = solver._cast(kwargs, levels[0])

        aux = {0: aux0}
        for i in range(1, depth + 1):
            # lattice arrays are restricted; a scalar serves every level
            aux[i] = {k: (self._restrict(levels[i - 1], levels[i], v)
                          if getattr(v, "ndim", 0) >= 3 else v)
                      for k, v in aux[i - 1].items()}
        unknowns = {0: dict(unknowns0)}
        rhos = {0: dict(rhos0)}

        errors = self.smooth(levels, 0, cycle[0][1], unknowns, rhos, aux)
        previous = 0
        for i, nu in cycle[1:]:
            if i == previous + 1:
                self.transfer_down(levels, i, unknowns, rhos, aux)
            elif i == previous - 1:
                self.transfer_up(levels, i, unknowns, rhos, aux)
            else:
                raise ValueError(
                    "consecutive levels must be spaced by one")
            errors += self.smooth(levels, i, nu, unknowns, rhos, aux)
            previous = i
        return self._materialize_errors(errors), unknowns[0]


class MultiGridSolver(FullApproximationScheme):
    """Linear (correction-scheme) multigrid. The coarse equation is
    ``L e = R r`` with a zero initial guess for the correction ``e``; going
    up, the correction is interpolated and added to the finer solution."""

    def transfer_down(self, levels, i, unknowns, rhos, aux):
        solver = self.solver
        r_fine = solver.residual(levels[i - 1], unknowns[i - 1],
                                 rhos[i - 1], aux[i - 1])
        rhos[i] = {}
        unknowns[i] = {}
        for n, r in r_fine.items():
            rr = self._restrict(levels[i - 1], levels[i], r)
            rhos[i][solver.f_to_rho_dict[n]] = rr
            unknowns[i][n] = (rr.map(torch.zeros_like)
                              if isinstance(rr, ShardedArray)
                              else torch.zeros_like(rr))

    def transfer_up(self, levels, i, unknowns, rhos, aux):
        for n, f_fine in unknowns[i].items():
            unknowns[i][n] = f_fine + self._interpolate(
                levels[i + 1], levels[i], unknowns[i + 1][n])
