"""Rehearse the kernels' x-march on the CPU, built with g++ behind the
CUDA stand-in of shim.py.

Every entry point of the scalar pairs K3 and K6 (both inputs) -- f32,
f64, bf16 carries, unpadded and x-, y- and xy-padded -- is held to its
plain version (relative 1e-5 in f32, 1e-13 in f64); each padded launch
must equal the unpadded one bit for bit, K3's interior and shell launches
its ``:xpad`` launch, and two x blocks' partials of K6 the unsharded
sums. With ``--gw`` the GW pairs K8 and K9 (both inputs) are held to
their plain versions and their padded launches to the unpadded ones.
With ``--chunk`` the whole-RK chunk K10 (f32, f64, bf16 carries) is held
to its plain version and to two K3 launches bit for bit, state and
carries. With ``--stage`` the single stages, which all march, the GW
energy stage K5', the GW stage K7, the scalar energy stage K5 and the
stage K2 (f32, f64, bf16 carries and, for K5' and K5, the ``_bf16_fin``
carries, every padding, K7's and K2's interior and shell launches)
likewise; K5''s lattice outputs also equal K7's bit for bit, its scalar
outputs and sums K5's, K5's scalar outputs K2's, K2's every launch that of
a per-site build (``PK_STAGE_PER_SITE 1``), and two x blocks' partials the
unsharded sums. With ``--fd`` the finite-difference operators ``fd_lap``,
``fd_grad``, ``fd_grad_lap``, ``fd_pdx``, ``fd_pdy``, ``fd_pdz`` and
``fd_div`` (h = 1-4, f32 and f64, every padding, the interior and shell
launches; all but ``fd_pdy`` and ``fd_pdz`` march) are held to their plain
versions, their padded, interior and shell launches to the unpadded one,
and every launch to a per-site build's (``PK_FD_PER_SITE 1``) bit for
bit; ``fd_grad_lap``'s outputs also equal
the marching ``fd_grad``'s and ``fd_lap``'s, and ``fd_grad``'s d-th output
``fd_pdx``'s, ``fd_pdy``'s or ``fd_pdz``'s. With ``--mg`` the multigrid sweeps
K11 (``mg_smooth`` one and three sweeps, ``mg_residual``, ``mg_tau``; the
Newton problem, the Jacobi pair and a Newton problem with a lattice and two
scalar auxiliary inputs; h = 1, 2 and, for the first two, 4; f32 and f64; every
padding, the interior and shell launches) are held to their plain versions from
a build that marches every launch (``MG_MARCH_MIN_SITES 1``), and bit for bit
to one that runs every launch per site and to the default build; padded,
interior and shell launches equal the unpadded one.
With ``--hist`` the binning kernels K13 (``bincount``: counts, float32
and float64 weights; 1, 2 and 6 outer slices; 7 and 1000 bins, some out
of range; uniform, hot-bin, sorted and misaligned bins) and K14
(``spectra_bin``: r2c and c2c, float32 and float64, k powers 3 and 0,
PowerSpectra's shells and wide ones) and their finish launch are held to
their plain versions (counts and K14's bins exactly, sums within 1e-13 /
1e-6 of the largest bin) and to the build that bins counts and K14 every
site through the warp grouping (``PK_HIST_MATCH 1``: counts, weighted
sums and K14's bins bit for bit, K14's sums within the same bound),
launched twice for equal bits, and on (2, 1, 1) and (2, 2, 1) blocks
equal to the whole lattice's launch bit for bit; ``--small`` keeps the
16^3 and 5x9x33 lattices (and 2x4x600 for K14).
With ``--health`` the health kernel K15 and its finish (f32, f64 and bf16
fields with NaN, +-inf and overflowing sites; aligned and scalar loads;
rows of several vector passes and more rows than a launch's warps) are
held to their plain version (``finite`` and ``max_abs`` exactly, ``rms``
within 1e-13), launched twice for equal bits, and on (2, 1, 1) and
(2, 2, 1) blocks equal to the whole lattice's launch bit for bit
(``--small``: three of the four shapes).
With ``--against DIR``, the root of another checkout (a parent commit
unpacked with ``git archive``, say), every launch must also equal that
checkout's kernels bit for bit, sums included; with ``--hist`` K14's sums
only within the bound above (the order of its float64 additions may
change between designs), its bins and every K13 result bit for bit.

Shapes: 16^3, 70x12x40 and 5x9x33 (two fields, h = 2), a five-field model
at h = 4 (f64: the split layout of the pairs, two groups of three
components for K5' and K7; K10: a lower rung of its ladder of tiles), ten
fields at h = 4 in f64 (the split layout of K5', K7 and K5), three fields
at h = 1 and 3, and 2^3, where the +-taps wrap onto one site. ``--lx`` is
the run length the kernels are built with (PK_SCALAR_MARCH_LX;
PK_MARCH_LX with ``--gw``, PK_CHUNK_LX with ``--chunk``,
PK_STAGE_MARCH_LX and PK_SCALAR_STAGE_MARCH_LX with ``--stage``,
PK_FD_LAP_LX, PK_FD_GRAD_LX, PK_FD_GRAD_LAP_LX, PK_FD_PD_LX and
PK_FD_DIV_LX with ``--fd``, MG_MARCH_LX with
``--mg``): the default 4 cuts runs short at every shape and keeps the run
to a few minutes. Exits 1 if a check fails::

    python pystella_tpu_torch/tools/cpu_shim/rehearse.py
        [--gw | --chunk | --stage | --fd | --mg | --hist [--small]
         | --health]
        [--lx N] [--against DIR]
"""

import argparse
import ctypes
import itertools
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from shim import (CSRC, build, built, pt, shim, tderivs, tfused, thealth,
                  thist, trelax)

A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
RESULTS = []


def bench_potential(f):
    return (0.5 * f[0]**2 + 0.5 * 0.1 * f[1]**2
            + 0.25 * f[0]**2 * f[1]**2 + 0.01 * f[0]**4)


def many_potential(n):
    def potential(f):
        return (sum((0.5 + 0.1 * i) * f[i]**2 / 2 for i in range(n))
                + 0.25 * f[0]**2 * sum(f[i]**2 for i in range(1, n)))
    return potential


def params(kernel, dx):
    """A pair's launch parameters (the tableau's stages 1 and 2; a single
    stage's, stage 1)."""
    dt = 0.1 * dx
    if kernel in ("fused_stage", "fused_stage_energy"):
        return (dt, 1.0, 0.5, A[1], B[1])
    if kernel == "fused_pair":
        return (dt, 1.0, 0.5, A[1], B[1], 1.01, 0.49, A[2], B[2])
    p = (dt, 1.0, 0.5, A[1], B[1], 1.0001, A[2], B[2])
    return p + ((0.49, B[0]) if kernel == "coupled_pair_deferred" else ())


def chunk_params(dx):
    """K10's launch parameters: dt, then per stage 1-4 a, hubble, A, B."""
    p = [0.1 * dx]
    for k, s in enumerate((1, 2, 3, 4)):
        p += [1.0 + 0.01 * k, 0.5 - 0.01 * k, A[s], B[s]]
    return tuple(p)


def pad(t, hx, hy):
    """``t`` padded periodically by ``hx`` rows along x, ``hy`` along y."""
    if hx:
        t = torch.cat([t[:, -hx:], t, t[:, :hx]], 1)
    if hy:
        t = torch.cat([t[:, :, -hy:], t, t[:, :, :hy]], 2)
    return t.contiguous()


def nans(st):
    return [t.fill_(float("nan")) for t in st._new_set("cpu")]


def same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def rel(got, ref):
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().max()
            / ref.abs().max().clamp_min(1e-300)).item()


def check(tag, ok):
    RESULTS.append(ok)
    print("ok  " if ok else "FAIL", tag, flush=True)


class Case:
    """One model on one lattice: this checkout's kernels (and another
    checkout's, with ``--against``) and a seeded set of inputs."""

    def __init__(self, args, F, h, grid, dtype, carry, potential, gw=False,
                 chunk=False, tile_src="fused_pair.cu"):
        sector = pt.ScalarSector(F, potential=potential)
        self.dx = 5.0 / grid[0]
        if gw:
            make = lambda: pt.FusedPreheatStepper(  # noqa: E731
                sector, pt.TensorPerturbationSector([sector]), grid,
                self.dx, h, dtype=dtype, carry_dtype=carry, device="cpu")
        else:
            make = lambda: pt.FusedScalarStepper(  # noqa: E731
                sector, grid, self.dx, h, dtype=dtype, carry_dtype=carry,
                chunk_stages=4 if chunk else 0, device="cpu")
        self.new = built(make(), defines=args.defines)
        self.old = (built(make(), Path(args.against) / "pystella_tpu_torch"
                          / "ops" / "csrc", args.defines)
                    if args.against else None)
        if chunk and self.old and self.old.chunk_kernel_tile(dtype) is None:
            # the other checkout has no chunk kernel for this model
            self.old = None
        self.grid, self.h, self.F = grid, h, F
        self.defines = args.defines
        self.tol = 1e-5 if dtype == torch.float32 else 1e-13
        g = torch.Generator().manual_seed(0)
        amps = (1e-3, 1e-4, 1e-5, 1e-3, 1e-3, 1e-4, 1e-5, 1e-4)
        self.ins = [(a * torch.randn((c,) + grid, generator=g,
                                     dtype=dtype)).to(d)
                    for a, c, d in zip(amps, self.new._comps,
                                       self.new._in_dtypes(False))]
        tile = (self.new.chunk_kernel_tile(dtype) if chunk else
                self.new.march_kernel_tile(dtype, tile_src))
        self.name = (f"{'GW ' if gw else ''}F{F} h{h} {grid} "
                     f"{str(dtype)[6:]} {'bf16' if carry else 'T'} tile {tile}")

    def launch(self, K, ins, p, kind=None):
        """This checkout's launch, and whether the other checkout's equals
        it (True without one)."""
        outs = []
        for st in filter(None, (self.new, self.old)):
            with shim():
                outs.append(st.launch(K, ins, nans(st), p) if kind is None
                            else st.launch_block(K, kind, ins, nans(st), p))
        return outs[0], len(outs) == 1 or same(*outs)

    def window(self, K, hx, hy, ins=None):
        wins = tfused._WINDOWS[K]
        return [pad(t, hx, hy) if j in wins else t
                for j, t in enumerate(ins or self.ins)]

    def run(self, kernels, kinds=True, ins=None, label=""):
        """Each of ``kernels`` on ``ins`` (the case's inputs by default)."""
        X, h, n = self.grid[0], self.h, len(self.new._comps)
        ins = ins or self.ins
        other = " and other checkout" if self.old else ""
        for K in kernels:
            p = params(tfused._GW_OF.get(K, K), self.dx)
            tag = f"{self.name} {K}{label}"
            a, ok = self.launch(K, ins, p)
            if self.old:
                check(f"{tag} == other checkout", ok)
            err = max(rel(x, y) for x, y in zip(
                a[:n], self.new.plain(K, ins, p)[:n]))
            check(f"{tag} vs plain {err:.1e}", err <= self.tol)
            if not kinds:
                continue
            for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                                   ("xypad", (h, h))):
                pa, ok = self.launch(K, self.window(K, hx, hy, ins), p, kind)
                check(f"{tag}:{kind} == unpadded{other}", ok and same(pa, a))
            if K in ("fused_pair", "fused_stage", "preheat_stage") \
                    and X > 2 * h:
                self.shells(K, p, a)
            if tfused.SUM_SETS[K] and X % 2 == 0:
                self.two_blocks(K, p, a, ins)

    def run_stage(self, sc):
        """K5' and K7, and K5 and K2 of the scalar case ``sc`` (the same
        model, lattice and inputs; K5' and K5 also on finalized velocity
        carries): each vs its plain version, padded, K7's and K2's interior
        and shells, two x blocks; K5''s lattice outputs bit for bit K7's, its
        scalar outputs and sums K5's, K5's scalar outputs K2's, and K2's
        launches the per-site build's (:meth:`per_site_stage`)."""
        K5p, K7, K5, K2 = ("preheat_stage_energy", "preheat_stage",
                           "fused_stage_energy", "fused_stage")
        n, st = len(self.new._comps), self.new
        sets = [("", self.ins)]
        if st.carry_dtype is not None:
            sets.append((" fin", [t.to(d) for t, d in zip(
                self.ins, st._in_dtypes(True))]))
        kinds = self.grid != (2, 2, 2)
        for label, ins in sets:
            self.run([K5p] + ([] if label else [K7]), kinds, ins, label)
            sc.run([K5] + ([] if label else [K2]), kinds, ins[:4], label)
            p = params(K5, self.dx)
            with shim():
                a = st.launch(K5p, ins, nans(st), p)
                c = sc.new.launch(K5, ins[:4], nans(sc.new), p)
                if not label:
                    b = st.launch(K7, ins, nans(st), p)
                    d = sc.new.launch(K2, ins[:4], nans(sc.new), p)
            if not label:
                check(f"{self.name} {K5p} lattice outputs == K7's",
                      same(a[:n], b))
                check(f"{sc.name} {K5} scalar outputs == K2's",
                      same(c[:4], d))
            check(f"{self.name} {K5p}{label} scalar outputs and sums == "
                  "K5's", same(a[:4] + a[n:], c))
        sc.per_site_stage(self.ins[:4], kinds)

    def per_site_stage(self, ins, kinds):
        """K2 (the march) equals the K2 of this checkout's
        ``PK_STAGE_PER_SITE 1`` build bit for bit: unpadded, padded and as
        an interior launch plus two shells."""
        st, X, h, K2 = self.new, self.grid[0], self.h, "fused_stage"
        lib = ctypes.CDLL(str(build(CSRC, "fused_stage.cu",
                                    st.kernel_header() + self.defines
                                    + "#define PK_STAGE_PER_SITE 1\n")))
        march = dict(st._libs)
        per_site = dict(march)
        for key, fn in march.items():
            if key[0] == K2:
                other = getattr(lib, fn.__name__)
                other.argtypes, other.restype = fn.argtypes, fn.restype
                per_site[key] = other
        p = params(K2, self.dx)
        got = {}
        for label, fns in (("march", march), ("per site", per_site)):
            st._libs = fns
            with shim():
                got[label] = [st.launch(K2, ins, nans(st), p)]
                if kinds:
                    for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                                           ("xypad", (h, h))):
                        got[label].append(st.launch_block(
                            K2, kind, self.window(K2, hx, hy, ins), nans(st),
                            p))
                if kinds and X > 2 * h:
                    xpad = self.window(K2, h, 0, ins)
                    outs = nans(st)
                    st.launch_block(K2, "interior", ins, outs, p, x0=h)
                    for x0 in (0, X - h):
                        st.launch_block(K2, "shell", [
                            t.narrow(1, x0, 3 * h).contiguous()
                            if j in tfused._WINDOWS[K2] else t
                            for j, t in enumerate(xpad)], outs, p, x0=x0)
                    got[label].append(outs)
        st._libs = march
        check(f"{self.name} {K2} == the per-site build's, "
              f"{len(got['march'])} launches",
              all(same(a, b) for a, b in zip(got["march"], got["per site"])))

    def run_chunk(self):
        """K10 vs its plain version, vs two K3 launches and, with
        ``--against``, vs the other checkout's K10."""
        p = chunk_params(self.dx)
        tag = f"{self.name} fused_chunk"
        a, ok = self.launch("fused_chunk", self.ins, p)
        if self.old:
            check(f"{tag} == other checkout", ok)
        err = max(rel(x, y) for x, y in zip(
            a, self.new.plain("fused_chunk", self.ins, p)))
        check(f"{tag} vs plain {err:.1e}", err <= self.tol)
        st = self.new
        with shim():
            mid = st.launch("fused_pair", self.ins, nans(st), p[:9])
            two = st.launch("fused_pair", mid, nans(st), p[:1] + p[9:])
        check(f"{tag} == two K3 launches", same(a, two))

    def shells(self, K, p, a):
        """The interior launch and the two shells equal ``:xpad``."""
        X, h, st = self.grid[0], self.h, self.new
        xpad = self.window(K, h, 0)
        wins = tfused._WINDOWS[K]
        outs = nans(st)
        with shim():
            st.launch_block(K, "interior", self.ins, outs, p, x0=h)
            for x0 in (0, X - h):
                st.launch_block(K, "shell", [
                    t.narrow(1, x0, 3 * h).contiguous() if j in wins else t
                    for j, t in enumerate(xpad)], outs, p, x0=x0)
        check(f"{self.name} {K} interior + shells == xpad",
              same(outs, a[:len(st._comps)]))

    def two_blocks(self, K, p, a, ins=None):
        """Two x blocks writing partials at their whole-lattice places give
        the unsharded sums."""
        (X, Y, Z), h, st = self.grid, self.h, self.new
        nb = st._num_blocks(X, Y, Z)
        buf = torch.full((tfused.SUM_SETS[K] * (2 * self.F + 1) * nb,),
                         float("nan"), dtype=st.dtype)
        xpad = self.window(K, h, 0, ins)
        wins = tfused._WINDOWS[K]
        outs = nans(st)
        with shim():
            for x0 in (0, X // 2):
                st.launch_block(K, "xpad", [
                    t.narrow(1, x0, X // 2 + 2 * h).contiguous()
                    if j in wins else t for j, t in enumerate(xpad)],
                    outs, p, x0=x0, partials=(buf, nb, x0, 0, -(-Y // 8)))
            sums = st._finish_sums(K, buf, nb, "cpu")
        check(f"{self.name} {K} two x blocks' partials == unsharded",
              same(outs + sums, a))


def scalar(args):
    kernels = ("fused_pair", "coupled_pair", "coupled_pair_deferred")
    for grid, dtype, carry in itertools.product(
            [(16, 16, 16), (70, 12, 40), (5, 9, 33)],
            [torch.float32, torch.float64], [None, torch.bfloat16]):
        Case(args, 2, 2, grid, dtype, carry, bench_potential).run(kernels)
    for dtype, carry in itertools.product([torch.float32, torch.float64],
                                          [None, torch.bfloat16]):
        Case(args, 5, 4, (37, 12, 40), dtype, carry,
             many_potential(5)).run(kernels)
    for h in (1, 3):
        Case(args, 3, h, (19, 10, 35), torch.float64, None,
             many_potential(3)).run(kernels)
    Case(args, 1, 2, (2, 2, 2), torch.float64, None,
         lambda f: 0.5 * f[0]**2).run(kernels, kinds=False)


def gw(args):
    kernels = ("preheat_pair", "preheat_coupled_pair",
               "preheat_coupled_pair_deferred")
    for grid, dtype, carry in [((16, 16, 16), torch.float32, None),
                               ((70, 12, 40), torch.float64, None),
                               ((5, 9, 33), torch.float32, torch.bfloat16)]:
        Case(args, 2, 2, grid, dtype, carry, bench_potential,
             gw=True).run(kernels)
    Case(args, 5, 4, (13, 12, 40), torch.float64, torch.bfloat16,
         many_potential(5), gw=True).run(kernels)


def chunk(args):
    for grid, dtype, carry in itertools.product(
            [(16, 16, 16), (70, 12, 40), (5, 9, 33), (2, 2, 2)],
            [torch.float32, torch.float64], [None, torch.bfloat16]):
        Case(args, 2, 2, grid, dtype, carry, bench_potential,
             chunk=True).run_chunk()
    for h in (1, 3):
        Case(args, 3, h, (19, 10, 35), torch.float64, None,
             many_potential(3), chunk=True).run_chunk()
    for carry in (None, torch.bfloat16):
        Case(args, 5, 4, (13, 12, 40), torch.float64, carry,
             many_potential(5), chunk=True).run_chunk()


def stage(args):
    def case(F, h, grid, dtype, carry, potential):
        sc = Case(args, F, h, grid, dtype, carry, potential,
                  tile_src="fused_stage.cu")
        Case(args, F, h, grid, dtype, carry, potential, gw=True,
             tile_src="fused_stage.cu").run_stage(sc)
    for grid, dtype, carry in [((16, 16, 16), torch.float32, None),
                               ((70, 12, 40), torch.float64, None),
                               ((5, 9, 33), torch.float32, torch.bfloat16),
                               ((16, 16, 16), torch.float64, torch.bfloat16),
                               ((2, 2, 2), torch.float64, None)]:
        case(2, 2, grid, dtype, carry, bench_potential)
    for h in (1, 3):
        case(3, h, (19, 10, 35), torch.float64, None, many_potential(3))
    case(5, 4, (13, 12, 40), torch.float64, torch.bfloat16,
         many_potential(5))
    case(10, 4, (6, 9, 33), torch.float64, None, many_potential(10))


class FdCase:
    """The operators, which all march, at stencil radius ``h`` on a
    seeded ``(C, X, Y, Z)`` input (``fd_div``: ``(3 C, X, Y, Z)``, C
    vectors): this checkout's library, one built with every operator per
    site (``PK_FD_PER_SITE 1``) and, with ``--against``, another
    checkout's."""

    def __init__(self, args, h, grid, dtype, C=2):
        header = tderivs.kernel_header(h)
        with ThreadPoolExecutor(3) as pool:
            libs = list(pool.map(lambda a: ctypes.CDLL(str(build(*a))), [
                (CSRC, "fd_ops.cu", header + args.defines),
                (CSRC, "fd_ops.cu", header + args.defines
                 + "#define PK_FD_PER_SITE 1\n")] + ([
                (Path(args.against) / "pystella_tpu_torch" / "ops" / "csrc",
                 "fd_ops.cu", header)] if args.against else [])))
        isz = dtype.itemsize
        tiles = [(tderivs.reported_lap_tile(libs[0].pk_fd_lap_tile, dtype),
                  tderivs.lap_tile(h, isz)),
                 (tderivs.reported_lap_tile(libs[1].pk_fd_lap_tile, dtype),
                  (0,) + tderivs.lap_tile(h, isz)[1:])]
        for query, mirror in tderivs.QUEUE_TILES.values():
            want = mirror(h, isz)
            tiles += [(tderivs.reported_queue_tile(getattr(libs[0], query),
                                                   dtype), want),
                      (tderivs.reported_queue_tile(getattr(libs[1], query),
                                                   dtype), (0,) + want[1:])]
        for got, want in tiles:
            if got != want:
                raise RuntimeError(f"fd_ops.cu's tile {got}, the mirror's "
                                   f"{want}")
        fns = [tderivs.bind_kernels(lib) for lib in libs]
        self.libs = [fns[0]] + fns[2:]
        self.per_site = fns[1]
        self.fd = pt.FiniteDifferencer(h, 5.0 / grid[0], device="cpu")
        self.h, self.grid = h, grid
        self.tol = 1e-5 if dtype == torch.float32 else 1e-13
        g = torch.Generator().manual_seed(h)
        self.x = torch.randn((C,) + grid, generator=g, dtype=dtype)
        self.v = torch.randn((3 * C,) + grid, generator=g, dtype=dtype)
        self.name = (f"h{h} {(C,) + grid} {str(dtype)[6:]} tiles "
                     f"{[t[0] for t in tiles[::2]]}")

    def input(self, op):
        return self.v if op == "div" else self.x

    def nans(self, op):
        """Fresh outputs of ``op`` (an operator of OPS), all NaN."""
        x = self.x
        grad = torch.full((x.shape[0], 3) + self.grid, float("nan"),
                          dtype=x.dtype)
        lap = torch.full_like(x, float("nan"))
        return {"grad": [grad], "grad_lap": [grad, lap]}.get(op, [lap])

    def launch(self, op, kind, win, x0=0, outs=None, libs=None):
        """Every library's (or ``libs``') launch of ``op``, into fresh
        outputs or into copies of ``outs``."""
        got = []
        for fns in libs or self.libs:
            tderivs._LIBS[self.h] = fns
            o = ([t.clone() for t in outs] if outs is not None
                 else self.nans(op))
            with shim():
                self.fd.launch_block(op, kind, win, o, x0)
            got.append(o)
        tderivs._LIBS.pop(self.h)
        return got

    def run(self):
        h, X = self.h, self.grid[0]
        other = " and other checkout" if len(self.libs) > 1 else ""
        res = {}
        for op in tderivs.OPS:
            tag = f"fd_{op} {self.name}"
            x = self.input(op)
            a = self.launch(op, None, x)
            if other:
                check(f"{tag} == other checkout", same(*a))
            a = res[op] = a[0]
            err = max(rel(o, p) for o, p in zip(a, self.fd.plain(op, x)))
            check(f"{tag} vs plain {err:.1e}", err <= self.tol)
            ps = self.launch(op, None, x, libs=[self.per_site])[0]
            check(f"{tag} == the per-site fd_{op}", same(a, ps))
            for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                                   ("xypad", (h, h))):
                if min(self.grid[:2]) < h:
                    break  # no neighbour holds h rows
                pa = self.launch(op, kind, pad(x, hx, hy))
                check(f"{tag}:{kind} == unpadded{other}",
                      all(same(o, a) for o in pa))
            if X > 2 * h:
                xpad = pad(x, h, 0)
                outs = self.nans(op)
                for fns in self.libs:
                    tderivs._LIBS[h] = fns
                    o = [t.clone() for t in outs]
                    with shim():
                        self.fd.launch_block(op, "interior", x, o, x0=h)
                        for x0 in (0, X - h):
                            self.fd.launch_block(op, "shell", xpad.narrow(
                                1, x0, 3 * h).contiguous(), o, x0=x0)
                    check(f"{tag} interior + shells == unpadded",
                          same(o, a))
                tderivs._LIBS.pop(h)
        ps = self.launch("grad_lap", None, self.x, libs=[self.per_site])[0]
        check(f"fd_lap {self.name} == the per-site fd_grad_lap's Laplacian",
              same(res["lap"], ps[1:]))
        check(f"fd_grad_lap {self.name} == (fd_grad, fd_lap)",
              same(res["grad_lap"], res["grad"] + res["lap"]))
        check(f"fd_grad {self.name} == (fd_pdx, fd_pdy, fd_pdz)",
              all(torch.equal(res["grad"][0][:, d], res[op][0])
                  for d, op in enumerate(("pdx", "pdy", "pdz"))))


def fd(args):
    for h, dtype in itertools.product((1, 2, 3, 4),
                                      (torch.float32, torch.float64)):
        for grid in ((16, 16, 16), (70, 12, 40), (5, 9, 33), (2, 2, 2)):
            FdCase(args, h, grid, dtype).run()
    FdCase(args, 2, (9, 20, 70), torch.float32, C=5).run()


def mg_problem(kind):
    """A relaxation solver class, its equations, omega and auxiliary
    inputs: the Newton FAS problem of the multigrid main path (one
    unknown), the Jacobi Poisson + Helmholtz pair (two) and a Newton
    problem that reads a lattice array and two scalars."""
    fld = pt.Field
    if kind == "newton":
        f = fld("f")
        return (pt.NewtonIterator, {f: (fld("lap_f") - f + f**3,
                                        fld("rho"))}, 2 / 3, {})
    if kind == "jacobi":
        return pt.JacobiIterator, {
            fld("f"): (fld("lap_f"), fld("rho")),
            fld("f2"): (fld("lap_f2") - fld("f2"), fld("rho2"))}, 1 / 2, {}
    lhs = fld("lap_f") - pt.Var("m2") * fld("f") + fld("c") * fld("g")
    return (pt.NewtonIterator, {fld("f"): (lhs, fld("rho"))}, 2 / 3,
            {"g": None, "m2": 0.5, "c": 2.0})


#: the site threshold of a build that marches every launch, and of one
#: that runs every launch per site
MG_ALL, MG_NONE = 1, 2**31 - 1


class MgCase:
    """The sweeps (``mg_smooth`` one and three sweeps, ``mg_residual``,
    ``mg_tau``) of ``problem`` at stencil radius ``h`` on a seeded level:
    libraries that march every launch (``MG_MARCH_MIN_SITES`` 1), run every
    launch per site, and keep the source's threshold; with ``--against``
    another checkout's."""

    def __init__(self, args, problem, h, grid, dtype):
        cls, lhs, omega, aux = mg_problem(problem)
        self.solver = cls(lhs, halo_shape=h, omega=omega, device="cpu")
        g = torch.Generator().manual_seed(h)
        names = list(self.solver.f_to_rho_dict)
        rand = lambda: torch.rand(grid, generator=g, dtype=dtype) - 0.5  # noqa
        self.fs = {n: rand() for n in names}
        self.rhos = {r: rand() for r in self.solver.f_to_rho_dict.values()}
        self.aux = {k: rand() if v is None else v for k, v in aux.items()}
        self.struct = self.solver._aux_struct(self.aux)
        header = self.solver.kernel_header(self.struct)
        plane = lambda n: f"#define MG_MARCH_MIN_SITES {n}\n"  # noqa
        srcs = [(CSRC, header + args.defines + plane(MG_ALL)),
                (CSRC, header + args.defines + plane(MG_NONE)),
                (CSRC, header + args.defines)]
        if args.against:
            srcs.append((Path(args.against) / "pystella_tpu_torch" / "ops"
                         / "csrc", header))
        with ThreadPoolExecutor(len(srcs)) as pool:
            libs = list(pool.map(lambda a: ctypes.CDLL(str(build(
                a[0], "mg_relax.cu", a[1]))), srcs))
        for lib, n in zip(libs, (MG_ALL, MG_NONE, None)):
            self.solver.check_tile(lib, lx=args.lx, min_sites=n)
        self.libs = [trelax.bind_kernels(lib) for lib in libs]
        self.level = trelax.LevelSpec(grid, (5.0 / grid[0], 0.4, 0.3))
        self.h, self.grid = h, grid
        self.tol = 1e-5 if dtype == torch.float32 else 1e-13
        tile = trelax.mg_tile(h, dtype.itemsize, len(names), lx=args.lx)
        self.name = (f"{problem} h{h} {grid} {str(dtype)[6:]} "
                     f"tile {tile}")

    def sweep(self, fns, kind, nu=1):
        """One call of ``kind`` (``nu`` sweeps) with the library ``fns``."""
        self.solver._libs[self.struct] = fns
        rhos = self.rhos
        if kind == "tau":
            rhos = {r: self.fs[n] * 0.5
                    for n, r in self.solver.f_to_rho_dict.items()}
        with shim():
            out = self.solver.launch(kind, self.level, self.fs, rhos,
                                     self.aux, nu)
        return out, rhos

    def block(self, fns, kind, wins, outs, pad_kind, x0=0):
        self.solver._libs[self.struct] = fns
        rhos = list(self.rhos.values())
        with shim():
            return self.solver.launch_block(kind, self.level, wins, rhos,
                                            self.aux, outs, pad_kind, x0)

    def run(self):
        h, (X, Y, _) = self.h, self.grid
        march, per_site, default, *other = self.libs
        names = list(self.solver.f_to_rho_dict)
        for kind, nu in (("smooth", 1), ("smooth", 3), ("residual", 1),
                         ("tau", 1)):
            tag = f"mg_{kind} x{nu} {self.name}"
            a, rhos = self.sweep(march, kind, nu)
            s = self.solver
            lat = {k: v for k, v in self.aux.items()
                   if not isinstance(v, float)}
            plain = s.plain(kind, self.level, list(self.fs.values()),
                            [rhos[s.f_to_rho_dict[n]] for n in names], lat,
                            {k: v for k, v in self.aux.items()
                             if isinstance(v, float)}, nu)
            err = max(rel(o, p) for o, p in zip(a, plain))
            check(f"{tag} vs plain {err:.1e}", err <= self.tol)
            check(f"{tag} == per-site", same(a, self.sweep(
                per_site, kind, nu)[0]))
            check(f"{tag} == the default build", same(a, self.sweep(
                default, kind, nu)[0]))
            for fns in other:
                check(f"{tag} == other checkout", same(a, self.sweep(
                    fns, kind, nu)[0]))
        fs = [t.unsqueeze(0) for t in self.fs.values()]
        nan = lambda: [torch.full(self.grid, float("nan"),  # noqa: E731
                                  dtype=fs[0].dtype) for _ in names]
        for kind in ("smooth", "residual", "tau"):
            tag = f"mg_{kind} {self.name}"
            ref = self.block(march, kind, [f[0] for f in fs], nan(), None)
            for pk, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                                 ("xypad", (h, h))):
                if min(X, Y) < h:
                    break  # no neighbour holds h rows
                wins = [pad(f, hx, hy)[0] for f in fs]
                for label, fns in [("", march)] + [
                        (" (other checkout)", o) for o in other]:
                    got = self.block(fns, kind, wins, nan(), pk)
                    check(f"{tag}:{pk}{label} == unpadded", same(got, ref))
            if X > 2 * h:
                xp = [pad(f, h, 0)[0] for f in fs]
                for label, fns in [("", march)] + [
                        (" (other checkout)", o) for o in other]:
                    outs = nan()
                    self.block(fns, kind, [f[0] for f in fs], outs,
                               "interior", h)
                    for x0 in (0, X - h):
                        self.block(fns, kind, [w.narrow(0, x0, 3 * h)
                                               .contiguous() for w in xp],
                                   outs, "shell", x0)
                    check(f"{tag} interior + shells{label} == unpadded",
                          same(outs, ref))


def mg(args):
    for problem, h in itertools.product(("newton", "jacobi", "aux"),
                                        (1, 2)):
        for grid, dtype in itertools.product(
                ((16, 16, 16), (70, 12, 40), (5, 9, 33), (2, 2, 2)),
                (torch.float32, torch.float64)):
            MgCase(args, problem, h, grid, dtype).run()
    for problem in ("newton", "jacobi"):
        MgCase(args, problem, 4, (13, 12, 40), torch.float64).run()


#: K13 / K14 sums against their plain versions and the grouping build,
#: relative to the largest bin: float64 sums in another order
HIST_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
#: K15's rms against its plain version, relative (the float64 sums add in
#: another order)
HEALTH_TOL = 1e-13

#: the histogram.cu build that bins counts and K14 through the warp grouping
HIST_MATCH = "\n#define PK_HIST_MATCH 1\n"


def hist_libs(args):
    """The bound entry points of histogram.cu as the port builds it
    (``kernel``; held to ``hist_smem`` as ``build_kernels`` holds it), of
    its grouping build (``match``) and, with ``--against``, of the other
    checkout's (``against``)."""
    builds = {"kernel": (CSRC, thist._HEADER),
              "match": (CSRC, thist._HEADER + HIST_MATCH)}
    if args.against:
        builds["against"] = (Path(args.against) / "pystella_tpu_torch" / "ops"
                             / "csrc", thist._HEADER)
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(
            lambda b: build(b[0], "histogram.cu", b[1]), builds.values())))
    keep = thist._stencil.build_kernels
    thist._stencil.build_kernels = lambda sources, header: {
        "histogram.cu": ctypes.CDLL(str(paths["kernel"]))}
    try:
        thist._LIB.clear()
        libs = {"kernel": dict(thist.build_kernels())}
    finally:
        thist._stencil.build_kernels = keep
    libs.update({k: thist.bind_kernels(ctypes.CDLL(str(v)))
                 for k, v in paths.items() if k != "kernel"})
    return libs


def hist_run(fns, fn, *a):
    """``fn(*a)`` under the shim with the entry points ``fns`` bound."""
    keep = dict(thist._LIB)
    thist._LIB.update(fns)
    try:
        with shim():
            return fn(*a)
    finally:
        thist._LIB.update(keep)


def hist_bins(kind, shape, nbins, g):
    """Seeded int32 bins: uniform over ``[-1, nbins]`` (some out of range),
    every site one bin (``hot1``), 90% of the sites in two bins (``hot2``),
    sorted (long runs) or uniform from a 4-byte offset (every unit's first
    bin off 16-byte alignment: the scalar loads)."""
    b = torch.randint(-1, nbins + 1, shape, generator=g, dtype=torch.int32)
    if kind == "hot1":
        b.fill_(nbins // 2)
    elif kind == "hot2":
        u = torch.rand(shape, generator=g)
        b = torch.where(u < 0.45, nbins // 3, torch.where(
            u < 0.9, nbins - 1, b)).to(torch.int32)
    elif kind == "sorted":
        b = b.reshape(-1).sort().values.reshape(shape)
    elif kind == "misaligned":
        b = torch.cat([torch.zeros(1, dtype=torch.int32),
                       b.reshape(-1)])[1:].view(shape)
        assert b.is_contiguous() and b.data_ptr() % 16
    return b


def hist(args):
    """K13, K14 and the finish launch against their plain versions, the
    grouping build and (``--against``) the other checkout's kernels."""
    libs = hist_libs(args)
    others = [k for k in libs if k != "kernel"]
    g = torch.Generator().manual_seed(5)
    grids = ((16, 16, 16), (5, 9, 33)) if args.small else (
        (16, 16, 16), (48, 40, 36), (5, 9, 33))
    wdts = (None, torch.float32, torch.float64)
    cases = [(grid, "uniform", outer, nbins, wdt) for grid in grids
             for outer in ((2,) if args.small else (1, 2, 6))
             for nbins in (7, 1000) for wdt in wdts]
    # --small: the weights on uniform and hot2 bins only
    cases += [(grid, kind, 2, 1000, wdt) for grid in grids
              for kind in ("hot1", "hot2", "sorted", "misaligned")
              for wdt in (wdts if kind == "hot2" or not args.small
                          else (None,))]
    for grid, kind, outer, nbins, wdt in cases:
        label = "counts" if wdt is None else str(wdt).split(".")[1]
        tag = f"bincount {label} {kind} {grid} outer {outer} bins {nbins}"
        b = hist_bins(kind, (outer,) + grid, nbins, g)
        w = None if wdt is None else torch.randn(
            (outer,) + grid, generator=g, dtype=torch.float64).to(wdt)
        plain = thist.bincount_plain(b, w, nbins)
        one, two = (hist_run(libs["kernel"], thist.bincount, b, w, nbins)
                    for _ in range(2))
        check(tag, (torch.equal(one, plain) if w is None
                    else rel(one, plain) <= HIST_TOL[wdt])
              and torch.equal(one, two))
        # counts: any order gives the same integers; the weighted entry
        # points keep the grouping, every build's bits
        for other in others:
            check(f"{tag} == {other}", torch.equal(
                hist_run(libs[other], thist.bincount, b, w, nbins), one))
        for mesh in ((2, 1, 1), (2, 2, 1)):
            if grid[1] // mesh[1] % thist.unit_rows(grid[1]) or \
                    grid[0] % mesh[0] or grid[1] % mesh[1]:
                continue
            d = pt.DomainDecomposition(mesh, devices=["cpu"] * (
                2 * mesh[1]))
            sharded = hist_run(libs["kernel"], thist.bincount, d.shard(b),
                               None if w is None else d.shard(w), nbins)
            check(f"{tag} {mesh}", torch.equal(sharded, one))
    # r2c and c2c; (2, 4, 600): rows of 301 and 600 sites, in segments
    for grid, dtype, real in itertools.product(
            grids + ((2, 4, 600),), (torch.float32, torch.float64),
            (True, False)):
        ndt = {torch.float32: "float32", torch.float64: "float64"}[dtype]
        if not real:
            ndt = {"float32": "complex64", "float64": "complex128"}[ndt]
        lat = pt.Lattice(grid, (5.0, 4.0, 7.0))
        ft = pt.DFT(None, grid_shape=grid, dtype=ndt, device="cpu")
        sp = pt.PowerSpectra(None, ft, lat.dk, lat.volume)
        cdt = {torch.float32: torch.complex64,
               torch.float64: torch.complex128}[dtype]
        fk = torch.randn((2,) + ft.shape(True), generator=g,
                         dtype=cdt)
        head = f"spectra_bin {'r2c' if real else 'c2c'} {grid} {dtype}"
        for kp in (3, 0):
            tag = f"{head} k^{kp}"
            plain = sp.binner.plain(fk, kp)
            one, two = (hist_run(libs["kernel"], sp.binner, fk, kp)
                        for _ in range(2))
            check(tag, rel(one, plain) <= HIST_TOL[dtype]
                  and torch.equal(one, two))
            # the sums in another order than the other builds': HIST_TOL
            for other in others:
                check(f"{tag} ~ {other}", rel(hist_run(
                    libs[other], sp.binner, fk, kp), one) <= HIST_TOL[dtype])
        # unit modes and no k weight: the shells' counts, exact
        ones = torch.ones_like(fk)
        counts = hist_run(libs["kernel"], sp.binner, ones, 0)
        check(f"{head} bins exact",
              torch.equal(counts, sp.binner.plain(ones, 0)))
        for other in others:
            check(f"{head} bins == {other}", torch.equal(
                hist_run(libs[other], sp.binner, ones, 0), counts))
        for mesh in ((2, 1, 1), (2, 2, 1)):
            ks = ft.shape(True)
            if ks[1] // mesh[1] % thist.unit_rows(ks[1]) or \
                    ks[0] % mesh[0] or ks[1] % mesh[1]:
                continue
            d = pt.DomainDecomposition(mesh, devices=["cpu"] * (
                2 * mesh[1]))
            sharded = hist_run(libs["kernel"], sp.binner, d.shard(fk), 3)
            whole = hist_run(libs["kernel"], sp.binner, fk, 3)
            check(f"{head} {mesh}", torch.equal(sharded, whole))
        # wide shells (about four a row): runs across many lanes
        wide = thist.SpectraBins(
            sp.binner.sq_axes, 4 * sp.bin_width * max(grid) / 8, grid,
            real, 6)
        tag = f"{head} wide shells"
        one = hist_run(libs["kernel"], wide, fk, 3)
        check(tag, rel(one, wide.plain(fk, 3)) <= HIST_TOL[dtype]
              and torch.equal(hist_run(libs["kernel"], wide, fk, 3), one))
        for other in others:
            check(f"{tag} ~ {other}", rel(hist_run(
                libs[other], wide, fk, 3), one) <= HIST_TOL[dtype])
        check(f"{tag} bins exact", torch.equal(
            hist_run(libs["kernel"], wide, ones, 0), wide.plain(ones, 0)))


def health_libs(args):
    """The bound entry points of health.cu as the port builds it
    (``kernel``) and, with ``--against``, of the other checkout's
    (``against``, where that checkout has the source)."""
    builds = {"kernel": CSRC}
    other = (Path(args.against) / "pystella_tpu_torch" / "ops" / "csrc"
             if args.against else None)
    if other is not None and (other / "health.cu").exists():
        builds["against"] = other
    return {k: thealth.bind_kernels(ctypes.CDLL(str(
                build(v, "health.cu", thealth._HEADER))))
            for k, v in builds.items()}


def health_run(fns, *a, **kw):
    """K15's wrapper under the shim with the entry points ``fns``."""
    keep = dict(thealth._LIB)
    thealth._LIB.clear()
    thealth._LIB.update(fns)
    try:
        with shim():
            return thealth.field_stats(*a, **kw)
    finally:
        thealth._LIB.clear()
        thealth._LIB.update(keep)


def health_field(shape, dtype, kind, g):
    """A seeded field with a poisoned site: ``clean``, ``nan``, ``inf``,
    ``-inf``, ``overflow`` (finite values whose square overflows f32 and
    bf16, 1e20) or ``misaligned`` (a view 4 bytes off 16-byte alignment:
    the scalar loads)."""
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if kind == "overflow":
        x = x * 1e20
    elif kind in ("nan", "inf", "-inf"):
        flat = x.view(-1)
        flat[int(torch.randint(flat.numel(), (1,), generator=g))] = float(
            kind)
    x = x.to(dtype)
    if kind == "misaligned":
        x = torch.cat([torch.zeros(16 // x.element_size() + 1,
                                   dtype=dtype), x.reshape(-1)])[1:]
        x = x[16 // x.element_size():].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    return x


def health_agrees(got, ref, tol):
    """finite and max_abs equal (NaN where NaN), rms within ``tol``
    relative (equal where not finite)."""
    got, ref = got.double().view(-1, 3), ref.double().view(-1, 3)
    exact = torch.equal(got[:, :2].nan_to_num(7.0), ref[:, :2].nan_to_num(7.0))
    g, r = got[:, 2], ref[:, 2]
    fin = torch.isfinite(r)
    close = bool(((g[fin] - r[fin]).abs() <= tol * r[fin].abs()).all())
    same_nf = torch.equal(g[~fin].nan_to_num(7.0), r[~fin].nan_to_num(7.0))
    return exact and close and same_nf


def health(args):
    """K15 and its finish against their plain version: NaN, +-inf and
    overflowing sites, aligned and scalar loads, rows of several vector
    passes and more rows than a launch's warps, f32, f64 and bf16,
    launched twice for equal bits and on (2, 1, 1) and (2, 2, 1) blocks
    equal to the whole lattice's launch."""
    libs = health_libs(args)
    g = torch.Generator().manual_seed(15)
    shapes = ((2, 16, 16, 16), (5, 9, 33), (1, 2, 1200)) if args.small else (
        (2, 16, 16, 16), (5, 9, 33), (3, 4, 1200), (2, 32, 32, 8))
    kinds = ("clean", "nan", "inf", "-inf", "overflow", "misaligned")
    for shape, dtype, kind in itertools.product(
            shapes, (torch.float32, torch.float64, torch.bfloat16), kinds):
        tag = f"health {str(dtype).split('.')[1]} {shape} {kind}"
        x = health_field(shape, dtype, kind, g)
        y = health_field(shape, dtype, "clean", g)
        fields = [x, y]
        for odt in (torch.float64, torch.float32):
            plain = thealth.field_stats_plain(fields, odt)
            one, two = (health_run(libs["kernel"], fields, odt)
                        for _ in range(2))
            check(f"{tag} out {str(odt).split('.')[1]}",
                  health_agrees(one, plain, HEALTH_TOL)
                  and torch.equal(one.nan_to_num(7.0), two.nan_to_num(7.0))
                  and one.dtype == odt)
        if "against" in libs:
            check(f"{tag} == against", torch.equal(
                health_run(libs["against"], fields).nan_to_num(7.0),
                health_run(libs["kernel"], fields).nan_to_num(7.0)))
        if len(shape) < 3 or kind == "misaligned":
            continue
        whole = health_run(libs["kernel"], fields, torch.float64)
        for mesh in ((2, 1, 1), (2, 2, 1)):
            if shape[-3] % mesh[0] or shape[-2] % mesh[1]:
                continue
            d = pt.DomainDecomposition(mesh, devices=["cpu"] * (
                mesh[0] * mesh[1]))
            sharded = health_run(libs["kernel"], [d.shard(x), d.shard(y)],
                                 torch.float64)
            check(f"{tag} {mesh}", torch.equal(sharded.nan_to_num(7.0),
                                               whole.nan_to_num(7.0)))
    # one finish over fields of three dtypes
    fields = [health_field((2, 16, 16, 16), dt, "clean", g)
              for dt in (torch.float32, torch.float64, torch.bfloat16)]
    check("health mixed dtypes", health_agrees(
        health_run(libs["kernel"], fields, torch.float64),
        thealth.field_stats_plain(fields, torch.float64), HEALTH_TOL))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    family = parser.add_mutually_exclusive_group()
    family.add_argument("--gw", action="store_true",
                        help="the GW pairs K8 and K9 instead of K3 and K6")
    family.add_argument("--chunk", action="store_true",
                        help="the whole-RK chunk K10 instead of K3 and K6")
    family.add_argument("--stage", action="store_true",
                        help="the stage marches K5', K7, K5 and K2 instead "
                        "of K3 and K6")
    family.add_argument("--fd", action="store_true",
                        help="the operators fd_lap, fd_grad, fd_grad_lap, "
                        "fd_pd* and fd_div instead of K3 and K6")
    family.add_argument("--mg", action="store_true",
                        help="the multigrid sweeps K11 instead of K3 and K6")
    family.add_argument("--hist", action="store_true",
                        help="the binning kernels K13 and K14 instead of K3 "
                        "and K6")
    family.add_argument("--health", action="store_true",
                        help="the health kernel K15 and its finish instead "
                        "of K3 and K6")
    parser.add_argument("--lx", type=int, default=4,
                        help="the march's run length to build with")
    parser.add_argument("--against", metavar="DIR",
                        help="another checkout's root, held bit for bit")
    parser.add_argument("--small", action="store_true",
                        help="with --hist: the 16^3 and 5x9x33 lattices "
                        "(and 2x4x600 for K14) only, 2 outer slices, "
                        "weights on uniform and hot2 bins only; with "
                        "--health: 16^3, 5x9x33 and 1x2x1200")
    args = parser.parse_args()
    if args.gw:
        tfused.MARCH_LX = args.lx
        args.defines = f"\n#define PK_MARCH_LX {args.lx}\n"
    elif args.chunk:
        tfused.CHUNK_LX = args.lx
        args.defines = f"\n#define PK_CHUNK_LX {args.lx}\n"
    elif args.stage:
        tfused.STAGE_MARCH_LX = tfused.SCALAR_STAGE_MARCH_LX = args.lx
        args.defines = (f"\n#define PK_STAGE_MARCH_LX {args.lx}\n"
                        f"#define PK_SCALAR_STAGE_MARCH_LX {args.lx}\n")
    elif args.fd:
        tderivs.LAP_LX = tderivs.GRAD_LAP_LX = args.lx
        tderivs.GRAD_LX = tderivs.PD_LX = tderivs.DIV_LX = args.lx
        args.defines = "\n" + "".join(
            f"#define PK_FD_{op}_LX {args.lx}\n"
            for op in ("LAP", "GRAD", "GRAD_LAP", "PD", "DIV"))
    elif args.mg:
        args.defines = f"\n#define MG_MARCH_LX {args.lx}\n"
    elif args.hist or args.health:
        args.defines = ""
    else:
        tfused.SCALAR_MARCH_LX = args.lx
        args.defines = f"\n#define PK_SCALAR_MARCH_LX {args.lx}\n"
    t0 = time.time()
    (gw if args.gw else chunk if args.chunk else stage if args.stage
     else fd if args.fd else mg if args.mg else hist if args.hist
     else health if args.health else scalar)(args)
    failed = RESULTS.count(False)
    print(f"{len(RESULTS) - failed} ok, {failed} failed, "
          f"{time.time() - t0:.0f} s")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
