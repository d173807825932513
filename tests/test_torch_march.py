"""The x-march tile of the pair kernels (the scalar pairs K3, K6 and the GW
pairs K8, K9) and of the single stages that march (K5', K7 and K5) as the
host mirrors it (``pystella_tpu_torch.ops.fused.march_tile``), the
Laplacian's (``pystella_tpu_torch.ops.derivs.lap_tile``), the multigrid
sweeps' (``pystella_tpu_torch.multigrid.relax.mg_tile``), and the smoke
run's phase selection (``chip_smoke.py --phases``), march variants and
ptxas rows.

The kernels themselves run only on the card (tests/test_torch_kernels.py);
their shared memory per block is fixed at compile time by the rule the
mirror repeats, and a build holds the library's report to the mirror.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

import pystella_tpu_torch as pt
from pystella_tpu_torch.multigrid import relax as trelax
from pystella_tpu_torch.ops import derivs as tderivs
from pystella_tpu_torch.ops import fused as tfused

#: the most dynamic shared memory a block may use on sm_90
SMEM_MAX = 232448


def many_potential(n):
    """A potential of ``n`` fields: each massive, the first coupled to the
    others."""
    def potential(f):
        return (sum((0.5 + 0.1 * i) * f[i]**2 / 2 for i in range(n))
                + 0.25 * f[0]**2 * sum(f[i]**2 for i in range(1, n)))
    return potential


def _stepper(F, h, dtype, carry):
    sector = pt.ScalarSector(F, potential=many_potential(F))
    return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), (8, 8, 8), 0.1, h, dtype=dtype, carry_dtype=carry,
        device="cpu")


@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("carry", [None, torch.bfloat16], ids=["T", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1, 2, 5, 9, 12])
def test_march_tile_fits_every_accepted_stepper(F, dtype, carry, h):
    """Every field count, working dtype, carry dtype and stencil radius a
    GW stepper accepts has a tile: its shared memory -- per tapped array
    (f, f1 of a field, h, h1 of a component) the haloed centre plane and a
    ring of 2h+1 planes of the tile, in dynamic shared memory, beside the
    static per-warp partials of K9's 2 (2F + 1) sum terms -- fits a
    block's 232,448 bytes. Joint where a
    group of components fits beside every field (the components a pass
    holds divide the six, and more of them would not fit); split
    otherwise, with scalar passes of the most fields that fit and tensor
    passes of the most components that fit alone. The carries live in
    device memory only, so the tile is the carry dtype's to share."""
    st = _stepper(F, h, dtype, carry)
    (lx, gf, g, joint), nbytes = tfused.march_tile(
        st.F, st.h, st.dtype.itemsize, st.n_hij)
    assert lx == tfused.MARCH_LX and st.n_hij % g == 0
    isz = st.dtype.itemsize
    sites = (8 + 2 * h) * (32 + 2 * h) + (2 * h + 1) * 8 * 32
    sums = 2 * (2 * st.F + 1) * 8
    fits = lambda arrays: (arrays * sites + sums) * isz <= SMEM_MAX  # noqa
    bigger = [n for n in (6, 3, 2, 1) if n > g]
    if joint:
        assert gf == st.F
        assert nbytes == (2 * st.F + 2 * g) * sites * isz
        assert not any(fits(2 * st.F + 2 * n) for n in bigger)
    else:
        assert not fits(2 * st.F + 2)
        assert 1 <= gf <= st.F and fits(2 * gf)
        assert gf == st.F or not fits(2 * gf + 2)
        assert not any(fits(2 * n) for n in bigger)
        assert nbytes == 2 * max(gf, g) * sites * isz
    assert nbytes + sums * isz <= SMEM_MAX


#: elements of one tapped array in a march tile at stencil radius h: the
#: 32 x 8 tile's centre plane with its y-z halo, (8 + 2h) (32 + 2h), and a
#: ring of 2h + 1 planes of 256
TILE_SITES = {1: 1108, 2: 1712, 3: 2324, 4: 2944}


@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("carry", [None, torch.bfloat16], ids=["T", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1, 2, 5, 9, 12])
def test_scalar_march_tile_fits_every_accepted_stepper(F, dtype, carry, h):
    """Every field count, working dtype, carry dtype and stencil radius a
    scalar stepper accepts has a tile for K3 and K6, with no tensor
    component: f and f1 of each field a pass holds in a block's 232,448
    bytes, beside K6's per-warp partials. Joint (one pass of every field)
    below the first field count whose 2F arrays do not fit -- f64 from
    nine fields at h = 2 (five at h = 4), f32 from ten at h = 4 -- and
    split from there, with passes of one field fewer than that count. The
    carries live in device memory only, so the tile is the carry dtype's
    to share."""
    st = pt.FusedScalarStepper(pt.ScalarSector(F, potential=many_potential(
        F)), (8, 8, 8), 0.1, h, dtype=dtype, carry_dtype=carry,
        device="cpu")
    assert st._march_nh == 0
    isz = st.dtype.itemsize
    (lx, gf, g, joint), nbytes = tfused.march_tile(F, h, isz, st._march_nh)
    assert lx == tfused.SCALAR_MARCH_LX and g == 0
    first_split = {4: {1: 26, 2: 17, 3: 13, 4: 10},
                   8: {1: 13, 2: 9, 3: 7, 4: 5}}[isz][h]
    assert bool(joint) == (F < first_split)
    assert gf == (F if joint else first_split - 1)
    assert nbytes == 2 * gf * TILE_SITES[h] * isz <= SMEM_MAX


def test_march_tile_examples():
    """The main path's tile (f32, h = 2, two fields: joint, all six
    components a pass, 109,568 bytes), the f64 one at
    h = 4 (joint, two components a pass), and twelve fields in f64 at
    h = 4: split, four fields a scalar pass, three components a tensor
    pass."""
    assert tfused.march_tile(2, 2, 4) == ((32, 2, 6, 1), 109568)
    assert tfused.march_tile(2, 4, 8) == ((32, 2, 2, 1), 188416)
    assert tfused.march_tile(12, 4, 8) == ((32, 4, 3, 0), 188416)


@pytest.mark.parametrize("args,lx,want", [
    ((2, 2, 4), 32, ((32, 2, 0, 1), 27392)),
    ((5, 4, 8), 32, ((32, 4, 0, 0), 188416)),
    ((4, 4, 8), 32, ((32, 4, 0, 1), 188416)),
    ((7, 3, 8), 16, ((16, 6, 0, 0), 223104)),
    ((10, 4, 4), 24, ((24, 9, 0, 0), 211968)),
    ((9, 2, 8), 64, ((64, 8, 0, 0), 219136)),
], ids=["main-path", "f64-h4-split", "f64-h4-joint", "f64-h3-split",
        "f32-h4-split", "f64-h2-split"])
def test_scalar_march_tile_examples(args, lx, want):
    """The scalar march's tile (no tensor component): the main path's (f32,
    h = 2, two fields: joint, 4 x 1,712 elements, 27,392 bytes); five
    fields in f64 at h = 4 split four and one, four fields joint; the
    first split of f64 at h = 3 (seven fields: six and one), of f32 at
    h = 4 (ten: nine and one) and of f64 at h = 2 (nine: eight and one).
    Without ``lx`` the tile is the sources' default."""
    assert tfused.march_tile(*args, nh=0, lx=lx) == want
    F, h, isz = args
    assert tfused.march_tile(F, h, isz, 0) == tfused.march_tile(
        F, h, isz, 0, lx=tfused.SCALAR_MARCH_LX)


@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("carry", [None, torch.bfloat16], ids=["T", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1, 2, 5, 9, 10, 12])
def test_stage_march_tile_fits_every_accepted_stepper(F, dtype, carry, h):
    """Every field count, working dtype, carry dtype and stencil radius a
    GW stepper accepts has a tile for K5', which holds one array per
    tapped value (f of a field, h of a component) where a pair holds two:
    joint where a group of components (dividing the six, the most that
    fit) fits beside every field's f, as at f64 h = 4 up to eight fields
    (h = 3: eleven); split from there, with scalar passes of the most
    fields that fit and tensor passes of the most components that fit
    alone. The
    same budget as the pairs': what is left of a block's 232,448 bytes
    holds the static per-warp partials of 2 (2F + 1) sum terms."""
    st = _stepper(F, h, dtype, carry)
    isz = st.dtype.itemsize
    (lx, gf, g, joint), nbytes = tfused.march_tile(
        st.F, st.h, isz, st.n_hij, values=1)
    assert lx == tfused.STAGE_MARCH_LX and st.n_hij % g == 0
    sites = TILE_SITES[h]
    sums = 2 * (2 * F + 1) * 8
    fits = lambda arrays: (arrays * sites + sums) * isz <= SMEM_MAX  # noqa
    bigger = [n for n in (6, 3, 2, 1) if n > g]
    if joint:
        assert gf == F and nbytes == (F + g) * sites * isz
        assert not any(fits(F + n) for n in bigger)
    else:
        assert not fits(F + 1) and 1 <= gf <= F and fits(gf)
        assert gf == F or not fits(gf + 1)
        assert not any(fits(n) for n in bigger)
        assert nbytes == max(gf, g) * sites * isz
    split_from = {3: 12, 4: 9}.get(h) if isz == 8 else None
    assert bool(joint) == (split_from is None or F < split_from)
    assert nbytes + sums * isz <= SMEM_MAX


@pytest.mark.parametrize("args,kw,want", [
    ((2, 2, 4), {}, ((16, 2, 6, 1), 54784)),
    ((5, 4, 8), {}, ((16, 5, 3, 1), 188416)),
    ((10, 4, 8), {}, ((16, 9, 6, 0), 211968)),
    ((12, 2, 8), {"lx": 32}, ((32, 12, 3, 1), 205440)),
], ids=["main-path", "f64-h4-five", "f64-h4-split", "f64-h2-twelve"])
def test_stage_march_tile_examples(args, kw, want):
    """The K5' march's tile: the main path's (f32, h = 2, two fields: f
    and h of every field and component, eight arrays of 1,712 elements,
    54,784 bytes); five fields in f64 at h = 4 (joint, three components a pass:
    eleven arrays would not fit); ten there (split: nine fields, then the
    six components); twelve fields in f64 at h = 2 (three components a
    pass), at a run of 32 planes. Without ``lx`` the tile is the source's
    default (16 planes)."""
    assert tfused.march_tile(*args, values=1, **kw) == want
    F, h, isz = args
    assert tfused.march_tile(F, h, isz, values=1) == tfused.march_tile(
        F, h, isz, values=1, lx=tfused.STAGE_MARCH_LX)


#: the first field count whose f arrays do not fit one block of K5's
#: march, by item size and stencil radius (below it, one joint pass)
SCALAR_STAGE_FIRST_SPLIT = {4: {1: 51, 2: 34, 3: 25, 4: 20},
                            8: {1: 26, 2: 17, 3: 13, 4: 10}}


@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("carry", [None, torch.bfloat16], ids=["T", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1, 2, 5, 9, 10, 12])
def test_scalar_stage_march_tile_fits_every_accepted_stepper(F, dtype, carry,
                                                             h):
    """Every field count, working dtype, carry dtype and stencil radius a
    scalar stepper accepts has a tile for K5, the scalar energy stage's
    march: one array per field (f) and no tensor component, in a block's
    232,448 bytes beside the static per-warp partials of 2 (2F + 1) sum
    terms. Joint below SCALAR_STAGE_FIRST_SPLIT (f64 from ten fields at
    h = 4), split from there with passes of one field fewer; the stepper
    holds fused_stage.cu's tile to it when it builds. The carries live in
    device memory only, so the tile is the carry dtype's to share."""
    st = pt.FusedScalarStepper(pt.ScalarSector(F, potential=many_potential(
        F)), (8, 8, 8), 0.1, h, dtype=dtype, carry_dtype=carry,
        device="cpu")
    assert ("fused_stage.cu", 1) in st._march_sources()
    isz = st.dtype.itemsize
    (lx, gf, g, joint), nbytes = tfused.march_tile(F, h, isz, 0, values=1)
    assert lx == tfused.SCALAR_STAGE_MARCH_LX and g == 0
    first_split = SCALAR_STAGE_FIRST_SPLIT[isz][h]
    assert bool(joint) == (F < first_split)
    assert gf == (F if joint else first_split - 1)
    assert nbytes == gf * TILE_SITES[h] * isz
    assert nbytes + 2 * (2 * F + 1) * 8 * isz <= SMEM_MAX


@pytest.mark.parametrize("args,kw,want", [
    ((2, 2, 4), {}, ((32, 2, 0, 1), 13696)),
    ((2, 2, 4), {"lx": 16}, ((16, 2, 0, 1), 13696)),
    ((9, 4, 8), {}, ((32, 9, 0, 1), 211968)),
    ((10, 4, 8), {}, ((32, 9, 0, 0), 211968)),
    ((17, 2, 8), {}, ((32, 16, 0, 0), 219136)),
    ((20, 4, 4), {"lx": 64}, ((64, 19, 0, 0), 223744)),
], ids=["main-path", "main-path-lx16", "f64-h4-nine", "f64-h4-split",
        "f64-h2-split", "f32-h4-split"])
def test_scalar_stage_march_tile_examples(args, kw, want):
    """K5's march tile: the main path's (f32, h = 2, two fields: two arrays
    of 1,712 elements, 13,696 bytes), at a run of 16 planes too; nine
    fields in f64 at h = 4 joint, ten split nine and one; seventeen in f64
    at h = 2 split sixteen and one; twenty in f32 at h = 4 split nineteen
    and one, at a run of 64. Without ``lx`` the tile is the source's
    default (32 planes; the GW stages' 16)."""
    assert tfused.march_tile(*args, nh=0, values=1, **kw) == want
    F, h, isz = args
    assert tfused.march_tile(F, h, isz, 0, values=1) == tfused.march_tile(
        F, h, isz, 0, values=1, lx=tfused.SCALAR_STAGE_MARCH_LX)


@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_march_sources_hold_the_stage_march(gw):
    """Every stepper's build holds fused_stage.cu's stage-march tile (one
    value per tapped array) to the mirror beside its pairs' tile: K5 for
    the scalar system, K5' and K7 for the GW one."""
    if gw:
        st = _stepper(2, 2, torch.float32, None)
    else:
        st = pt.FusedScalarStepper(pt.ScalarSector(
            2, potential=many_potential(2)), (8, 8, 8), 0.1, 2,
            device="cpu")
    assert st._march_sources() == [("fused_coupled_pair.cu", 2),
                                   ("fused_pair.cu", 2),
                                   ("fused_stage.cu", 1)]


#: the most static shared memory a block may declare
STATIC_SMEM_MAX = 48 * 1024


@pytest.mark.parametrize("lx", [None, 16], ids=["default", "lx16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_lap_tile(h, dtype, lx):
    """The Laplacian's march tile at every stencil radius and dtype: the
    centre plane with its y-z halo in static shared memory, within the
    48 KB a block may declare statically (the +-x taps live in
    registers). Without ``lx`` the run is the source's default."""
    isz = dtype.itemsize
    got_lx, nbytes = tderivs.lap_tile(h, isz, lx=lx)
    assert got_lx == (tderivs.LAP_LX if lx is None else lx)
    assert nbytes == (8 + 2 * h) * (32 + 2 * h) * isz
    assert nbytes <= STATIC_SMEM_MAX


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_mg_tile(h, dtype, nf):
    """The multigrid sweeps' march tile at every stencil radius, dtype and
    count of unknowns: per unknown the centre plane with its y-z halo in
    static shared memory, within the 48 KB a block may declare statically
    (the +-x taps live in registers); a region of fewer sites than the
    threshold (the multigrid path's levels of 128^3 and below, a one-plane
    shell of its 512^3 level) runs the per-site kernel (None), and so does
    every region where the planes do not fit. Without ``lx`` the run is
    the source's default."""
    isz = dtype.itemsize
    nbytes = nf * (8 + 2 * h) * (32 + 2 * h) * isz
    assert nbytes <= STATIC_SMEM_MAX
    want = (trelax.MG_LX, nbytes)
    assert trelax.mg_tile(h, isz, nf) == want
    assert trelax.mg_tile(h, isz, nf, lx=16) == (16, nbytes)
    for shape in ((512,) * 3, (256,) * 3, (256, 512, 512), (64, 256, 256)):
        assert trelax.mg_tile(h, isz, nf, shape) == want
    for shape in ((128,) * 3, (8,) * 3, (1, 512, 512), (63, 256, 256)):
        assert trelax.mg_tile(h, isz, nf, shape) is None
    # the unknowns' planes that no longer fit: every launch per site
    most = STATIC_SMEM_MAX // ((8 + 2 * h) * (32 + 2 * h) * isz)
    assert trelax.mg_tile(h, isz, most) is not None
    assert trelax.mg_tile(h, isz, most + 1) is None
    assert trelax.mg_tile(h, isz, most + 1, (512,) * 3) is None


@pytest.mark.parametrize("src,kernels", [
    ("fd_ops.cu", ("pk_fd_grad_kernel", "pk_fd_grad_lap_kernel",
                   "pk_fd_pd_kernel", "pk_fd_div_kernel")),
    ("mg_relax.cu", ("mg_relax_march_kernel",))], ids=["fd", "mg"])
def test_queue_march_sources_launch_the_shared_march(src, kernels):
    """fd_ops.cu's fd_grad, fd_grad_lap, fd_pd* and fd_div and
    mg_relax.cu's sweeps march through pk_common.cuh's register-queue march,
    defined outside the fused sources' PK_F guard (neither header defines
    PK_F); the queue loader and tile live there alone. fd_lap keeps its own
    loop (the shared one changed its registers on the card); K11 has none."""
    csrc = Path(tderivs.__file__).resolve().parent / "csrc"
    common = (csrc / "pk_common.cuh").read_text()
    defined = common.index("pk_queue_march(const PkQueueSrc")
    assert defined < common.index("#ifdef PK_F")
    assert "struct PkQueueLoad" in common and "struct PkQueueTile" in common
    text = (csrc / src).read_text()
    for k in kernels:
        body = text[text.index(k + "("):]
        body = body[:body.index("\n}\n")]
        assert "pk_queue_march<" in body
    assert "struct PkQueueLoad" not in text and "PkFdLapTile :" not in text
    if src == "mg_relax.cu":
        assert "__syncthreads" not in text
    else:
        # div taps its vector's three arrays in one march
        body = text[text.index("pk_fd_div_kernel("):]
        assert "pk_queue_march<T, 3," in body[:body.index("\n}\n")]


def _body(text, name):
    """The source of the function ``name`` in ``text``, to its closing
    brace."""
    body = text[text.index(name + "("):]
    return body[:body.index("\n}\n")]


def test_fd_pd_kernel_marches_its_own_halo():
    """fd_ops.cu's pdx marches through pk_queue_march with one tapped array
    and the halo mask 0u: its x taps come from the thread's queue alone, so
    no plane is stored; its sum is pk_pd's along x in box coordinates from
    0. The default build launches it for pdx; pdy and pdz (whose march lost
    to the per-site kernel) and every operator of the per-site build
    (PK_FD_PER_SITE) run pk_fd_kernel."""
    csrc = Path(tderivs.__file__).resolve().parent / "csrc"
    text = (csrc / "fd_ops.cu").read_text()
    body = _body(text, "pk_fd_pd_kernel")
    assert "pk_queue_march<T, 1, PAD, PK_FD_PD_AHEAD, 0u>(" in body
    assert "pk_pd<T, 0, PK_BOX>(col[0], PK_H, by, bz, 0, 0, 0, w, T(0))" \
        in body
    assert "template <typename T, int PAD>\n" in text[
        text.index("pk_fd_pd_kernel(") - 120:text.index("pk_fd_pd_kernel(")]
    assert "PK_FD_PD_MARCH" not in text
    assert "using PkFdPdTile = PkQueueTile<T, 0, PK_FD_PD_LX>;" in text
    launch = _body(text, "static int pk_launch_fd")
    march = launch[:launch.index("} else {")]
    assert ("if constexpr (!PK_FD_PER_SITE && OP != PK_FD_PDY "
            "&& OP != PK_FD_PDZ) {") in march
    assert "pk_fd_pd_kernel<T, PAD><<<" in march
    assert "pk_fd_kernel<" not in march
    assert "pk_fd_kernel<T, OP, PAD>" in launch[len(march):]
    # with no plane stored the march declares no shared plane and takes no
    # barrier; with one, two a plane
    common = (csrc / "pk_common.cuh").read_text()
    queue = _body(common, "pk_queue_march")
    assert "__shared__ T sm[HALO ? NA * Tl::CENTRE : 1];" in queue
    assert queue.count("if constexpr (HALO != 0u) __syncthreads();") == 2
    assert queue.count("__syncthreads()") == 2


def test_stage_launch_runs_per_site_only_under_the_define():
    """fused_stage.cu sends every stage to the stage march
    (pk_stage_march_kernel; K2 with ENERGY and GW false) and reaches the
    per-site K2 (pk_fused_stage_kernel) only in a build with
    PK_STAGE_PER_SITE set, which defaults to 0."""
    csrc = Path(tderivs.__file__).resolve().parent / "csrc"
    text = (csrc / "fused_stage.cu").read_text()
    assert "#ifndef PK_STAGE_PER_SITE\n#define PK_STAGE_PER_SITE 0\n#endif" \
        in text
    launch = _body(text, "static int pk_launch_stage")
    per_site, march = launch.split("} else {")
    assert "if constexpr (PK_STAGE_PER_SITE && !ENERGY && !GW) {" in per_site
    assert "pk_fused_stage_kernel<T, C, PAD>" in per_site
    assert "pk_stage_march_kernel<T, C, KD, ENERGY, GW, PAD>" in march
    assert "pk_fused_stage_kernel" not in march
    assert text.count("pk_fused_stage_kernel<") == 1


def test_fd_pd_z_tap_takes_the_padding():
    """fd_ops.cu's one-axis derivative (pk_pd, pd* and div) takes its z
    tap through pk_tap, as pk_grad does: unwrapped on a march's box
    loader (PK_BOX), pk_wrap's expression on a lattice."""
    csrc = Path(tderivs.__file__).resolve().parent / "csrc"
    text = (csrc / "fd_ops.cu").read_text()
    body = text[text.index("__device__ __forceinline__ T pk_pd("):]
    body = body[:body.index("\n}\n")]
    assert "pk_tap<PZ>(z + s, Z)" in body and "pk_tap<PZ>(z - s, Z)" in body
    assert "pk_wrap" not in body
    assert "constexpr bool PZ = PAD & PK_PAD_Z;" in body


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv,env,want", [
    ([], None, "all"),
    (["--phases", "gw"], None, {"gw"}),
    (["--phases=fd,mg"], None, {"fd", "mg"}),
    (["--phases", "sharded_bf16"], None, {"sharded_bf16", "scalar", "gw"}),
    (["--phases", "sharded_mg"], None, {"sharded_mg", "mg"}),
    (["--phases", "march_variants"], None, {"march_variants"}),
    ([], "sharded_gw,fd", {"sharded_gw", "gw", "fd"}),
    (["--phases", "march_variants,sharded_mg"], None,
     {"march_variants", "sharded_mg", "mg"}),
    (["--phases", "fd,march_variants"], None, {"fd", "march_variants"}),
    (["--phases", "sharded,fd"], None, {"sharded", "scalar", "fd"}),
], ids=["default", "one", "two", "deps", "mg-deps", "opt-in", "env",
        "opt-in-mg", "opt-in-fd", "sharded-fd"])
def test_smoke_phase_selection(monkeypatch, argv, env, want):
    """``--phases`` (or ``PYSTELLA_SMOKE_PHASES``) selects phase groups and
    every group whose results they read; with neither, every group of
    PHASES runs (the opt-in march_variants not among them)."""
    smoke = _smoke()
    if env is None:
        monkeypatch.delenv("PYSTELLA_SMOKE_PHASES", raising=False)
    else:
        monkeypatch.setenv("PYSTELLA_SMOKE_PHASES", env)
    got = smoke.selected_phases(argv)
    assert got == (set(smoke.PHASES) if want == "all" else want)
    assert "march_variants" not in set(smoke.PHASES)


def test_smoke_stage_variants():
    """march_variants times the stage march at run lengths 16, 32 and 64
    (K5' and K7), and K5 and K2 at each with and without the next plane's
    loads a step ahead; a variant's defines set both (K2 with bf16 carries
    never looks ahead, in no build)."""
    smoke = _smoke()
    assert smoke.STAGE_VARIANTS == (16, 32, 64)
    assert set(smoke.SCALAR_STAGE_VARIANTS[:-1]) == {
        (lx, a) for lx in (16, 32, 64) for a in (0, 1)}
    assert set(smoke.STAGE_MARCH_KERNELS) == {"preheat_stage_energy",
                                              "preheat_stage"}
    assert smoke.SCALAR_STAGE_MARCH_KERNELS == ("fused_stage_energy",
                                                "fused_stage")
    assert smoke.stage_defines((32, 0)).split() == [
        "#define", "PK_SCALAR_STAGE_MARCH_LX", "32", "#define",
        "PK_SCALAR_STAGE_AHEAD", "0"]
    csrc = Path(tderivs.__file__).resolve().parent / "csrc"
    stage = (csrc / "fused_stage.cu").read_text()
    assert "BF16_AHEAD" not in stage
    assert ("constexpr bool AHEAD = !GW && PK_SCALAR_STAGE_AHEAD\n"
            "                         && (ENERGY || sizeof(C) == sizeof(T));"
            in stage)
    # K2's per-site build, timed beside the marches
    assert smoke.SCALAR_STAGE_VARIANTS[-1] == "per_site"
    assert smoke.stage_defines("per_site") == smoke.STAGE_PER_SITE
    assert smoke.STAGE_PER_SITE.split() == ["#define", "PK_STAGE_PER_SITE",
                                            "1"]


@pytest.mark.parametrize("name,gated", [
    ("pk_stage_march_kernel<float, float, float, true, true, 0>", True),
    ("pk_stage_march_kernel<float, float, float, false, true, 1>", True),
    ("pk_stage_march_kernel<float, __nv_bfloat16, float, true, false, 3>",
     True),
    ("pk_fused_pair_kernel<float, float, 2>", True),
    ("pk_fused_stage_kernel<float, float, 0>", False),
    ("pk_reduce_partials_kernel<float>", False),
    ("pk_fd_lap_kernel<float, 3>", True),
    ("pk_fd_grad_lap_kernel<double, 1>", True),
    ("pk_fd_grad_kernel<float, 0>", True),
    ("pk_fd_grad_kernel<double, 3>", True),
    ("pk_fd_div_kernel<float, 2>", True),
    ("pk_fd_div_kernel<double, 0>", True),
    ("pk_fd_pd_kernel<float, 0>", True),
    ("pk_fd_pd_kernel<double, 3>", True),
    ("mg_relax_march_kernel<float, 0, 0>", True),
    ("mg_relax_march_kernel<double, 2, 3>", True),
    ("mg_relax_kernel<float, 0, 0>", False),
    ("pk_fd_kernel<float, 1, 0>", False),
    ("pk_fd_kernel<double, 6, 3>", False),
], ids=["k5prime", "k7-xpad", "k5-bf16-fin-xypad", "k3", "k2", "finish",
        "fd-lap-xypad", "fd-grad-lap-xpad", "fd-grad", "fd-grad-xypad",
        "fd-div-ypad", "fd-div-f64", "fd-pdx", "fd-pdx-f64-xypad",
        "k11-smooth", "k11-tau-xypad",
        "k11-per-site", "fd-per-site", "fd-div-per-site"])
def test_smoke_march_ptxas_rows(name, gated):
    """The smoke's build gate reads the spills of every x-marching
    instantiation -- K5', K7, K5 and K2 (``pk_stage_march_kernel``),
    fd_lap, fd_grad, fd_grad_lap, fd_pdx, fd_div and K11's march, padded
    ones included --
    and not the per-site K2, K11, K12 kernels or the sums' finish."""
    smoke = _smoke()
    rows = smoke.march_ptxas({"fused_stage": {name: {"registers": 90}}})
    assert (name in rows) == gated


def test_smoke_queue_variants():
    """march_variants times fd_grad, fd_grad_lap, fd_div, fd_pdx and K11's
    sweep at run lengths 16, 32 and 64, each with and without the next
    plane's loads a step ahead, beside their per-site builds, and K11 on
    the multigrid path's levels from 512^3 down; a variant's defines set
    both knobs (one fd_ops.cu build a variant sets them for every queue
    march's tile), a per-site build's the threshold (K11) or the per-site
    switch (K12, and K2's in fused_stage.cu); every operator but pdy and
    pdz marches, and every one that does is timed beside its per-site
    build."""
    smoke = _smoke()
    assert set(smoke.QUEUE_VARIANTS) == {
        (lx, a) for lx in (16, 32, 64) for a in (0, 1)}
    assert smoke.mg_defines((16, 0)).split() == [
        "#define", "MG_MARCH_LX", "16", "#define", "MG_MARCH_AHEAD", "0"]
    assert smoke.FD_QUEUE_OPS == ("grad", "grad_lap", "div", "pdx")
    assert {op[:2] if op == "pdx" else op
            for op in smoke.FD_QUEUE_OPS} == set(tderivs.QUEUE_TILES)
    assert not hasattr(smoke, "FD_PD_MARCH_ALL")
    assert smoke.fd_queue_defines((64, 1)).split() == [
        w for op in ("GRAD", "GRAD_LAP", "PD", "DIV")
        for w in ("#define", f"PK_FD_{op}_LX", "64", "#define",
                  f"PK_FD_{op}_AHEAD", "1")]
    # pdy and pdz run per site
    assert set(smoke.FD_MARCHED) == set(tderivs.OPS) - {"pdy", "pdz"}
    assert smoke.STAGE_PER_SITE.split() == ["#define", "PK_STAGE_PER_SITE",
                                            "1"]
    assert smoke.FD_QUEUE_VARIANTS == smoke.QUEUE_VARIANTS
    assert smoke.queue_label((32, 1)) == {"lx": 32, "ahead": 1}
    assert smoke.queue_label((16, 0)) == {"lx": 16, "ahead": 0}
    assert smoke.mg_defines("per_site") == smoke.MG_PER_SITE
    assert smoke.fd_queue_defines("per_site") == smoke.FD_PER_SITE
    assert int(smoke.MG_PER_SITE.split()[-1]) > 512 * 512
    assert int(smoke.MG_MARCH_ALL.split()[-1]) == 1
    assert smoke.MG_LEVELS[0] == smoke.GRID
    assert [s[0] for s in smoke.MG_LEVELS] == sorted(
        (s[0] for s in smoke.MG_LEVELS), reverse=True)


@pytest.mark.parametrize("lx", [None, 16], ids=["default", "lx16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_grad_lap_tile(h, dtype, lx):
    """fd_grad_lap's march tile: the Laplacian's (one tapped array) at its
    own run length, and whether its loads go a step ahead."""
    isz = dtype.itemsize
    got = tderivs.grad_lap_tile(h, isz, lx=lx)
    assert got == ((tderivs.GRAD_LAP_LX if lx is None else lx),
                   (8 + 2 * h) * (32 + 2 * h) * isz, tderivs.GRAD_LAP_AHEAD)
    assert tderivs.grad_lap_tile(h, isz, lx=lx, ahead=0)[2] == 0


@pytest.mark.parametrize("lx", [None, 16, 64], ids=["default", "lx16",
                                                    "lx64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_grad_tile(h, dtype, lx):
    """fd_grad's march tile: fd_grad_lap's (one tapped array, its centre
    plane with the y-z halo in static shared memory) at fd_grad's own run
    length and look-ahead."""
    isz = dtype.itemsize
    got = tderivs.grad_tile(h, isz, lx=lx)
    assert got == ((tderivs.GRAD_LX if lx is None else lx),
                   (8 + 2 * h) * (32 + 2 * h) * isz, tderivs.GRAD_AHEAD)
    assert got[1] <= STATIC_SMEM_MAX
    assert tderivs.grad_tile(h, isz, lx=lx, ahead=0)[2] == 0
    assert tderivs.QUEUE_TILES["grad"] == ("pk_fd_grad_tile",
                                           tderivs.grad_tile)


@pytest.mark.parametrize("lx", [None, 16, 64], ids=["default", "lx16",
                                                    "lx64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_div_tile(h, dtype, lx):
    """fd_div's march tile: the three arrays of a vector tapped together,
    three haloed centre planes in static shared memory, within the 48 KB a
    block may declare statically, at fd_div's own run length and
    look-ahead."""
    isz = dtype.itemsize
    got = tderivs.div_tile(h, isz, lx=lx)
    assert got == ((tderivs.DIV_LX if lx is None else lx),
                   3 * (8 + 2 * h) * (32 + 2 * h) * isz, tderivs.DIV_AHEAD)
    assert got[1] <= STATIC_SMEM_MAX
    assert tderivs.div_tile(h, isz, lx=lx, ahead=0)[2] == 0
    assert tderivs.QUEUE_TILES["div"] == ("pk_fd_div_tile", tderivs.div_tile)


@pytest.mark.parametrize("lx", [None, 16, 64], ids=["default", "lx16",
                                                    "lx64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_pd_tile(h, dtype, lx):
    """fd_pdx's march tile, in fd_grad_lap's form: its own run length and
    look-ahead, and no shared memory (its x taps come from a thread's
    register queue alone)."""
    isz = dtype.itemsize
    got = tderivs.pd_tile(h, isz, lx=lx)
    assert got == ((tderivs.PD_LX if lx is None else lx), 0,
                   tderivs.PD_AHEAD)
    assert tderivs.pd_tile(h, isz, lx=lx, ahead=0)[2] == 0
    assert tderivs.QUEUE_TILES["pd"] == ("pk_fd_pd_tile", tderivs.pd_tile)


def test_div_tile_fits_three_planes_at_f64_h4():
    """The largest div tile, f64 at h = 4: three planes of 16 x 40
    elements, 15,360 bytes, fit a block's static shared memory
    (fd_ops.cu's static_assert on PkFdDivTile<double>::FITS)."""
    assert tderivs.div_tile(4, 8) == (tderivs.DIV_LX, 15360,
                                      tderivs.DIV_AHEAD)
    assert 15360 <= STATIC_SMEM_MAX
    text = (Path(tderivs.__file__).resolve().parent / "csrc"
            / "fd_ops.cu").read_text()
    assert "using PkFdDivTile = PkQueueTile<T, 3, PK_FD_DIV_LX>;" in text
    assert "static_assert(PkFdDivTile<double>::FITS" in text


#: the operators the smoke's circular convolution computes, by the plain
#: version's outputs
LIBRARY_OPS = ["lap", "grad", "pdx", "pdy", "pdz", "div", "grad_lap"]


@pytest.mark.parametrize("op", LIBRARY_OPS)
def test_smoke_library_conv_is_the_operator(op):
    """The smoke's yardstick (``fd_library_conv``: one
    ``torch.nn.Conv3d(padding_mode="circular")``; div reads (n, 3, X, Y, Z)
    as it is, grad_lap's channels are the gradient, then the Laplacian)
    computes the operator: at 16^3 f64 on the CPU, within 1e-12 of the
    plain version, laid out as ``fd_library_io`` lays the kernel's
    outputs."""
    smoke = _smoke()
    nin, nout, _ = smoke.FD_LIBRARY[op]
    fd = pt.FiniteDifferencer(2, (0.3, 0.25, 0.2), device="cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2 * nin, 16, 16, 16), generator=g, dtype=torch.float64)
    conv = smoke.fd_library_conv(fd, op, device="cpu", dtype=torch.float64)
    assert (conv.in_channels, conv.out_channels) == (nin, nout)
    xin, ref = smoke.fd_library_io(op, x, fd.plain(op, x))
    with torch.no_grad():
        got = conv(xin)
    assert got.shape == ref.shape == (2, nout, 16, 16, 16)
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_smoke_unknown_phase_exits_nonzero(monkeypatch, capsys):
    """An unknown phase name exits with status 2 before anything runs."""
    smoke = _smoke()
    monkeypatch.delenv("PYSTELLA_SMOKE_PHASES", raising=False)
    with pytest.raises(SystemExit) as info:
        smoke.selected_phases(["--phases", "gw,nonsense"])
    assert info.value.code == 2
    assert "nonsense" in capsys.readouterr().err
