"""The port's whole-RK-chunk tier (K10) and bfloat16 RK carries against the
JAX package's, and against the port's own pair tier.

The JAX steppers run their Pallas kernels in interpret mode here (bx=4,
by=8, chunk_bx=4, chunk_by=8, as tests/test_fused.py builds them), 5-18 s
per call at 16^3, so their results are computed once per module (five
calls, about a minute) and every comparison reads them. The CUDA kernels'
own tests, which need the card, are in tests/test_torch_kernels.py."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused
from pystella_tpu_torch import config as tconfig
from pystella_tpu_torch._device import torch_dtype
from pystella_tpu_torch.ops import fused as tfused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.3, "hubble": 0.21}
ARGS32 = {"a": np.float32(1.3), "hubble": np.float32(0.21)}
JAX_BLOCKS = dict(bx=4, by=8)
JAX_CHUNK = dict(chunk_stages=4, chunk_bx=4, chunk_by=8, **JAX_BLOCKS)


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(seed=17, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID).astype(dtype),
            "dfdt": (0.1 * rng.standard_normal((2,) + GRID)).astype(dtype)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _port(dtype=torch.float64, **kw):
    return pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                                 GRID, DX, H, dtype=dtype, device="cpu", **kw)


def _copy(tree):
    return {k: v.clone() for k, v in tree.items()}


def _torch_state(dtype=torch.float64):
    return pt.state_from_numpy(_state(), device="cpu", dtype=dtype)


def _jnp(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX results: the f64 chunk stepper's multi_step(2), multi_step(3)
    and stage_chunk([0, 1, 2, 3]) + stage(4); the f32 steppers with bf16
    carries, pair and chunk, multi_step(2); the tier reports."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    sector = ps.ScalarSector(2, potential=potential)
    out = {}
    chunk = JaxFused(sector, decomp, GRID, DX, H, dtype=jnp.float64,
                     **JAX_CHUNK)
    assert chunk._chunk_call is not None
    for n in (2, 3):
        out[f"multi{n}"] = chunk.multi_step(_jnp(_state()), n, 0.0, DT, ARGS)
    carry = chunk.init_carry(_jnp(_state()))
    carry = chunk.stage_chunk([0, 1, 2, 3], carry, 0.0, DT, [ARGS] * 4)
    out["stage_chunk"] = chunk.stage(4, carry, 0.0, DT, ARGS)[0]
    pair = JaxFused(sector, decomp, GRID, DX, H, dtype=jnp.float64,
                    **JAX_BLOCKS)
    reports = {"f64": (chunk.kernel_tier_report(),
                       pair.kernel_tier_report())}
    for tier, kw in (("pair", JAX_BLOCKS), ("chunk", JAX_CHUNK)):
        st = JaxFused(sector, decomp, GRID, DX, H, dtype=jnp.float32,
                      carry_dtype=jnp.bfloat16, **kw)
        out[f"bf16_{tier}"] = st.multi_step(
            _jnp(_state(dtype=np.float32)), 2, 0.0, np.float32(DT), ARGS32)
        reports[f"bf16_{tier}"] = st.kernel_tier_report()
    res = {k: {n: np.asarray(a) for n, a in v.items()}
           for k, v in out.items()}
    res["reports"] = reports
    return res


# -- parity with the JAX chunk stepper ----------------------------------------

@pytest.mark.parametrize("how", ["multi2", "multi3", "stage_chunk"])
def test_chunk_matches_jax_f64(jax_ref, how):
    """The port's chunk stepper vs the JAX one, f64, to 1e-12 relative:
    multi_step(2) (chunk, wrapped chunk, pair), multi_step(3) (three
    chunks, a pair, a single stage) and the within-step chunk + single.
    The two packages round the same operations; XLA may contract or
    reorder a few."""
    st = _port(chunk_stages=4)
    if how == "stage_chunk":
        carry = st.init_carry(_torch_state())
        carry = st.stage_chunk([0, 1, 2, 3], carry, 0.0, DT, [ARGS] * 4)
        got = st.stage(4, carry, 0.0, DT, ARGS)[0]
    else:
        got = st.multi_step(_torch_state(), int(how[-1]), 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        err = _rel(got[name], jax_ref[how][name])
        assert err < 1e-12, f"{how} {name}: rel err {err}"


#: the port's bf16-carry steppers vs the JAX ones after two steps (10
#: stages, 10 carry roundings): rounding a carry to bf16 can move it by
#: 2^-8 relative, and the two packages round the same f32 values only up to
#: the f32 ulp they may differ by, which flips a bf16 rounding wherever a
#: value lies within that ulp of a bf16 midpoint; each flip moves a carry
#: by one bf16 ulp, entering f and dfdt scaled by B*dt. Measured 4.6e-7 in
#: f and 7.7e-5 in dfdt, against a bf16 vs f32-carry gap of 2.4e-5 and
#: 5.6e-4; the bar is test_fused.py:416's bf16 accuracy bar, 1e-2, never
#: looser.
BF16_BAR = 1e-2


@pytest.mark.parametrize("tier", ["pair", "chunk"])
def test_bf16_carries_match_jax(jax_ref, tier):
    """bf16 carries, f32 state: the port's pair and chunk steppers vs the
    JAX ones (BF16_BAR); the port's carries are bfloat16, and its result
    differs from the f32-carry run."""
    st = _port(torch.float32, carry_dtype=torch.bfloat16,
               chunk_stages=4 if tier == "chunk" else 0)
    state = _torch_state(torch.float32)
    assert st.init_carry(state)[1]["f"].dtype == torch.bfloat16
    got = _copy(st.multi_step(_copy(state), 2, 0.0, DT, ARGS))
    f32 = _port(torch.float32).multi_step(_copy(state), 2, 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert got[name].dtype == torch.float32
        err = _rel(got[name], jax_ref[f"bf16_{tier}"][name])
        assert err < BF16_BAR, f"{name}: rel err {err}"
        assert not torch.equal(got[name], f32[name])
        assert _rel(got[name], f32[name]) < BF16_BAR


# -- identities inside the port -----------------------------------------------

PRECISIONS = {"f64": (torch.float64, None),
              "f32-bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("nsteps", [2, 3])
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_chunk_equals_pair_bitwise(precision, nsteps):
    """multi_step on the chunk tier equals the pair tier bit for bit: the
    chunk body is the pair sequence, its carries rounded where the pairs
    store them."""
    dtype, cd = PRECISIONS[precision]
    chunk = _port(dtype, carry_dtype=cd, chunk_stages=4)
    pair = _port(dtype, carry_dtype=cd)
    got = chunk.multi_step(_torch_state(dtype), nsteps, 0.0, DT, ARGS)
    ref = pair.multi_step(_torch_state(dtype), nsteps, 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert torch.equal(got[name], ref[name]), name


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_stage_chunk_equals_two_pairs(precision):
    """One stage_chunk equals two stage_pair calls in state and carries,
    bit for bit; with bf16 carries the chunk's carries are bfloat16."""
    dtype, cd = PRECISIONS[precision]
    chunk = _port(dtype, carry_dtype=cd, chunk_stages=4)
    pair = _port(dtype, carry_dtype=cd)
    cc = chunk.stage_chunk([0, 1, 2, 3], chunk.init_carry(
        _torch_state(dtype)), 0.0, DT, [ARGS] * 4)
    cp = pair.init_carry(_torch_state(dtype))
    cp = pair.stage_pair(0, cp, 0.0, DT, ARGS)
    cp = pair.stage_pair(2, cp, 0.0, DT, ARGS)
    for part in (0, 1):
        for name in ("f", "dfdt"):
            assert torch.equal(cc[part][name], cp[part][name])
    assert cc[1]["f"].dtype == (cd or dtype)


def test_chunk_launch_schedule():
    """Chunks first, then pairs, then a single stage, across step
    boundaries: multi_step(2) = chunk, wrapped chunk, pair; multi_step(3)
    = 3 chunks, a pair, a single; step() = a chunk and a single."""
    st = _port(chunk_stages=4)
    calls = []
    st.stage = lambda s, c, *a, **k: calls.append(("stage", s)) or c
    st.stage_pair = (lambda s, c, *a, s2=None, **k:
                     calls.append(("pair", s, s2)) or c)
    st.stage_chunk = (lambda stages, c, *a, **k:
                      calls.append(("chunk", list(stages))) or c)
    state = _torch_state()
    st.multi_step(state, 2, 0.0, DT, ARGS)
    assert calls == [("chunk", [0, 1, 2, 3]), ("chunk", [4, 0, 1, 2]),
                     ("pair", 3, 4)]
    calls.clear()
    st.multi_step(state, 3, 0.0, DT, ARGS)
    assert calls == [("chunk", [0, 1, 2, 3]), ("chunk", [4, 0, 1, 2]),
                     ("chunk", [3, 4, 0, 1]), ("pair", 2, 3), ("stage", 4)]
    calls.clear()
    st.step(state, 0.0, DT, ARGS)
    assert calls == [("chunk", [0, 1, 2, 3]), ("stage", 4)]


def test_chunk_counts_launches_on_cpu_as_plain():
    """On CPU tensors the chunk runs its plain version and counts no
    launch (the counts are of kernel launches)."""
    st = _port(chunk_stages=4)
    tfused.reset_launch_counts()
    st.multi_step(_torch_state(), 2, 0.0, DT, ARGS)
    assert all(v == 0 for v in tfused.LAUNCHES.values())
    assert "fused_chunk:bf16" in tfused.LAUNCHES


# -- the fallback ladder (tests/test_fused.py:1050) ---------------------------

@pytest.mark.parametrize("depth", [2, 3, 5])
def test_bad_depth_raises(depth):
    with pytest.raises(ValueError, match="even number >= 4"):
        _port(chunk_stages=depth)


def test_stage_chunk_without_chunk_raises():
    st = _port()
    with pytest.raises(RuntimeError, match="chunk fusion is not"):
        st.stage_chunk([0, 1, 2, 3], st.init_carry(_torch_state()), 0.0, DT,
                       [ARGS] * 4)
    chunk = _port(chunk_stages=4)
    carry = chunk.init_carry(_torch_state())
    with pytest.raises(ValueError, match="exactly 4"):
        chunk.stage_chunk([0, 1], carry, 0.0, DT, [ARGS] * 2)


def test_wrapped_chunk_needs_zero_A():
    """A tableau with A[0] != 0: a chunk deeper than a step warns and runs
    pairs; a depth-4 chunk stays within the step (multi_step then resets
    the carries every step), and a wrapped stage list is refused."""
    class Tableau(pt.LowStorageRK54):
        _A = [0.5] + pt.LowStorageRK54._A[1:]

    with pytest.warns(UserWarning, match="chunk fusion disabled .*A\\[0\\]"):
        st = _port(tableau=Tableau, chunk_stages=6)
    assert st.kernel_tier_report()["tier"] == "pair"
    st = _port(tableau=Tableau, chunk_stages=4)
    carry = st.init_carry(_torch_state())
    with pytest.raises(ValueError, match="A\\[0\\] == 0"):
        st.stage_chunk([3, 4, 0, 1], carry, 0.0, DT, [ARGS] * 4)
    got = st.multi_step(_torch_state(), 2, 0.0, DT, ARGS)
    ref = _torch_state()
    for _ in range(2):
        ref = _copy(_port(tableau=Tableau).step(ref, 0.0, DT, ARGS))
    for name in ("f", "dfdt"):
        assert torch.equal(got[name], ref[name])


@pytest.mark.parametrize("case", ["preheat", "depth6", "no_tile"])
def test_chunk_falls_back_to_pairs(case):
    """What the chunk kernel cannot take warns in the JAX package's words
    and runs pairs: the GW stepper (no chunk body), a depth without a
    kernel instantiation, a model whose shared-memory planes fit no tile
    of the ladder (eight fields at h=4 in f64)."""
    sector = pt.ScalarSector(2, potential=potential)
    with pytest.warns(UserWarning, match="whole-RK-chunk fusion disabled"):
        if case == "preheat":
            st = pt.FusedPreheatStepper(
                sector, pt.TensorPerturbationSector([sector]), GRID, DX, H,
                dtype=torch.float64, chunk_stages=4, device="cpu")
        elif case == "depth6":
            st = _port(chunk_stages=6)
        else:
            wide = pt.ScalarSector(8, potential=lambda f: sum(
                0.5 * f[i] ** 2 for i in range(8)))
            st = pt.FusedScalarStepper(wide, GRID, DX, 4,
                                       dtype=torch.float64, chunk_stages=4,
                                       device="cpu")
    assert st._chunk_depth == 0
    assert "fused_chunk" not in st.kernel_names()
    rep = st.kernel_tier_report()
    assert rep["tier"] == "pair" and rep["kernels_per_2_steps"] == {
        "pair": 5}


def test_env_turns_chunk_tier_on(monkeypatch):
    """chunk_stages=None reads PYSTELLA_CHUNK_STAGES (default 0, the pair
    tier); an explicit argument wins."""
    monkeypatch.delenv("PYSTELLA_CHUNK_STAGES", raising=False)
    assert tconfig.get_int("PYSTELLA_CHUNK_STAGES") == 0
    assert _port().kernel_tier_report()["tier"] == "pair"
    monkeypatch.setenv("PYSTELLA_CHUNK_STAGES", "4")
    assert _port().kernel_tier_report()["tier"] == "chunk"
    assert _port(chunk_stages=0).kernel_tier_report()["tier"] == "pair"
    with pytest.raises(KeyError):
        tconfig.getenv("PYSTELLA_NOT_REGISTERED")


# -- what the carry dtype does not cover yet ----------------------------------

def test_carry_dtype_gaps_raise():
    """The two entry points that once refused a carry dtype take it now
    (their kernels have bf16 variants; tests/test_torch_bf16_*.py hold
    them to the JAX package): the GW stepper stores bf16 carries and the
    coupled chunk runs to a finite f32 state. What still raises is a carry
    dtype that is neither bfloat16 nor the working dtype."""
    sector = pt.ScalarSector(2, potential=potential)
    gw = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector([sector]),
                                GRID, DX, H, carry_dtype=torch.bfloat16,
                                device="cpu")
    assert gw.carry_dtype == torch.bfloat16
    st = _port(torch.float32, carry_dtype=torch.bfloat16)
    out = st.coupled_multi_step(_torch_state(torch.float32), 1,
                                pt.Expansion(1.0, pt.LowStorageRK54), 0.0,
                                DT)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in out.values())
    with pytest.raises(TypeError, match="carry_dtype"):
        _port(carry_dtype=torch.float16)
    # the working dtype as carry dtype is no carry dtype at all
    assert _port(carry_dtype=torch.float64).carry_dtype is None


def test_bf16_stepper_refuses_f32_carries():
    st = _port(torch.float32, carry_dtype=torch.bfloat16)
    state = _torch_state(torch.float32)
    carry = (state, {k: torch.zeros_like(v) for k, v in state.items()})
    with pytest.raises(ValueError, match="bfloat16"):
        st.stage(0, carry, 0.0, DT, ARGS)


# -- the tier report ----------------------------------------------------------

@pytest.mark.parametrize("precision", ["f64", "bf16"])
def test_tier_report_bytes(jax_ref, precision):
    """bytes_per_step: the chunk tier's is below the pair tier's, and each
    equals the JAX package's report (every array once in and once out,
    carries at their storage width)."""
    if precision == "f64":
        chunk, pair = _port(chunk_stages=4), _port()
        jchunk, jpair = jax_ref["reports"]["f64"]
    else:
        kw = dict(dtype=torch.float32, carry_dtype=torch.bfloat16)
        chunk, pair = _port(chunk_stages=4, **kw), _port(**kw)
        jchunk = jax_ref["reports"]["bf16_chunk"]
        jpair = jax_ref["reports"]["bf16_pair"]
    rc, rp = chunk.kernel_tier_report(), pair.kernel_tier_report()
    assert rc["tier"] == "chunk" and rc["chunk_depth"] == 4
    assert rc["kernels_per_2_steps"] == {"chunk": 2, "pair": 1}
    assert rc["bytes_per_step"] < rp["bytes_per_step"]
    assert rc["bytes_per_step"] == jchunk["bytes_per_step"]
    assert rp["bytes_per_step"] == jpair["bytes_per_step"]
    assert rc["kernels_per_2_steps"] == jchunk["kernels_per_2_steps"]


def test_chunk_tile_rule():
    """The x-march the kernel's compile-time choice mirrors: ((run length,
    tile rows, tile columns), bytes a block), counted by hand. Per field,
    level 0 holds f and f1 as a ring of 2h+1 planes of the tile grown by h
    and a centre plane grown by 2h, level 1 f2 and f3 as a ring of 2h+1
    planes grown by h, the delay ring dfdt2, kf2 and kdfdt2 on h+1 planes
    of the tile."""
    # two fields, h = 2, the first rung 8 x 32: planes of 12 x 36 = 432
    # and 16 x 40 = 640 sites; 4 x (5 x 432 + 640) + 4 x 5 x 432 + 6 x 3 x
    # 256 = 24,448 elements
    assert tfused.chunk_tile(2, 2, 4, 4) == ((64, 8, 32), 97792)
    assert tfused.chunk_tile(2, 2, 8, 4) == ((64, 8, 32), 195584)
    # the variants' first rung of 16 rows: 20 x 36 = 720 and 24 x 40 = 960
    # sites; 4 x (5 x 720 + 960) + 4 x 5 x 720 + 6 x 3 x 512 = 41,856
    assert tfused.chunk_tile(2, 2, 4, 4, lx=16, rows=16) == (
        (16, 16, 32), 167424)
    # three fields, h = 3, f64: the rung 4 x 16, planes of 10 x 22 = 220 and
    # 16 x 28 = 448 sites; 6 x (7 x 220 + 448) + 6 x 7 x 220 + 9 x 4 x 64
    # = 23,472 elements
    assert tfused.chunk_tile(3, 3, 8, 4) == ((64, 4, 16), 187776)
    # five fields, h = 4, f64: 1 x 8 would take 10 x (9 x 144 + 408) + 10 x
    # 9 x 144 + 15 x 5 x 8 = 30,600 elements (244,800 bytes), the last
    # rung 2 x 4 takes 10 x (9 x 120 + 360) + 10 x 9 x 120 + 15 x 5 x 8 =
    # 25,800
    assert tfused.chunk_tile(5, 4, 8, 4) == ((64, 2, 4), 206400)
    # eight fields: 41,280 elements on the last rung, 330,240 bytes
    assert tfused.chunk_tile(8, 4, 8, 4) is None
    assert tfused.chunk_tile(2, 2, 4, 6) is None


#: the parent design's rule (a box of f, dfdt, kf and kdfdt over the
#: output tile grown by 2h on every face, the smallest tile 2 x 2 x 8):
#: the first field count whose box exceeded 232,448 bytes, per (h,
#: itemsize), counted by hand; 13: every count up to 12 fitted. For
#: example h = 2 in f64: 10 x 10 x 16 sites x 4 arrays x 8 bytes = 51,200
#: bytes a field, so four fields fit and five do not.
BOX_FIRST_REJECTED = {(1, 4): 13, (2, 4): 10, (3, 4): 4, (4, 4): 2,
                      (1, 8): 13, (2, 8): 5, (3, 8): 2, (4, 8): 1}
#: the chunk march's ladder of y-z tiles (rows, columns), first to last
CHUNK_LADDER = [(8, 32), (4, 32), (8, 16), (4, 16), (2, 16), (2, 8), (1, 8),
                (2, 4)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("F", range(1, 13))
def test_chunk_tile_covers_the_box_rule(F, h, itemsize):
    """Every model the box design gave a chunk kernel gets one from the
    march; where the march has a tile, it is a rung of the ladder within
    a block's shared memory, no higher than one field fewer gets."""
    tile = tfused.chunk_tile(F, h, itemsize, 4)
    if F < BOX_FIRST_REJECTED[h, itemsize]:
        assert tile is not None
    if tile is None:
        return
    (lx, rows, cols), nbytes = tile
    assert lx == tfused.CHUNK_LX and nbytes <= 232448
    assert (rows, cols) in CHUNK_LADDER
    if F > 1:
        fewer = tfused.chunk_tile(F - 1, h, itemsize, 4)
        assert CHUNK_LADDER.index(fewer[0][1:]) <= CHUNK_LADDER.index(
            (rows, cols))


# -- bfloat16 across the package boundary -------------------------------------

def test_bf16_jax_carry_round_trips():
    """A JAX carry with bf16 k arrays comes across bit for bit (through
    float32, which holds every bfloat16) and goes back as float32."""
    rng = np.random.default_rng(3)
    state = {"f": rng.standard_normal((2,) + GRID).astype(np.float32)}
    k = {"f": jnp.asarray(rng.standard_normal((2,) + GRID),
                          dtype=jnp.bfloat16)}
    np_k = {n: np.asarray(v) for n, v in k.items()}
    assert np_k["f"].dtype.name == "bfloat16"
    tstate, tk = pt.carry_from_numpy((state, np_k), device="cpu")
    assert tk["f"].dtype == torch.bfloat16
    assert tstate["f"].dtype == torch.float32
    back = pt.to_numpy((tstate, tk))
    assert back[1]["f"].dtype == np.float32
    np.testing.assert_array_equal(back[1]["f"],
                                  np_k["f"].astype(np.float32))
    np.testing.assert_array_equal(back[0]["f"], state["f"])
    # the bit patterns themselves
    bits = tk["f"].view(torch.int16).numpy()
    np.testing.assert_array_equal(bits, np_k["f"].view(np.int16))


@pytest.mark.parametrize("spec", ["torch", "numpy", "jax"])
def test_torch_dtype_takes_bfloat16(spec):
    dt = {"torch": torch.bfloat16,
          "numpy": np.asarray(jnp.zeros(1, jnp.bfloat16)).dtype,
          "jax": jnp.bfloat16}[spec]
    assert torch_dtype(dt) == torch.bfloat16


def test_torch_dtype_refuses_others():
    with pytest.raises(TypeError):
        torch_dtype(np.int32)
    with pytest.raises(TypeError):
        torch_dtype("no-such-dtype")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch_dtype(np.float32) == torch.float32
