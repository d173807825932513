"""The port's Checkpointer (utils/checkpoint.py) and forensic bundles
(obs/forensics.py): round trips bit for bit (f32, f64, bf16, a (2, 2, 1)
ShardedArray), max_to_keep and latest_step, the durability contract
(last_good only after finalize), the walk-back past a torn newest
checkpoint, resume == the uninterrupted run bit for bit (coupled_multi_step
and a generic stepper; both within 1e-12 of the JAX package's uninterrupted
trajectory), a trip's bundle, and the event log of one call sequence equal
in kinds, steps and payload keys to the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(seed=4, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID).astype(dtype),
            "dfdt": (0.3 * rng.standard_normal((2,) + GRID)).astype(dtype)}


def _equal(a, b):
    """Bit-for-bit equality of two states (tensors, sharded arrays)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, pt.ShardedArray):
            assert isinstance(y, pt.ShardedArray)
            assert len(x.blocks) == len(y.blocks)
            for bx, by in zip(x.blocks, y.blocks):
                assert bx.dtype == by.dtype and torch.equal(bx, by), k
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.fixture
def logs(tmp_path):
    yield tmp_path
    pt.obs.configure(None)
    ps.obs.configure(None)


# -- round trips ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
def test_round_trip(tmp_path, dtype):
    """A state with carries in ``dtype``, metadata and nested leaves comes
    back bit for bit, as the JAX package's round trip does."""
    st = {k: torch.from_numpy(v) for k, v in _state().items()}
    st = {"state": {k: v.to(dtype) for k, v in st.items()},
          "carries": [st["f"].to(dtype) * 0.5, st["dfdt"].to(dtype)],
          "n": 3}
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        assert ck.save(3, st, metadata={"t": 1.5, "a": np.float64(2.0)})
        ck.wait()
        step, got, meta = ck.restore()
    assert step == 3 and meta == {"t": 1.5, "a": 2.0}
    _equal(got["state"], st["state"])
    assert all(torch.equal(a, b) for a, b in zip(got["carries"],
                                                 st["carries"]))
    assert got["n"] == 3


@pytest.mark.parametrize("via", ["decomp", "sharding_fn"])
def test_round_trip_sharded(tmp_path, via):
    """A (2, 2, 1) ShardedArray is written block by block and restored
    onto the same decomposition, or through sharding_fn=decomp.shard, bit
    for bit."""
    d = pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 4)
    st = pt.shard_state(d, _state())
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        ck.save(2, st)
        ck.finalize()
        names = sorted(os.listdir(tmp_path / "ck" / "2"))
        kw = {"decomp": d} if via == "decomp" else {"sharding_fn": d.shard}
        _, got, _ = ck.restore(**kw)
    assert len([n for n in names if n.endswith(".bin")]) == 8
    _equal(got, st)


def test_max_to_keep_latest_and_missing(tmp_path):
    st = pt.state_from_numpy(_state(), device="cpu")
    with pt.Checkpointer(tmp_path / "ck", max_to_keep=2,
                         device="cpu") as ck:
        for s in (1, 2, 3):
            ck.save(s, st)
        ck.wait()
        assert ck.latest_step == 3
        assert ck.all_steps() == [2, 3]
        assert not ck.maybe_save(3, st)
    with pt.Checkpointer(tmp_path / "ck", save_interval_steps=5,
                         device="cpu") as ck:
        assert ck.all_steps() == [2, 3] and ck.last_good["step"] == 3
        assert not ck.maybe_save(4, st) and ck.maybe_save(5, st)
    with pt.Checkpointer(tmp_path / "empty", device="cpu") as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()


def test_last_good_only_after_finalize(tmp_path):
    """A scheduled write is not good: last_good stays None until the
    durability barrier, then names the newest durable step; a save snaps
    the tensors at the call, whatever the caller does to them after."""
    st = pt.state_from_numpy(_state(), device="cpu")
    keep = {k: v.clone() for k, v in st.items()}
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        ck.save(4, st)
        st["f"].fill_(7.0)
        assert ck.last_good is None and ck.latest_step == 4
        assert ck.finalize() == [4]
        assert ck.last_good == {"directory": str(tmp_path / "ck"),
                                "step": 4}
        ck.save(8, st)
        assert ck.last_good["step"] == 4
        ck.finalize()
        assert ck.last_good["step"] == 8
        _, got, _ = ck.restore(4)
    _equal(got, keep)


def test_torn_newest_walks_back(tmp_path, logs):
    """A truncated file in the newest checkpoint: restore falls back to
    the next older one with a checkpoint_fallback event; an explicit step
    raises; re-saving the torn step replaces it."""
    log = str(logs / "ev.jsonl")
    pt.obs.configure(log)
    a = pt.state_from_numpy(_state(1), device="cpu")
    b = pt.state_from_numpy(_state(2), device="cpu")
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        ck.save(1, a)
        ck.save(2, b)
        ck.finalize()
        path = tmp_path / "ck" / "2" / "0.bin"
        with open(path, "r+b") as f:
            f.truncate(100)
        step, got, _ = ck.restore()
        assert step == 1
        _equal(got, a)
        with pytest.raises(ValueError, match="torn"):
            ck.restore(2)
        ck.save(2, b)
        ck.finalize()
        step, got, _ = ck.restore()
        assert step == 2
        _equal(got, b)
    kinds = [(e["kind"], e["step"]) for e in pt.obs.read_events(log)]
    assert ("checkpoint_fallback", 2) in kinds
    assert kinds.index(("checkpoint_fallback", 2)) < kinds.index(
        ("checkpoint_restore", 1))


# -- resume == uninterrupted ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trajectories():
    """The JAX package's uninterrupted runs: the generic stepper (4 steps of
    LowStorageRK3Williamson over FiniteDifferencer.lap, the property of
    tests/test_checkpoint.py:61-100) and the fused coupled driver (2 steps
    of coupled_multi_step, interpret mode), from the same numpy state."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    lattice = ps.Lattice(GRID, (2 * np.pi,) * 3, dtype=np.float64)
    fd = ps.FiniteDifferencer(decomp, 1, lattice.dx, mode="halo")
    gen = ps.LowStorageRK3Williamson(
        lambda s, t: {"f": s["dfdt"], "dfdt": fd.lap(s["f"])})
    st = {k: jnp.asarray(v) for k, v in _state(4).items()}
    for _ in range(4):
        st = gen.step(st, 0.0, 1e-3)
    fused = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                     decomp, GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    exp = ps.Expansion(1.0, ps.LowStorageRK54)
    cst = fused.coupled_multi_step(
        {k: jnp.asarray(v) for k, v in _state(41).items()}, 2, exp, 0.0, DT)
    return ({k: np.asarray(v) for k, v in st.items()},
            ({k: np.asarray(v) for k, v in cst.items()}, float(exp.a),
             float(exp.adot)))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def test_resume_generic_stepper(tmp_path, jax_trajectories):
    """2 steps, save, finalize, restore, 2 steps == 4 uninterrupted steps
    bit for bit; within 1e-12 of the JAX package's 4 steps."""
    lattice = pt.Lattice(GRID, (2 * np.pi,) * 3, dtype=np.float64)
    fd = pt.FiniteDifferencer(1, lattice.dx, device="cpu")
    gen = pt.LowStorageRK3Williamson(
        lambda s, t: {"f": s["dfdt"], "dfdt": fd.lap(s["f"])})
    ref = pt.state_from_numpy(_state(4), device="cpu")
    for _ in range(4):
        ref = gen.step(ref, 0.0, 1e-3)
    st = pt.state_from_numpy(_state(4), device="cpu")
    for _ in range(2):
        st = gen.step(st, 0.0, 1e-3)
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        ck.save(2, st, metadata={"t": 2e-3})
        ck.finalize()
        _, st, meta = ck.restore()
    for _ in range(2):
        st = gen.step(st, meta["t"], 1e-3)
    _equal(st, ref)
    for k, v in jax_trajectories[0].items():
        assert _rel(st[k], v) < 1e-12, k


def test_resume_coupled_multi_step(tmp_path, jax_trajectories):
    """coupled_multi_step in chunks of one step: 1 step, check_now, save
    (a, adot in the metadata), finalize, restore, 1 step == the same two
    chunks uninterrupted bit for bit, a and adot too; within 1e-12 of the
    JAX package's one chunk of 2 steps (a chunk boundary moves where the
    stage pairs fall, so chunks of another length round otherwise)."""
    st_ = pt.FusedScalarStepper(
        pt.ScalarSector(2, potential=fused_test_potential), GRID, DX, H,
        dtype=torch.float64, device="cpu")
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    ref = pt.state_from_numpy(_state(41), device="cpu")
    for i in range(2):
        ref = st_.coupled_multi_step(ref, 1, exp, i * DT, DT)
    ref = {k: v.clone() for k, v in ref.items()}
    a_ref, adot_ref = float(exp.a), float(exp.adot)
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    mon = pt.HealthMonitor(every=1)
    st = st_.coupled_multi_step(pt.state_from_numpy(_state(41),
                                                    device="cpu"), 1, exp,
                                0.0, DT)
    mon.check_now(st, step=1)
    with pt.Checkpointer(tmp_path / "ck", device="cpu") as ck:
        ck.save(1, st, metadata={"t": DT, "a": float(exp.a),
                                 "adot": float(exp.adot)})
        st["f"].fill_(0.0)  # the stepper's buffers: the save kept a copy
        ck.finalize()
        _, st, meta = ck.restore()
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    exp.a, exp.adot = exp.dtype.type(meta["a"]), exp.dtype.type(
        meta["adot"])
    exp.hubble = exp.adot / exp.a
    got = st_.coupled_multi_step(st, 1, exp, meta["t"], DT)
    _equal(got, ref)
    assert (float(exp.a), float(exp.adot)) == (a_ref, adot_ref)
    jref, ja, jadot = jax_trajectories[1]
    for k, v in jref.items():
        assert _rel(got[k], v) < 1e-12, k
    assert abs(exp.a - ja) / ja < 1e-12
    assert abs(exp.adot - jadot) / abs(jadot) < 1e-12


# -- forensics and the event log ------------------------------------------------------

def _trip_sequence(pkg, tmp, log, arr, ckpt_kw):
    """saves at 1 and 2, finalize, restore, then a sentinel trip at step 5
    with a forensic sink pointing at the checkpointer."""
    pkg.obs.configure(log)
    st = {k: arr(v) for k, v in _state(3).items()}
    ck = pkg.Checkpointer(tmp / "ck", **ckpt_kw)
    ck.save(1, st, metadata={"t": 0.1})
    ck.save(2, st, metadata={"t": 0.2})
    ck.finalize()
    ck.restore()
    sink = pkg.obs.ForensicSink(str(tmp / "forensics"), events_path=log,
                                checkpoint=ck, config={"grid": list(GRID)},
                                label="unit")
    sen = pkg.obs.Sentinel.for_state(st)
    mon = pkg.obs.SentinelMonitor(sen, every=2, history=8, forensics=sink,
                                  emit_steps=True)
    for step in (3, 4):
        mon.observe(step, st)
        mon.poll()
    bad = _state(3)
    bad["f"][1, 3, 4, 5] = np.nan
    mon.observe(5, {k: arr(v) for k, v in bad.items()})
    with pytest.raises(RuntimeError) as exc:
        mon.flush()
    ck.close()
    pkg.obs.configure(None)
    return exc.value, sink


def test_trip_bundle_and_event_log_match_jax(tmp_path, logs):
    """The same saves, finalize, restore and sentinel trip in both
    packages: logs with equal kinds, steps and payload keys (timestamps,
    host and trace ids aside); the port's bundle names the bad field, the
    trip step, the last good checkpoint (durable: step 2) and holds the
    event tail."""
    pytest.importorskip("orbax.checkpoint")
    out = {}
    for name, pkg, arr, kw in (
            ("jax", ps, jnp.asarray, {}),
            ("port", pt, lambda v: torch.from_numpy(v), {"device": "cpu"})):
        tmp = tmp_path / name
        tmp.mkdir()
        log = str(tmp / "ev.jsonl")
        err, sink = _trip_sequence(pkg, tmp, log, arr, kw)
        assert type(err).__name__ == "SimulationDiverged" and err.step == 5
        out[name] = (pt.obs.read_events(log), sink)
    seq = {name: [(e["kind"], e["step"], sorted(e["data"]))
                  for e in evs] for name, (evs, _) in out.items()}
    assert seq["port"] == seq["jax"]
    assert [k for k, _, _ in seq["port"]] == [
        "checkpoint_save", "checkpoint_save", "checkpoint_durable",
        "checkpoint_durable", "checkpoint_restore", "health", "health",
        "health", "diverged", "forensic_bundle"]
    bundle = pt.obs.load_bundle(out["port"][1].last_bundle)
    jbundle = ps.obs.load_bundle(out["jax"][1].last_bundle)
    assert sorted(bundle) == sorted(jbundle)
    assert bundle["trip"]["step"] == 5 and bundle["trip"]["bad_fields"] == [
        "f"]
    assert bundle["last_good_checkpoint"]["step"] == 2
    assert bundle["health_history"][-1]["fields"]["f"]["finite"] is False
    assert bundle["field_history"]["f"]["steps"] == [3, 4, 5]
    assert any(e["kind"] == "diverged" for e in bundle["events_tail"])
    assert bundle["env"]["torch"] == torch.__version__
    with pytest.raises(ValueError):
        pt.obs.load_bundle(str(tmp_path / "port" / "ev.jsonl"))


def test_forensic_sink_never_raises(tmp_path, logs):
    """A bundle that cannot be written degrades to a forensic_failed event
    and returns None."""
    log = str(logs / "ev.jsonl")
    pt.obs.configure(log)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    sink = pt.obs.ForensicSink(str(blocker / "sub"))
    assert sink.write(step=3, reason="r", bad_fields=["f"]) is None
    assert sink.last_bundle is None
    pt.obs.configure(None)
    assert [e["kind"] for e in pt.obs.read_events(log)] == [
        "forensic_failed"]


# -- the science example ------------------------------------------------------

def _example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_scalar_preheating",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "examples", "torch_scalar_preheating.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", [[], ["--fused", "--chunk-steps", "1"]],
                         ids=["per_stage", "fused_coupled"])
def test_example_resume_is_uninterrupted(tmp_path, logs, path):
    """examples/torch_scalar_preheating.py at 16^3 on the CPU, with
    --checkpoint-dir: a run to t1 and a second run to t2 (resumed from the
    newest checkpoint) end in the final state and constraint of one
    uninterrupted run to t2, bit for bit; the resumed run's log records the
    restore and the in-loop saves' durability barriers."""
    pytest.importorskip("h5py")
    example = _example()
    base = ["-grid", "16", "16", "16", "--device", "cpu",
            "--checkpoint-interval", "2", "--health-every", "2", *path]

    def run(name, end_t):
        return example.main(base + [
            "-end-t", str(end_t), "--checkpoint-dir", str(tmp_path / name),
            "--outfile", str(tmp_path / f"{name}-{end_t}"),
            "--forensics-dir", str(tmp_path / "forensics"),
            "--event-log", str(tmp_path / f"{name}.jsonl")])
    whole = run("whole", 0.3)
    run("split", 0.15)
    resumed = run("split", 0.3)
    assert resumed == whole
    finals = []
    for name in ("whole", "split"):
        with pt.Checkpointer(tmp_path / name, device="cpu") as ck:
            finals.append(ck.restore())
    (sa, a, ma), (sb, b, mb) = finals
    assert sa == sb and ma == mb
    _equal(a, b)
    evs = pt.obs.read_events(str(tmp_path / "split.jsonl"))
    kinds = [e["kind"] for e in evs]
    restore = kinds.index("checkpoint_restore")
    assert kinds.count("run_start") == 2 and restore < kinds.index(
        "run_start", kinds.index("run_start") + 1)
    assert {"checkpoint_save", "checkpoint_durable", "health", "step_time",
            "spectra_time", "run_complete"} <= set(kinds)
    assert not (tmp_path / "forensics").exists()
