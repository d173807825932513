"""The port's run telemetry (obs/events.py, obs/metrics.py, obs/scope.py,
config.py's event-log knobs) against the JAX package's: the same
registered event kinds and scope names, logs each package's
``read_events`` reads back (a rotated family too), the metrics'
semantics and names, and the import rule: no module of the port, no new
example and no part of ``chip_smoke.py`` imports ``jax``, ``orbax`` or
``pystella_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.obs import events as jevents
from pystella_tpu.obs import metrics as jmetrics
from pystella_tpu_torch import config as tconfig
from pystella_tpu_torch.obs import events as tevents
from pystella_tpu_torch.obs import metrics as tmetrics

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def logs(tmp_path):
    """A fresh default log in each package, closed afterwards."""
    yield tmp_path
    pt.obs.configure(None)
    ps.obs.configure(None)


# -- events ------------------------------------------------------------------

def test_registries_match_jax():
    """The port registers the JAX package's event kinds and scope names,
    as both packages hold them on import: compared in a fresh process,
    since a test of the JAX package registers a scope of its own at run
    time (tests/test_sentinel.py) in whichever worker runs it."""
    code = ("import json, pystella_tpu as ps, pystella_tpu_torch as pt\n"
            "from pystella_tpu.obs import events as je\n"
            "from pystella_tpu_torch.obs import events as te\n"
            "print(json.dumps([sorted(s) for s in ("
            "te.registered_event_kinds(), je.registered_event_kinds(), "
            "pt.obs.registered_scopes(), ps.obs.registered_scopes())]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    tkinds, jkinds, tscopes, jscopes = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert tkinds == jkinds
    assert tscopes == jscopes and tscopes


def test_config_registers_event_knobs():
    """PYSTELLA_EVENT_LOG and PYSTELLA_EVENT_ROTATE_MB, with the JAX
    package's defaults and help text."""
    from pystella_tpu import config as jconfig
    for name in ("PYSTELLA_EVENT_LOG", "PYSTELLA_EVENT_ROTATE_MB"):
        ours, theirs = tconfig._REGISTRY[name], jconfig.registered()[name]
        assert ours.default == theirs.default and ours.help == theirs.help


def test_emit_schema_and_cross_read(logs):
    """One event sequence in both packages: each package's read_events
    reads the other's log, with equal kinds, steps, payload keys and
    schema fields; tracing attaches trace/span/parent."""
    recs = {}
    for name, mod in (("jax", ps.obs), ("port", pt.obs)):
        path = str(logs / f"{name}.jsonl")
        mod.configure(path)
        mod.emit("run_start", step=0, t=0.0, grid_shape=(4, 4, 4))
        with mod.tracing(trace="t1", span="s1"):
            with mod.tracing(span="s2"):
                mod.emit("checkpoint_save", step=3, directory="d",
                         durable=False, a=np.float64(1.5),
                         x=torch.tensor(2.0))
        mod.configure(None)
        recs[name] = path
    for reader in (ps.obs.read_events, pt.obs.read_events):
        a, b = reader(recs["jax"]), reader(recs["port"])
        assert [(e["kind"], e["step"], sorted(e["data"])) for e in a] == \
            [(e["kind"], e["step"], sorted(e["data"])) for e in b]
        assert [sorted(e) for e in a] == [sorted(e) for e in b]
    save = pt.obs.read_events(recs["port"], kind="checkpoint_save")[0]
    assert (save["trace"], save["span"], save["parent"]) == ("t1", "s2",
                                                             "s1")
    assert save["data"]["a"] == 1.5 and save["data"]["x"] == 2.0
    assert save["v"] == tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION


def test_rotation_at_env_threshold(logs, monkeypatch):
    """PYSTELLA_EVENT_ROTATE_MB rolls the live file over into
    <stem>.<n>.jsonl members; the family reads back whole and in order in
    both packages, and no line is split."""
    monkeypatch.setenv("PYSTELLA_EVENT_ROTATE_MB", str(600 / 2**20))
    path = str(logs / "rot.jsonl")
    log = tevents.EventLog(path)
    assert log.rotate_bytes == 600
    for i in range(40):
        log.emit("step_time", step=i, ms=float(i))
    log.close()
    family = tevents.rotated_family(path)
    assert len(family) > 3 and family == jevents.rotated_family(path)
    for f in family:
        with open(f) as fh:
            for line in fh:
                json.loads(line)
    for reader in (tevents.read_events, jevents.read_events):
        steps = [e["step"] for e in reader(path, include_rotated=True)]
        assert steps == list(range(40))
    assert len(tevents.read_events(path)) < 40


def test_subscribers_and_torn_lines(logs):
    """A subscriber gets every record (also without a file); one that
    raises degrades to an obs_subscriber_error event; a torn trailing line
    is skipped on read."""
    got = []
    log = tevents.EventLog(str(logs / "sub.jsonl"))
    log.subscribe(got.append)

    def boom(rec):
        raise RuntimeError("nope")
    log.subscribe(boom)
    log.emit("health", step=1, label="x")
    log.emit("health", step=2, label="x")
    log.close()
    assert [r["step"] for r in got if r["kind"] == "health"] == [1, 2]
    kinds = [e["kind"] for e in tevents.read_events(str(logs / "sub.jsonl"))]
    assert kinds.count("obs_subscriber_error") == 1
    with open(logs / "sub.jsonl", "a") as f:
        f.write('{"kind": "torn')
    assert len(tevents.read_events(str(logs / "sub.jsonl"))) == len(kinds)
    quiet = tevents.EventLog(None)
    assert quiet.emit("health") is None and not quiet.enabled


def test_default_log_from_env(logs, monkeypatch):
    """PYSTELLA_EVENT_LOG configures the default log; an unopenable path
    degrades to a disabled sink."""
    path = logs / "env.jsonl"
    monkeypatch.setenv("PYSTELLA_EVENT_LOG", str(path))
    monkeypatch.setattr(tevents, "_default", None)
    pt.obs.emit("run_start", step=0)
    assert tevents.get_log().path == str(path)
    assert pt.obs.read_events(str(path))[0]["kind"] == "run_start"
    tevents.get_log().close()
    # a regular file where the log's directory should be
    monkeypatch.setenv("PYSTELLA_EVENT_LOG", str(path / "x.jsonl"))
    monkeypatch.setattr(tevents, "_default", None)
    assert not tevents.get_log().enabled


# -- metrics -----------------------------------------------------------------

def test_metrics_semantics_match_jax():
    """Counters, gauges and timers export the JAX package's keys, types
    and reductions; reduce_snapshots drops NaN the same way."""
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    for r in regs:
        r.counter("steps").inc(3)
        r.gauge("ms_per_step").set(2.5)
        r.gauge("peak", reduce="max")
        t = r.timer("sentinel")
        t.observe(0.002)
        t.observe(0.004)
        with pytest.raises(TypeError):
            r.gauge("steps")
    (j, t) = regs
    # repr: an unset gauge is NaN in both, and NaN != NaN
    assert repr(t.snapshot()) == repr(j.snapshot())
    assert repr(t.snapshot_typed()) == repr(j.snapshot_typed())
    snaps = [{"steps": 1.0, "ms_per_step": float("nan"), "peak": 3.0},
             {"steps": 2.0, "ms_per_step": 4.0, "peak": 5.0}]
    assert t.reduce_snapshots(snaps) == j.reduce_snapshots(snaps)
    assert repr(t.aggregate()) == repr(j.aggregate())


def test_run_metric_names(tmp_path):
    """The names the run-safety layer records: the sentinel timer and the
    health_checks counter (and a prefixed pair), the steps counter of the
    fused steppers, StepTimer's step timer and gauges."""
    before = tmetrics.registry().snapshot()
    st = pt.FusedScalarStepper(
        pt.ScalarSector(1, potential=lambda f: f[0] ** 2 / 2), (8, 8, 8),
        0.1, 1, dtype=torch.float64, dt=0.01, device="cpu")
    state = {"f": torch.ones(1, 8, 8, 8, dtype=torch.float64),
             "dfdt": torch.zeros(1, 8, 8, 8, dtype=torch.float64)}
    st.multi_step(state, 2, rhs_args={"a": 1.0, "hubble": 0.0})
    mon = pt.HealthMonitor(every=0)
    mon.observe(1, state)
    mon.poll()
    aux = pt.HealthMonitor(every=1, metrics_prefix="supervised")
    aux(0, state)
    timer = pt.StepTimer(report_every=0.0)
    assert timer.tick() is None
    ms, sps = timer.tick()
    assert ms > 0 and sps > 0
    after = tmetrics.registry().snapshot()
    for name in ("sentinel.count", "sentinel.total_s", "sentinel.ema_ms",
                 "health_checks", "supervised_sentinel.count",
                 "supervised_health_checks", "steps", "step.count",
                 "ms_per_step", "steps_per_s"):
        assert name in after, name
    assert after["steps"] - before.get("steps", 0) == 2
    assert after["health_checks"] - before.get("health_checks", 0) == 1
    assert after["supervised_health_checks"] - before.get(
        "supervised_health_checks", 0) == 1


def test_kernel_tier_and_fallback_events(logs):
    """A fused stepper's first multi_step and step each emit kernel_tier
    (its kernel_tier_report); a chunk depth it cannot take emits
    kernel_fallback beside the warning; the generic stepper's first step
    emits tier "eager"."""
    path = str(logs / "tier.jsonl")
    pt.obs.configure(path)
    sector = pt.ScalarSector(2, potential=lambda f: f[0] ** 2 / 2
                             + f[0] ** 2 * f[1] ** 2)
    with pytest.warns(UserWarning, match="whole-RK-chunk"):
        st = pt.FusedScalarStepper(sector, (8, 8, 8), 0.1, 1,
                                   dtype=torch.float64, dt=0.01,
                                   chunk_stages=6, device="cpu")
    state = {"f": torch.ones(2, 8, 8, 8, dtype=torch.float64),
             "dfdt": torch.zeros(2, 8, 8, 8, dtype=torch.float64)}
    args = {"a": 1.0, "hubble": 0.0}
    for _ in range(2):
        st.multi_step(state, 2, rhs_args=args)
        st.step(state, rhs_args=args)
    gen = pt.LowStorageRK54(lambda s, t: {"f": s["dfdt"], "dfdt": -s["f"]})
    gen.step(state, 0.0, 0.01)
    pt.obs.configure(None)
    evs = pt.obs.read_events(path)
    fb = [e for e in evs if e["kind"] == "kernel_fallback"]
    assert len(fb) == 1 and fb[0]["data"]["tier"] == "chunk"
    tiers = [e["data"] for e in evs if e["kind"] == "kernel_tier"]
    assert [(d["entrypoint"], d["tier"]) for d in tiers] == [
        ("multi_step", "pair"), ("step", "pair"), ("step", "eager")]
    assert tiers[0]["kernels_per_2_steps"] == \
        st.kernel_tier_report()["kernels_per_2_steps"]


# -- scopes ------------------------------------------------------------------

def test_trace_scope_names_a_profiler_region():
    """trace_scope and traced mark record_function regions a
    torch.profiler trace lists by name."""
    @pt.obs.traced("driver_step")
    def work(x):
        return x * 2

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pt.obs.trace_scope("sentinel"):
            torch.ones(4).sum()
        work(torch.ones(4))
    names = {e.key for e in prof.key_averages()}
    assert {"sentinel", "driver_step"} <= names


# -- the import rule ---------------------------------------------------------

def test_new_modules_import_no_jax():
    """Importing every module of the run-safety layer pulls in neither jax
    nor orbax nor pystella_tpu."""
    mods = ["pystella_tpu_torch.obs", "pystella_tpu_torch.obs.events",
            "pystella_tpu_torch.obs.metrics", "pystella_tpu_torch.obs.scope",
            "pystella_tpu_torch.obs.sentinel",
            "pystella_tpu_torch.obs.forensics",
            "pystella_tpu_torch.obs.ledger", "pystella_tpu_torch.ops.health",
            "pystella_tpu_torch.utils.monitor",
            "pystella_tpu_torch.utils.checkpoint",
            "pystella_tpu_torch.utils.profiling"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'orbax', 'pystella_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]", out.stdout


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_name_no_jax_import():
    """No source of the port's package, the port's examples or
    chip_smoke.py has an import of jax, orbax or pystella_tpu."""
    files = list((REPO / "pystella_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    files += list((REPO / "examples").glob("torch_*.py"))
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "orbax",
                                    "pystella_tpu"}
        assert not bad, (f, bad)


def test_port_emit_literals_are_registered():
    """Every obs emit("<kind>", ...) literal in the port names a registered
    kind (the JAX package's source lint checks its own the same way)."""
    kinds = tevents.registered_event_kinds()
    for f in (REPO / "pystella_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", None))
                    == "emit" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                assert node.args[0].value in kinds, (f, node.args[0].value)
    assert os.path.exists(REPO / "pystella_tpu_torch" / "obs" / "events.py")
