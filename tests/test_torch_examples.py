"""examples/torch_scalar_preheating.py, the port's science example, on the
CPU (``--device cpu``), against the JAX example's golden Friedmann
constraint (tests/test_examples.py:GOLDEN_CONSTRAINT, 32^3 to t = 1, seed
49279).

- With the JAX package's white-noise draws handed to the port's
  RayleighGenerator (its draw method replaced; the same seed, in the JAX
  example's order: per field, the field's noise then its velocity's), the
  constraint is within 1e-3 of the golden value, the JAX test's own bar
  (the gap found: about 1e-8 relative).
- On the port's own RNG, within 2%: the realization spread is about +-1%
  and the reference's own value sits 0.53% from the golden one.
- On -proc 2 2 1 the run is the (1, 1, 1) run bit for bit.
- With -gws at 16^3 to t = 0.3 the HDF5 file holds spectra/gw.

examples/torch_ensemble_scan.py against examples/ensemble_scan.py at 16^3,
``--members 8 --jobs 16 --nsteps 16`` (8 members: the JAX example packs them
over the suite's 8 virtual CPU devices, and its shard_members needs a count
they divide): each seed's final <dfdt^2> within 1e-5 relative.
examples/torch_wave_equation.py keeps the JAX example's energy bar, drift
< 1e-3 at 32^3 to t = 1 (tests/test_examples.py:55-59).
"""

import importlib.util
import os

import h5py
import jax
import numpy as np
import pytest
import torch

import pystella_tpu_torch as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_CONSTRAINT = 5.6021274619233452e-08
ARGS = ["-grid", "32", "32", "32", "-end-t", "1", "--device", "cpu"]


def _example(name="torch_scalar_preheating"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _example()


@pytest.fixture(scope="module")
def own_rng_runs(example, tmp_path_factory):
    """The 32^3 run on the port's own RNG, on (1, 1, 1) and (2, 2, 1)."""
    out = tmp_path_factory.mktemp("own")
    return {proc: example.main(ARGS + ["-proc", *map(str, proc),
                                       "--outfile", str(out / "".join(
                                           map(str, proc)))])
            for proc in ((1, 1, 1), (2, 2, 1))}, out


def test_golden_with_jax_noise(example, monkeypatch, tmp_path):
    key = jax.random.key(49279)
    draws = []
    for _ in range(4):  # two fields, each its field's and velocity's draw
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (32,) * 3,
                                                  np.float64)))
    it = iter(draws)
    monkeypatch.setattr(pt.RayleighGenerator, "_white_noise",
                        lambda self: torch.from_numpy(next(it)).to(
                            self.device))
    constraint = example.main(ARGS + ["--outfile", str(tmp_path / "fed")])
    assert next(it, None) is None
    gap = abs(constraint - GOLDEN_CONSTRAINT) / GOLDEN_CONSTRAINT
    assert gap < 1e-3, f"constraint {constraint}: {gap:.3e} from golden"
    with h5py.File(tmp_path / "fed.h5", "r") as f:
        assert "energy" in f and "statistics/f" in f and "spectra" in f
        assert "rho_histogram/linear" in f and "rho_histogram/log" in f
        assert f["spectra/scalar"].shape[1:] == (2, 29)
        assert f["energy/constraint"].shape[0] > 0
        assert "hostname" in f.attrs and "runfile" in f.attrs


def test_golden_band_on_own_rng(own_rng_runs):
    constraint = own_rng_runs[0][(1, 1, 1)]
    assert abs(constraint - GOLDEN_CONSTRAINT) / GOLDEN_CONSTRAINT < 2e-2


def test_sharded_run_equals_single_device(own_rng_runs):
    """-proc 2 2 1: the same final constraint and output, bit for bit."""
    runs, out = own_rng_runs
    assert runs[(2, 2, 1)] == runs[(1, 1, 1)]
    with h5py.File(out / "111.h5", "r") as a, \
            h5py.File(out / "221.h5", "r") as b:
        for key in ("energy/total", "statistics/f/mean", "spectra/scalar",
                    "spectra/rho", "rho_histogram/linear",
                    "rho_histogram/log_bins"):
            np.testing.assert_array_equal(a[key][:], b[key][:], err_msg=key)


def test_gravitational_waves(example, tmp_path):
    constraint = example.main(["-grid", "16", "16", "16", "-end-t", "0.3",
                               "-gws", "--device", "cpu", "--outfile",
                               str(tmp_path / "gw")])
    assert np.isfinite(constraint) and constraint < 1e-4
    with h5py.File(tmp_path / "gw.h5", "r") as f:
        assert "spectra" in f and "gw" in f["spectra"]
        assert np.all(np.isfinite(f["spectra/gw"][:]))


SCAN_ARGS = ["--members", "8", "--jobs", "16", "--nsteps", "16"]


def test_ensemble_scan_matches_jax(monkeypatch):
    """Every seed's final <dfdt^2> within 1e-5 relative of the JAX
    example's (the JAX example prints eight; its driver's on_finish is
    wrapped to read all sixteen)."""
    import pystella_tpu as ps
    jax_finals = {}
    run = ps.EnsembleDriver.run

    def wrapped(self, on_finish=None):
        def record(rec, state):
            jax_finals[rec["seed"]] = float(np.mean(np.square(
                state["dfdt"])))
            on_finish(rec, state)
        return run(self, on_finish=record)
    monkeypatch.setattr(ps.EnsembleDriver, "run", wrapped)
    jout = _example("ensemble_scan").main(SCAN_ARGS)
    out = _example("torch_ensemble_scan").main(SCAN_ARGS
                                               + ["--device", "cpu"])
    assert out["stats"]["members_completed"] == 16
    assert jout["stats"]["members_completed"] == 16
    assert out["stats"]["evictions"] == jout["stats"]["evictions"] == 0
    ours = {seed: kin for seed, _, kin in out["finals"]}
    assert sorted(ours) == sorted(jax_finals) == list(range(16))
    for seed, kin in ours.items():
        assert abs(kin - jax_finals[seed]) <= 1e-5 * abs(jax_finals[seed])


def test_wave_equation_energy():
    drift = _example("torch_wave_equation").main(
        ["-grid", "32", "32", "32", "--end-time", "1", "--device", "cpu"])
    assert drift < 1e-3
