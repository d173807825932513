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


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_scalar_preheating",
        os.path.join(REPO, "examples", "torch_scalar_preheating.py"))
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
