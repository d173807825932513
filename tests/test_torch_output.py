"""The port's OutputFile (utils/output.py): an HDF5 round trip with run
provenance, lazily created appendable datasets, the default-name
collision scan, and no h5py import before a file is opened."""

import subprocess
import sys

import h5py
import numpy as np
import pytest

import pystella_tpu_torch as pt

REPO = __file__.rsplit("/tests/", 1)[0]


def test_round_trip(tmp_path):
    runfile = tmp_path / "driver.py"
    runfile.write_text("print('hello')\n")
    with pt.OutputFile(name=str(tmp_path / "run"), runfile=str(runfile),
                       grid=(8, 8, 8), label="x") as out:
        for i in range(3):
            out.output("energy", t=0.5 * i, total=np.arange(2) * i)
            out.output("spectra", scalar=np.full((2, 5), i, np.float32))
        name = out.filename
    out.close()  # idempotent
    with h5py.File(name, "r") as f:
        np.testing.assert_array_equal(f["energy/t"][:], [0.0, 0.5, 1.0])
        assert f["energy/total"].shape == (3, 2)
        assert f["spectra/scalar"].shape == (3, 2, 5)
        assert f["spectra/scalar"].dtype == np.float32
        assert f.attrs["runfile"] == "print('hello')\n"
        assert f.attrs["label"] == "x"
        np.testing.assert_array_equal(f.attrs["grid"], [8, 8, 8])
        assert f.attrs["platform"] in ("gpu", "cpu")
        assert "hostname" in f.attrs and "torch_version" in f.attrs
        assert "jax_version" not in f.attrs


def test_default_names_do_not_collide(tmp_path):
    names = []
    for _ in range(2):
        out = pt.OutputFile(out_dir=str(tmp_path / "results"))
        names.append(out.filename)
        out.close()
    assert names[0].endswith("output-0.h5")
    assert names[1].endswith("output-1.h5")


@pytest.mark.parametrize("module", ["pystella_tpu_torch",
                                    "pystella_tpu_torch.utils.output"])
def test_import_pulls_in_no_h5py(module):
    """The GPU machine has no h5py: importing the package (or the module)
    must not need it."""
    code = (f"import sys, {module}\n"
            "print([m for m in sys.modules if m.split('.')[0] == 'h5py'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]", out.stdout
