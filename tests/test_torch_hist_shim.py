"""The binning kernels' CUDA source (``ops/csrc/histogram.cu``) built with
g++ behind the CPU stand-in of the CUDA runtime
(``pystella_tpu_torch/tools/cpu_shim``) and run on CPU tensors through the
port's own wrappers: K13 (counts on uniform, hot-bin, sorted and
misaligned bins; float32 and float64 weights) and K14 (r2c and c2c
spectra, float32 and float64) against their plain versions at 16^3,
5x9x33 and 2x4x600, against the build that bins every site through the
warp grouping (``PK_HIST_MATCH 1``), twice for equal bits, and on (2, 1, 1)
and (2, 2, 1) blocks against the whole lattice's launch.

The rehearsal runs once, in a process of its own (``rehearse.py --hist
--small``): the stand-in patches a copy of the package and ``torch.cuda``,
which must not leak into the other tests' process. Each test reads the
checks of one group from its output. It skips where g++ is missing.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REHEARSE = (Path(__file__).resolve().parents[1] / "pystella_tpu_torch"
            / "tools" / "cpu_shim" / "rehearse.py")


@pytest.fixture(scope="module")
def checks():
    """``{tag: passed}`` of every check of the small hist rehearsal."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build histogram.cu behind the CPU "
                    "stand-in of the CUDA runtime")
    # at a lower priority: its 8 threads a launch yield to the other
    # workers of a parallel test run
    run = subprocess.run(
        [sys.executable, str(REHEARSE), "--hist", "--small"],
        cwd=REHEARSE.parent, capture_output=True, text=True, timeout=600,
        preexec_fn=lambda: os.nice(10))
    got, lines = {}, 0
    for line in run.stdout.splitlines():
        status, _, tag = line.partition(" ")
        if status in ("ok", "FAIL"):
            lines += 1
            got[tag.strip()] = got.get(tag.strip(), True) and status == "ok"
    # the rehearsal ran to its end: no exception, its closing summary
    # printed, and its exit code the summary's (1 only for failed checks)
    assert "Traceback" not in run.stderr, run.stderr[-4000:]
    summary = re.search(r"^(\d+) ok, (\d+) failed, ", run.stdout, re.M)
    assert summary, ("the rehearsal did not reach its end:\n"
                     f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    n_ok, n_failed = map(int, summary.groups())
    assert run.returncode == (1 if n_failed else 0), run.stderr[-4000:]
    assert lines == n_ok + n_failed, (lines, n_ok, n_failed)
    return got


@pytest.mark.parametrize("group", [
    "bincount counts uniform", "bincount counts hot1",
    "bincount counts hot2", "bincount counts sorted",
    "bincount counts misaligned", "bincount float32", "bincount float64",
    "spectra_bin r2c", "spectra_bin c2c"])
def test_hist_kernels_behind_cpu_shim(checks, group):
    """Every check of one group passes: counts and K14's bins exact and
    equal to the grouping build's, sums within 1e-13 (f64) / 1e-6 (f32)
    of the largest bin, repeat and sharded launches bit for bit."""
    mine = {t: ok for t, ok in checks.items() if t.startswith(group)}
    assert mine, f"no check of {group!r}"
    assert all(mine.values()), [t for t, ok in mine.items() if not ok]


def test_hist_shim_covers_grouping_and_meshes(checks):
    """The rehearsal holds the kernels to the grouping build and runs the
    sharded launches."""
    assert any(t.endswith("== match") for t in checks)
    assert any(t.endswith("~ match") for t in checks)
    assert any(t.endswith("(2, 2, 1)") for t in checks)
