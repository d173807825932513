"""The health kernel's CUDA source (``ops/csrc/health.cu``, K15 and its
finish) built with g++ behind the CPU stand-in of the CUDA runtime
(``pystella_tpu_torch/tools/cpu_shim``) and run on CPU tensors through the
port's own wrapper: float32, float64 and bfloat16 fields with NaN, +-inf
and overflowing sites, aligned and scalar loads, rows of several vector
passes and more units than a launch's blocks, against the plain version
(finite and max_abs exactly, rms within 1e-13), twice for equal bits, and
on (2, 1, 1) and (2, 2, 1) blocks against the whole lattice's launch.

The rehearsal runs once, in a process of its own (``rehearse.py --health
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
    """``{tag: passed}`` of every check of the small health rehearsal."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build health.cu behind the CPU stand-in "
                    "of the CUDA runtime")
    # at a lower priority: its 8 threads a launch yield to the other
    # workers of a parallel test run
    run = subprocess.run(
        [sys.executable, str(REHEARSE), "--health", "--small"],
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
    "health float32", "health float64", "health bfloat16",
    "health mixed dtypes", "health members"])
def test_health_kernel_behind_cpu_shim(checks, group):
    """Every check of one dtype passes: finite and max_abs equal to the
    plain version's, rms within 1e-13, repeat and sharded launches bit for
    bit."""
    mine = {t: ok for t, ok in checks.items() if t.startswith(group)}
    assert mine, f"no check of {group!r}"
    assert all(mine.values()), [t for t, ok in mine.items() if not ok]


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf", "overflow",
                                  "misaligned"])
def test_health_shim_covers_poisoned_sites(checks, kind):
    """The rehearsal runs each poisoned and the misaligned case, in each
    dtype, and the sharded launches."""
    for dt in ("float32", "float64", "bfloat16"):
        assert any(t.startswith(f"health {dt}") and t.split(")")[1]
                   .strip().startswith(kind) for t in checks), (dt, kind)
    assert any(t.endswith("(2, 2, 1)") for t in checks)
