"""Benchmark/profiling helpers.

PyTorch counterpart of ``pystella_tpu/utils/profiling.py``:
:func:`timer` (a warmup + average harness that waits for the card with
``torch.cuda.synchronize``), :class:`trace` (``torch.profiler`` around a
block, written as a Chrome/Perfetto trace) and :class:`StepTimer` (rolling
ms/step telemetry with the JAX package's events and metrics). The JAX
``StepTimer`` also feeds every tick to the continuous-performance digest
(``obs.perf``, pystella_tpu/utils/profiling.py:165-171, ``PYSTELLA_PERF``);
that leg is left out until the port's ``obs/perf`` (ROADMAP queue 1 item
7).
"""

from __future__ import annotations

import collections
import os
import time

import torch

from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import metrics as _metrics

__all__ = ["timer", "trace", "StepTimer"]


def _sync():
    """Wait for the card when CUDA is in use (a no-op on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timer(kernel, ntime=200, nwarmup=2, reps=1, min_over_rounds=None):
    """Average milliseconds per call of ``kernel()``, with warmup; the
    card is synchronized before the clock starts and after the last call.

    ``min_over_rounds=R`` (an int > 1) instead runs R such timed rounds
    and returns the MINIMUM of the per-round averages."""
    for _ in range(nwarmup):
        kernel()
    _sync()
    rounds = 1 if not min_over_rounds else max(1, int(min_over_rounds))
    best = None
    for _ in range(rounds):
        start = time.perf_counter()
        for _ in range(ntime):
            for _ in range(reps):
                kernel()
        _sync()
        elapsed = time.perf_counter() - start
        ms = elapsed / ntime / reps * 1000
        best = ms if best is None else min(best, ms)
    return best


class trace:
    """Context manager around ``torch.profiler`` producing a Chrome /
    Perfetto trace of everything inside (CPU and, where CUDA is in use,
    the card's kernels), written to ``<logdir>/trace.json`` on exit.

    Usage::

        with pt.utils.profiling.trace("/tmp/trace"):
            state = stepper.multi_step(state, 4)
            torch.cuda.synchronize()
    """

    def __init__(self, logdir):
        self.logdir = str(logdir)
        self.path = os.path.join(self.logdir, "trace.json")
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        _sync()
        self._prof.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)


class StepTimer:
    """Rolling ms/step + steps/s telemetry for driver loops: the rate
    covers only the last reporting window, so one-time kernel builds do
    not skew steady-state numbers.

    Call :meth:`tick` once per step; it returns a ``(ms_per_step,
    steps_per_s)`` tuple every ``report_every`` seconds and ``None``
    otherwise. On the card each tick first waits for it
    (``torch.cuda.synchronize``), so a step's time is the time its work
    took, not the time its launches took to enqueue.

    The metrics registry's ``step`` timer is the single timing
    accumulator; each report sets the ``ms_per_step`` / ``steps_per_s``
    gauges and emits a ``step_timer`` run event. Per-step wall times are
    kept in :attr:`samples_ms` (bounded, newest last); with
    ``emit_steps=True`` each tick also emits a ``step_time`` event.

    :arg report_every: seconds between window reports.
    :arg emit_steps: emit a ``step_time`` event on every tick.
    :arg sample_capacity: per-step samples retained in :attr:`samples_ms`.

    The JAX package's ``signature`` and ``perf`` arguments select the
    ``obs.perf`` digest the ticks feed; they come with the port's
    ``obs/perf``.
    """

    def __init__(self, report_every=30.0, emit_steps=False,
                 sample_capacity=4096):
        self.report_every = float(report_every)
        self.emit_steps = bool(emit_steps)
        self.samples_ms = collections.deque(maxlen=int(sample_capacity))
        # the clock starts at the FIRST tick, so timing covers steps 2..N
        self.last_tick = None
        self.last_report = None
        self.steps = 0
        # registered now, so a snapshot lists them before the first report
        _metrics.gauge("ms_per_step")
        _metrics.gauge("steps_per_s")
        self._timer = _metrics.timer("step")
        self._count_at_report = self._timer.count
        self._total_at_report = self._timer.total_s

    def tick(self):
        self.steps += 1
        _sync()
        now = time.perf_counter()
        if self.last_tick is None:
            self.last_tick = now
            self.last_report = now
            self._count_at_report = self._timer.count
            self._total_at_report = self._timer.total_s
            return None
        elapsed = now - self.last_tick
        self.last_tick = now
        self._timer.observe(elapsed)  # the one accumulator
        self.samples_ms.append(elapsed * 1e3)
        if self.emit_steps:
            _events.emit("step_time", step=self.steps, ms=elapsed * 1e3)
        if now - self.last_report < self.report_every:
            return None
        window_steps = self._timer.count - self._count_at_report
        window_s = self._timer.total_s - self._total_at_report
        self.last_report = now
        self._count_at_report = self._timer.count
        self._total_at_report = self._timer.total_s
        ms = window_s * 1e3 / window_steps
        _metrics.gauge("ms_per_step").set(ms)
        _metrics.gauge("steps_per_s").set(1e3 / ms)
        _events.emit("step_timer", step=self.steps, ms_per_step=ms,
                     steps_per_s=1e3 / ms)
        return ms, 1e3 / ms
