"""Runtime health monitoring: NaN/Inf watchdogs for long simulations.

PyTorch counterpart of ``pystella_tpu/utils/monitor.py``. Drivers wrap
their loop with a :class:`HealthMonitor` built on the numerics sentinel
(:mod:`pystella_tpu_torch.obs.sentinel`): a compact per-step health vector
(per-field finite/max-abs/rms) computed on the card by the kernel K15 and
its finish launch, enqueued behind the step and polled **asynchronously**:
the host only ever converts vectors already ``every`` steps behind the
driver, so the check adds no sync to the step critical path. On failure
:class:`SimulationDiverged` is raised with the offending field names and
the *actual* offending step, after the configured
:class:`~pystella_tpu_torch.obs.forensics.ForensicSink` (if any) wrote its
bundle, so a checkpointed run can stop early, diagnose, and resume from
the last good snapshot.

Two usage modes:

- **async (preferred)**: once per step/chunk call
  :meth:`HealthMonitor.observe` then :meth:`~HealthMonitor.poll`; call
  :meth:`~HealthMonitor.flush` at loop exit and
  :meth:`~HealthMonitor.check_now` (synchronous) immediately before
  trusting the state, e.g. a checkpoint save.
- **sync (legacy)**: the original ``monitor(step, state)`` contract:
  a blocking check every ``every`` steps.
"""

from __future__ import annotations

from pystella_tpu_torch.obs import sentinel as _sentinel
from pystella_tpu_torch.obs.sentinel import (  # noqa: F401  (re-exports)
    Sentinel, SentinelMonitor, SimulationDiverged)

__all__ = ["HealthMonitor", "SimulationDiverged"]


class HealthMonitor:
    """Finite-ness (and optional magnitude-bound) watchdog over a state
    (nested dicts of tensors or sharded arrays), async-first.

    :arg every: async mode: the poll lag in steps (a vector is only
        host-converted once the driver has pushed ``every`` newer
        steps). Sync mode: the check interval.
    :arg max_abs: optional magnitude bound — exceeding it also counts
        as divergence (useful to catch blowup before the first inf).
    :arg history: health vectors retained for the forensic bundle.
    :arg metrics_prefix: metric-name prefix forwarded to the underlying
        :class:`SentinelMonitor`: an auxiliary monitor running beside a
        primary driver monitor sets it so the two keep separate
        ``sentinel`` timers and ``health_checks`` counters.

    Set :attr:`forensics` to a
    :class:`~pystella_tpu_torch.obs.forensics.ForensicSink` to get a bundle
    written on every trip.
    """

    def __init__(self, every=50, max_abs=None, history=64,
                 metrics_prefix=""):
        self.every = int(every)
        self.max_abs = max_abs
        self.history_size = int(history)
        self.metrics_prefix = metrics_prefix
        #: optional ForensicSink consulted on a trip
        self.forensics = None
        self._mon = None
        self._names = None

    def _monitor_for(self, state):
        """The underlying :class:`SentinelMonitor`, rebuilt if the state
        structure changed (pending vectors of the old structure are
        flushed first so nothing silently escapes checking)."""
        names = tuple(sorted(_sentinel.named_leaves(state)))
        if self._mon is None or names != self._names:
            if self._mon is not None:
                self._mon.flush()
            self._mon = _sentinel.SentinelMonitor(
                _sentinel.Sentinel(names), every=self.every,
                history=self.history_size, max_abs=self.max_abs,
                metrics_prefix=self.metrics_prefix)
            self._names = names
        self._mon.forensics = self.forensics
        return self._mon

    # -- async interface ---------------------------------------------------

    def observe(self, step, state):
        """Dispatch the health vector of ``state`` at ``step`` (K15 and its
        finish, NO host sync) and enqueue it for a later :meth:`poll`."""
        self._monitor_for(state).observe(step, state)

    def sentinel_for(self, state):
        """The :class:`Sentinel` this monitor checks ``state`` with: pass it
        to ``multi_step(..., sentinel=)``, ``coupled_multi_step(...,
        sentinel=)`` or ``step_with_health`` and hand the vector they return
        to :meth:`push`. (The port's addition: the JAX ``HealthMonitor``
        computes its vectors through :meth:`observe` only.)"""
        return self._monitor_for(state).sentinel

    def push(self, step, vector):
        """Enqueue a health vector computed in the step with
        :meth:`sentinel_for`'s sentinel, for a later :meth:`poll`."""
        if self._mon is None:
            raise RuntimeError("push needs the sentinel of sentinel_for() "
                               "first")
        self._mon.push(step, vector)

    def poll(self):
        """Check every pending vector at least ``every`` steps behind
        the newest :meth:`observe`; raises :class:`SimulationDiverged`
        on failure. Returns the number of vectors checked."""
        return 0 if self._mon is None else self._mon.poll()

    def flush(self):
        """Drain the pending queue unconditionally (loop exit)."""
        return 0 if self._mon is None else self._mon.flush()

    def discard(self):
        """Drop pending vectors WITHOUT checking them — the recovery
        path: after a restore they describe the corrupted trajectory
        being rolled back. Returns the number dropped."""
        return 0 if self._mon is None else self._mon.discard()

    def reset(self):
        """Forget all decomposition-derived state (the re-mesh path): the
        next :meth:`observe` rebuilds the sentinel against the new state
        placement. Pending
        vectors are dropped unchecked (they describe the pre-loss
        trajectory; the recovery already discarded the corrupt ones).
        Returns the number dropped."""
        n = self.discard()
        self._mon = None
        self._names = None
        return n

    @property
    def checked_through(self):
        """Highest step actually health-checked so far (None before the
        first check) — the driver runs ahead of this by >= ``every``."""
        return None if self._mon is None else self._mon.checked_through

    @property
    def history(self):
        """Decoded health vectors, newest last (the forensic last-K)."""
        return [] if self._mon is None else list(self._mon.history)

    # -- sync interface ----------------------------------------------------

    def check_now(self, state, step=None):
        """Run the health check synchronously (e.g. immediately before a
        checkpoint save); raises :class:`SimulationDiverged` on failure.
        Pass ``step`` so a trip (and its ``diverged`` event / forensic
        bundle) reports the actual simulation step, not 0."""
        self._monitor_for(state).check_sync(
            0 if step is None else int(step), state)
        return True

    def __call__(self, step, state):
        """Check (every ``self.every`` steps, synchronously); raises
        :class:`SimulationDiverged` on failure, else returns True if the
        check ran — the legacy blocking contract."""
        if step % self.every:
            return False
        self._monitor_for(state).check_sync(step, state)
        return True
