"""Per-member health with evict-and-resample.

PyTorch counterpart of ``pystella_tpu/ensemble/health.py``, under its names
(events ``ensemble_health``, ``member_evicted`` and ``diverged``, the
``ensemble_sentinel`` timer, the ``ensemble_health_checks`` and
``ensemble_evictions`` counters).

The single-run :class:`~pystella_tpu_torch.obs.sentinel.SentinelMonitor`
treats ANY unhealthy vector as fatal: it writes forensics and raises
``SimulationDiverged``, killing the run. In an ensemble that policy is
wrong — one bad parameter draw must not kill the other ``size - 1``
members (nor force a recompile of the batch). The
:class:`EnsembleMonitor` is the member-axis consumer:

- the batched step produces a ``(members, size)`` health MATRIX
  (:meth:`~pystella_tpu_torch.obs.sentinel.Sentinel.compute_members`: one
  K15 read of each state leaf for the batch) per chunk; the monitor polls
  it with the same maturity lag as the single-run monitor (no host sync on
  the step path);
- an unhealthy ROW marks that member **evicted**: a ``member_evicted``
  run event names the member, its parameter draw, and the offending
  fields; a per-member forensic bundle
  (:func:`~pystella_tpu_torch.obs.forensics.write_bundle` with ``member=``)
  records its own blowup curve — not the whole batch's; the member is
  then ignored until the driver resamples the slot and calls
  :meth:`EnsembleMonitor.reset_member`;
- the batch itself never raises — UNLESS the eviction budget
  (``PYSTELLA_ENSEMBLE_MAX_EVICTIONS``) is exhausted, at which point
  the configuration itself is declared broken the single-run way
  (``diverged`` event + :class:`~pystella_tpu_torch.obs.sentinel.
  SimulationDiverged`).

The driver side (slot resampling, occupancy/throughput accounting)
lives in :mod:`pystella_tpu_torch.ensemble.driver`.
"""

from __future__ import annotations

import collections

from pystella_tpu_torch import config as _config
from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import metrics as _metrics
from pystella_tpu_torch.obs.sentinel import SimulationDiverged

__all__ = ["EnsembleMonitor", "Eviction"]


class Eviction:
    """One member eviction: ``member`` (slot index), ``step`` (the
    offending step), ``fields`` (bad field/invariant names),
    ``problems`` (human reasons), ``params`` (the member's parameter
    draw at trip time), ``scenario`` (its scenario name, when the
    driver registered one), ``bundle`` (forensic-bundle path or
    ``None``)."""

    __slots__ = ("member", "step", "fields", "problems", "params",
                 "scenario", "bundle")

    def __init__(self, member, step, fields, problems, params=None,
                 scenario=None, bundle=None):
        self.member = int(member)
        self.step = int(step)
        self.fields = tuple(fields)
        self.problems = tuple(problems)
        self.params = dict(params or {})
        self.scenario = scenario
        self.bundle = bundle

    def __repr__(self):
        return (f"Eviction(member={self.member}, step={self.step}, "
                f"fields={list(self.fields)})")


class EnsembleMonitor:
    """Asynchronous consumer of per-chunk ensemble health matrices.

    :arg sentinel: the (single-member) :class:`~pystella_tpu_torch.obs.
        sentinel.Sentinel` whose :meth:`compute_members` produced the
        matrices.
    :arg size: member count (matrix row count).
    :arg every: minimum step lag before a matrix is host-converted
        (same pipelining contract as ``SentinelMonitor``).
    :arg history: ring-buffer capacity of decoded matrices (per-member
        forensic history is sliced from it).
    :arg max_abs / invariant_bounds: the health checks, per member.
    :arg forensics: optional :class:`~pystella_tpu_torch.obs.forensics.
        ForensicSink`; each eviction writes a member-scoped bundle.
    :arg max_evictions: eviction budget (default: the registered
        ``PYSTELLA_ENSEMBLE_MAX_EVICTIONS``); exceeding it raises
        :class:`~pystella_tpu_torch.obs.sentinel.SimulationDiverged`.
    :arg emit_steps: emit one ``ensemble_health`` event per checked
        matrix (summary counts only — per-member payloads would bloat
        the log at production sizes).
    """

    def __init__(self, sentinel, size, every=1, history=64,
                 max_abs=None, invariant_bounds=None, emit_steps=False,
                 label="", forensics=None, max_evictions=None):
        self.sentinel = sentinel
        self.size = int(size)
        self.every = int(every)
        self.max_abs = max_abs
        self.invariant_bounds = dict(invariant_bounds or {})
        self.emit_steps = bool(emit_steps)
        self.label = label
        self.forensics = forensics
        if max_evictions is None:
            max_evictions = _config.get_int(
                "PYSTELLA_ENSEMBLE_MAX_EVICTIONS")
        self.max_evictions = int(max_evictions)
        self._pending = collections.deque()   # (step, device matrix)
        self.history = collections.deque(maxlen=int(history))
        self.newest_step = None
        self.checked_through = None
        #: every Eviction so far, oldest first
        self.evictions = []
        self._member_params = {}   # member -> params dict
        self._member_scenario = {}  # member -> scenario name
        # members currently excluded from checks: evicted-awaiting-
        # resample and permanently masked (idle slots); plus the step
        # up to which a freshly resampled slot's STALE pending matrices
        # must be skipped
        self._suspended = set()
        self._masked = set()
        self._ignore_until = {}

    # -- driver bookkeeping -------------------------------------------------

    def set_member(self, member, params=None, scenario=None):
        """Record slot ``member``'s parameter draw / scenario name
        (what the eviction record and forensic bundle will name)."""
        member = int(member)
        if params is not None:
            self._member_params[member] = dict(params)
        if scenario is not None:
            self._member_scenario[member] = str(scenario)

    def mask_member(self, member):
        """Exclude slot ``member`` from all further checks (an idle
        slot after the scenario queue drained — its state keeps
        stepping as ballast and must not produce evictions)."""
        self._masked.add(int(member))

    def reset_member(self, member, at_step, params=None, scenario=None):
        """Re-arm checks for slot ``member`` after a resample/refill:
        matrices for steps ``<= at_step`` (produced by the OLD,
        possibly diverged occupant) are skipped for this member."""
        member = int(member)
        self._suspended.discard(member)
        self._masked.discard(member)
        self._ignore_until[member] = int(at_step)
        self.set_member(member, params=params, scenario=scenario)

    # -- queue --------------------------------------------------------------

    @property
    def pending_steps(self):
        return [s for s, _ in self._pending]

    def push(self, step, matrix):
        """Enqueue a ``(members, size)`` health matrix the batched step
        already produced (a device tensor; NO host sync)."""
        step = int(step)
        self._pending.append((step, matrix))
        self.newest_step = step

    def poll(self):
        """Check every pending matrix at least ``every`` steps behind
        the newest push. Returns the list of NEW :class:`Eviction`\\ s
        found (empty when all members are healthy); raises
        :class:`~pystella_tpu_torch.obs.sentinel.SimulationDiverged` only
        when the eviction budget is exhausted."""
        new = []
        while (self._pending and self.newest_step is not None
                and self._pending[0][0] <= self.newest_step
                - self.every):
            new += self._check_one(*self._pending.popleft())
        return new

    def flush(self):
        """Drain the queue unconditionally (end of run); returns the
        remaining new evictions."""
        new = []
        while self._pending:
            new += self._check_one(*self._pending.popleft())
        return new

    def check_member_now(self, member, through_step):
        """Synchronously check ``member``'s rows of the still-pending
        matrices for steps ``<= through_step`` — the RETIRE-time
        check: a member about to be reported finished must not have
        diverged inside its final chunks, whose matrices are still
        inside the maturity lag (retire is the driver's one deliberate
        sync point, so forcing these matrices to host here is within
        contract). Matrices stay queued for the normal asynchronous
        path (a healthy row re-checked later is still healthy; a
        tripped member is suspended, so it cannot evict twice).
        Returns the :class:`Eviction`, or ``None`` when the member's
        tail is healthy."""
        member = int(member)
        if member in self._masked or member in self._suspended:
            return None
        tail = []
        for step, matrix in self._pending:
            if step > int(through_step):
                break
            if step <= self._ignore_until.get(member, -1):
                continue
            with _metrics.timer("ensemble_sentinel"):
                # decode ONE row — a drain wave retires every slot at
                # once, and decoding the whole matrix per retiring
                # member would be O(size^2) host work
                dec = self.sentinel.decode(matrix[member])
                bad, why = self.sentinel.problems(
                    dec, max_abs=self.max_abs,
                    invariant_bounds=self.invariant_bounds)
            tail.append({"step": step, "members": {member: dec}})
            if bad:
                # commit the member's final-chunk rows to the history
                # ring before the evict, so the forensic bundle carries
                # exactly the series that diverged — healthy retires
                # commit nothing (size single-member appends per drain
                # wave would flush the ring other members' bundles
                # need). No double entry later: after the trip the
                # member is suspended, so _check_one skips it when
                # these matrices mature.
                self.history.extend(tail)
                ev = self._evict(step, member, bad, why)
                self._enforce_budget(step)
                return ev
        return None

    # -- the check ----------------------------------------------------------

    def _member_history(self, member):
        """This member's own health series from the ring buffer, in
        single-run record shape (so the forensic bundle's per-field
        blowup pivot applies unchanged)."""
        out = []
        for rec in self.history:
            row = rec["members"].get(member)
            if row is not None:
                out.append({"step": rec["step"], **row})
        return out

    def _check_one(self, step, matrix):
        # own metric names: the single-run `sentinel` timer and
        # `health_checks` counter feed the ledger's numerics section
        # (sentinel overhead % vs step time), which must keep
        # describing the single-run monitor when both run in one
        # process (bench.py --smoke does)
        with _metrics.timer("ensemble_sentinel"):
            decoded = self.sentinel.decode_members(matrix)
        self.checked_through = (step if self.checked_through is None
                                else max(self.checked_through, step))
        _metrics.counter("ensemble_health_checks").inc()
        checked = {}
        tripped = []
        for member, dec in enumerate(decoded):
            if member in self._masked or member in self._suspended:
                continue
            if step <= self._ignore_until.get(member, -1):
                continue
            checked[member] = dec
            with _metrics.timer("ensemble_sentinel"):
                bad, why = self.sentinel.problems(
                    dec, max_abs=self.max_abs,
                    invariant_bounds=self.invariant_bounds)
            if bad:
                tripped.append((member, bad, why))
        self.history.append({"step": step, "members": checked})
        if self.emit_steps:
            _events.emit("ensemble_health", step=step, label=self.label,
                         members=self.size, checked=len(checked),
                         tripped=[m for m, _, _ in tripped])
        new = []
        for member, bad, why in tripped:
            new.append(self._evict(step, member, bad, why))
        self._enforce_budget(step)
        return new

    def _enforce_budget(self, step):
        """Escalate to the single-run ``diverged`` path once the
        eviction budget is exhausted — a configuration producing that
        many bad draws is itself broken."""
        if len(self.evictions) > self.max_evictions:
            _events.emit(
                "diverged", step=step, label=self.label,
                fields=sorted({f for e in self.evictions
                               for f in e.fields}),
                problems=[f"eviction budget exhausted: "
                          f"{len(self.evictions)} member evictions "
                          f"(limit {self.max_evictions})"])
            raise SimulationDiverged(
                step, [f"member{e.member}" for e in self.evictions],
                [f"ensemble eviction budget exhausted "
                 f"({len(self.evictions)} > {self.max_evictions})"])

    def _evict(self, step, member, bad, why):
        """Record one member eviction: event + member-scoped forensic
        bundle; the member is suspended until the driver resamples the
        slot. Never raises (the batch survives by contract)."""
        self._suspended.add(member)
        params = self._member_params.get(member)
        scenario = self._member_scenario.get(member)
        _metrics.counter("ensemble_evictions").inc()
        _events.emit("member_evicted", step=step, label=self.label,
                     member=member, scenario=scenario, fields=bad,
                     problems=why, params=params)
        bundle = None
        if self.forensics is not None:
            offending = next(
                (n for n in bad if n in self.sentinel.invariants), None)
            bundle = self.forensics.write(
                step=step, reason="; ".join(why), bad_fields=bad,
                offending_invariant=offending,
                history=self._member_history(member),
                member=member,
                member_params={"scenario": scenario,
                               **(params or {})})
        ev = Eviction(member, step, bad, why, params=params,
                      scenario=scenario, bundle=bundle)
        self.evictions.append(ev)
        return ev
