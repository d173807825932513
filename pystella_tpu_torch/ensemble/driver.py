"""Scenario-queue scheduler: heterogeneous populations over one batch.

PyTorch counterpart of ``pystella_tpu/ensemble/driver.py``, with its events
(``ensemble_run``, ``ensemble_chunk``, ``ensemble_done``,
``member_started``, ``member_finished``, ``member_preempted``), its counters
and the keys of its stats dict. Left out: the PerfLedger's ``ensemble``
report section and the gate's member-throughput verdict, which read these
events in the JAX package; the port has no ``obs.ledger`` report or
``obs.gate`` yet (ROADMAP queue 1 item 7).

A production parameter scan is not one batch of identical members — it
is a QUEUE of scenarios (preheating configs, wave tests, GW runs) whose
members differ in parameter draws, IC seeds, and step budgets. The
:class:`EnsembleDriver` turns that queue into batched device work:

- **grouping**: jobs are grouped into shape-compatible batches — same
  base stepper, same state pytree structure/shapes/dtypes, same
  per-member parameter names — because one batched body can only carry
  members of one shape. Scenarios in different groups run
  as separate batches, sequentially.
- **chunked stepping**: each batch advances ``chunk`` steps per
  dispatch through :meth:`~pystella_tpu_torch.ensemble.EnsembleStepper.
  multi_step` with the sentinel piggybacked, so per-member health
  matrices are enqueued right behind the chunk (one K15 read of each
  leaf, no host sync on the step path).
- **slot refill**: a member that reaches its scenario's step budget
  retires; its slot is refilled from the queue (a write of one slot,
  :meth:`~pystella_tpu_torch.ensemble.EnsembleStepper.write_member`;
  the batch's shape never changes). With the queue drained, idle slots keep stepping as
  masked ballast so the batch shape never changes.
- **evict-and-resample**: an unhealthy member (per the
  :class:`~pystella_tpu_torch.ensemble.EnsembleMonitor`) is evicted — named
  in a ``member_evicted`` event and a member-scoped forensic bundle —
  and its slot resampled from the same scenario under a fresh seed
  (``PYSTELLA_ENSEMBLE_RESAMPLE=0`` masks the slot instead). The batch
  itself never dies unless the eviction budget is exhausted.
- **throughput accounting**: ``ensemble_chunk`` events per dispatch
  window and one ``ensemble_done`` event with the batch totals
  (member-steps, wall seconds, member-steps/s, mean occupancy,
  evictions), the events the JAX package's PerfLedger ``ensemble``
  report section and the gate's member-throughput verdict ingest.

A :class:`Scenario` is a named member family::

    def sample(seed):
        rng = np.random.default_rng(seed)
        state = {...}                  # ONE member's state pytree
        params = {"g2": rng.uniform(...)}   # scalar rhs_args draw
        return state, params

    sc = Scenario("preheat-g2-scan", stepper, sample, nsteps=200,
                  dt=1e-3)
    driver = EnsembleDriver(size=8, chunk=10, decomp=edecomp)
    driver.submit(sc, seeds=range(64))
    out = driver.run()

``out["results"]`` holds one record per completed member (scenario,
seed, params, final t); pass ``on_finish`` to retrieve final states
(the only host sync, at retire time by design).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pystella_tpu_torch import config as _config
from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import metrics as _metrics
from pystella_tpu_torch.obs.sentinel import Sentinel, named_leaves
from pystella_tpu_torch.ensemble.batch import EnsembleStepper
from pystella_tpu_torch.ensemble.health import EnsembleMonitor
from pystella_tpu_torch.parallel.decomp import (
    MemberArray, ShardedArray, _leaves)

__all__ = ["EnsembleDriver", "Scenario"]


class Scenario:
    """One member family in the queue.

    :arg name: scenario name (events, eviction records, and forensic
        bundles carry it).
    :arg stepper: the single-member stepper every member of this
        scenario advances under (any :class:`~pystella_tpu_torch.Stepper`,
        fused included).
    :arg sample: ``sample(seed) -> (state, params)`` — one member's
        initial state pytree and its SCALAR parameter draw (a dict
        merged into the batched ``rhs_args``; may be empty). Called
        again with a fresh seed when an evicted slot is resampled.
    :arg nsteps: per-member step budget; a member retires after it.
    :arg dt: member time step — a scalar, or ``dt(seed)`` for
        per-member draws.
    :arg t0: member start time.
    :arg invariants: optional ``{name: fn}`` sentinel invariants for
        this scenario's states (the first scenario of a batch group
        defines the group's sentinel).
    """

    def __init__(self, name, stepper, sample, nsteps, dt=None, t0=0.0,
                 invariants=None):
        self.name = str(name)
        self.stepper = stepper
        self.sample = sample
        self.nsteps = int(nsteps)
        self.dt = dt
        self.t0 = float(t0)
        self.invariants = dict(invariants or {})
        if self.nsteps < 1:
            raise ValueError(f"scenario {name!r}: nsteps must be >= 1")

    def member_dt(self, seed):
        dt = self.dt if not callable(self.dt) else self.dt(seed)
        if dt is None:
            dt = self.stepper.dt
        if dt is None:
            raise ValueError(
                f"scenario {self.name!r}: no dt (pass dt= or construct "
                "the stepper with one)")
        return float(dt)

    def __repr__(self):
        return f"Scenario({self.name!r}, nsteps={self.nsteps})"


class _Job:
    __slots__ = ("scenario", "seed", "resume", "trace")

    def __init__(self, scenario, seed, resume=None, trace=None):
        self.scenario = scenario
        self.seed = int(seed)
        #: ``(state, step, t, params)`` for a job re-entering with a
        #: restored trajectory (a preempted member) instead of a fresh
        #: sampler draw — see :meth:`EnsembleDriver.requeue`
        self.resume = resume
        #: optional request-scoped trace id (obs schema v2): the
        #: member lifecycle events carry it, so a caller that owns
        #: traces (the scenario service, a traced sweep harness) can
        #: attribute driver work per request — and a requeued member
        #: keeps its trace across the drain
        self.trace = trace


class _Slot:
    """One batch slot's host-side bookkeeping."""

    __slots__ = ("index", "job", "steps_done", "t", "dt", "active")

    def __init__(self, index):
        self.index = int(index)
        self.job = None
        self.steps_done = 0
        self.t = 0.0
        self.dt = 0.0
        self.active = False


def _state_signature(state):
    """The shape-compatibility key of one member state: leaf paths with
    shapes and dtypes (two scenarios batch together iff these match)."""
    sig = []
    for path, leaf in named_leaves(state).items():
        dtype = leaf.dtype
        dtype = (str(dtype).replace("torch.", "")
                 if isinstance(dtype, torch.dtype) else str(np.dtype(dtype)))
        sig.append((path, tuple(leaf.shape), dtype))
    return tuple(sig)


def _block_until_ready(batch):
    """Wait for every card the batch lies on (the JAX
    ``block_until_ready``)."""
    devs = set()
    for leaf in _leaves(batch):
        parts = leaf.parts if isinstance(leaf, MemberArray) else [leaf]
        for p in parts:
            for b in (p.blocks if isinstance(p, ShardedArray) else [p]):
                if b.device.type == "cuda":
                    devs.add(b.device)
    for d in devs:
        torch.cuda.synchronize(d)


class EnsembleDriver:
    """Run a queue of scenario jobs through batched member stepping.

    :arg size: batch member count (default: the registered
        ``PYSTELLA_ENSEMBLE_SIZE``).
    :arg chunk: steps per batched dispatch (health matrices and
        eviction decisions happen at chunk granularity).
    :arg decomp: optional ensemble-aware
        :class:`~pystella_tpu_torch.DomainDecomposition` (an
        :func:`~pystella_tpu_torch.ensemble_mesh` mesh) for member placement.
    :arg via / donate / device: forwarded to
        :class:`~pystella_tpu_torch.ensemble.EnsembleStepper` (``device``:
        where a batch without ``decomp`` lives; default the stepper's, or
        the GPU).
    :arg every: health-matrix maturity lag in CHUNKS before a poll
        converts it (the async-consumption contract of
        :class:`~pystella_tpu_torch.obs.sentinel.SentinelMonitor`, at chunk
        granularity).
    :arg forensics: optional :class:`~pystella_tpu_torch.obs.forensics.
        ForensicSink` — evictions then write member-scoped bundles.
    :arg resample: eviction policy override (default: the registered
        ``PYSTELLA_ENSEMBLE_RESAMPLE``): resample the slot from its
        scenario under a fresh seed, vs. mask it out for the run.
    :arg max_evictions / max_abs / invariant_bounds / history:
        forwarded to :class:`~pystella_tpu_torch.ensemble.EnsembleMonitor`.
    :arg emit_steps: per-chunk ``ensemble_health`` events (summary
        counts only).
    :arg preempt: optional ``preempt(chunk_index) -> bool`` polled
        after every batched dispatch; returning true DRAINS the run at
        that chunk boundary — pending health matrices are converted,
        the batch is synced, and every still-active member leaves as a
        requeue record (scenario, seed, host state, steps done, t,
        parameter draw) in the run output's ``preempted`` list, with
        unstarted jobs in ``pending``. :meth:`requeue` is the matching
        re-entry: a drained member resumes its OWN trajectory (bit-
        consistent with an uninterrupted run) instead of resampling.
        This is the scenario service's preemption hook
        (:mod:`pystella_tpu_torch.service`).
    """

    def __init__(self, size=None, chunk=4, decomp=None, via="auto",
                 donate=False, every=1, forensics=None, resample=None,
                 max_evictions=None, max_abs=None, invariant_bounds=None,
                 history=64, emit_steps=False, label="ensemble",
                 preempt=None, device=None):
        if size is None:
            size = _config.get_int("PYSTELLA_ENSEMBLE_SIZE")
        self.size = int(size)
        self.chunk = int(chunk)
        if self.size < 1 or self.chunk < 1:
            raise ValueError("size and chunk must be >= 1")
        self.decomp = decomp
        self.via = via
        self.donate = donate
        self.every = int(every)
        self.forensics = forensics
        if resample is None:
            resample = _config.get_bool("PYSTELLA_ENSEMBLE_RESAMPLE")
        self.resample = bool(resample)
        self.max_evictions = max_evictions
        self.max_abs = max_abs
        self.invariant_bounds = dict(invariant_bounds or {})
        self.history = int(history)
        self.emit_steps = bool(emit_steps)
        self.label = str(label)
        self.preempt = preempt
        self.device = device
        self._queue = []          # FIFO of _Job, submit order preserved
        self._next_seed = {}      # scenario name -> next resample seed
        self._predrawn = {}       # (id(scenario), seed) -> (state, params)

    # -- queue --------------------------------------------------------------

    def submit(self, scenario, seeds, trace=None):
        """Enqueue one job per seed for ``scenario`` (FIFO; grouping
        into shape-compatible batches happens at :meth:`run`).
        ``trace`` optionally tags every job's member lifecycle events
        with a request-scoped trace id (obs schema v2)."""
        seeds = [int(s) for s in seeds]
        for s in seeds:
            self._queue.append(_Job(scenario, s, trace=trace))
        nxt = self._next_seed.get(scenario.name, 0)
        self._next_seed[scenario.name] = max([nxt] + [s + 1 for s in seeds])
        return self

    def _fresh_seed(self, scenario):
        s = self._next_seed.get(scenario.name, 0)
        self._next_seed[scenario.name] = s + 1
        return s

    def requeue(self, scenario, state, step, seed=0, params=None,
                t=None, trace=None):
        """Re-enter a preempted member: the job re-joins the queue
        carrying its RESTORED state and completed step count, so its
        slot resumes the same trajectory instead of resampling from
        scratch (the only re-entry path before this was a fresh draw).
        ``state`` is one member's state pytree (host or device arrays);
        ``step`` is the number of steps already taken (the member
        retires after ``scenario.nsteps - step`` more); ``params`` is
        the member's original parameter draw; ``t`` overrides the
        resume time (default ``scenario.t0 + step * member_dt``). A
        requeued member's trajectory is bit-consistent with its
        uninterrupted run — the batched per-member bodies are
        lane-independent, so neither the preemption boundary nor the
        co-members of the resumed batch change its arithmetic.
        ``trace`` carries the member's request-scoped trace id across
        the drain — the requeued member's events keep ONE trace."""
        job = _Job(scenario, seed,
                   resume={"state": state, "step": int(step),
                           "t": t, "params": dict(params or {})},
                   trace=trace)
        self._queue.append(job)
        nxt = self._next_seed.get(scenario.name, 0)
        self._next_seed[scenario.name] = max(nxt, int(seed) + 1)
        return self

    # -- grouping -----------------------------------------------------------

    def _group_jobs(self):
        """Partition the queue into shape-compatible groups (submit
        order preserved within and across groups). The group key is
        (stepper identity, state signature of a sample draw, sorted
        parameter names): exactly the things one batched trace can't
        vary. The signature draw happens once per SCENARIO, not per
        job — a sampler producing production-size fields must not run
        twice per member just to read shapes."""
        groups = []       # list of (key, [jobs], template_state, params)
        by_key = {}
        by_scenario = {}  # id(scenario) -> (signature, param_names, template)
        self._predrawn = {}  # (id(scenario), seed) -> (state, params)
        for job in self._queue:
            sc = job.scenario
            if job.resume is not None:
                # a requeued member carries its own restored state: its
                # signature comes from THAT, not a sampler draw (and it
                # groups with fresh jobs of the same shape — one
                # batched program serves both)
                ent = (_state_signature(job.resume["state"]),
                       tuple(sorted(job.resume["params"])),
                       (job.resume["state"],
                        dict(job.resume["params"])))
            else:
                ent = by_scenario.get(id(sc))
                if ent is None:
                    state, params = sc.sample(job.seed)
                    ent = (_state_signature(state),
                           tuple(sorted(params or {})),
                           (state, dict(params or {})))
                    by_scenario[id(sc)] = ent
                    # the fill/refill path reuses this draw for the same
                    # job instead of sampling it a second time
                    self._predrawn[(id(sc), job.seed)] = ent[2]
            sig, param_names, template = ent
            key = (id(sc.stepper), sig, param_names)
            if key not in by_key:
                by_key[key] = len(groups)
                groups.append({"key": key, "jobs": [],
                               "template": template})
            groups[by_key[key]]["jobs"].append(job)
        self._queue = []
        return groups

    def _sample(self, job):
        """One member's fill: a requeued job re-enters with its
        restored state; a fresh job draws from the sampler (reusing the
        grouping pass's signature draw when it was for this very
        (scenario, seed) job)."""
        if job.resume is not None:
            return job.resume["state"], dict(job.resume["params"])
        pre = self._predrawn.pop((id(job.scenario), job.seed), None)
        if pre is not None:
            return pre[0], dict(pre[1])
        return job.scenario.sample(job.seed)

    # -- the batch loop -----------------------------------------------------

    def run(self, on_finish=None):
        """Drain the queue. Returns ``{"results": [...], "evictions":
        [...], "preempted": [...], "pending": [...], "stats": {...}}``;
        ``on_finish(record, state)`` (if given) receives each retired
        member's host state — the one deliberate host sync, at retire
        time. With a ``preempt`` hook that fired, ``preempted`` holds
        one requeue record per still-active member (pass each to
        :meth:`requeue` to resume it later) and ``pending`` one record
        per job that never started: ``{"scenario", "seed"}``, plus the
        preserved resume payload (``state``/``step``/``t``/``params``)
        when the job was itself a requeued member — pass those back
        through :meth:`requeue`, the rest through :meth:`submit`.

        Raises :class:`~pystella_tpu_torch.obs.sentinel.SimulationDiverged`
        only when a batch exhausts its eviction budget (the
        configuration itself is broken)."""
        groups = self._group_jobs()
        _events.emit("ensemble_run", label=self.label, size=self.size,
                     chunk=self.chunk,
                     groups=[{"scenarios": sorted({j.scenario.name
                                                   for j in g["jobs"]}),
                              "jobs": len(g["jobs"])} for g in groups])
        results, evictions, preempted, pending = [], [], [], []
        totals = {"member_steps": 0, "wall_s": 0.0, "chunks": 0,
                  "occupancy_sum": 0.0, "batches": len(groups)}
        for gi, g in enumerate(groups):
            drained = self._run_group(g, results, evictions, totals,
                                      on_finish, preempted, pending)
            if drained:
                # the preempt hook fired: later groups never start —
                # their jobs leave as pending, resubmittable as-is
                # (the drained group's own unstarted jobs were already
                # recorded by the drain)
                pending += [self._pending_record(j)
                            for rest in groups[gi + 1:]
                            for j in rest["jobs"]]
                break
        rate = (totals["member_steps"] / totals["wall_s"]
                if totals["wall_s"] > 0 else None)
        occupancy = (totals["occupancy_sum"] / totals["chunks"]
                     if totals["chunks"] else None)
        stats = {
            "size": self.size,
            "batches": totals["batches"],
            "chunks": totals["chunks"],
            "member_steps": totals["member_steps"],
            "wall_s": totals["wall_s"],
            "member_steps_per_s": rate,
            "occupancy_mean": occupancy,
            "members_completed": len(results),
            "evictions": len(evictions),
            "preempted": len(preempted),
        }
        _events.emit("ensemble_done", label=self.label, **stats)
        return {"results": results, "evictions": evictions,
                "preempted": preempted, "pending": pending,
                "stats": stats}

    def _make_monitor(self, sentinel):
        return EnsembleMonitor(
            sentinel, self.size, every=self.every, history=self.history,
            max_abs=self.max_abs, invariant_bounds=self.invariant_bounds,
            emit_steps=self.emit_steps, label=self.label,
            forensics=self.forensics, max_evictions=self.max_evictions)

    def _run_group(self, group, results, evictions, totals, on_finish,
                   preempted=None, pending=None):
        jobs = list(group["jobs"])
        template_state, template_params = group["template"]
        stepper = jobs[0].scenario.stepper
        ens = EnsembleStepper(stepper, self.size, decomp=self.decomp,
                              via=self.via, donate=self.donate,
                              device=self.device)
        sentinel = Sentinel.for_state(
            template_state, invariants=jobs[0].scenario.invariants)
        monitor = self._make_monitor(sentinel)

        # initial fill: one sampled member per slot; spare slots carry
        # the template state as masked ballast (the batch shape is
        # fixed for the group's lifetime)
        slots = [_Slot(i) for i in range(self.size)]
        param_names = tuple(sorted(template_params))
        params = {n: np.zeros(self.size, dtype=np.float64)
                  for n in param_names}
        member_states = []
        t_vec = np.zeros(self.size)
        dt_vec = np.zeros(self.size)
        for slot in slots:
            if jobs:
                job = jobs.pop(0)
                state, draw = self._sample(job)
                self._arm(slot, job, draw, params, monitor)
                member_states.append(state)
                t_vec[slot.index] = slot.t
                dt_vec[slot.index] = slot.dt
            else:
                member_states.append(template_state)
                monitor.mask_member(slot.index)
                dt_vec[slot.index] = 1.0  # ballast: any finite dt
        batch = ens.stack(member_states)

        chunk_index = 0
        group_t0 = time.perf_counter()
        while any(s.active for s in slots):
            active = sum(s.active for s in slots)
            t_wall = time.perf_counter()
            batch, matrix = ens.multi_step(
                batch, self.chunk, t=t_vec, dt=dt_vec,
                rhs_args={n: params[n] for n in param_names},
                sentinel=sentinel)
            chunk_index += 1
            monitor.push(chunk_index, matrix)
            new_ev = monitor.poll()
            # dispatch-window time: CUDA launches are asynchronous, so
            # this measures host time until the poll's matrix converts
            # (>= `every` chunks behind), NOT this chunk's compute —
            # per-chunk events carry it as a dispatch-interval
            # distribution; throughput comes from the group wall clock
            # below, which the end-of-group sync closes honestly
            ms = (time.perf_counter() - t_wall) * 1e3
            t_vec += self.chunk * dt_vec
            for s in slots:
                if s.active:
                    s.steps_done += self.chunk
            totals["member_steps"] += self.chunk * active
            totals["chunks"] += 1
            totals["occupancy_sum"] += active / self.size
            _metrics.counter("ensemble_member_steps").inc(
                self.chunk * active)
            _events.emit("ensemble_chunk", step=chunk_index,
                         label=self.label, ms=ms, active=active,
                         size=self.size,
                         member_steps=self.chunk * active)
            batch = self._handle_evictions(
                new_ev, slots, batch, ens, params, t_vec, dt_vec,
                monitor, chunk_index, evictions)
            batch = self._retire_and_refill(
                slots, jobs, batch, ens, params, t_vec, dt_vec, monitor,
                chunk_index, results, on_finish, evictions)
            if (self.preempt is not None
                    and any(s.active for s in slots)
                    and self.preempt(chunk_index)):
                self._drain(slots, jobs, batch, ens, params, t_vec,
                            monitor, chunk_index, evictions,
                            preempted if preempted is not None else [],
                            pending if pending is not None else [])
                drained = True
                break
        else:
            drained = False
        # end of group: convert matrices still inside the maturity lag;
        # late trips are honest evictions (recorded, slot already done)
        late = monitor.flush()
        batch = self._handle_evictions(
            late, slots, batch, ens, params, t_vec, dt_vec, monitor,
            chunk_index, evictions)
        # block on the final state before closing the clock: the last
        # chunk's compute may still be in flight (the driver provably
        # runs ahead of the async health path), and member-steps/s
        # must not exclude it — this is the group's one deliberate
        # full sync, at its natural end
        _block_until_ready(batch)
        totals["wall_s"] += time.perf_counter() - group_t0
        return drained

    def _drain(self, slots, jobs, batch, ens, params, t_vec, monitor,
               chunk_index, evictions, preempted, pending):
        """Preemption drain at a chunk boundary: convert the health
        matrices still inside the maturity lag (a trip found here is an
        honest eviction — a diverged trajectory must not be requeued as
        good work), sync the batch, and capture every still-active
        member as a requeue record. No work is lost: the captured state
        is exactly the trajectory at ``steps_done`` steps, and
        :meth:`requeue` re-enters it bit-consistently."""
        late = monitor.flush()
        for ev in late:
            evictions.append(ev)
            s = slots[ev.member]
            if s.active:
                # evicted at the drain: its trajectory is poisoned —
                # record the eviction (done by the monitor) and do NOT
                # requeue it; the drain never resamples (the batch is
                # stopping, a fresh draw would be immediately drained
                # at step 0)
                s.active = False
                monitor.mask_member(s.index)
        _block_until_ready(batch)
        for s in slots:
            if not s.active:
                continue
            rec = {
                "scenario": s.job.scenario,
                "seed": s.job.seed,
                "state": ens.take_member(batch, s.index),
                "step": s.steps_done,
                "t": float(t_vec[s.index]),
                "params": {n: float(params[n][s.index])
                           for n in params},
            }
            preempted.append(rec)
            rec["trace"] = s.job.trace
            with _events.tracing(trace=s.job.trace):
                _events.emit("member_preempted", label=self.label,
                             member=s.index,
                             scenario=s.job.scenario.name,
                             seed=s.job.seed, step=s.steps_done)
            s.active = False
            monitor.mask_member(s.index)
        pending += [self._pending_record(j) for j in jobs]
        del jobs[:]

    @staticmethod
    def _pending_record(job):
        """An unstarted job as a resubmittable record. A job that was
        itself REQUEUED (it carries a restored trajectory) keeps its
        resume payload — dropping it would silently restart the member
        from step 0, losing the work the earlier drain preserved;
        resubmit such a record with :meth:`requeue`, plain ones with
        :meth:`submit`. The job's trace id rides along (pass it back
        as ``trace=``) so an unstarted traced job keeps one trace
        across the drain, like the started members do."""
        rec = {"scenario": job.scenario, "seed": job.seed,
               "trace": job.trace}
        if job.resume is not None:
            rec.update(state=job.resume["state"],
                       step=job.resume["step"], t=job.resume["t"],
                       params=dict(job.resume["params"]))
        return rec

    def _arm(self, slot, job, draw, params, monitor):
        sc = job.scenario
        slot.job = job
        slot.steps_done = 0
        slot.t = sc.t0
        slot.dt = sc.member_dt(job.seed)
        if job.resume is not None:
            # a requeued member picks its trajectory back up where the
            # drain left it: step budget and clock both resume
            slot.steps_done = int(job.resume["step"])
            slot.t = (float(job.resume["t"])
                      if job.resume["t"] is not None
                      else sc.t0 + slot.steps_done * slot.dt)
        slot.active = True
        for n in params:
            params[n][slot.index] = float(draw.get(n, 0.0))
        monitor.set_member(slot.index,
                           params={**draw, "seed": job.seed,
                                   "dt": slot.dt},
                           scenario=sc.name)
        with _events.tracing(trace=job.trace):
            _events.emit("member_started", label=self.label,
                         member=slot.index, scenario=sc.name,
                         seed=job.seed,
                         resumed_from=(slot.steps_done
                                       if job.resume is not None
                                       else None))

    def _handle_evictions(self, new_ev, slots, batch, ens, params,
                          t_vec, dt_vec, monitor, chunk_index,
                          evictions):
        """Resample (or mask) every slot the monitor just evicted: one
        slot write, the rest of the batch untouched."""
        for ev in new_ev:
            evictions.append(ev)
            slot = slots[ev.member]
            if not slot.active:
                # tripped after retiring/masking (a matured matrix from
                # its final chunks) — recorded, nothing to refill
                continue
            job = slot.job
            if not self.resample:
                slot.active = False
                monitor.mask_member(slot.index)
                continue
            seed = self._fresh_seed(job.scenario)
            state, draw = job.scenario.sample(seed)
            batch = ens.write_member(batch, slot.index, state)
            self._arm(slot, _Job(job.scenario, seed), draw, params,
                      monitor)
            t_vec[slot.index] = slot.t
            dt_vec[slot.index] = slot.dt
            monitor.reset_member(slot.index, at_step=chunk_index,
                                 params={**draw, "seed": seed,
                                         "dt": slot.dt},
                                 scenario=job.scenario.name)
        return batch

    def _retire_and_refill(self, slots, jobs, batch, ens, params, t_vec,
                           dt_vec, monitor, chunk_index, results,
                           on_finish, evictions):
        for slot in slots:
            if not slot.active or slot.steps_done < slot.job.scenario.nsteps:
                continue
            # retire-time health check: the member's final chunks may
            # still be inside the maturity lag — a member that diverged
            # there must be evicted, not reported finished (retire is
            # the driver's one deliberate sync point, so forcing those
            # matrices to host here is within contract)
            ev = monitor.check_member_now(slot.index, chunk_index)
            if ev is not None:
                batch = self._handle_evictions(
                    [ev], slots, batch, ens, params, t_vec, dt_vec,
                    monitor, chunk_index, evictions)
                continue
            job = slot.job
            record = {
                "scenario": job.scenario.name,
                "seed": job.seed,
                "member": slot.index,
                "steps": slot.steps_done,
                "t_final": float(t_vec[slot.index]),
                "params": {n: float(params[n][slot.index])
                           for n in params},
            }
            results.append(record)
            _metrics.counter("ensemble_members_completed").inc()
            with _events.tracing(trace=job.trace):
                _events.emit("member_finished", label=self.label,
                             **record)
            if on_finish is not None:
                on_finish(record, ens.take_member(batch, slot.index))
            if jobs:
                nxt = jobs.pop(0)
                state, draw = self._sample(nxt)
                batch = ens.write_member(batch, slot.index, state)
                self._arm(slot, nxt, draw, params, monitor)
                t_vec[slot.index] = slot.t
                dt_vec[slot.index] = slot.dt
                monitor.reset_member(slot.index, at_step=chunk_index,
                                     params={**draw, "seed": nxt.seed,
                                             "dt": slot.dt},
                                     scenario=nxt.scenario.name)
            else:
                slot.active = False
                monitor.mask_member(slot.index)
        return batch
