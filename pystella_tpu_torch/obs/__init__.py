"""Run telemetry of the port: run events, metrics, trace scopes, the
numerics sentinel and divergence forensics.

PyTorch counterpart of ``pystella_tpu/obs``, in the parts the science
driver's run safety needs, under the JAX package's names:

- :mod:`~pystella_tpu_torch.obs.events`: the structured JSONL run-event
  log (:func:`configure`, :func:`emit`, :func:`read_events` over a
  rotated family, :func:`tracing`, the registered kinds);
- :mod:`~pystella_tpu_torch.obs.metrics`: counters, gauges and timers
  (:func:`registry`, :meth:`~MetricsRegistry.snapshot`,
  :meth:`~MetricsRegistry.reduce_snapshots`);
- :mod:`~pystella_tpu_torch.obs.scope`: named regions on
  ``torch.profiler``'s timeline (:func:`trace_scope`, :func:`traced`);
- :mod:`~pystella_tpu_torch.obs.sentinel`: the per-step health vector
  (its field statistics by the kernel K15 on the card) and its
  asynchronous monitor;
- :mod:`~pystella_tpu_torch.obs.forensics`: the forensic bundle of a
  tripped sentinel;
- :func:`~pystella_tpu_torch.obs.ledger.environment_fingerprint`.

Not ported yet (ROADMAP queue 1 item 7): ``memory``, ``trace``, ``perf``,
``stragglers``, ``spans``, ``slo``, ``live``, ``fleet``, ``gate``,
``warmstart``, ``capacity`` and the rest of ``ledger``. The port's modules
leave out their calls into those and say so.
"""

from pystella_tpu_torch.obs.events import (
    EventLog, configure, current_trace, emit, get_log, new_span_id,
    new_trace_id, read_events, register_event_kind,
    registered_event_kinds, tracing)
from pystella_tpu_torch.obs.metrics import (
    Counter, Gauge, MetricsRegistry, Timer, counter, gauge, registry, timer)
from pystella_tpu_torch.obs.scope import (
    register_scope, registered_scopes, trace_scope, traced)
from pystella_tpu_torch.obs import (
    events, forensics, ledger, metrics, scope, sentinel)
from pystella_tpu_torch.obs.ledger import environment_fingerprint
from pystella_tpu_torch.obs.sentinel import (
    Sentinel, SentinelMonitor, SimulationDiverged)
from pystella_tpu_torch.obs.forensics import (
    ForensicSink, load_bundle, write_bundle)

__all__ = [
    "EventLog", "configure", "current_trace", "emit", "get_log",
    "new_span_id", "new_trace_id", "read_events",
    "register_event_kind", "registered_event_kinds", "tracing",
    "Counter", "Gauge", "Timer", "MetricsRegistry",
    "counter", "gauge", "timer", "registry",
    "trace_scope", "traced", "register_scope", "registered_scopes",
    "events", "metrics", "scope", "ledger", "sentinel", "forensics",
    "environment_fingerprint",
    "Sentinel", "SentinelMonitor", "SimulationDiverged",
    "ForensicSink", "load_bundle", "write_bundle",
]
