"""Divergence forensics: everything needed to diagnose a tripped run.

PyTorch counterpart of ``pystella_tpu/obs/forensics.py``, with the same
bundle schema. When the numerics sentinel trips
(:mod:`pystella_tpu_torch.obs.sentinel`), the bare ``SimulationDiverged``
traceback answers *that* a field went bad, not *why* or *since when*. The
forensic bundle is the record that does: one JSON file holding

- the trip itself: step, reason, offending fields, and (when an
  invariant bound tripped) the offending invariant by name;
- the last-K health vectors from the monitor's ring buffer, plus a
  pivoted per-field ``max_abs``/``rms`` history (the blowup curve);
- the tail of the run-event log;
- the active configuration and environment fingerprint (torch and CUDA
  versions, device name and count, ``PYSTELLA_*`` env;
  :func:`~pystella_tpu_torch.obs.ledger.environment_fingerprint`);
- a pointer to the last good checkpoint
  (:class:`~pystella_tpu_torch.Checkpointer` directory + step). "Good"
  means **durable**: the pointer only ever names steps past the
  checkpointer's durability barrier, never a write that was merely
  scheduled when the run died.

:func:`write_bundle` / :func:`load_bundle` round-trip the schema;
:class:`ForensicSink` is the configured writer a
:class:`~pystella_tpu_torch.obs.sentinel.SentinelMonitor` calls on a trip,
best-effort by contract (a failed bundle write must never mask the
``SimulationDiverged`` that triggered it).
"""

from __future__ import annotations

import json
import os
import sys
import time

from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import ledger as _ledger

__all__ = ["BUNDLE_SCHEMA_VERSION", "ForensicSink", "load_bundle",
           "write_bundle"]

BUNDLE_SCHEMA_VERSION = 1

#: env-var name prefixes captured into the bundle's environment record
_ENV_PREFIXES = ("PYSTELLA_", "CUDA_", "TORCH_", "PYTORCH_")


def _jsonify(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonify(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) in (None, 0):
        try:
            return _jsonify(obj.item())
        except Exception:
            pass
    return str(obj)


def _checkpoint_pointer(checkpoint):
    """Resolve the last-good-checkpoint pointer: a
    :class:`~pystella_tpu_torch.Checkpointer` (via its ``last_good``
    property — durable steps only, so a trip racing an in-flight
    write can never embed a torn checkpoint), an explicit
    ``{"directory", "step"}`` dict, or ``None``."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, dict):
        return _jsonify(checkpoint)
    last_good = getattr(checkpoint, "last_good", None)
    return _jsonify(last_good)


def _field_history(history):
    """Pivot the monitor's ring buffer into per-field stat series:
    ``{field: {"steps": [...], "max_abs": [...], "rms": [...]}}`` —
    the blowup curve, directly plottable."""
    out = {}
    for rec in history:
        step = rec.get("step")
        for name, st in (rec.get("fields") or {}).items():
            row = out.setdefault(
                name, {"steps": [], "max_abs": [], "rms": []})
            row["steps"].append(step)
            row["max_abs"].append(st.get("max_abs"))
            row["rms"].append(st.get("rms"))
    return out


def write_bundle(out_dir, step, reason, bad_fields=(),
                 offending_invariant=None, history=(), events_path=None,
                 events_window=200, checkpoint=None, config=None,
                 label="", member=None, member_params=None):
    """Write one forensic bundle; returns the JSON path. Also emits a
    ``forensic_bundle`` run event pointing at it, so the event log's
    forensic tail (``diverged`` -> ``forensic_bundle`` ->
    ``run_aborted``) links to the full record.

    For an ensemble trip (:class:`~pystella_tpu_torch.ensemble.
    EnsembleMonitor`) the bundle is PER MEMBER:
    ``member`` is the slot index of the diverged member and
    ``member_params`` its parameter draw (couplings, dt, seed), so the
    record names the bad scenario instead of dumping the whole batch —
    ``history`` should then already be the member's own health series."""
    events_tail = []
    if events_path:
        events_tail = _events.read_events(events_path)[-int(events_window):]
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(_ENV_PREFIXES)}
    bundle = {
        "schema": BUNDLE_SCHEMA_VERSION,
        "generated_ts": time.time(),
        "label": label,
        "trip": {
            "step": int(step),
            "reason": str(reason),
            "bad_fields": [str(f) for f in bad_fields],
            "offending_invariant": offending_invariant,
            "member": None if member is None else int(member),
            "member_params": _jsonify(member_params)
            if member_params is not None else None,
        },
        "health_history": _jsonify(list(history)),
        "field_history": _jsonify(_field_history(history)),
        "events_tail": events_tail,
        "env": _ledger.environment_fingerprint(),
        "env_vars": env,
        "config": _jsonify(config) if config is not None else None,
        "last_good_checkpoint": _checkpoint_pointer(checkpoint),
    }
    os.makedirs(out_dir, exist_ok=True)
    stem = (f"forensic_bundle_step{int(step)}" if member is None else
            f"forensic_bundle_step{int(step)}_member{int(member)}")
    path = os.path.join(out_dir, stem + ".json")
    with open(path, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
        f.write("\n")
    _events.emit("forensic_bundle", step=step, path=path,
                 reason=str(reason), bad_fields=list(bad_fields),
                 offending_invariant=offending_invariant, label=label,
                 member=None if member is None else int(member))
    return path


def load_bundle(path):
    """Parse a forensic bundle back; raises ``ValueError`` on files
    that are not bundles (so a wrong path fails loudly, not as an
    empty-looking record)."""
    with open(path) as f:
        bundle = json.load(f)
    if not isinstance(bundle, dict) or "trip" not in bundle:
        raise ValueError(f"{path}: not a forensic bundle (no 'trip')")
    return bundle


class ForensicSink:
    """Configured bundle writer for a
    :class:`~pystella_tpu_torch.obs.sentinel.SentinelMonitor`.

    :arg out_dir: bundle directory (created on first write).
    :arg events_path: the run's JSONL event log; its tail is embedded.
    :arg checkpoint: a :class:`~pystella_tpu_torch.Checkpointer` (queried for
        its last good step AT TRIP TIME) or a ``{"directory", "step"}``
        dict.
    :arg config: the run configuration (e.g. the parsed CLI namespace's
        ``vars()``), JSON-coerced best-effort.

    ``write`` never raises: forensics must not mask the
    ``SimulationDiverged`` being raised around it — a failed write
    degrades to a ``forensic_failed`` event plus a stderr line.
    """

    def __init__(self, out_dir, events_path=None, events_window=200,
                 checkpoint=None, config=None, label=""):
        self.out_dir = str(out_dir)
        self.events_path = events_path
        self.events_window = int(events_window)
        self.checkpoint = checkpoint
        self.config = config
        self.label = label
        #: path of the last bundle written (None until a trip)
        self.last_bundle = None

    def write(self, step, reason, bad_fields=(),
              offending_invariant=None, history=(), member=None,
              member_params=None):
        try:
            self.last_bundle = write_bundle(
                self.out_dir, step, reason, bad_fields=bad_fields,
                offending_invariant=offending_invariant, history=history,
                events_path=self.events_path,
                events_window=self.events_window,
                checkpoint=self.checkpoint, config=self.config,
                label=self.label, member=member,
                member_params=member_params)
            return self.last_bundle
        except Exception as e:
            _events.emit("forensic_failed", step=step,
                         error=f"{type(e).__name__}: {e}")
            print(f"pystella_tpu_torch.obs.forensics: bundle write failed "
                  f"({e}); the diverged event still holds the trip "
                  "record", file=sys.stderr)
            return None
