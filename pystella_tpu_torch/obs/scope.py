"""Named trace scopes for hot paths, plus the central scope registry.

PyTorch counterpart of ``pystella_tpu/obs/scope.py``. :func:`trace_scope`
marks a region with ``torch.profiler.record_function``, so a
``torch.profiler`` trace (Perfetto / TensorBoard) shows
``sentinel`` / ``driver_step`` / ``fused_rk_stage_pair`` regions on the
host timeline, with the kernels they launched beneath them. It costs about
a microsecond when no profiler is attached (the JAX package's
``jax.named_scope`` + ``jax.profiler.TraceAnnotation``; torch has no
compiled-code name scopes, so the host annotation is the one sink).

**Registry.** Every scope name is registered here (:func:`register_scope`)
with the JAX package's vocabulary, so that traces of the two packages fold
under the same names. ``lowered_scopes`` and ``has_scope`` read the scope
paths out of lowered StableHLO; the port compiles no StableHLO, and their
counterpart over what it does compile (torch.fx graphs and the kernel
sources) waits for the lint tier (ROADMAP queue 1 item 10).

torch is imported inside the functions, so this module stays loadable by
file without it, like ``obs/events.py``.
"""

from __future__ import annotations

import contextlib
import functools

__all__ = ["trace_scope", "traced", "register_scope", "registered_scopes"]


#: the central scope-name registry (see module docstring); seeded below
#: with the JAX package's vocabulary
_SCOPE_REGISTRY = set()


def register_scope(name):
    """Register a scope name (idempotent; returns ``name``). Call this
    for any new ``trace_scope`` literal."""
    _SCOPE_REGISTRY.add(str(name))
    return name


def registered_scopes():
    """The registered scope names, as a frozenset."""
    return frozenset(_SCOPE_REGISTRY)


for _name in (
    # generic stepper stages (rk_stage0..N fold into this at parse time)
    "rk_stage",
    # fused Pallas steppers
    "fused_rk_stage", "fused_rk_stage_pair", "fused_rk_stage_energy",
    "fused_coupled_pair",
    # halo exchange: padded path and the overlapped interior/shell split
    "halo_exchange",
    "halo_overlap", "halo_overlap_interior", "halo_overlap_shells",
    # the raw XLA ppermute op rows — device traces carry them with no
    # named-scope path; the ledger's communication-time denominator
    "collective-permute",
    # Pallas kernel dispatch
    "pallas_stencil", "pallas_resident_stencil",
    # the whole-RK-chunk (temporal blocking) kernel dispatch and the
    # persistent autotuner's timed candidate probes (ops.autotune)
    "chunk_stage", "autotune_probe",
    # the sanctioned carry_dtype quantization point (ops.fused): the one
    # scope under which an f32->bf16 narrowing is legal; the dataflow
    # lint tier treats any float downcast OUTSIDE this scope as a
    # POLICY_BF16_ACC32 violation
    "carry_quantize",
    # multigrid
    "mg_cycle", "mg_smooth", "mg_residual",
    # driver-level spans (bench smoke / example loops)
    "bench_step", "driver_step",
    # the in-graph numerics health vector (obs.sentinel)
    "sentinel",
    # the ensemble tier (pystella_tpu.ensemble): the batched member
    # step and the in-graph evict/resample slot write
    "ensemble_step", "ensemble_evict",
    # the elastic runtime (pystella_tpu.resilience): each step taken
    # under Supervisor control — replayed spans after a recovery show
    # up as a second pass over the same step numbers in a trace
    "supervised_step",
    # the sharded pencil-FFT tier (fourier.pencil): per-axis local FFT
    # stages and the all_to_all transposes between them — the ledger's
    # `fft` section derives its exposed-vs-hidden transpose split from
    # these two rows, like the halo rows above
    "fft_stage", "fft_transpose",
    # the RAW XLA op rows of the same two phases — device traces (TPU
    # and the TFRT CPU backend) carry `all-to-all.N` / `fft.N` op rows
    # with no named-scope path; the ledger falls back to them when the
    # scope-path rows are absent (longest-match folding keeps a
    # TPU row like `jit(..)/fft_stage/fft.3` in `fft_stage`, not here)
    "all-to-all", "fft",
    # k-space stencil application through the transform
    # (ops.fft_stencil)
    "fft_stencil",
    # the scenario service's request-scoped span vocabulary
    # (obs.spans): the SpanAssembler exports assembled request
    # timelines as Perfetto complete-span rows under THESE names, so
    # hardware profiler captures and service traces fold through one
    # parser (obs.trace.scope_durations) — the critical-path phases...
    "service_queue_wait", "service_admission", "service_compile",
    "service_chunk_compute", "service_checkpoint_barrier",
    "service_recovery_replay", "service_preempt_drain",
    # ...plus the structural spans they hang off
    "service_request_span", "service_lease_span",
):
    register_scope(_name)
del _name


@contextlib.contextmanager
def trace_scope(name):
    """Name everything inside on the profiler's host timeline
    (``torch.profiler.record_function``)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


def traced(name=None):
    """Decorator form of :func:`trace_scope` (defaults to the function's
    ``__name__``)."""
    def wrap(fn):
        scope_name = name if name is not None else fn.__name__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with trace_scope(scope_name):
                return fn(*args, **kwargs)
        return inner
    return wrap
