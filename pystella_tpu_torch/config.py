"""The port's environment-variable registry.

The pattern of ``pystella_tpu/config.py``, copied rather than loaded: every
``PYSTELLA_*`` knob the port reads is declared here with its default and a
one-line description, and read through :func:`getenv`, :func:`get_int` or
:func:`get_float`.
Reads are live (no caching at import), so a variable set between two
stepper builds in one process takes effect at the second.

Registered so far: ``PYSTELLA_EVENT_LOG`` and ``PYSTELLA_EVENT_ROTATE_MB``
(:mod:`~pystella_tpu_torch.obs.events`, which reads them with
``os.environ`` as the JAX module does, so that it stays loadable by file),
``PYSTELLA_CHUNK_STAGES`` (the JAX package's autotune
table, which may also set the chunk depth there, is not ported),
``PYSTELLA_HALO_OVERLAP`` (:mod:`~pystella_tpu_torch.parallel.overlap`),
``PYSTELLA_FFT_SCHEME`` (:mod:`~pystella_tpu_torch.fourier.plan`),
``PYSTELLA_FFT_STENCIL`` and ``PYSTELLA_FFT_STENCIL_CROSSOVER``
(:mod:`~pystella_tpu_torch.ops.fft_stencil`). The JAX package's
``PYSTELLA_FFT_REPLICATE_LIMIT`` is not registered: the port's only
distributed transform gathers to one device (:class:`~pystella_tpu_torch.DFT`),
so there is no replicate tier to limit.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["EnvVar", "register", "getenv", "get_int", "get_float"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One registered environment variable."""

    name: str
    default: str | None
    help: str


#: name -> EnvVar, in registration order
_REGISTRY: dict[str, EnvVar] = {}


def register(name, default=None, help=""):
    """Register a variable (idempotent for an identical declaration);
    returns ``name``. A conflicting re-registration raises."""
    var = EnvVar(name=str(name), default=default, help=help)
    existing = _REGISTRY.get(var.name)
    if existing is not None and existing != var:
        raise ValueError(
            f"env var {name!r} already registered with a different "
            f"declaration: {existing} vs {var}")
    _REGISTRY[var.name] = var
    return var.name


def getenv(name):
    """The raw string value of a registered variable (its registered
    default when unset). Reading an unregistered name raises
    ``KeyError``."""
    var = _REGISTRY.get(name)
    if var is None:
        raise KeyError(f"env var {name!r} is not registered in "
                       "pystella_tpu_torch.config")
    val = os.environ.get(name)
    return var.default if val is None else val


def get_int(name):
    """A registered variable as an integer (``None`` when it is unset and
    has no default)."""
    val = getenv(name)
    return None if val is None else int(float(val))


def get_float(name):
    """A registered variable as a float (``None`` when it is unset and
    has no default)."""
    val = getenv(name)
    return None if val is None else float(val)


register("PYSTELLA_EVENT_LOG", default=None,
         help="JSONL run-event log path picked up by obs.events.get_log() "
              "when no explicit obs.configure() call was made; unset "
              "disables implicit event logging")
register("PYSTELLA_EVENT_ROTATE_MB", default=None,
         help="size-triggered event-log rollover in MiB: when the live "
              "JSONL file reaches this size, obs.events.EventLog "
              "renames it to <stem>.<n>.jsonl and opens a fresh file, "
              "so a persistent server cannot grow one unbounded log; "
              "ledger ingestion reads the whole rotated family; unset "
              "disables rotation")
register("PYSTELLA_CHUNK_STAGES", default="0",
         help="default whole-RK-chunk depth of FusedScalarStepper when no "
              "chunk_stages= argument decides it: an even number >= 4 of "
              "RK stages advanced per kernel launch (K10); a depth or model "
              "the kernel cannot take degrades to the pair kernels with a "
              "warning; 0 (default) keeps the pair tier")
register("PYSTELLA_HALO_OVERLAP", default="auto",
         help="halo-exchange/compute overlap policy for sharded stencils: "
              "1/0 force on/off, unset/'auto' enables exactly when the "
              "mesh shards a lattice axis (parallel.overlap.enabled)")
register("PYSTELLA_FFT_SCHEME", default="auto",
         help="distributed-FFT scheme the planner (fourier.plan."
              "make_dft) and the spectra/projector/Poisson consumers "
              "select: 'auto' (the shard_map pencil tier whenever the "
              "grid x/y axes divide the total device count, else the "
              "DFT reshard/partial/replicate chain), 'pencil' (force "
              "the shard_map tier; infeasible shapes raise), or 'dft' "
              "(force the legacy declarative-reshard tiering). In the "
              "port every scheme but 'pencil' is the DFT's gather tier, "
              "and 'pencil' raises NotImplementedError (not ported)")
register("PYSTELLA_FFT_STENCIL", default="auto",
         help="FFT-stencil fast-path policy (ops.fft_stencil."
              "use_fft_stencil): 1/0 force the k-space/direct path, "
              "unset/'auto' decides by the flops crossover model "
              "(direct tap cost vs 2 x 5 N log2 N transform cost)")
register("PYSTELLA_FFT_STENCIL_CROSSOVER", default="1.5",
         help="direct-to-FFT flops ratio the auto FFT-stencil policy "
              "requires before taking the k-space path (margin for the "
              "transpose traffic the flops model does not see)")
