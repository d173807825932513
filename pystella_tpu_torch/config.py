"""The port's environment-variable registry.

The pattern of ``pystella_tpu/config.py``, copied rather than loaded: every
``PYSTELLA_*`` knob the port reads is declared here with its default and a
one-line description, and read through :func:`getenv` or :func:`get_int`.
Reads are live (no caching at import), so a variable set between two
stepper builds in one process takes effect at the second.

Registered so far: ``PYSTELLA_CHUNK_STAGES`` (the JAX package's autotune
table, which may also set the chunk depth there, is not ported) and
``PYSTELLA_HALO_OVERLAP`` (:mod:`~pystella_tpu_torch.parallel.overlap`).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["EnvVar", "register", "getenv", "get_int"]


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
