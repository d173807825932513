"""Communication/computation overlap policy for sharded stencil updates.

PyTorch counterpart of the policy half of ``pystella_tpu/parallel/overlap.py``.
A sharded stencil update either waits for its whole halo exchange and then
runs once on the padded block (the padded path), or it is split: the
*interior* (the block inset by the stencil radius along the communicated
axis) needs no neighbour data and runs while the exchange copies are in
flight; the two boundary *shells* run once the halos have landed. The two
paths are bit-exact, so the choice is pure scheduling.

- :func:`enabled` resolves whether a mesh takes the overlapped path:
  per-call/constructor override > ``PYSTELLA_HALO_OVERLAP`` (``1``/``0``/
  ``auto``) > auto (on for meshes that shard a lattice axis).
- :data:`MIN_INTERIOR_FACTOR` bounds the thinnest block that still has an
  interior to hide the exchange behind.

The mechanism lives in
:meth:`~pystella_tpu_torch.parallel.decomp.DomainDecomposition.overlap_stencil`
and in the interior and shell launches of the sharded fused steppers and
``FiniteDifferencer``, where the exchange copies run on a side CUDA stream
ordered by events. The JAX package's libtpu scheduler flags
(``SCHEDULER_FLAGS``, ``ensure_scheduler_flags``, ``flags_fingerprint``)
have no counterpart here: on the card the streams and events are the
schedule.
"""

from __future__ import annotations

import logging

from pystella_tpu_torch import config as _config

logger = logging.getLogger(__name__)

__all__ = ["enabled", "env_setting", "MIN_INTERIOR_FACTOR"]

#: a block must span at least ``MIN_INTERIOR_FACTOR * h`` sites along a
#: communicated axis for the interior/shell split to leave a non-empty
#: interior worth hiding the transfer behind (two h-deep shells + at least
#: h interior rows); thinner blocks take the padded path.
MIN_INTERIOR_FACTOR = 3


def env_setting():
    """The raw ``PYSTELLA_HALO_OVERLAP`` setting: ``True``/``False`` for
    an explicit 1/0, ``None`` for unset/auto."""
    val = _config.getenv("PYSTELLA_HALO_OVERLAP").strip().lower()
    if val in ("1", "true", "on", "yes"):
        return True
    if val in ("0", "false", "off", "no"):
        return False
    if val not in ("", "auto"):
        logger.warning("PYSTELLA_HALO_OVERLAP=%r not understood; "
                       "treating as 'auto'", val)
    return None


def enabled(decomp=None, override=None):
    """Should stencil consumers on ``decomp``'s mesh take the overlapped
    halo path? Resolution order: explicit per-call/constructor
    ``override`` > ``PYSTELLA_HALO_OVERLAP`` env > auto (on exactly when
    the mesh shards at least one lattice axis -- there is nothing to
    overlap on a single-rank mesh)."""
    if override is not None:
        return bool(override)
    env = env_setting()
    if env is not None:
        return env
    if decomp is None:
        return False
    return any(p > 1 for p in decomp.proc_shape)
