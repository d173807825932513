"""Ensemble engine: batched scenario populations instead of single runs.

PyTorch counterpart of ``pystella_tpu/ensemble``. Everything else in the
package drives ONE lattice per call; parameter scans and Monte-Carlo over
initial-condition seeds need a member axis. This subsystem adds it:

- :mod:`~pystella_tpu_torch.ensemble.batch`: :class:`EnsembleStepper`, the
  ``"map"`` tier (a loop over members through the stepper's chunk body,
  bit for bit a sequential run) and the ``"vmap"`` tier (``torch.func.vmap``
  of the member body, its hand-written operators batched by custom-operator
  rules: one launch per operator call for the whole batch), threading
  per-member parameters as batched leaves. The device side is
  :func:`~pystella_tpu_torch.parallel.ensemble_mesh`, ``(ensemble, x, y,
  z)``: small lattices pack the devices along the member axis, large ones
  keep their spatial sharding.
- :mod:`~pystella_tpu_torch.ensemble.driver`: :class:`EnsembleDriver` and
  :class:`Scenario`, a scenario-queue scheduler that groups heterogeneous
  work into shape-compatible batches, advances each chunk by chunk with the
  numerics sentinel's member matrix behind every chunk, and refills slots as
  members finish.
- :mod:`~pystella_tpu_torch.ensemble.health`: :class:`EnsembleMonitor`,
  per-member health matrices (one K15 read of each state leaf for the whole
  batch) with evict-and-resample: a diverged member is recorded (a
  ``member_evicted`` event and a member-scoped forensic bundle) and its slot
  resampled in place, without stopping the batch.
"""

from pystella_tpu_torch.ensemble.batch import EnsembleStepper, repack_members
from pystella_tpu_torch.ensemble.driver import EnsembleDriver, Scenario
from pystella_tpu_torch.ensemble.health import EnsembleMonitor, Eviction

__all__ = ["EnsembleStepper", "EnsembleDriver", "Scenario",
           "EnsembleMonitor", "Eviction", "repack_members"]
