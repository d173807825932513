"""The port's utilities: the HDF5 run output, checkpoint / resume, the
health monitor and the profiling helpers (the JAX package's
``ShardedSnapshot`` and ``advise_shapes`` wait for ROADMAP queue 1 item 6).
"""

from pystella_tpu_torch.utils.checkpoint import Checkpointer
from pystella_tpu_torch.utils.monitor import HealthMonitor, SimulationDiverged
from pystella_tpu_torch.utils.output import OutputFile
from pystella_tpu_torch.utils.profiling import StepTimer, timer, trace

__all__ = ["Checkpointer", "HealthMonitor", "SimulationDiverged",
           "OutputFile", "StepTimer", "timer", "trace"]
