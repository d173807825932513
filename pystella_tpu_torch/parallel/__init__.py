"""Domain decomposition of the port: one process drives every shard."""

from pystella_tpu_torch.parallel.decomp import (
    DomainDecomposition, HaloShells, ShardedArray, blockwise,
)

__all__ = ["DomainDecomposition", "HaloShells", "ShardedArray", "blockwise"]
