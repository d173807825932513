"""Domain decomposition of the port: one process drives every shard."""

from pystella_tpu_torch.parallel.decomp import (
    DomainDecomposition, HaloShells, MemberArray, Mesh, NamedSharding,
    ShardedArray, blockwise, ensemble_mesh, make_mesh,
)

__all__ = ["DomainDecomposition", "HaloShells", "MemberArray", "Mesh",
           "NamedSharding", "ShardedArray", "blockwise", "ensemble_mesh",
           "make_mesh"]
