"""The sharding plan on ``torch.distributed`` (the JAX package's
``repro.parallel``): the spec rules, the plan, the Sharder, and the kernel
boundary under a mesh (:mod:`repro_torch.parallel.local`).

The process model
-----------------
The JAX package runs one process that addresses every device of its mesh.
A DTensor program runs one process per rank, and each rank addresses only
its own device (``torchrun`` starts them: the launchers' ``init_from_env``,
NCCL on the card, gloo with ``--device cpu``).  So wherever the JAX package
loops over a sharding's ``addressable_devices_indices_map``, a rank of the
port handles its own index range (``Sharding.local_slices``, what
``distribute_tensor(..., src_data_rank=None)`` cuts), and every rank holds
the same host homes (the same weights, moments and checkpoint, each its own
copy of a disk home).  What the two count compares as follows:

* integers (H2D requests and bytes, ``n_devices`` where a group stages):
  the sum over the ranks is the JAX package's one-process count, exactly;
* per-(device, group) ratios (``requests_per_device_group``): each rank's
  own is the JAX package's;
* disk requests and bytes: each rank reads its own home, so each rank's is
  the JAX package's;
* D2H requests and bytes (writebacks, demoted pages): each rank gathers a
  DTensor group and drains its full host value into its own home, the JAX
  package's ``np.asarray`` of a sharded array, so each rank's is the JAX
  package's.

A host-kind placement under a mesh is the rank's local shard at that level
with its placement (``memkind.HostShard``), never a DTensor: only the
card's side makes DTensors.  A checkpoint holds full leaves (each DTensor
gathered), written by rank 0.  Started without ``torchrun`` and with
``--model-parallel 1`` the launchers open no process group and make no
DTensor: the one-device program, bit for bit.
"""
from repro_torch.parallel.sharding import (
    P,
    ShardingPlan,
    batch_spec,
    batch_specs,
    cache_specs_tree,
    make_plan,
    opt_state_specs,
    param_specs,
    placements,
)

__all__ = [
    "P",
    "ShardingPlan",
    "make_plan",
    "param_specs",
    "opt_state_specs",
    "batch_spec",
    "batch_specs",
    "cache_specs_tree",
    "placements",
]
