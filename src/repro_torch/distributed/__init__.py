"""Multi-device placement, counterpart of ``repro.distributed``.

* `distributed.sharding`: the slot-axis helpers of the mesh serving
  backend, and the LM stack's logical-axis rules (`MeshRules`,
  `default_rules`) with the process-global mesh context
  (`set_mesh_rules`, `current_mesh`, `logical`);
* `distributed.mesh`: `Mesh`, named axes over a row-major grid of devices
  (repeats allowed);
* `distributed.collectives`: `split` / `join` and JAX's tiled collectives
  over lists of per-shard tensors, which the LM stack's sharded paths
  (the expert-parallel MoE, sharded sigma-delta decode, flash-decode
  combine) run on;
* `distributed.compression`: int8 gradient compression with error
  feedback, and the int8 all-reduce `int8_psum`.
"""
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (MeshRules, PartitionSpec,
                                              clear_mesh_rules,
                                              current_mesh, default_rules,
                                              logical, set_mesh_rules,
                                              shard_count, slot_mesh,
                                              visible_cards)

__all__ = ["Mesh", "MeshRules", "PartitionSpec", "clear_mesh_rules",
           "current_mesh", "default_rules", "logical", "set_mesh_rules",
           "shard_count", "slot_mesh", "visible_cards"]
