"""Distribution utilities: logical-axis sharding rules, compressed
collectives, and spec-driven mesh placement (counterpart of
``repro.parallel``): a :class:`Mesh` of ``torch.device``\\ s built from a
``ShardSpec``, the one per-shard placement seam, and the rule tables that
turn logical axes into :class:`PartitionSpec`\\ s."""

from repro_torch.parallel.placement import (Mesh, available_devices,
                                            device_grid, mesh_from_spec,
                                            place_shards)
from repro_torch.parallel.sharding import (AxisRules, MULTI_POD_RULES,
                                           SINGLE_POD_RULES, PartitionSpec,
                                           ShardingContext, logical_to_spec,
                                           shard, shard_constraint,
                                           spec_for_shape)

__all__ = ["AxisRules", "MULTI_POD_RULES", "Mesh", "PartitionSpec",
           "SINGLE_POD_RULES", "ShardingContext", "available_devices",
           "device_grid", "logical_to_spec", "mesh_from_spec",
           "place_shards", "shard", "shard_constraint", "spec_for_shape"]
