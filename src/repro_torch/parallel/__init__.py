"""Device placement for sharded search (counterpart of ``repro.parallel``'s
placement module): a :class:`Mesh` of ``torch.device``\\ s built from a
``ShardSpec``, and the one per-shard placement seam."""

from repro_torch.parallel.placement import (Mesh, available_devices,
                                            device_grid, mesh_from_spec,
                                            place_shards)

__all__ = ["Mesh", "available_devices", "device_grid", "mesh_from_spec",
           "place_shards"]
