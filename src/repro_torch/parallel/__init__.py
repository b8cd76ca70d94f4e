from .sharding import (LOGICAL_RULES, MeshPolicy, PartitionSpec,
                       logical_to_pspec, mesh_shape, named_shardings,
                       param_pspecs, shard_constraint)
