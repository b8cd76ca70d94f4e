from .sharding import MeshPolicy, shard_constraint
