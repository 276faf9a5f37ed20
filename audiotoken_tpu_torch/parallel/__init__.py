"""The device mesh over ``torch.distributed``: the mesh, its collectives,
the sharding rules, and the hosts' share of a corpus."""

from .hosts import shard_files_for_host
from .mesh import make_mesh
from .shard import gpt_param_spec

__all__ = ["make_mesh", "shard_files_for_host", "gpt_param_spec"]
