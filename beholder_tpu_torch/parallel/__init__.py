"""The port's parallel stack: so far the ``sp`` mesh that ring attention
runs on and the serving cluster's worker placement
(:mod:`beholder_tpu_torch.parallel.mesh`)."""

from .mesh import Mesh, serving_shard_devices

__all__ = ["Mesh", "serving_shard_devices"]
