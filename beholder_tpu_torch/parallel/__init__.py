"""The port's parallel stack: so far the ``sp`` mesh that ring attention
runs on, the serving cluster's worker placement and the megatron split a
decode group keeps its weights in (:mod:`beholder_tpu_torch.parallel.mesh`)."""

from .mesh import Mesh, seq_param_slices, seq_params_from_slices, serving_shard_devices

__all__ = ["Mesh", "seq_param_slices", "seq_params_from_slices", "serving_shard_devices"]
