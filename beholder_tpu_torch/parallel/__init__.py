"""The port's parallel stack: a mesh with named axes (``dp``, ``tp``,
``sp``, ``ep``), the sharding rules over ``state_dict`` names, explicit
differentiable collectives over member tensors, and the sharded training
steps built on them (dp x tp for the anomaly MLP; dp x tp x sp megatron with
ring or Ulysses attention and ``seq_shard`` for the transformer; dp x ep for
its MoE; ZeRO-2/3), pipeline parallelism over a ``pp`` axis (GPipe, 1F1B,
dp x pp, tp inside the stages), and the serving cluster's worker placement;
and the multi-process runtime's entry (:func:`initialize`, a
``torch.distributed`` process group) with the hybrid ``(dp, tp)`` mesh
(:func:`make_hybrid_mesh`), which spans every process of the group: ``dp``
across processes, ``tp`` inside each. One process drives every member it
holds; on a mesh over processes every path runs (the sharded steps, ZeRO,
MoE, the pipelines, sharded serving, ring and Ulysses attention), each
process computing its own members, the collectives of a group split
between processes moving bytes and folding sums in member order
(:func:`along`, :func:`process_gather`), bitwise the one-process mesh."""

from .collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    along,
    gather_from_members,
    process_gather,
    reduce_scatter,
    ring_shift,
    scatter_to_members,
    tp_all_reduce,
    tp_replicate,
)
from .distributed import initialize, make_hybrid_mesh, process_count, process_index
from .mesh import (
    Mesh,
    ShardedState,
    gather_state,
    group_mesh,
    make_mesh,
    param_shardings,
    place_seq_state,
    place_state,
    seq_state_shardings,
    serving_shard_devices,
    sharded_seq_train_step,
    sharded_train_step,
    state_shardings,
)
from .pipeline import (
    bubble_fraction,
    merge_microbatches,
    pipeline_forward,
    pipeline_train_step,
    split_microbatches,
    stack_stage_grads,
    stack_stage_params,
    stage_shardings,
    stage_specs,
)
from .zero import ZeroState, place_zero_state, zero_state_specs, zero_train_step

__all__ = [
    "Mesh",
    "ShardedState",
    "ZeroState",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "along",
    "bubble_fraction",
    "gather_from_members",
    "gather_state",
    "group_mesh",
    "initialize",
    "make_hybrid_mesh",
    "make_mesh",
    "merge_microbatches",
    "param_shardings",
    "pipeline_forward",
    "pipeline_train_step",
    "place_seq_state",
    "place_state",
    "place_zero_state",
    "process_count",
    "process_gather",
    "process_index",
    "reduce_scatter",
    "ring_shift",
    "scatter_to_members",
    "seq_state_shardings",
    "serving_shard_devices",
    "sharded_seq_train_step",
    "sharded_train_step",
    "split_microbatches",
    "stack_stage_grads",
    "stack_stage_params",
    "stage_shardings",
    "stage_specs",
    "state_shardings",
    "tp_all_reduce",
    "tp_replicate",
    "zero_state_specs",
    "zero_train_step",
]
