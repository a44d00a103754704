"""Group-parallel decode: one logical decode shard served by a group of N
devices, its paged pool split by kv head.

The port's copy of the reference's ``cluster/group/``. Default off
(``ClusterConfig.group`` is None): every decode shard is then one
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` on one device.
With ``instance.cluster.group.*`` set, each decode shard is a
:class:`~beholder_tpu_torch.cluster.group.engine.GroupBatcher`:

- **the pool splits by kv head**: member ``m`` holds heads ``[m*Hkv/N,
  (m+1)*Hkv/N)`` of every page, as a contiguous pool of its own on its
  device. The page table, free stack, refcounts and lengths exist once
  (allocator arithmetic reads no head), so page ids are group-wide and the
  prefix cache, the fabric's directory and the host arithmetic never learn
  that the pool was split;
- **weights rest in the megatron split**
  (:func:`~beholder_tpu_torch.parallel.sharding.seq_spec` over
  :func:`~beholder_tpu_torch.parallel.mesh.group_mesh`) and are put back
  together by concatenation, a bitwise copy;
- **attention is the only head-aware stage**: each member attends its own
  pool over its head slice, and the heads are concatenated, never summed,
  so a group's streams are the single batcher's bits in every pool dtype;
- **the scheduler sees one shard**: a group routes, drains, fails over and
  mirrors as one ``decode-g<id>`` worker, and the recorder's ``group.tick``
  instants carry member names (``decode-g0.m1``).

The device half lives in :mod:`.engine`, loaded on first use: this module
imports no torch.
"""

from __future__ import annotations

__all__ = ["GroupBatcher"]


def __getattr__(name):
    if name == "GroupBatcher":
        from .engine import GroupBatcher

        return GroupBatcher
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
