"""The group-parallel decode engine: one logical shard, N devices.

:class:`GroupBatcher` subclasses
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` and keeps its
whole host half (the claim loop, page headroom, prefix-cache bookkeeping,
deadlines, the packed readback) as it is. What differs is where the pools
live and how the paged steps run over them:

- **Layout.** Each layer's k and v pools are tuples of member pools,
  member ``m`` holding kv heads ``[m*Hkv/N, (m+1)*Hkv/N)`` of every page as
  a contiguous tensor on ``devices[m]`` (the kernels take pools by data
  pointer with full-head strides, so a member's pool is never a view of a
  full one). The allocator tensors (page table, lengths, free stack,
  refcounts, the sticky flag) exist once, on member 0: one controller drives
  every member, so there is no replica to keep in lockstep. The serving ops
  of :mod:`beholder_tpu_torch.models.serving` write, import and export such
  layers member by member; the wire format stays full-head.
- **Weights.** At rest they are the members' megatron slices
  (``param_slices``: :func:`~beholder_tpu_torch.parallel.sharding.
  shard_tensors` under :func:`~beholder_tpu_torch.parallel.sharding.seq_spec`
  on :func:`~beholder_tpu_torch.parallel.mesh.group_mesh`; column layers
  split their output features, row layers their input features). The
  forward's weights on member 0 are their concatenation
  (:func:`~beholder_tpu_torch.parallel.sharding.unshard_tensors`), a
  bitwise copy made once at construction.
- **The step.** Where the reference runs one program a member and
  all-gathers the heads, this runs the full-width layers (LayerNorms,
  projections, MLP, head) once a step on member 0 and sends each member its
  q/k/v head slice for its pool write and its attention
  (:func:`~beholder_tpu_torch.models.sequence._group_attention`). The
  numbers are the reference's replicated member programs', without N-fold
  work on the one card the port runs on; what it costs is the head-slice
  copies (``Tensor.to`` moves nothing on one device) and N attention
  launches a layer instead of one, each on ``1/N`` of the heads. A decode
  member launches with the full-head launch's split
  (``paged_decode_attention(group=N)``), so its heads carry the single
  pool's bits.
- **Warm admissions are fused**: a member holds a slice of the heads, so
  there is no full-head context for the dense path to gather; they run the
  paged chunk kernel over the member pools. Cold admissions run the dense
  prefill at full width and write each member's head slice.

Refused, as in the reference: ``spec=`` and ``fused_verify=`` at
construction, and ``run_waves``, ``run_what_if`` and ``run_spec`` (route
those to a single-device shard).
"""

from __future__ import annotations

import copy
import functools

import torch

from beholder_tpu_torch.models.serving import ContinuousBatcher, QuantizedPool, _tick_chunk
from beholder_tpu_torch.ops.paged_attention import GroupSpec
from beholder_tpu_torch.parallel.mesh import group_mesh
from beholder_tpu_torch.parallel.sharding import seq_spec, shard_tensors, specs_for, unshard_tensors


def _split_heads(pool, size: int, devices):
    """A full-head pool as ``size`` member pools, member ``m`` a contiguous
    tensor (values and scales alike) on ``devices[m]``."""
    if isinstance(pool, QuantizedPool):
        vals = _split_heads(pool.values, size, devices)
        scales = _split_heads(pool.scales, size, devices)
        return tuple(QuantizedPool(v, s) for v, s in zip(vals, scales))
    hloc = pool.shape[1] // size
    return tuple(
        pool[:, m * hloc:(m + 1) * hloc].to(devices[m]).contiguous() for m in range(size)
    )


class GroupBatcher(ContinuousBatcher):
    """A :class:`ContinuousBatcher` over a group of ``len(devices)``
    devices, its pools split by kv head.

    The router treats a group as one routable shard: its
    :attr:`transfer_device` (member 0) receives handoffs, migrations and
    fabric pages in the full-head wire format, which :meth:`export_pages`
    and :meth:`import_pages` merge and slice. ``model`` is copied onto
    member 0; the caller's module is left as it is."""

    def __init__(self, model, *, devices, axis: str = "tp", name: str = "decode-g0", **kwargs):
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) < 2:
            raise ValueError(
                f"a decode group needs >= 2 devices, got {len(devices)} "
                "(group_size=1 is the plain ContinuousBatcher)"
            )
        hkv = model.kv_heads or model.heads
        if hkv % len(devices):
            raise ValueError(
                f"group size {len(devices)} does not divide the model's {hkv} KV heads "
                "(head-partition policy is kv_head)"
            )
        if kwargs.get("spec") is not None:
            raise ValueError(
                "group-parallel decode does not compose with speculative decoding "
                "(spec verify is a single-device lane): route spec traffic to a "
                "non-group shard"
            )
        if kwargs.get("fused_verify"):
            raise ValueError(
                "fused_verify is a per-batcher single-device knob; the group engine "
                "always runs warm admissions fused (drop the knob: it is implied)"
            )
        if "device" in kwargs:
            raise TypeError("a GroupBatcher is placed by devices=, not device=")
        n = len(devices)
        self.devices = devices
        self.name = name
        #: the members' megatron slices of every weight, each on its device
        weights = model.state_dict()
        mesh, specs = group_mesh(devices), specs_for(weights, seq_spec)
        self.param_slices = shard_tensors(weights, specs, mesh)
        full = copy.deepcopy(model).to(devices[0])
        full.load_state_dict(unshard_tensors(self.param_slices, specs, mesh, devices[0]))
        super().__init__(full, device=devices[0], **kwargs)
        self.group = GroupSpec(axis, n)
        #: warm admissions always run the paged chunk kernel (see the module)
        self.fused_verify = True
        self.state = self.state._replace(
            k_pools=tuple(_split_heads(p, n, devices) for p in self.state.k_pools),
            v_pools=tuple(_split_heads(p, n, devices) for p in self.state.v_pools),
        )
        self._tick_chunk = self._instrumented_tick(
            functools.partial(_tick_chunk, self.model, group=self.group)
        )

    def _instrumented_tick(self, tick):
        """One ``group.tick`` instant a member for each tick-chunk dispatch
        (``worker=decode-g0.m1``), so a recorded timeline shows which devices
        the tick spanned; without a recorder the call goes straight
        through."""

        def run(state, carry, write_idx, n):
            fr = self.flight_recorder
            if fr is not None:
                for m in range(self.group.size):
                    fr.instant("group.tick", worker=f"{self.name}.m{m}",
                               collective="concat", members=self.group.size)
            return tick(state, carry, write_idx, n)

        return run

    # -- single-device lanes -----------------------------------------------

    def run_waves(self, *a, **kw):
        raise NotImplementedError(
            "run_waves is a single-device lane (its per-wave admit does not split "
            "by kv head): use run()/run_pending on a group shard"
        )

    def run_what_if(self, *a, **kw):
        raise NotImplementedError(
            "run_what_if forks are a single-device lane: replay what-ifs on a "
            "non-group shard"
        )

    def run_spec(self, *a, **kw):
        raise NotImplementedError(
            "speculative decoding is a single-device lane (spec is rejected at "
            "GroupBatcher construction)"
        )
