"""Cluster memory fabric: KV pages as a cluster-wide resource.

The port's copy of the reference's ``cluster/fabric/``. Two halves behind
``ClusterConfig.fabric`` (default None: every shard's prefix cache stays
private and failover replays, as without the fabric), sharing one
page-movement plane, the transfer engine's raw hop between
:meth:`~beholder_tpu_torch.models.serving.ContinuousBatcher.export_pages`
and :meth:`~beholder_tpu_torch.models.serving.ContinuousBatcher.import_pages`:

- **Global prefix index** (:mod:`.index`): a cluster-wide directory over
  every shard's prefix cache. The chained content hashes do not mention
  the shard, so "warm anywhere" is a directory lookup: a prefix cached on
  shard A admits as a prefix hit on shard B after a verbatim page fetch,
  with cross-shard pins (released at the serve's end, on drop, drain and
  failover) and a borrow-or-replicate rule for hot prefixes
  (``replicate_after``).
- **Standby mirror** (:mod:`.mirror`): a dark standby shard copies the
  primaries' cached pages between serves; failover promotes it
  (:meth:`~.engine.FabricEngine.promote`), so recovery re-admits onto pages
  already resident instead of prefilling again.

:mod:`.engine` owns both and is the router's one point of contact. This
module and :mod:`.index` import no torch.
"""

from __future__ import annotations

from .index import GlobalPrefixIndex, IndexedPrefixCache

__all__ = [
    "GlobalPrefixIndex",
    "IndexedPrefixCache",
]
