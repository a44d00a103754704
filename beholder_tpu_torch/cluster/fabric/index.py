"""The global prefix index: one cluster-wide directory over every
shard's prefix cache.

The port's own copy of the reference's ``cluster/fabric/index.py`` (host
side only, no torch), the same division of labor as
:mod:`beholder_tpu_torch.cache.prefix`: this module is pure bookkeeping; the
device half (the actual page movement) lives in :mod:`.engine`. The
directory maps chained prefix-page hashes (the radix cache's
content-derived key space, identical on every shard by construction —
``H(parent, page_bytes)`` does not mention the shard) to the shards
currently caching that page and the pool page id each holds.

Two pieces:

- :class:`GlobalPrefixIndex` — the directory itself, plus the
  cross-shard pin ledger (a borrower fetching pages from an owner
  pins the owner's chain so eviction cannot reclaim it mid-move; pins
  release on serve completion, drop, drain, and failover) and the
  per-chain remote hit counter driving the replicate-vs-borrow
  decision.
- :class:`IndexedPrefixCache` — a transparent proxy wrapped around a
  shard's :class:`~beholder_tpu_torch.cache.prefix.PrefixCache` that keeps
  the directory coherent as a side effect of the cache's own
  mutations (insert/adopt publish, evict/drop retract). The serving
  layer sees the exact PrefixCache surface it already speaks; with
  the fabric off nothing wraps and behavior is byte-identical.
"""

from __future__ import annotations


class GlobalPrefixIndex:
    """Cluster-wide directory: prefix hash -> {owner shard: page id}.

    The index never holds device references itself — each owning
    shard's cache keeps its usual ONE reference per cached page, and
    the directory only records WHO holds what. Directory staleness is
    therefore safe the same way the radix cache's host index is: a
    fetch re-resolves pages against the owner's live cache before
    moving anything, and the device refcounts own reclamation truth.
    """

    def __init__(self):
        #: key -> {shard name: pool page id on that shard}
        self._owners: dict[bytes, dict[str, int]] = {}
        #: key -> parent key (same chain structure as the radix cache)
        self._parents: dict[bytes, bytes | None] = {}
        #: chain tip key -> cross-shard hits served from it
        self._hits: dict[bytes, int] = {}
        #: outstanding cross-shard pins:
        #: {"owner": shard, "borrower": shard, "keys": [chain keys]}
        self._pins: list[dict] = []

    # -- directory maintenance (driven by IndexedPrefixCache) ------------

    def publish(
        self, shard: str, key: bytes, parent: bytes | None, page_id: int
    ) -> None:
        self._owners.setdefault(key, {})[shard] = int(page_id)
        self._parents[key] = parent

    def retract(self, shard: str, key: bytes) -> None:
        owners = self._owners.get(key)
        if owners is None:
            return
        owners.pop(shard, None)
        if not owners:
            del self._owners[key]
            self._parents.pop(key, None)
            self._hits.pop(key, None)

    def forget_shard(self, shard: str) -> None:
        """Drop every directory fact about one shard (worker death,
        drain) in one sweep."""
        for key in list(self._owners):
            self.retract(shard, key)

    # -- lookup -----------------------------------------------------------

    def best_owner(
        self, chain: list[bytes], exclude: str, beyond: int
    ) -> tuple[str, int] | None:
        """The shard (other than ``exclude``) caching the DEEPEST
        consecutive-from-root run of ``chain``, provided that depth
        exceeds ``beyond`` (the borrower's own local hit depth — a
        fetch that cannot extend the local hit is pure waste).
        Deterministic: candidate shards walk in sorted-name order and
        the first deepest wins."""
        candidates: set[str] = set()
        for key in chain:
            candidates.update(self._owners.get(key, ()))
        candidates.discard(exclude)
        best: tuple[str, int] | None = None
        for shard in sorted(candidates):
            depth = 0
            for key in chain:
                if self._owners.get(key, {}).get(shard) is None:
                    break
                depth += 1
            if depth > beyond and (best is None or depth > best[1]):
                best = (shard, depth)
        return best

    def page_ids(self, shard: str, keys: list[bytes]) -> list[int]:
        """The ``shard``-local pool page ids for ``keys`` (raises
        KeyError on a key the shard does not own — callers resolve
        against the owner's live cache, so this is a directory-vs-
        cache coherence assertion, not a fallible probe)."""
        return [self._owners[key][shard] for key in keys]

    # -- hot-prefix accounting --------------------------------------------

    def record_remote_hit(self, tip: bytes) -> int:
        """Count one cross-shard hit against a chain tip; returns the
        running total (the replicate-vs-borrow input)."""
        self._hits[tip] = self._hits.get(tip, 0) + 1
        return self._hits[tip]

    # -- cross-shard pin ledger --------------------------------------------

    def register_pin(
        self, owner: str, borrower: str, keys: list[bytes]
    ) -> dict:
        record = {
            "owner": owner, "borrower": borrower, "keys": list(keys)
        }
        self._pins.append(record)
        return record

    def release_pin(self, record: dict) -> None:
        try:
            self._pins.remove(record)
        except ValueError:
            pass

    def take_pins(
        self, owner: str | None = None, borrower: str | None = None
    ) -> list[dict]:
        """Remove and return every pin matching the given owner and/or
        borrower — the release sweep for retire/drop/drain/failover."""
        taken, kept = [], []
        for record in self._pins:
            if (owner is not None and record["owner"] != owner) or (
                borrower is not None and record["borrower"] != borrower
            ):
                kept.append(record)
            else:
                taken.append(record)
        self._pins = kept
        return taken

    def rewrite_pin_owner(self, old: str, new: str) -> int:
        """Repoint pins after a drain migrated the owner's pool: the
        chains (and their ``live_users`` marks) moved byte-identically
        to ``new``, so outstanding borrows release against it."""
        n = 0
        for record in self._pins:
            if record["owner"] == old:
                record["owner"] = new
                n += 1
        return n

    @property
    def outstanding_pins(self) -> int:
        return len(self._pins)

    @property
    def indexed_keys(self) -> int:
        return len(self._owners)


class IndexedPrefixCache:
    """A shard's :class:`~beholder_tpu_torch.cache.prefix.PrefixCache`,
    published. Pure delegation proxy — NOT a subclass: every read and
    every method the serving layer uses passes straight through to the
    wrapped cache, so pin semantics, eviction order, and counters are
    the inner cache's own. Only the four index-mutating operations are
    intercepted, to mirror the mutation into the global directory."""

    def __init__(self, inner, index: GlobalPrefixIndex, shard: str):
        self._inner = inner
        self._index = index
        self._shard = str(shard)
        # a cache wrapped mid-life (standby promotion) publishes what
        # it already holds
        for key, parent, page_id, _ in inner.export_entries():
            index.publish(self._shard, key, parent, page_id)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def insert(self, hashes, page_ids):
        new_pages, new_keys = self._inner.insert(hashes, page_ids)
        for key in new_keys:
            entry = self._inner._entries[key]
            self._index.publish(
                self._shard, key, entry.parent, entry.page_id
            )
        return new_pages, new_keys

    def adopt_entry(self, key, parent, page_id, live_users=0):
        adopted = self._inner.adopt_entry(key, parent, page_id, live_users)
        if adopted:
            self._index.publish(self._shard, key, parent, page_id)
        return adopted

    def evict(self, n_pages):
        before = set(self._inner._entries)
        out = self._inner.evict(n_pages)
        for key in before - set(self._inner._entries):
            self._index.retract(self._shard, key)
        return out

    def drop_entries(self, keys):
        keys = list(keys)
        out = self._inner.drop_entries(keys)
        for key in keys:
            if key not in self._inner._entries:
                self._index.retract(self._shard, key)
        return out
