"""The speculative serving loop over the ContinuousBatcher.

Port of the reference's ``spec/scheduler.py``. :func:`run_spec` is the spec
twin of :meth:`~beholder_tpu_torch.models.serving.ContinuousBatcher.run`:
the same admission claim loop (batched cold prefill, prefix-cache warm
adoption, page headroom, pressure eviction, deferral) feeding a
draft-then-verify decode loop:

- every round, each active slot's drafter proposes up to ``k_s`` tokens
  (``k_s`` tuned per slot by :class:`AdaptiveDraftController`);
- one verify scores every slot's chunk at once — slots whose drafter
  proposed nothing ride along as plain one-token decodes;
- one packed readback returns every prediction and the sticky allocator
  flag: the round's only synchronising call;
- the host accepts per slot (greedy exact or within a tolerance, or
  temperature-mode rejection sampling); the dense path then rolls every
  rejected suffix back in one call, the fused path commits the accepted
  columns at the start of the next round's verify.

The reference's metrics (``SpecMetrics``), run and round spans, kernel tags
and flight-recorder markers are not ported yet (``ROADMAP.md`` A.3).
"""

from __future__ import annotations

import numpy as np
import torch

from beholder_tpu_torch.models.serving import (
    paged_admit_batch,
    paged_admit_with_prefix,
    paged_release_many,
)
from beholder_tpu_torch.ops import NUM_STATUSES

from . import DRAFTER_MODEL, DRAFTER_NGRAM, DRAFTER_NONE, MODE_SAMPLE, SpecConfig
from .drafter import Drafter, NGramDrafter, NullDrafter
from .verify import (
    greedy_accept,
    paged_rollback,
    spec_verify_commit,
    spec_verify_step,
    speculative_sample,
)


class AdaptiveDraftController:
    """Per-slot draft length from the observed acceptance EMA:
    ``k = clip(round(a / (1 - a)), min, max)`` for the slot's acceptance-rate
    EMA ``a`` (the expected accepted run at per-token acceptance ``a``).

    Control-plane hooks: ``k_cap_fn`` returns a draft-length cap to apply
    now (None = uncapped, the default), and ``on_k_shed(slot, wanted, cap)``
    reports each choice the cap shortened."""

    def __init__(self, slots: int, cfg: SpecConfig):
        self.min_k = cfg.min_draft
        self.max_k = cfg.max_draft
        self.adaptive = cfg.adaptive
        self.decay = cfg.ema
        self._init = 0.5
        self.ema = np.full(slots, self._init, np.float64)
        self.k_cap_fn = None
        self.on_k_shed = None

    def choose(self, slot: int) -> int:
        if not self.adaptive:
            k = self.max_k
        else:
            a = float(self.ema[slot])
            k = int(round(a / max(1e-6, 1.0 - a)))
            k = min(self.max_k, max(self.min_k, k))
        cap = self.k_cap_fn() if self.k_cap_fn is not None else None
        if cap is not None and cap < k:
            if self.on_k_shed is not None:
                self.on_k_shed(slot, k, cap)
            return max(int(cap), 0)
        return k

    def update(self, slot: int, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        rate = accepted / drafted
        self.ema[slot] = self.decay * self.ema[slot] + (1.0 - self.decay) * rate

    def reset(self, slot: int) -> None:
        self.ema[slot] = self._init


def _build_drafter(batcher, cfg: SpecConfig) -> Drafter:
    if isinstance(cfg.drafter, Drafter):
        return cfg.drafter
    if cfg.drafter == DRAFTER_NGRAM:
        return NGramDrafter(max_order=cfg.ngram_max_order, match_tol=cfg.ngram_match_tol)
    if cfg.drafter == DRAFTER_NONE:
        return NullDrafter()
    if cfg.drafter == DRAFTER_MODEL:
        raise ValueError(
            "drafter='model' needs a constructed SmallModelDrafter (a "
            "draft model's weights can't come from config) — pass "
            "SpecConfig(drafter=SmallModelDrafter(...))"
        )
    raise ValueError(f"unknown drafter {cfg.drafter!r}")


def run_spec(batcher, requests: list) -> list[np.ndarray]:
    """Serve ``requests`` speculatively on ``batcher``; results are the
    per-request forecast delta arrays ``run()`` returns. With
    ``accept_tol == 0`` under greedy the stream does not depend on the
    drafter."""
    cfg: SpecConfig = batcher.spec
    if cfg is None:
        raise RuntimeError("batcher has no spec config — construct it with spec=")
    # persistent per-batcher collaborators: a drafter may hold its own paged
    # state across calls, and the controller's EMA carries over
    drafter = getattr(batcher, "_spec_drafter", None)
    if drafter is None:
        drafter = batcher._spec_drafter = _build_drafter(batcher, cfg)
    controller = getattr(batcher, "_spec_controller", None)
    if controller is None:
        controller = batcher._spec_controller = AdaptiveDraftController(batcher.slots, cfg)
    # control-plane shedding hooks, re-read every call (they may be set
    # after the controller was built)
    cap_fn = getattr(batcher, "_spec_k_cap_fn", None)
    if cap_fn is not None:
        controller.k_cap_fn = cap_fn
        controller.on_k_shed = getattr(batcher, "_spec_k_shed_cb", None)
    rng = np.random.default_rng(cfg.seed)

    # fail fast before anything is admitted (_need_pages budgets the dense
    # path's verify transient)
    batcher._start_run(requests)
    try:
        with torch.no_grad():
            return _run_spec_loop(batcher, requests, cfg, drafter, controller, rng)
    except BaseException:
        batcher._poisoned = True
        raise


def _run_spec_loop(batcher, requests, cfg, drafter, controller, rng):
    model = batcher.model
    slots = batcher.slots
    page = batcher.page_size
    dev = batcher.device
    w = cfg.max_draft + 1
    features = 1 + NUM_STATUSES
    queue = list(enumerate(requests))
    results: list = [None] * len(requests)
    sample_mode = cfg.mode == MODE_SAMPLE

    req_of: list = [None] * slots
    history: list[list[float]] = [[] for _ in range(slots)]
    emitted: list[list[float]] = [[] for _ in range(slots)]
    status_id = np.zeros(slots, np.int64)
    cache_len = np.zeros(slots, np.int64)   # host mirror of seq_lens
    total_need = np.zeros(slots, np.int64)
    status_eye = np.eye(NUM_STATUSES, dtype=np.float32)

    # fused verify: one call a round (commit the previous round's accepted
    # prefix, then attend the pools in place through the chunk kernel);
    # dense verify: a verify plus a rollback a round
    fused = batcher.fused_verify
    if fused:
        # the deferred-commit carry: last round's kv chunks and how many
        # columns each slot keeps (0: first round, inactive or retired — a
        # retiring slot's final chunk is never committed)
        hkv = model.kv_heads or model.heads
        zero_kv = torch.zeros((slots, hkv, w, model.dim // model.heads),
                              dtype=torch.bfloat16, device=dev)
        pending_kvs = tuple((zero_kv, zero_kv) for _ in range(model.layers))
        pending_accepts = np.zeros(slots, np.int32)

    def free_pages() -> int:
        cold = batcher.prefix_cache.cold_page_count if batcher.prefix_cache else 0
        return batcher.num_pages - int(total_need.sum()) - cold

    def fetch_packed(preds_list) -> np.ndarray:
        """One readback: the sticky allocator flag and every pending
        prediction, packed into one buffer."""
        got = torch.cat(
            [batcher.state.alloc_failed.float()[None]]
            + [p.float().reshape(-1) for p in preds_list]
        ).cpu().numpy()
        if got[0]:
            raise RuntimeError(batcher._ALLOCATOR_TRIPPED)
        return got[1:]

    def retire(done: list[int]):
        batcher.state = paged_release_many(batcher.state, batcher._up(np.asarray(done, np.int32)))
        for s in done:
            rid = req_of[s]
            results[rid] = np.asarray(emitted[s][: requests[rid].horizon], np.float32)
            req_of[s] = None
            history[s] = []
            emitted[s] = []
            total_need[s] = 0
            cache_len[s] = 0
            drafter.on_retire(s)
            controller.reset(s)
            if batcher.prefix_cache is not None and batcher._slot_chain[s]:
                batcher.prefix_cache.release(batcher._slot_chain[s])
                batcher._slot_chain[s] = []

    def commit(slot, rid, req, need):
        total_need[slot] = need

    while queue or any(r is not None for r in req_of):
        # -- admission round: the batcher's shared claim loop, then one
        # batched cold prefill, per-hit warm admits, one packed readback
        batch = batcher._claim_admissions(queue, results, req_of, free_pages, commit)
        if batch:
            batcher.admission_rounds += 1
            cold = [b for b in batch if not b[4]]
            warm = [b for b in batch if b[4]]
            preds_pending = []
            pred_owner: list[int] = []
            if cold:
                t_pad = -(-max(b[3] for b in cold) // page) * page
                preds, batcher.state = paged_admit_batch(
                    model, batcher.state,
                    batcher._up(np.asarray([b[0] for b in cold], np.int32)),
                    batcher._up(np.stack([batcher._pad_to(b[2], t_pad) for b in cold])),
                    batcher._up(np.asarray([b[3] for b in cold], np.int32)),
                )
                preds_pending.append(preds)
                pred_owner.extend(b[0] for b in cold)
            for slot, rid, feats_np, t, hit_pages, _ in warm:
                t_hit = len(hit_pages) * page
                s_len = t - t_hit
                s_pad = -(-s_len // page) * page
                pred, batcher.state = paged_admit_with_prefix(
                    model, batcher.state, batcher._up(np.asarray(slot, np.int64)),
                    batcher._up(batcher._pad_to(feats_np[t_hit:], s_pad)[None]),
                    batcher._up(np.asarray(s_len, np.int32)),
                    batcher._up(np.asarray(hit_pages, np.int32)),
                    fused=fused,
                )
                preds_pending.append(pred.reshape(1))
                pred_owner.append(slot)
            if batcher.prefix_cache is not None:
                batcher.prefix_cache.prefilled(sum(b[3] - len(b[4]) * page for b in batch))
                batcher._index_admitted([(b[0], b[5], b[3] // page) for b in batch])
            pred_of = dict(zip(pred_owner, fetch_packed(preds_pending)))
            for slot, rid, feats_np, t, _, _ in batch:
                status_id[slot] = int(requests[rid].statuses[-1])
                cache_len[slot] = t
                first = float(np.float32(pred_of[slot]))
                history[slot] = [float(x) for x in feats_np[:, 0]]
                history[slot].append(first)
                emitted[slot] = [first]
                drafter.on_admit(slot, feats_np, int(status_id[slot]))
            done = [b[0] for b in batch if requests[b[1]].horizon <= len(emitted[b[0]])]
            if done:
                retire(done)
        if not any(r is not None for r in req_of):
            continue

        # -- draft round: per-slot proposals
        active = np.asarray([r is not None for r in req_of])
        chunk = np.zeros((slots, w, features), np.float32)
        drafts_of: dict[int, np.ndarray] = {}
        means_of: dict[int, np.ndarray] = {}
        for slot in range(slots):
            if req_of[slot] is None:
                continue
            # a step emits up to k_s + 1 tokens: never draft past the
            # slot's remaining horizon
            remaining = requests[req_of[slot]].horizon - len(emitted[slot])
            k_s = min(controller.choose(slot), max(remaining - 1, 0))
            means = drafter.propose(slot, np.asarray(history[slot], np.float32), k_s)[:k_s]
            if sample_mode and means.shape[0]:
                drafts = np.asarray(
                    means + cfg.temperature * rng.standard_normal(means.shape[0]),
                    np.float32,
                )
            else:
                drafts = means
            drafts_of[slot] = drafts
            means_of[slot] = means
            row = chunk[slot]
            row[0, 0] = history[slot][-1]
            row[1 : 1 + drafts.shape[0], 0] = drafts
            row[:, 1:] = status_eye[status_id[slot]]

        # -- verify: one call for the whole mixed batch, one readback
        if fused:
            preds_dev, pending_kvs, batcher.state = spec_verify_commit(
                model, batcher.state, batcher._up(chunk), pending_kvs,
                batcher._up(pending_accepts),
            )
        else:
            preds_dev, batcher.state = spec_verify_step(
                model, batcher.state, batcher._up(chunk), batcher._up(active)
            )
        batcher.verify_rounds += 1
        preds = fetch_packed([preds_dev]).reshape(slots, w)

        # -- host acceptance, then the rollback / commit lengths
        new_lens = np.zeros(slots, np.int32)
        accepts = np.zeros(slots, np.int32)
        done = []
        for slot in range(slots):
            if req_of[slot] is None:
                continue
            drafts = drafts_of[slot]
            k_s = drafts.shape[0]
            if sample_mode:
                m, toks = speculative_sample(
                    preds[slot][: k_s + 1], means_of[slot], drafts, cfg.temperature, rng,
                )
            else:
                m, toks = greedy_accept(drafts, preds[slot][: k_s + 1], cfg.accept_tol)
            new_lens[slot] = cache_len[slot] + m + 1
            accepts[slot] = m + 1
            history[slot].extend(float(x) for x in toks)
            emitted[slot].extend(float(x) for x in toks)
            cache_len[slot] = new_lens[slot]
            controller.update(slot, k_s, m)
            if len(emitted[slot]) >= requests[req_of[slot]].horizon:
                done.append(slot)
            else:
                # stateful drafters roll their speculation back here
                # (retiring slots go straight to on_retire)
                drafter.resync(slot, np.asarray(history[slot], np.float32))
        if fused:
            # nothing to reconcile now: the accepted columns commit at the
            # start of the next round's verify, and a retiring slot's final
            # chunk is dropped
            accepts[done] = 0
            pending_accepts = accepts
        else:
            batcher.state = paged_rollback(
                batcher.state, batcher._up(new_lens), batcher._up(active)
            )
        if done:
            retire(done)

    # no trailing allocator check: every allocating call (admit, dense
    # verify, the fused round's commit) is followed by a fetch_packed that
    # reads the sticky flag, and rollback and release only free pages
    return results
