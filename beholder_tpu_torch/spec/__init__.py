"""Speculative decoding: draft-then-verify serving on the paged KV cache.

Port of the reference's ``spec`` package. The paged serving core decodes one
token per model step; speculative serving turns the per-row causal-offset
chunk forward into an N-tokens-per-step decode loop:

1. a cheap drafter proposes up to ``k`` future tokens per slot —
   :class:`~beholder_tpu_torch.spec.drafter.NGramDrafter` (suffix matching
   over the request's own history, no model work) or
   :class:`~beholder_tpu_torch.spec.drafter.SmallModelDrafter` (a smaller
   :class:`~beholder_tpu_torch.models.sequence.TelemetrySequenceModel` on
   its own paged slots);
2. one verify step scores all ``k`` drafts for every slot at once: either
   the dense-gather verify
   (:func:`~beholder_tpu_torch.spec.verify.spec_verify_step`: pages gathered
   into a dense context, plain PyTorch) or the fused verify
   (:func:`~beholder_tpu_torch.spec.verify.spec_verify_commit`: the chunk
   attends the pools in place through the paged chunk kernel,
   ``csrc/paged_chunk.cu``, one launch per layer per round);
3. the host accepts the longest agreeing draft prefix (greedy), or
   rejection-samples under a temperature
   (:func:`~beholder_tpu_torch.spec.verify.speculative_sample`), emitting
   ``accepted + 1`` tokens per verify step;
4. the dense path rolls the rejected suffix's pages back
   (:func:`~beholder_tpu_torch.spec.verify.paged_rollback`, refcount-aware);
   the fused path commits only the accepted columns.

Greedy exactness: with ``accept_tol == 0`` a draft is accepted only when it
equals the verifier's own output bit for bit, so the emitted stream does not
depend on the drafter, provided the verifier computes a token at a given
position the same way whichever chunk row it sits in. That holds for both
verify paths on CPU tensors, for the dense path on the card, and for the
fused path on the card because the chunk kernel walks keys in tiles of fixed
absolute positions (see ``csrc/paged_chunk.cu``).

Nothing drafts unless a batcher is built with ``spec=`` (a
:class:`SpecConfig`; :func:`spec_from_config` parses ``instance.spec.*``,
off by default). This module imports no torch; the device half lives in
:mod:`.verify`, :mod:`.drafter` and :mod:`.scheduler` and loads on first
use; the counters live in :mod:`.instruments` (``SpecMetrics``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

#: acceptance modes
MODE_GREEDY = "greedy"
MODE_SAMPLE = "sample"

#: drafter kinds buildable from config
DRAFTER_NGRAM = "ngram"
DRAFTER_MODEL = "model"
DRAFTER_NONE = "none"


@dataclass
class SpecConfig:
    """Speculative-decoding knobs (``instance.spec.*``).

    ``drafter`` may also be a :class:`~beholder_tpu_torch.spec.drafter.
    Drafter` instance (the small-model drafter needs weights a config
    cannot carry)."""

    mode: str = MODE_GREEDY        # greedy | sample
    temperature: float = 0.0       # sample-mode proposal/target std dev
    #: greedy acceptance tolerance. 0.0 = exact bitwise agreement (spec on
    #: == spec off token for token); > 0 trades bounded per-token drift for
    #: acceptance rate
    accept_tol: float = 0.0
    drafter: Any = DRAFTER_NGRAM   # "ngram" | "model" | "none" | Drafter
    max_draft: int = 4             # k cap (the verify chunk is k+1 wide)
    min_draft: int = 1
    #: adaptive per-slot k from the observed acceptance EMA
    adaptive: bool = True
    ema: float = 0.9               # EMA decay for per-slot acceptance
    #: n-gram drafter knobs
    ngram_max_order: int = 3
    ngram_match_tol: float = 0.0
    #: sample-mode seed (None -> nondeterministic)
    seed: int | None = None

    def __post_init__(self):
        if self.mode not in (MODE_GREEDY, MODE_SAMPLE):
            raise ValueError(f"spec mode must be greedy|sample, got {self.mode!r}")
        if self.mode == MODE_SAMPLE and self.temperature <= 0:
            raise ValueError("sample mode needs temperature > 0")
        if self.max_draft < 1:
            raise ValueError(f"max_draft must be >= 1, got {self.max_draft}")
        if not 1 <= self.min_draft <= self.max_draft:
            raise ValueError(
                f"min_draft must be in [1, max_draft={self.max_draft}], "
                f"got {self.min_draft}"
            )
        if self.accept_tol < 0:
            raise ValueError(f"accept_tol must be >= 0, got {self.accept_tol}")
        if not 0 < self.ema < 1:
            raise ValueError(f"ema must be in (0, 1), got {self.ema}")


def spec_from_config(config) -> SpecConfig | None:
    """Parse ``instance.spec.*`` from ``config`` (anything with a dotted-path
    ``get(path, default)``) into a :class:`SpecConfig`; None unless
    ``instance.spec.enabled``."""
    if not bool(config.get("instance.spec.enabled")):
        return None
    seed = config.get("instance.spec.seed")
    return SpecConfig(
        mode=str(config.get("instance.spec.mode", MODE_GREEDY)),
        temperature=float(config.get("instance.spec.temperature", 0.0)),
        accept_tol=float(config.get("instance.spec.accept_tol", 0.0)),
        drafter=str(config.get("instance.spec.drafter", DRAFTER_NGRAM)),
        max_draft=int(config.get("instance.spec.max_draft", 4)),
        min_draft=int(config.get("instance.spec.min_draft", 1)),
        adaptive=bool(config.get("instance.spec.adaptive", True)),
        ema=float(config.get("instance.spec.ema", 0.9)),
        ngram_max_order=int(config.get("instance.spec.ngram.max_order", 3)),
        ngram_match_tol=float(config.get("instance.spec.ngram.match_tol", 0.0)),
        seed=int(seed) if seed is not None else None,
    )


def __getattr__(name: str):
    # the torch halves load lazily: parsing a config imports no torch
    if name in ("Drafter", "NGramDrafter", "NullDrafter", "SmallModelDrafter"):
        from . import drafter

        return getattr(drafter, name)
    if name in ("spec_verify_step", "spec_verify_chunk", "spec_commit_step",
                "spec_verify_commit", "paged_rollback", "greedy_accept",
                "speculative_sample"):
        from . import verify

        return getattr(verify, name)
    if name in ("run_spec", "AdaptiveDraftController"):
        from . import scheduler

        return getattr(scheduler, name)
    raise AttributeError(name)


__all__ = [
    "SpecConfig",
    "spec_from_config",
    "MODE_GREEDY",
    "MODE_SAMPLE",
    "DRAFTER_NGRAM",
    "DRAFTER_MODEL",
    "DRAFTER_NONE",
]
