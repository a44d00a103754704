"""The speculative-decoding metric catalog.

The port's own copy of the reference's ``spec/instruments.py``. Nothing is
registered unless a spec run's batcher is handed a registry, and every
series goes through :func:`~beholder_tpu_torch.metrics.get_or_create`, so
a replacement batcher re-attaches instead of tripping the duplicate guard.
Every value is host bookkeeping (no device reads):

- ``beholder_spec_drafted_tokens_total`` — drafts submitted to verification;
- ``beholder_spec_accepted_tokens_total`` — drafts the verifier accepted;
- ``beholder_spec_rejected_tokens_total`` — drafts discarded at the first
  disagreement;
- ``beholder_spec_emitted_tokens_total`` — tokens emitted by verify steps
  (``accepted + 1`` a step);
- ``beholder_spec_verify_steps_total`` — per-slot verify outcomes;
- ``beholder_spec_rollbacks_total`` / ``beholder_spec_rollback_pages_total``
  — verify steps whose rejected suffix freed pages, and those pages;
- ``beholder_spec_accept_len`` — histogram of accepted length a step;
- ``beholder_spec_draft_k`` — gauge: mean draft length chosen in the
  latest round.
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create


class SpecMetrics:
    """The series above, find-or-registered on a shared registry (a
    :class:`~beholder_tpu_torch.metrics.Registry`, or any object whose
    ``.registry`` is one)."""

    #: accepted-length histogram buckets: small integers — k rarely
    #: exceeds 8 (the controller caps it); default prom buckets are
    #: latency-shaped and useless here
    ACCEPT_LEN_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.drafted_total = get_or_create(
            registry, "counter",
            "beholder_spec_drafted_tokens_total",
            "Draft tokens submitted to speculative verification",
        )
        self.accepted_total = get_or_create(
            registry, "counter",
            "beholder_spec_accepted_tokens_total",
            "Draft tokens the verifier accepted",
        )
        self.rejected_total = get_or_create(
            registry, "counter",
            "beholder_spec_rejected_tokens_total",
            "Draft tokens discarded at the first verifier disagreement",
        )
        self.emitted_total = get_or_create(
            registry, "counter",
            "beholder_spec_emitted_tokens_total",
            "Forecast tokens emitted by speculative verify steps",
        )
        self.verify_steps_total = get_or_create(
            registry, "counter",
            "beholder_spec_verify_steps_total",
            "Per-slot speculative verify outcomes (slot-steps)",
        )
        self.rollbacks_total = get_or_create(
            registry, "counter",
            "beholder_spec_rollbacks_total",
            "Verify steps whose rejected suffix freed at least one page",
        )
        self.rollback_pages_total = get_or_create(
            registry, "counter",
            "beholder_spec_rollback_pages_total",
            "KV pages returned to the pool by rejected-suffix rollbacks",
        )
        self.accept_len = get_or_create(
            registry, "histogram",
            "beholder_spec_accept_len",
            "Accepted draft length per slot per verify step",
            buckets=self.ACCEPT_LEN_BUCKETS,
        )
        self.draft_k = get_or_create(
            registry, "gauge",
            "beholder_spec_draft_k",
            "Mean per-slot draft length chosen by the adaptive "
            "controller in the latest round",
        )

    def observe_step(
        self, drafted: int, accepted: int, emitted: int, freed_pages: int
    ) -> None:
        """Record one slot's outcome within one verify step."""
        self.verify_steps_total.inc()
        self.drafted_total.inc(drafted)
        self.accepted_total.inc(accepted)
        self.rejected_total.inc(drafted - accepted)
        self.emitted_total.inc(emitted)
        self.accept_len.observe(float(accepted))
        if freed_pages > 0:
            self.rollbacks_total.inc()
            self.rollback_pages_total.inc(freed_pages)
