"""Serving observability: the flight recorder and roofline attribution.

:mod:`.recorder` keeps a bounded ring of the batcher's phase events;
:mod:`.roofline` measures the device's ceilings and tags each dispatch with
its achieved fraction of them. Both are off unless a
``ContinuousBatcher(flight_recorder=...)`` is built with one.

Not ported: the reference's SLO tracker, timelines fold, sentinel,
retention vault and flight plane, and ``flight_recorder_from_config``.
"""

from .recorder import DEFAULT_RING_SIZE, FlightRecorder, chrome_trace, parse_cursor
from .roofline import (
    PHASE_FAMILIES,
    RooflineAttributor,
    attribution_summary,
    model_flops_per_token,
)

__all__ = [
    "DEFAULT_RING_SIZE",
    "FlightRecorder",
    "PHASE_FAMILIES",
    "RooflineAttributor",
    "attribution_summary",
    "chrome_trace",
    "model_flops_per_token",
    "parse_cursor",
]
