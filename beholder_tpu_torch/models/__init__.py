"""Models of the port: the telemetry sequence model, its dense oracle and
the paged serving engine."""

from .decode import DecodeCache, decode_step, forecast_deltas, init_cache, prefill
from .sequence import FEATURES, Block, TelemetrySequenceModel, stream_features

__all__ = [
    "FEATURES",
    "Block",
    "DecodeCache",
    "TelemetrySequenceModel",
    "decode_step",
    "forecast_deltas",
    "init_cache",
    "prefill",
    "stream_features",
]
