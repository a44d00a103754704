"""Models of the port: the telemetry sequence model, its dense oracle and
its dp/tp-sharded serving, the paged serving engine, the anomaly model, and
their training state and checkpoints."""

from .anomaly import ProgressAnomalyModel, anomaly_scores, init_train_state, make_windows
from .checkpoint import restore_state, save_state
from .decode import (
    DecodeCache,
    cache_shardings,
    decode_step,
    forecast_deltas,
    forecast_eta,
    init_cache,
    prefill,
    serving_params,
    sharded_decode_step,
    sharded_forecast_eta,
    sharded_prefill,
)
from .sequence import (
    FEATURES,
    Block,
    TelemetrySequenceModel,
    init_seq_state,
    pipeline_stages,
    seq_loss,
    seq_train_step,
    stream_features,
)
from .train import TrainState, apply_gradients

__all__ = [
    "FEATURES",
    "Block",
    "DecodeCache",
    "ProgressAnomalyModel",
    "TelemetrySequenceModel",
    "TrainState",
    "anomaly_scores",
    "apply_gradients",
    "cache_shardings",
    "decode_step",
    "forecast_deltas",
    "forecast_eta",
    "init_cache",
    "init_seq_state",
    "init_train_state",
    "make_windows",
    "pipeline_stages",
    "prefill",
    "restore_state",
    "save_state",
    "seq_loss",
    "seq_train_step",
    "serving_params",
    "sharded_decode_step",
    "sharded_forecast_eta",
    "sharded_prefill",
    "stream_features",
]
