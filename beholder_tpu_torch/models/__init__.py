"""Models of the port: the telemetry sequence model, its dense oracle, the
paged serving engine, the anomaly model, and their training state and
checkpoints."""

from .anomaly import ProgressAnomalyModel, anomaly_scores, init_train_state, make_windows
from .checkpoint import restore_state, save_state
from .decode import (
    DecodeCache,
    decode_step,
    forecast_deltas,
    forecast_eta,
    init_cache,
    prefill,
)
from .sequence import (
    FEATURES,
    Block,
    TelemetrySequenceModel,
    init_seq_state,
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
    "decode_step",
    "forecast_deltas",
    "forecast_eta",
    "init_cache",
    "init_seq_state",
    "init_train_state",
    "make_windows",
    "prefill",
    "restore_state",
    "save_state",
    "seq_loss",
    "seq_train_step",
    "stream_features",
]
