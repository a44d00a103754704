"""Structured JSON logging, pino-style.

The port's own copy of the reference's ``log.py``. pino emits one JSON
object per line with ``level`` (numeric), ``time`` (epoch ms), ``name``,
``msg``, plus any bound fields; this formatter reproduces that shape, so a
log pipeline built for the reference reads the port's lines unchanged.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any

#: pino's numeric levels.
_PINO_LEVELS = {
    logging.DEBUG: 20,
    logging.INFO: 30,
    logging.WARNING: 40,
    logging.ERROR: 50,
    logging.CRITICAL: 60,
}


class PinoFormatter(logging.Formatter):
    """Format records as pino-compatible JSON lines."""

    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "level": _PINO_LEVELS.get(record.levelno, record.levelno),
            "time": int(record.created * 1000),
            "name": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        if record.exc_info and record.exc_info[1] is not None:
            payload["err"] = repr(record.exc_info[1])
        return json.dumps(payload, separators=(",", ":"), default=str)


def get_logger(name: str, stream: Any = None) -> logging.Logger:
    """A configured structured logger (idempotent per name)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stdout)
        handler.setFormatter(PinoFormatter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def bind(logger: logging.Logger, **fields: Any) -> logging.LoggerAdapter:
    """Attach structured fields to every record, pino ``child()``-style."""

    class _Adapter(logging.LoggerAdapter):
        def process(self, msg, kwargs):
            merged = dict(fields)
            merged.update(kwargs.pop("fields", {}) or {})
            kwargs.setdefault("extra", {})["fields"] = merged
            return msg, kwargs

    return _Adapter(logger, {})
