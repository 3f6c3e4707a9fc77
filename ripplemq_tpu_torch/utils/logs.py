"""Logging: named loggers under one "ripplemq" root + console config.

Twin of `ripplemq_tpu/utils/logs.py`.

The reference ships a configured log4j2 console stack (reference:
mq-broker/src/main/resources/log4j2.xml:10-14 — pattern
"%d{HH:mm:ss.SSS} [%t] %-5level %logger{36} - %msg%n"); this is the
equivalent: every subsystem logs through `get_logger(<subsystem>)`
("ripplemq.broker", "ripplemq.dataplane", "ripplemq.hostraft",
"ripplemq.replication", "ripplemq.storage"), and the process entry point
calls `configure_logging()` once. Library code NEVER configures handlers
itself (embedders own the root config), so imports stay side-effect
free; unconfigured loggers follow stdlib defaults (warnings+ to stderr).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional, TextIO

_ROOT = "ripplemq"

# Mirrors the reference's log4j2 console pattern (thread, level, logger).
_PATTERN = "%(asctime)s.%(msecs)03d [%(threadName)s] %(levelname)-5s %(name)s - %(message)s"
_DATEFMT = "%H:%M:%S"


def get_logger(subsystem: str) -> logging.Logger:
    """Logger for one subsystem, namespaced under the ripplemq root."""
    return logging.getLogger(f"{_ROOT}.{subsystem}")


class _JsonLinesFormatter(logging.Formatter):
    """One JSON object per log record: machine-greppable broker logs
    that merge cleanly with the telemetry plane's event timeline (the
    proc chaos backend launches its subprocess brokers with this, so a
    soak's broker-N.log sits `jq`-able next to the trace ring). Fields:
    ts (epoch seconds), level, subsystem (the logger name under the
    ripplemq root), broker (the launching process's id, if known),
    thread, msg; exceptions land in `exc`."""

    def __init__(self, broker_id: Optional[int] = None) -> None:
        super().__init__()
        self._broker_id = broker_id

    def format(self, record: logging.LogRecord) -> str:
        name = record.name
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "subsystem": name[len(_ROOT) + 1:] if
            name.startswith(_ROOT + ".") else name,
            "broker": self._broker_id,
            "thread": record.threadName,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, ensure_ascii=False)


def configure_logging(level: str | int = "INFO",
                      stream: Optional[TextIO] = None,
                      json_lines: bool = False,
                      broker_id: Optional[int] = None) -> logging.Logger:
    """Attach one console handler to the ripplemq root logger (idempotent:
    reconfiguring replaces the previous handler, so tests and re-entrant
    mains don't stack duplicates). `json_lines=True` swaps the log4j2-
    style pattern for one JSON object per record (`_JsonLinesFormatter`),
    with `broker_id` stamped into every line. Returns the root logger."""
    root = logging.getLogger(_ROOT)
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root.setLevel(level)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    if json_lines:
        handler.setFormatter(_JsonLinesFormatter(broker_id=broker_id))
    else:
        handler.setFormatter(logging.Formatter(_PATTERN, datefmt=_DATEFMT))
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.propagate = False
    return root
