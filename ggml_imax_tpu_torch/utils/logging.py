"""Logging — the ggml_log_callback analog (ggml.h:2081; adopted by the
CUDA/Metal backends and whisper's WHISPER_LOG_*): a process-wide injectable
log sink with levels, defaulting to stderr (counterpart of
ggml_imax_tpu/utils/logging.py, the same behaviour).
"""
from __future__ import annotations

import enum
import sys
from typing import Callable


class LogLevel(enum.IntEnum):
    ERROR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5


_callback: Callable[[LogLevel, str], None] | None = None
_level = LogLevel.INFO


def set_log_callback(fn: Callable[[LogLevel, str], None] | None):
    """Install a custom sink (ggml_log_set analog); None restores stderr."""
    global _callback
    _callback = fn


def set_log_level(level: LogLevel):
    global _level
    _level = level


def log(level: LogLevel, msg: str):
    if _callback is not None:
        _callback(level, msg)
    elif level <= _level:
        print(f"[{level.name.lower()}] {msg}", file=sys.stderr)


def error(msg: str):
    log(LogLevel.ERROR, msg)


def warn(msg: str):
    log(LogLevel.WARN, msg)


def info(msg: str):
    log(LogLevel.INFO, msg)


def debug(msg: str):
    log(LogLevel.DEBUG, msg)
