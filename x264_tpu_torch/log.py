"""Pluggable logging — the analogue of x264_param_t.pf_log +
x264_log (common/common.c x264_log): every encoder message routes
through a caller-replaceable callback, defaulting to stderr with the
reference's "x264 [level]:" prefix style."""

from __future__ import annotations

import sys

LOG_ERROR, LOG_WARNING, LOG_INFO, LOG_DEBUG = 0, 1, 2, 3
_NAMES = {LOG_ERROR: "error", LOG_WARNING: "warning",
          LOG_INFO: "info", LOG_DEBUG: "debug"}


def default_log(level: int, msg: str) -> None:
    print(f"x264_tpu_torch [{_NAMES.get(level, 'unknown')}]: {msg}",
          file=sys.stderr)


_callback = default_log


def set_log_callback(cb) -> None:
    """Install a `cb(level: int, msg: str)` callback (None restores the
    stderr default) — the x264_param_t.pf_log slot."""
    global _callback
    _callback = cb if cb is not None else default_log


def log(level: int, msg: str, max_level: int = LOG_DEBUG) -> None:
    """Emit when `level` passes the param's i_log_level gate."""
    if level <= max_level:
        _callback(level, msg)
