"""Logging for the framework.

Port of rtm_tpu/utils/logging.py: the reference's two-logger (engine/app) x
two-sink (stderr + a log file) layout (Engine/src/Engine/Core/Log.cpp:13-41)
with the ``file:line`` prefix the reference builds from compile-time
FileInfo defaults (Engine/src/Engine/Core/Utils.h:10-29).  Python's logging
module records the callsite, so this is configuration only.  RTM_LOG_LEVEL
sets the level and RTM_LOG_FILE adds the file sink.
"""
from __future__ import annotations

import logging
import os
import sys

_FMT = ("[%(asctime)s] %(name)s %(levelname)s %(filename)s:%(lineno)d: "
        "%(message)s")
_initialised = False


def _init() -> None:
    global _initialised
    if _initialised:
        return
    _initialised = True
    root = logging.getLogger("rtm")
    root.setLevel(os.environ.get("RTM_LOG_LEVEL", "INFO").upper())
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(logging.Formatter(_FMT))
    root.addHandler(stream)
    logfile = os.environ.get("RTM_LOG_FILE")
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FMT))
        root.addHandler(fh)
    root.propagate = False


def get_logger(name: str = "app") -> logging.Logger:
    """Two named loggers, mirroring the reference's ENGINE/APP split."""
    _init()
    return logging.getLogger(f"rtm.{name}")


def log_debug(msg, *a):
    get_logger().debug(msg, *a, stacklevel=2)


def log_info(msg, *a):
    get_logger().info(msg, *a, stacklevel=2)


def log_warn(msg, *a):
    get_logger().warning(msg, *a, stacklevel=2)


def log_error(msg, *a):
    get_logger().error(msg, *a, stacklevel=2)
