"""Logging setup: stdlib logging, one line per event, configured once per
process (mirror of ``cosmos_curate_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "cosmos_curate_tpu_torch"
_CONFIGURED = False


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("CURATE_LOG_LEVEL", "INFO").upper()
    # logging.getLevelNamesMapping is 3.11+; the project floor is 3.10
    if hasattr(logging, "getLevelNamesMapping"):
        known_levels = set(logging.getLevelNamesMapping())
    else:
        known_levels = set(logging._nameToLevel)
    if level not in known_levels:
        print(f"{_ROOT}: unknown CURATE_LOG_LEVEL={level!r}; using INFO", file=sys.stderr)
        level = "INFO"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s.%(msecs)03d | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s",
            datefmt="%H:%M:%S",
        )
    )
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
