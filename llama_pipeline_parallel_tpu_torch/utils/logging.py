"""Package logging: one stderr handler on the package's root logger."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "llama_pipeline_parallel_tpu_torch"
_FORMAT = "%(asctime)s %(levelname).1s [%(name)s] %(message)s"


def _configure_root() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("LPP_TPU_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return root


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
