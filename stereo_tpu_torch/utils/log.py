"""Structured logging, as ``stereo_tpu/utils/log.py``.

Per-module loggers under the "stereo_tpu_torch" root; ``setup()``
configures a stderr handler once (the CLI calls it; library users keep
control of their own logging config). The level comes from ``setup``'s
argument, else from ``STEREO_TPU_LOG``, else INFO. Structured per-run
records are the JSONL files the eval harness writes; logging here is for
human-readable progress and diagnostics.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"stereo_tpu_torch.{name}")


def setup(level: str | int | None = None) -> None:
    """Attach a stderr handler to the package root logger (idempotent)."""
    global _CONFIGURED
    root = logging.getLogger("stereo_tpu_torch")
    if level is None:
        level = os.environ.get("STEREO_TPU_LOG", "INFO")
    root.setLevel(level)
    if _CONFIGURED:
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"
        )
    )
    root.addHandler(handler)
    _CONFIGURED = True
