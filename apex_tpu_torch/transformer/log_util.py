"""Transformer loggers under ``apex_tpu_torch.transformer.*``.

The port's counterpart of ``apex_tpu/transformer/log_util.py``."""

from __future__ import annotations

import logging
import os
from typing import Union

__all__ = ["get_transformer_logger", "set_logging_level"]


def get_transformer_logger(name: str) -> logging.Logger:
    name_wo_ext = os.path.splitext(name)[0]
    logger = logging.getLogger(f"apex_tpu_torch.transformer.{name_wo_ext}")
    # library-import hygiene: without any handler in the hierarchy,
    # the first log record prints a bare "No handlers could be found"
    # warning to stderr.  A NullHandler on the subtree root silences
    # that default while leaving real handlers (the apex_tpu_torch root
    # handler, or whatever the application installs) fully in charge.
    root = logging.getLogger("apex_tpu_torch.transformer")
    if not any(isinstance(h, logging.NullHandler) for h in root.handlers):
        root.addHandler(logging.NullHandler())
    return logger


def set_logging_level(verbosity: Union[int, str]) -> None:
    """Set the ``apex_tpu_torch.transformer`` subtree's logging level.

    ``verbosity`` must be an int (e.g. ``logging.INFO``/``20``) or a
    standard level name (``"DEBUG"``, ``"info"``, ... —
    case-insensitive).  Anything else raises instead of being handed
    to ``Logger.setLevel`` unvalidated: an arbitrary object would
    otherwise surface as a confusing ``TypeError`` deep inside the first
    log call."""
    if isinstance(verbosity, bool):
        # bool is an int subclass; True as a log level is a caller bug
        raise TypeError(
            f"verbosity must be an int level or level name, got "
            f"{verbosity!r}"
        )
    if isinstance(verbosity, str):
        level = logging.getLevelName(verbosity.upper())
        if not isinstance(level, int):
            raise ValueError(
                f"unknown logging level name {verbosity!r}; expected "
                "one of CRITICAL/ERROR/WARNING/INFO/DEBUG/NOTSET"
            )
        verbosity = level
    elif not isinstance(verbosity, int):
        raise TypeError(
            f"verbosity must be an int level or level name, got "
            f"{type(verbosity).__name__}"
        )
    logging.getLogger("apex_tpu_torch.transformer").setLevel(verbosity)
