"""Logging for audiotoken_tpu_torch: one stderr handler per logger."""

import logging
import sys

_FORMAT = (
    "%(asctime)s | %(processName)s | %(levelname)-8s | "
    "%(filename)s:%(lineno)d | %(message)s"
)


def get_logger(name: str, level="WARNING") -> logging.Logger:
    """Return ``name``'s logger, writing ``level`` and above to stderr (the
    training tools log their progress at INFO).

    The handler is installed once per logger, however often this is called."""
    logger = logging.getLogger(name)
    if getattr(logger, "_audiotoken_configured", False):
        return logger
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(level)
    console.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.setLevel(logging.DEBUG)
    logger.addHandler(console)
    logger.propagate = False
    logger._audiotoken_configured = True  # type: ignore[attr-defined]
    return logger
