"""Logging and warning hygiene.

Reference parity: ``setup_logger()`` (loggers_configs.py:21-59) builds a
singleton logger with console DEBUG + ``logfile.log`` INFO handlers, attached on
rank 0 only (loggers_configs.py:35-38); ``suppress_warnings()``
(loggers_configs.py:102-121) filters noisy third-party warnings.

Here "rank 0" is ``jax.process_index() == 0``.
"""

from __future__ import annotations

import logging
import warnings
from pathlib import Path

_LOGGER_NAME = "gwen"


def _process_index() -> int:
    try:
        import jax

        return jax.process_index()
    except Exception:  # jax not initialised yet / no backend
        return 0


def setup_logger(
    log_file: str | Path = "logfile.log",
    console_level: int = logging.DEBUG,
    file_level: int = logging.INFO,
    force: bool = False,
) -> logging.Logger:
    """Create (once) the framework logger; handlers only on process 0."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers and not force:
        return logger
    if force:
        logger.handlers.clear()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if _process_index() == 0:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"
        )
        ch = logging.StreamHandler()
        ch.setLevel(console_level)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        try:
            fh = logging.FileHandler(log_file)
            fh.setLevel(file_level)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass  # read-only filesystem etc.
    else:
        logger.addHandler(logging.NullHandler())
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def suppress_warnings() -> None:
    """Silence known-noisy third-party warnings (reference loggers_configs.py:102-121)."""
    warnings.filterwarnings("ignore", message=".*experimental.*", module="jax.*")
    warnings.filterwarnings("ignore", category=DeprecationWarning, module="matplotlib.*")
    warnings.filterwarnings("ignore", category=UserWarning, module="matplotlib.*")
