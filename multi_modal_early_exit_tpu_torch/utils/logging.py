"""ANSI-colored one-shot logger (reference: EE/utils.py:26-30, 275-293)."""

from __future__ import annotations

import logging

LOGGING_FORMATS = {
    "info": "\x1b[6;30;42m%(asctime)s - %(name)s - %(levelname)s - %(message)s\x1b[0m",
    "error": "\x1b[6;30;41m%(asctime)s - %(name)s - %(levelname)s - %(message)s\x1b[0m",
    "warning": "\x1b[6;30;43m%(asctime)s - %(name)s - %(levelname)s - %(message)s\x1b[0m",
}


def logger_message(message: str, type: str = "info") -> logging.Logger:
    """Emit one colored log line; handler attached and removed per call."""
    logger = logging.getLogger("multi_modal_early_exit_tpu_torch")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler()
    handler.setLevel(logging.INFO)
    handler.setFormatter(logging.Formatter(LOGGING_FORMATS.get(type, LOGGING_FORMATS["info"])))
    logger.addHandler(handler)
    try:
        if type == "error":
            logger.error(message)
        elif type == "warning":
            logger.warning(message)
        else:
            logger.info(message)
    finally:
        logger.removeHandler(handler)
    return logger
