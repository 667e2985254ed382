"""Shared CLI plumbing: logging configuration, argument echo, strtobool.

Mirrors the uniform logging setup every reference CLI repeats
(`train.py:396-413`, `decode.py:206-219`, `feature_extract.py:334-351`).
"""

from __future__ import annotations

import argparse
import logging


def configure_logging(verbose: int) -> None:
    fmt = "%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s"
    datefmt = "%m/%d/%Y %I:%M:%S"
    if verbose == 1:
        logging.basicConfig(level=logging.INFO, format=fmt, datefmt=datefmt)
    elif verbose > 1:
        logging.basicConfig(level=logging.DEBUG, format=fmt, datefmt=datefmt)
    else:
        logging.basicConfig(level=logging.WARNING, format=fmt, datefmt=datefmt)
        logging.warning("logging is disabled.")


def echo_args(args: argparse.Namespace) -> None:
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))


def strtobool(v: str) -> bool:
    """distutils.util.strtobool equivalent (distutils is removed in 3.12)."""
    v = str(v).lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {v!r}")
