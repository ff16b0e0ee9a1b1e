"""Shared CLI plumbing."""
from __future__ import annotations

import logging


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(format="[%(levelname)s]: %(message)s", level=level)
