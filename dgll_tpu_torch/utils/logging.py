"""Logging. Counterpart of ``dgll_tpu/utils/logging.py``: a file INFO logger or a
console logger, plus a rank prefix for multi-process runs.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional


def get_logger(file_name: Optional[str] = None, level: int = logging.INFO,
               rank: Optional[int] = None) -> logging.Logger:
    name = f"dgll_tpu_torch{'' if rank is None else f'.r{rank}'}"
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        f"%(asctime)s {'' if rank is None else f'[rank {rank}] '}%(levelname)s %(message)s"
    )
    if file_name:
        h: logging.Handler = logging.FileHandler(file_name)
        h.setLevel(level)
    else:
        h = logging.StreamHandler(sys.stderr)
        h.setLevel(level)
    h.setFormatter(fmt)
    logger.addHandler(h)
    logger.propagate = False
    return logger
