"""Component loggers (a copy of ``kubeshare_tpu/utils/logger.py``).

Every component logs with a fixed ``"YYYY-mm-dd HH:MM:SS LEVL:
file:line msg"`` layout, to stderr and optionally to
``<log_dir>/<component>.log``. Verbosity is an integer 0..3 mapping to
WARNING..DEBUG, as the reference's ``--level`` flag.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG, 3: logging.DEBUG}

_FMT = "%(asctime)s %(levelname).4s: %(filename)s:%(lineno)d %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def get_logger(
    component: str,
    level: int = 1,
    log_dir: Optional[str] = None,
    stderr: bool = True,
) -> logging.Logger:
    """Create (or reconfigure) the logger for one component."""
    logger = logging.getLogger(f"kubeshare_tpu_torch.{component}")
    logger.setLevel(_LEVELS.get(level, logging.DEBUG))
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter(_FMT, datefmt=_DATEFMT)
    if stderr:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{component}.log"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
