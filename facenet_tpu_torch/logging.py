"""Logging for facenet_tpu_torch: one stdlib logger with a console sink."""

from __future__ import annotations

import logging as _logging
import sys

_FORMAT = '%(asctime)s | %(levelname)-7s | %(name)s - %(message)s'

logger = _logging.getLogger('facenet_tpu_torch')
logger.setLevel(_logging.INFO)

if not logger.handlers:  # console sink once
    _console = _logging.StreamHandler(sys.stderr)
    _console.setFormatter(_logging.Formatter(_FORMAT))
    logger.addHandler(_console)

