"""Logging for facenet_tpu_torch: one stdlib logger with a console sink,
and a file sink a run adds for its log file (`configure_logging`)."""

from __future__ import annotations

import logging as _logging
import sys
from pathlib import Path

_FORMAT = '%(asctime)s | %(levelname)-7s | %(name)s - %(message)s'

logger = _logging.getLogger('facenet_tpu_torch')
logger.setLevel(_logging.INFO)

if not logger.handlers:  # console sink once
    _console = _logging.StreamHandler(sys.stderr)
    _console.setFormatter(_logging.Formatter(_FORMAT))
    logger.addHandler(_console)


def add_file_sink(file):
    """Add a file sink to the package's logger; returns the handler."""
    file = Path(file).expanduser()
    file.parent.mkdir(parents=True, exist_ok=True)
    handler = _logging.FileHandler(str(file))
    handler.setFormatter(_logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    return handler


def remove_file_sink(handler):
    """Detach and close a sink `add_file_sink` returned."""
    logger.removeHandler(handler)
    handler.close()


def configure_logging(cfg):
    """The run's log file: `cfg` has ``.dir`` and ``.file`` (an app
    config's ``logs`` section); the sink writes ``dir/file``."""
    return add_file_sink(Path(str(cfg.dir)) / str(cfg.file))
