"""Logging helpers (counterpart of ``torecsys_tpu/utils/logging.py``).

``TqdmHandler`` is a logging handler that interleaves log records with
active tqdm progress bars via ``tqdm.write``, so bars are not corrupted by
log lines.  Where ``tqdm`` is not installed it writes to stderr.
"""

from __future__ import annotations

import logging
import sys


class TqdmHandler(logging.Handler):
    """Route log records through ``tqdm.write`` (falls back to stderr).

    Drop-in for a ``StreamHandler``::

        handler = TqdmHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logging.getLogger().addHandler(handler)

    Like every logging handler it never raises: a failure goes to
    ``handleError``.
    """

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            try:
                from tqdm import tqdm
            except ImportError:
                sys.stderr.write(msg + "\n")
            else:
                tqdm.write(msg, file=sys.stderr)
            self.flush()
        except Exception:  # noqa: BLE001 - logging must never raise
            self.handleError(record)


__all__ = ["TqdmHandler"]
