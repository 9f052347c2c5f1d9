"""TensorBoard scalar logging (a copy of mspl_tpu/utils/tb_logger.py).

tensorboardX is optional at import time; when unavailable the logger
degrades to a no-op so headless environments never fail on it.
"""

from __future__ import annotations

from typing import Optional


class ScalarLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self._writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._writer = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
