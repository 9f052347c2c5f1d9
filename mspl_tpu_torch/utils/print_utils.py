"""Colored console printing helpers (a copy of
mspl_tpu/utils/print_utils.py).

Mirrors the reference's `utilities/print_utils.py` surface (SURVEY.md §2,
"Logging/printing"): info / log / warning / error message printers used
throughout the training scripts, re-implemented from scratch.
"""

from __future__ import annotations

import sys
import time

_COLORS = {
    "info": "\033[92m",  # green
    "log": "\033[94m",  # blue
    "warning": "\033[93m",  # yellow
    "error": "\033[91m",  # red
    "end": "\033[0m",
}


def _stamp() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def _emit(kind: str, message: str, file=None) -> None:
    color, end = _COLORS[kind], _COLORS["end"]
    print(f"{color}{_stamp()} - {kind.upper():7s} - {message}{end}", file=file or sys.stdout)


def print_info_message(message: str) -> None:
    _emit("info", message)


def print_log_message(message: str) -> None:
    _emit("log", message)


def print_warning_message(message: str) -> None:
    _emit("warning", message)


def print_error_message(message: str) -> None:
    """Print an error and exit — matches the reference's fail-fast behavior."""
    _emit("error", message, file=sys.stderr)
    raise SystemExit(1)
