"""Error reporting (reference parity: error.py -> KLTError / KLTWarning).

The reference's error layer is a fatal error type and a stderr warning
printer. We keep the same two symbols so user code written against the
reference maps 1:1, but warnings go through the stdlib ``warnings`` module
so they can be filtered/asserted in tests.
"""

from __future__ import annotations

import sys
import warnings


class KLTError(RuntimeError):
    """Fatal error (reference parity: error.py -> KLTError)."""


class KLTWarningCategory(UserWarning):
    """Warning category used by :func:`KLTWarning`."""


# The reference prints progress by default (KLT_verbose = 1); here the
# default is quiet because each verbose completion line pulls a count from
# the device, which waits for every queued step. Call
# KLTSetVerbosity(1) for reference-style progress lines.
_verbosity = 0


def KLTSetVerbosity(level: int) -> None:
    """Set verbosity for progress prints (reference parity: klt.py -> KLTSetVerbosity)."""
    global _verbosity
    _verbosity = int(level)


def KLTGetVerbosity() -> int:
    return _verbosity


def KLTWarning(msg: str, *args) -> None:
    """Recoverable warning to stderr (reference parity: error.py -> KLTWarning)."""
    if args:
        msg = msg % args
    warnings.warn(msg, KLTWarningCategory, stacklevel=2)


def verbose_print(msg: str) -> None:
    """Progress line, printed only when verbosity > 0 (reference parity:
    klt.py -> KLT_verbose progress prints)."""
    if _verbosity > 0:
        print(msg, file=sys.stderr, flush=True)
