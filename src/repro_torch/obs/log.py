"""Structured logging for driver diagnostics.

The round drivers' operational diagnostics (async quorum caps, the
rotating+EF staleness caveat, the Dirichlet pad blowup) route through
one module-level logger — ``logging.getLogger("repro_torch.obs")`` —
with structured context (round, optimizer, policy spec, ...) appended
as ``key=value`` pairs, so a host application can attach a
handler/filter once and see every driver diagnostic in one stream.

``warn_with_context`` keeps the warning *API-visible*: it emits BOTH
the structured log record and a real ``warnings.warn`` (same category,
caller-relative stacklevel), because these conditions are observable
through the warnings machinery (``pytest.warns``, ``-W error``) — the
logger is an addition, not a replacement.
"""
from __future__ import annotations

import logging
import warnings

logger = logging.getLogger("repro_torch.obs")
# library default: silent unless the host application configures
# logging (the stdlib "last resort" handler would print WARNINGs twice
# next to the warnings machinery we keep emitting)
logger.addHandler(logging.NullHandler())


def format_context(context: dict) -> str:
    """Render structured context as a stable ``key=value`` suffix."""
    return " ".join(f"{k}={v}" for k, v in sorted(context.items())
                    if v is not None)


def log_with_context(level: int, msg: str, **context) -> None:
    """Emit one structured log record; context rides both in the message
    suffix and machine-readable on ``record.context``."""
    suffix = format_context(context)
    logger.log(level, "%s%s", msg, f" [{suffix}]" if suffix else "",
               extra={"context": context})


def warn_with_context(msg: str, *, category=UserWarning, stacklevel: int = 2,
                      **context) -> None:
    """Structured log record AND an API-visible ``warnings.warn``.

    ``stacklevel`` is relative to the *caller* of this helper (2 points
    the warning at that caller's call site, matching a direct
    ``warnings.warn(..., stacklevel=2)`` there).
    """
    log_with_context(logging.WARNING, msg, **context)
    warnings.warn(msg, category=category, stacklevel=stacklevel + 1)


def debug(msg: str, **context) -> None:
    log_with_context(logging.DEBUG, msg, **context)


def info(msg: str, **context) -> None:
    log_with_context(logging.INFO, msg, **context)
