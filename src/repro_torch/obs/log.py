"""Shared ``repro`` logger hierarchy with structured key=value output
(PyTorch port of ``repro/obs/log.py``: the same logger names, so one
configuration covers both packages).

Every module logs through :func:`get_logger` (``repro.<subsystem>``
children of one root), so level configuration and formatting happen in
exactly one place instead of per-module ``logging.getLogger`` calls with
ad-hoc formats.  The formatter renders ``key=value`` pairs (the structured
fields ride ``logging``'s ``extra=`` mechanism via :func:`kv`), which grep
and log pipelines parse without a schema:

    log = get_logger("service")
    log.info("wave admitted %s", kv(jobs=3, capacity=4096, chunk=8))
    # 2026-08-09 12:00:00 INFO repro.service wave admitted jobs=3 ...

The level is env-configurable (``REPRO_LOG_LEVEL=DEBUG``) so a serving
deployment can flip verbosity without code changes; :func:`configure` is
idempotent and never touches the root logger (library etiquette — the
embedding application owns global logging).
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Optional

ROOT = "repro"
ENV_LEVEL = "REPRO_LOG_LEVEL"

_configured = False


def kv(**fields: Any) -> str:
    """Render structured fields as ``key=value`` pairs, space-joined.

    Values containing whitespace are repr-quoted so the line stays
    machine-splittable on spaces.
    """
    out = []
    for k, v in fields.items():
        s = f"{v:.6g}" if isinstance(v, float) else str(v)
        if any(c.isspace() for c in s):
            s = repr(s)
        out.append(f"{k}={s}")
    return " ".join(out)


class KeyValueFormatter(logging.Formatter):
    """``ts level logger message`` with exception text appended plainly."""

    default_msec_format = "%s.%03d"

    def __init__(self):
        super().__init__(
            fmt="%(asctime)s %(levelname)s %(name)s %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        )


def configure(level: Optional[str] = None, stream=None,
              force: bool = False) -> logging.Logger:
    """Attach the key=value handler to the ``repro`` root logger once.

    ``level`` overrides ``$REPRO_LOG_LEVEL`` (default WARNING, matching the
    stdlib default so importing the runtime stays silent).  ``force``
    re-applies handler + level (tests, or runtime level flips).
    """
    global _configured
    root = logging.getLogger(ROOT)
    if _configured and not force:
        return root
    lvl = level or os.environ.get(ENV_LEVEL) or "WARNING"
    root.setLevel(getattr(logging, str(lvl).upper(), logging.WARNING))
    if force:
        for h in list(root.handlers):
            if getattr(h, "_repro_obs", False):
                root.removeHandler(h)
    if not any(getattr(h, "_repro_obs", False) for h in root.handlers):
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(KeyValueFormatter())
        handler._repro_obs = True  # type: ignore[attr-defined]
        root.addHandler(handler)
    root.propagate = False  # one handler, no double lines via the stdlib root
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    """Child logger under the shared ``repro`` hierarchy.

    ``get_logger("runtime")`` -> ``repro.runtime``; a bare call returns the
    hierarchy root.  Ensures the hierarchy is configured (cheap after the
    first call), so call sites need no logging boilerplate.
    """
    configure()
    return logging.getLogger(f"{ROOT}.{name}" if name else ROOT)
