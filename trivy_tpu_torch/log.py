"""Logging facade, the port of ``trivy_tpu/log.py``: per-subsystem loggers
under one root, configured once by the CLI (``--debug``/``-d``,
``--quiet``, ``--log-format plain|json``). The JSON format writes one
object per line (``ts``, ``level``, ``subsystem``, ``msg``, the active
scan's ``trace_id``, ``exc``) with the JAX package's keys and subsystem
names, so one collector reads both packages' lines.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_ROOT_NAME = "trivy_tpu_torch"


def logger(prefix: str | None = None) -> logging.Logger:
    """Return the package logger, optionally namespaced by subsystem."""
    name = _ROOT_NAME if not prefix else f"{_ROOT_NAME}.{prefix}"
    return logging.getLogger(name)


class _JSONFormatter(logging.Formatter):
    """One JSON object per line:
    {"ts", "level", "subsystem", "msg", "trace_id"}."""

    def format(self, record: logging.LogRecord) -> str:
        subsystem = record.name
        if subsystem.startswith(_ROOT_NAME):
            subsystem = subsystem[len(_ROOT_NAME):].lstrip(".") or "root"
        doc = {
            # UTC with an explicit Z: collectors correlating logs across
            # hosts must not have to guess the zone
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int((record.created % 1) * 1000):03d}Z",
            "level": record.levelname,
            "subsystem": subsystem,
            "msg": record.getMessage(),
        }
        # the active scan's trace id (a server handler joins the client's
        # trace, so its lines carry the client's id); imported late, as the
        # span layer logs through this module
        try:
            from trivy_tpu_torch import obs

            doc["trace_id"] = obs.current().trace_id
        except Exception:
            pass
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def init(debug: bool = False, quiet: bool = False, stream=None, fmt: str = "plain") -> None:
    """Configure the root package logger (re-configuration replaces the
    previous handler): errors only with ``quiet``, else debug lines with
    ``debug``; ``fmt`` ``json`` for one JSON object per line."""
    root = logging.getLogger(_ROOT_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    if fmt == "json":
        handler.setFormatter(_JSONFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s", "%H:%M:%S"))
    root.addHandler(handler)
    root.setLevel(logging.ERROR if quiet else logging.DEBUG if debug else logging.INFO)
    root.propagate = False
