"""The library logger bare ``print()`` calls route through (raftlint R10).

Library modules of the package must not print directly: output from a
serving thread, a data-loader worker or a training loop belongs on stderr
with a stable prefix, where a caller (or test harness) can redirect or
silence it.  CLI entry points (``cli.py``, ``main``/``*_cli`` functions,
``tools/`` scripts) keep printing — their stdout IS the product.

Deliberately tiny: stdlib ``logging`` with one stderr handler and a
``[raft.<name>]`` prefix, configured once, never propagating into the root
logger (so embedding applications keep control of their own logging).
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(name)s] %(message)s"


def get_logger(name: str) -> logging.Logger:
    """A ``raft.<name>`` logger writing ``[raft.<name>] msg`` to stderr.

    Idempotent — repeated calls return the same configured logger; INFO
    level by default so library chatter is visible but filterable
    (``logging.getLogger("raft").setLevel(logging.WARNING)`` silences the
    whole stack at once).
    """
    logger = logging.getLogger(f"raft.{name}")
    root = logging.getLogger("raft")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger
