"""Structured JSONL event log.

Copy of ``spearmint_tpu/utils/events.py`` (the port imports nothing of the JAX
package).

The reference's observability is timestamped prints + per-job .out files
(SURVEY.md §5.5); the rebuild adds an append-only ``events.jsonl`` in
the experiment dir: suggestion latency (the north-star metric), chain
statistics, dispatches, completions, best-so-far.  Append-only single
file, written under O_APPEND so concurrent runners interleave whole
lines without locking.
"""

from __future__ import annotations

import json
import os
import time


class EventLog:
    def __init__(self, expt_dir: str, filename: str = "events.jsonl"):
        self.path = os.path.join(expt_dir, filename)

    def emit(self, kind: str, **fields) -> None:
        rec = {"t": round(time.time(), 3), "kind": kind, **fields}
        line = json.dumps(rec, default=_jsonable) + "\n"
        fd = os.open(self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


def _jsonable(o):
    try:
        import numpy as np

        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return str(o)
