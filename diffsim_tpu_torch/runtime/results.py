"""Incremental JSONL result store with resume (the port's copy of
``diffsim_tpu/runtime/results.py``).

Every scored comparison is appended to a JSONL file as it completes; re-running with the same
path skips the completed indices.
"""

from __future__ import annotations

import json
import os


class ResultLog:
    def __init__(self, path: str | None):
        self.path = path
        self._done: dict[int, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._done[rec["idx"]] = rec
        self._fh = open(path, "a") if path else None

    @property
    def done(self) -> dict[int, dict]:
        return self._done

    def record(self, idx: int, **fields):
        rec = {"idx": idx, **fields}
        self._done[idx] = rec
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
