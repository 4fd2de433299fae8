"""Run artifacts and structured metrics.

The port's own copy of ``xnode_wan_tpu/utils/logging.py::RunLogger``, with
the same artifact names and schemas (reference
``src/training.py:140-141,169-174``):

* ``losses_NODE_<dim>.json``: list of per-iteration primal losses;
* ``L2_NODE_<dim>.json``: list of per-iteration L^p errors;
* ``Time_NODE_<dim>.json``: wall-clock stamps, one at construction and one
  per iteration;

plus ``metrics_NODE_<dim>.jsonl`` with one JSON object per iteration
(``step``, ``time`` and every metric). The jsonl gets the records since
the previous flush appended every ``_FLUSH_EVERY`` iterations; the three
list artifacts are rewritten on :meth:`RunLogger.flush` and every
``_FULL_FLUSH_EVERY`` jsonl flushes, so a crashed run still leaves them.
With ``write=False`` (a rank past the first of a mesh) it keeps the same
lists and writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

_FLUSH_EVERY = 25        # iterations between jsonl appends
_FULL_FLUSH_EVERY = 10   # jsonl appends between rewrites of the lists

class RunLogger:
    def __init__(self, dim: int, work_dir: str = "./", write: bool = True):
        self.dim = dim
        self.work_dir = work_dir
        self.write = write
        self.losses: List[float] = []
        self.l2s: List[float] = []
        self.times: List[float] = [time.time()]
        self._records: List[dict] = []
        self._jsonl_written = 0
        self._n_flushes = 0
        if write:
            os.makedirs(work_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.work_dir, name)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.losses.append(float(metrics.get("loss_u", float("nan"))))
        if "L2" in metrics:
            self.l2s.append(float(metrics["L2"]))
        self.times.append(time.time())
        self._records.append({"step": step, "time": self.times[-1],
                              **{k: float(v) for k, v in metrics.items()}})
        if self.write and (step + 1) % _FLUSH_EVERY == 0:
            self._flush_jsonl()
            self._n_flushes += 1
            if self._n_flushes % _FULL_FLUSH_EVERY == 0:
                self._write_lists()

    def _flush_jsonl(self) -> None:
        """Append the records since the last flush."""
        new = self._records[self._jsonl_written:]
        if not new:
            return
        mode = "a" if self._jsonl_written else "w"
        with open(self._path(f"metrics_NODE_{self.dim}.jsonl"), mode) as fh:
            for rec in new:
                fh.write(json.dumps(rec) + "\n")
        self._jsonl_written = len(self._records)

    def _write_lists(self) -> None:
        with open(self._path(f"losses_NODE_{self.dim}.json"), "w") as fh:
            json.dump(self.losses, fh)
        with open(self._path(f"L2_NODE_{self.dim}.json"), "w") as fh:
            json.dump(self.l2s, fh)
        with open(self._path(f"Time_NODE_{self.dim}.json"), "w") as fh:
            json.dump(self.times, fh)

    def flush(self) -> None:
        """The jsonl tail and the whole-history list artifacts."""
        if not self.write:
            return
        self._flush_jsonl()
        self._write_lists()
