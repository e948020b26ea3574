"""Structured metrics writer, one JSON line per step or epoch (the port of
`dl4ss_tpu/train/metrics.py`): every scalar the reference tracks (losses,
lr, per-epoch SDR) lands greppable and plottable."""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._t0 = time.time()

    def write(self, kind: str, step: int, **scalars) -> dict:
        """Write (and print) one record; tensors and numpy scalars become
        Python numbers, floats rounded to 6 decimals."""
        rec = {"kind": kind, "step": int(step),
               "wall_s": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        print(line)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
