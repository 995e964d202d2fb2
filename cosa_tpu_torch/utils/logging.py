"""Metrics aggregation + structured logging.

Twins of the reference's AverageMeter (utils/torch_helper.py:61-88), the
Texttable per-class IoU tables (:12-30) and the print-hijack logging system
(:193-208). Instead of hijacking builtins.print, a ``MetricWriter`` appends
JSONL records (host-0 only) and mirrors pretty lines to stdout + print.out.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist


class AverageMeter:
    def __init__(self, *keys: str):
        self._data: Dict[str, List[float]] = {k: [0.0, 0] for k in keys}

    def add(self, d: Dict[str, float]) -> None:
        for k, v in d.items():
            s = self._data.setdefault(k, [0.0, 0])
            s[0] += float(v)
            s[1] += 1

    def get(self, key: str) -> float:
        s = self._data[key]
        return s[0] / max(s[1], 1)

    def pop(self, key: Optional[str] = None):
        if key is None:
            for k in self._data:
                self._data[k] = [0.0, 0]
            return None
        v = self.get(key)
        self._data[key] = [0.0, 0]
        return v


class EMATracker:
    """utils/torch_helper.py:90-99."""

    def __init__(self, initial: float = 0.0, decay: float = 0.9):
        self.x = initial
        self.decay = decay

    def update(self, v: float) -> None:
        self.x = self.x * self.decay + v * (1 - self.decay)

    def get(self) -> float:
        return self.x


def is_host0() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def format_iou_table(
    scores: Sequence[Dict], names: Sequence[str], cat_list: Sequence[str]
) -> str:
    """ASCII per-class IoU table (reference format_tabs,
    utils/torch_helper.py:12-30). Returns the drawn table; the per-metric
    mIoU row is appended like the reference's."""
    vals = np.array(
        [[scores[i]["iou"][k] for k in sorted(scores[i]["iou"])] for i in range(len(names))]
    )
    vals = np.round(vals * 100, 2)
    rows = [["Class"] + list(names)]
    for ci, cname in enumerate(cat_list):
        rows.append([cname] + [f"{vals[m, ci]:.2f}" for m in range(len(names))])
    rows.append(["mIoU"] + [f"{np.nanmean(vals[m]):.2f}" for m in range(len(names))])
    widths = [max(len(str(r[c])) for r in rows) for c in range(len(rows[0]))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for r in rows:
        out.append(
            "|" + "|".join(f" {str(v):<{w}} " for v, w in zip(r, widths)) + "|"
        )
        out.append(sep)
    return "\n".join(out)


class MetricWriter:
    """JSONL metric log + mirrored console/file prints, host-0 gated."""

    def __init__(self, output_dir: str):
        self.dir = output_dir
        self.active = is_host0() and bool(output_dir)
        if self.active:
            os.makedirs(output_dir, exist_ok=True)
            self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
            self.printout = open(os.path.join(output_dir, "print.out"), "a")
        self.t0 = time.time()

    def log(self, record: Dict) -> None:
        if not self.active:
            return
        record = {k: _tofloat(v) for k, v in record.items()}
        record["wall_s"] = round(time.time() - self.t0, 2)
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()

    def print(self, *args) -> None:
        if not is_host0():
            return
        msg = " ".join(str(a) for a in args)
        print(msg, flush=True)
        if self.active:
            self.printout.write(msg + "\n")
            self.printout.flush()

    def close(self) -> None:
        if self.active:
            self.jsonl.close()
            self.printout.close()


def _tofloat(v):
    try:
        if isinstance(v, (str, bool, int)):
            return v
        arr = np.asarray(v)
        if arr.size == 1:
            return float(arr)
        return arr.tolist()
    except Exception:
        return str(v)


def eta_string(t0: float, cur_iter: int, total_iter: int) -> str:
    """Reference cal_eta (utils/torch_helper.py:44-54)."""
    elapsed = time.time() - t0
    scale = (total_iter - cur_iter) / max(float(cur_iter), 1.0)
    eta = datetime.timedelta(seconds=int(elapsed * scale))
    return f"{datetime.timedelta(seconds=int(elapsed))}", f"{eta}"
