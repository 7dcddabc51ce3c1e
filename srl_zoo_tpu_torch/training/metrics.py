"""Per-epoch loss history and per-step jsonl records (port of
``srl_zoo_tpu/training/metrics.py`` ``MetricsLogger``, without TensorBoard).

``loss_history.npz`` holds ``epoch`` and ``train/<metric>`` /
``val/<metric>`` arrays, one entry per epoch; ``metrics.jsonl`` one record
per logged step (``step``, ``time``, the metrics and any extras). A resumed
run continues the history and drops the records of the epochs it runs
again.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np

HISTORY_FILE = "loss_history.npz"
JSONL_FILE = "metrics.jsonl"


class MetricsLogger:
    def __init__(self, log_folder: str):
        self.log_folder = log_folder
        os.makedirs(log_folder, exist_ok=True)
        self._jsonl = open(os.path.join(log_folder, JSONL_FILE), "a")
        self.history: Dict[str, list] = defaultdict(list)
        hist_path = os.path.join(log_folder, HISTORY_FILE)
        if os.path.exists(hist_path):
            try:
                with np.load(hist_path) as z:
                    for k in z.files:
                        self.history[k] = z[k].tolist()
            except (OSError, ValueError):
                self.history = defaultdict(list)  # corrupt: start fresh
        self._t0 = time.time()
        self._jsonl_deduped = False

    def log_step(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        rec.update({k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in extra.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def _truncate_jsonl(self, epoch: int) -> None:
        """Drop the records of ``epoch`` and later (a crashed attempt's),
        which a resumed run writes again."""
        path = os.path.join(self.log_folder, JSONL_FILE)
        self._jsonl.close()
        kept = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail of a crash mid-write
                    if not isinstance(rec.get("epoch"), (int, float)) \
                            or rec["epoch"] < epoch:
                        kept.append(line)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.writelines(kept)
            os.replace(tmp, path)
        finally:
            self._jsonl = open(path, "a")

    def log_epoch(self, epoch: int, train_metrics: Dict[str, float],
                  val_metrics: Dict[str, float]) -> None:
        if not self._jsonl_deduped:
            self._jsonl_deduped = True
            self._truncate_jsonl(epoch)
        epochs = self.history.get("epoch", [])
        if epochs and epoch <= epochs[-1]:
            keep = sum(1 for e in epochs if e < epoch)
            for k in self.history:
                self.history[k] = self.history[k][:keep]
            self._truncate_jsonl(epoch)
        self.history["epoch"].append(epoch)
        for k, v in train_metrics.items():
            self.history[f"train/{k}"].append(float(v))
        for k, v in val_metrics.items():
            self.history[f"val/{k}"].append(float(v))
        self.save_history()  # durable per epoch

    def save_history(self) -> str:
        path = os.path.join(self.log_folder, HISTORY_FILE)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # a file handle: savez adds no suffix
            np.savez(f, **{k: np.asarray(v) for k, v in self.history.items()})
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        self._jsonl.close()
