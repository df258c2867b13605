"""Pluggable metrics sink: stdout + JSONL, optional wandb.

Replaces the reference's hard dependency on wandb (train_gan.py:28-42 etc.)
with a sink that always logs locally and forwards to wandb only when the
library is importable and WANDB_MODE is configured.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsSink:
    def __init__(self, exp_name: str, out_dir: str = ".", use_wandb: bool = False, config: Optional[dict] = None):
        self.exp_name = exp_name
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"metrics_{exp_name}.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project="B2H-H2S", name=exp_name, id=exp_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # offline/unavailable: local logging only
                print(f"[metrics] wandb unavailable ({e}); logging locally", flush=True)
        if config:
            self.log({"event": "config", **config})

    def log(self, metrics: dict):
        rec = {"t": time.time(), **metrics}
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in metrics.items() if k != "event"})

    def save_file(self, path: str):
        if self._wandb is not None:
            self._wandb.save(path)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullSink:
    """A sink that records nothing (the ranks but 0 of a multi-process run)."""

    def log(self, metrics: dict):
        pass

    def save_file(self, path: str):
        pass

    def close(self):
        pass
