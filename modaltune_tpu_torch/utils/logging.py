"""Local experiment logging: JSONL metrics + stdout, replacing the
reference's wandb usage (``utils/base_trainer.py:365-377,438-440``;
wandb is unavailable in this environment). Keeps the same observable
artifacts: per-epoch metric rows, run summary with best values, and a
``config.json`` dump in the run directory."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / f"{run_name}_metrics.jsonl"
        self.summary: Dict[str, float] = {}

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        row = {"_time": time.time()}
        if step is not None:
            row["_step"] = step
        row.update({k: v for k, v in metrics.items()
                    if isinstance(v, (int, float, str, bool))})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        parts = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in row.items() if not k.startswith("_")]
        prefix = f"[step {step}] " if step is not None else ""
        print(prefix + " ".join(parts), flush=True)
        # track max for known higher-is-better metrics, min for losses
        for k, v in metrics.items():
            if not isinstance(v, (int, float)):
                continue
            if "loss" in k:
                cur = self.summary.get(k, float("inf"))
                self.summary[k] = min(cur, v)
            else:
                cur = self.summary.get(k, float("-inf"))
                self.summary[k] = max(cur, v)

    def dump_summary(self) -> None:
        with open(self.out_dir / "summary.json", "w") as f:
            json.dump(self.summary, f, indent=2)


def dump_config(out_dir: str, config: Dict) -> None:
    """config.json dump like ``base_trainer.py:61-68``."""
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    with open(p / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
