"""The training summaries: scalars as JSON lines.

The JAX package's CLI writes them with `tensorboardX.SummaryWriter`, which
the card machine does not have; this writer takes the same
`add_scalar(tag, value, step)` calls and appends one JSON object per scalar
to `<summary_dir>/scalars.jsonl`:

    {"tag": "loss", "value": 12.3, "step": 25, "time": 1760000000.0}
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, summary_dir: str):
        os.makedirs(summary_dir, exist_ok=True)
        self.path = os.path.join(summary_dir, "scalars.jsonl")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "time": time.time()}) + "\n")
