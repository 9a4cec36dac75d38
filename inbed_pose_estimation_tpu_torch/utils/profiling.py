"""Phase timing of the training loop on the host's clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StepTimer:
    """Windowed-mean phase timer.

    Phase times are arithmetic means since the last `reset()`, not a running
    average: the first steps pay for cuDNN's algorithm search and the
    allocator's growth, and an average seeded by them would colour every
    later line.  The trainer resets the window at each summary, so each
    printed line is the mean of its own window.

        timer = StepTimer()
        with timer.phase("data"):
            batch = next(loader)
        with timer.phase("step"):
            state, metrics = train_step(state, batch)
        print(timer.summary()); timer.reset()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @property
    def means(self) -> Dict[str, float]:
        """Seconds per entry of each phase in the current window."""
        return {k: self.totals[k] / self.counts[k] for k in self.totals if self.counts[k]}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        return " ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.means.items()))
