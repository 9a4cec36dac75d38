"""Named spans for torch.profiler traces, and phase timing on the host's
clock.

`span(name)` marks a layer of the program in a trace: while a profiler is
recording it opens a `record_function` span, which lands in the same Kineto
trace as the kernels and copies launched inside it; otherwise it does
nothing beyond checking whether a profiler is on.  Spans nest on the
calling thread, so each span's parent in the trace is the span around it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` span while a profiler records, else a
    no-op context (an ungated `record_function` costs tens of times the
    check, and SMPLify runs `lbs` hundreds of times a step)."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    """Windowed-mean phase timer.

    Phase times are arithmetic means since the last `reset()`, not a running
    average: the first steps pay for cuDNN's algorithm search and the
    allocator's growth, and an average seeded by them would colour every
    later line.  The trainer resets the window at each summary, so each
    printed line is the mean of its own window.  Each phase is also a span
    named `<scope>.<phase>`.

        timer = StepTimer("train")
        with timer.phase("data"):
            batch = next(loader)
        with timer.phase("step"):
            state, metrics = train_step(state, batch)
        print(timer.summary()); timer.reset()
    """

    def __init__(self, scope: str):
        self.scope = scope
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
        with span(f"{self.scope}.{name}"):
            t0 = time.perf_counter()
            yield
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        return " ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.means.items()))
