"""Closed-loop eval batches through the eval CLI's entry.

One caller sends the pool's batches in turn (float32 NCHW host tensors,
as the eval loader yields them) to `make_inference_fn`'s step and sends
the next as soon as the call returns; the step copies each batch to the
card itself.  The window closes with a synchronize.

End-to-end: eval_images_per_s, all images of the calls made in the window
over the window's wall time.  Traced stretch: `trace_calls` more calls,
with a span around every forward call of the model.  The check compares
the last answer of `check` pool entries drawn from the seed with the eval
step of the plain reference (`check.py`).
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

from benchmark import check, program, trace, traffic_gen
from benchmark.readings import NETWORK_SPAN


def setup(run):
    model, infer = program.build_inference(run)
    pool = traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)
    for inputs in pool[: run.traffic["warm_calls"]]:
        infer(inputs)
    program.sync(run.device)
    return SimpleNamespace(run=run, model=model, infer=infer, pool=pool, last={}, calls=0)


def _call(state):
    i = state.calls % len(state.pool)
    state.last[i] = state.infer(state.pool[i])
    state.calls += 1


def measure(state, seconds):
    dev, batch = state.run.device, state.run.traffic["batch"]
    start_calls = state.calls
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _call(state)
    program.sync(dev)
    elapsed = time.perf_counter() - t0
    n = state.calls - start_calls
    return {"e2e": {"eval_images_per_s": n * batch / elapsed}, "attempted": n, "calls": n, "seconds": elapsed}


def trace_stretch(state):
    spans = trace.Spans(state.model, NETWORK_SPAN)
    try:
        for _ in range(state.run.traffic["trace_calls"]):
            _call(state)
        program.sync(state.run.device)
    finally:
        spans.remove()


def collect(state):
    """(inputs, outputs on the host) of the sampled pool entries' last calls."""
    rng = random.Random(state.run.seed)
    done = sorted(state.last)
    picked = rng.sample(done, min(state.run.traffic["check"], len(done)))
    return [(state.pool[i], program.to_host(state.last[i])) for i in sorted(picked)]


def release(state):
    state.model = state.infer = None
    state.last.clear()


def compare(run, collected):
    return check.compare(run, collected)
