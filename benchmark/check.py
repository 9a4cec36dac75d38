"""The comparison that decides `correct` in the eval cells.

For each sampled answer of the window (its inputs and what the timed path
returned, copied to the host), the plain reference's eval step
(`reference.nets.infer` over the architecture's network) runs once on the
same inputs, at the same batch, from the same weights and assets, in true
float32.  Each output key gives one number: over the sampled answers, the
largest absolute gap between the program's value and the reference's, as a
share of the largest magnitude of the reference's value.

The fusion family's body masks are a step function of the vertices: a
vertex on a pixel's edge lands on either side under two float32 orders of
the same sum.  So the benchmark taps each fusion stage's mask in the
program (`tap.<stage>`, a forward hook), and
  - the reference computes every answer from its own masks, and holds each
    tapped mask to the band of masks that its own vertices give when moved
    by up to `reference.nets.MASK_EDGE_PX` pixels (`mask.<stage>`: the
    share of pixels outside the band);
  - only where a tapped mask differs from the reference's own by more than
    rounding does the reference run that answer again, following the
    tapped masks in the stages after them, so that a vertex on an edge
    moves no later number; the band check then uses that run's bands.
    The notes count the answers that needed this.
Each number has a limit of its own in `limits/<workload>.json`.
"""

from __future__ import annotations

import contextlib

import torch

from .reference import nets

BAND_SLACK = 1e-6


def flatten(outputs: dict) -> dict:
    """An answer with its `recon` and `taps` dicts spread into
    recon.<name> and tap.<stage>."""
    flat = {k: v for k, v in outputs.items() if k not in ("recon", "taps")}
    for group, prefix in (("recon", "recon."), ("taps", "tap.")):
        for k, v in outputs.get(group, {}).items():
            flat[f"{prefix}{k}"] = v
    return flat


@contextlib.contextmanager
def tf32(enabled: bool):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def reference_outputs(run, inputs, use_tf32: bool = False, masks=None, bands: bool = False) -> dict:
    """The reference's outputs on the host for one call's inputs; `masks`
    ({stage: mask}) are tapped masks for it to follow."""
    dev = run.device
    if masks:
        masks = {k: v.to(dev, torch.float32) for k, v in masks.items()}
    with tf32(use_tf32):
        out = nets.infer(run.reference.network, run.weights, run.config, tuple(x.to(dev) for x in inputs),
                         run.assets, masks, bands)

    def host(v):
        return tuple(host(t) for t in v) if isinstance(v, tuple) else v.detach().to("cpu", torch.float64)
    return {k: host(v) for k, v in out.items()}


def _gap(g, ref):
    if g.shape != ref.shape:
        return float("inf")
    diff = float((g.to(torch.float64) - ref).abs().max())
    scale = float(ref.abs().max())
    return diff / scale if scale > 0 else diff


def _differs(tapped, own) -> bool:
    """Whether a tapped mask of the reference's shape differs from the
    reference's own mask by more than rounding."""
    return (own is not None and tapped.shape == own.shape
            and float((tapped.to(torch.float64) - own).abs().max()) > BAND_SLACK)


def answer_numbers(run, inputs, got: dict, use_tf32: bool = False):
    """(numbers, followed) of one answer (`got`: flattened, on the host):
    `followed` says whether the reference had to follow the answer's tapped
    masks.  A key that the answer lacks, or that reads NaN, reads inf."""
    want = reference_outputs(run, inputs, use_tf32, bands=True)
    taps = {k[len("tap."):]: v for k, v in got.items() if k.startswith("tap.")}
    followed = any(_differs(v, want.get(f"tap.{stage}")) for stage, v in taps.items())
    if followed:
        same_shape = {s: v for s, v in taps.items() if v.shape == want[f"tap.{s}"].shape}
        want = reference_outputs(run, inputs, use_tf32, masks=same_shape, bands=True)
    out = {}
    for k, ref in want.items():
        if k.startswith("band."):
            stage = k[len("band."):]
            tapped = got.get(f"tap.{stage}")
            if tapped is None or tapped.shape != ref[0].shape:
                out[f"mask.{stage}"] = float("inf")
                continue
            m = tapped.to(torch.float64)
            outside = (m < ref[0] - BAND_SLACK) | (m > ref[1] + BAND_SLACK)
            out[f"mask.{stage}"] = float(outside.double().mean())
        elif not k.startswith("tap."):
            out[k] = _gap(got[k], ref) if k in got else float("inf")
    return {k: (v if v == v else float("inf")) for k, v in out.items()}, followed


def compare(run, collected):
    """(the numbers of each answer, notes) over the collected (inputs,
    outputs) pairs; with mask taps, the notes count the answers whose
    reference followed the program's masks."""
    per_answer, followed = [], 0
    for inputs, got in collected:
        numbers, f = answer_numbers(run, inputs, flatten(got))
        per_answer.append(numbers)
        followed += f
    notes = {"followed_program_mask": followed, "answers_checked": len(per_answer)} if run.config.get("mask_taps") \
        else {}
    return per_answer, notes
