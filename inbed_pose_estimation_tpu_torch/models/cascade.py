"""The depth-feedback cascade (cashmrV2's multi-pass refinement)."""

from __future__ import annotations

from typing import Callable, List, Sequence

from .hmr import HMROutput


def cascade_apply(
    apply_fn: Callable[..., HMROutput],
    inputs: Sequence,
    num_cas_iters: int,
    feed_map: Sequence[tuple] = (("depth", 2),),
    final_recon: bool = True,
) -> List[HMROutput]:
    """Run `num_cas_iters` forward passes (at least one).

    apply_fn: (modality tuple, **kw) -> HMROutput.  After each pass, every
    reconstruction named in `feed_map` replaces its input slot (cashmrV2:
    recovered depth into slot 2).  With `final_recon=False` the last pass
    skips its decoders.  Returns the per-stage outputs, last one final.
    """
    outs: List[HMROutput] = []
    current = list(inputs)
    n = max(int(num_cas_iters), 1)
    for stage in range(n):
        if stage == n - 1 and not final_recon:
            out = apply_fn(tuple(current), compute_recon=False)
        else:
            out = apply_fn(tuple(current))
        outs.append(out)
        for name, slot in feed_map:
            if name in out.recon:
                current[slot] = out.recon[name]
    return outs
