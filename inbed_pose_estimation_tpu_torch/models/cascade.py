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
    skips its decoders.  A pass whose output has a `carry` (a
    `MultiTrunkCore` in eval) hands it to the next pass as
    `apply_fn(..., carry=...)`; the other models carry none and are handed
    none.  Returns the per-stage outputs, last one final, without their
    carry, so that nothing of it outlives the cascade.
    """
    outs: List[HMROutput] = []
    current = list(inputs)
    carry = None
    n = max(int(num_cas_iters), 1)
    for stage in range(n):
        kw = {} if carry is None else {"carry": carry}
        if stage == n - 1 and not final_recon:
            kw["compute_recon"] = False
        out = apply_fn(tuple(current), **kw)
        carry = out.carry
        outs.append(out if carry is None else out._replace(carry=None))
        for name, slot in feed_map:
            if name in out.recon:
                current[slot] = out.recon[name]
    return outs
