"""The program against the benchmark's plain reference at a tiny size on
the CPU, and the faults that `correct` must catch: a whole run with the
timed path broken underneath (the harness's look for a card skipped by
running on the CPU) reads `correct` false."""

from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import run_tiny, tiny_root

EVAL_CELLS = ("cashmrV2.eval.b32", "ir_depth_pm_fusion.eval.b32")


@pytest.mark.parametrize("workload", EVAL_CELLS)
def test_program_matches_the_reference(tmp_path, workload):
    result = run_tiny(tiny_root(tmp_path), workload)
    assert result["correct"] is True, result["check"]
    for name, c in result["check"].items():
        assert c["value"] <= 1e-6, name  # the same float32 arithmetic on the CPU


def _half_batch(infer):
    """The first half of the rows computed, the rest given their mean."""
    def broken(inputs):
        B = inputs[0].shape[0]
        half = B // 2
        out = infer(tuple(x[:half] for x in inputs))

        def fill(t):
            mean = t.mean(dim=0, keepdim=True)
            return torch.cat([t, mean.expand(B - half, *t.shape[1:])], dim=0)
        return {k: ({kk: fill(vv) for kk, vv in v.items()} if isinstance(v, dict) else fill(v))
                for k, v in out.items()}
    return broken


def _answer_altered(infer):
    """One joint of one answer moved by 5 mm where it is produced."""
    def broken(inputs):
        out = infer(inputs)
        out["keypoints_3d_17"][0, 3, 1] += 0.005
        return out
    return broken


@pytest.mark.parametrize("workload", EVAL_CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    result = run_tiny(tiny_root(tmp_path), workload, wrap=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_limits_cover_exactly_the_compared_numbers(tmp_path):
    root = tiny_root(tmp_path)
    for workload in EVAL_CELLS:
        limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
        assert set(run_tiny(root, workload)["check"]) == set(limits)


def test_the_reference_follows_a_tapped_mask_only_where_it_differs(tmp_path):
    """The reference's own answer reads 0 and follows nothing; a mask that
    differs by less than rounding is not followed; one pixel flipped is
    followed and read outside the band."""
    from benchmark import check, harness, traffic_gen

    run = harness.make_cell(tiny_root(tmp_path), "ir_depth_pm_fusion.eval.b32", 2**31 + 5, "cpu").run
    inputs = traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)[0]
    own = check.reference_outputs(run, inputs)
    numbers, followed = check.answer_numbers(run, inputs, own)
    assert not followed and max(numbers.values()) == 0.0
    rounded = dict(own, **{"tap.guide": own["tap.guide"] + 1e-9})
    assert check.answer_numbers(run, inputs, rounded)[1] is False
    flipped = own["tap.guide"].clone()
    H = flipped.shape[-1]
    flipped[0, ..., H // 2, H // 2] = 1.0 - flipped[0, ..., H // 2, H // 2]
    numbers, followed = check.answer_numbers(run, inputs, dict(own, **{"tap.guide": flipped}))
    assert followed and numbers["mask.guide"] > 0.0
