"""Each configuration's FLOP count against torch's FlopCounterMode run over
the benchmark's own reference, at a small size on the CPU: the network
(what runs inside the model's forward) and the whole eval call."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import BENCH
from benchmark import harness, smpl_assets, weights
from benchmark.reference import smpl as smpl_ref


def _count(config_name, batch, res, **changes):
    config = json.loads((BENCH / "configs" / f"{config_name}.json").read_text())
    config.update(img_res=res, **changes)
    traffic = {"batch": batch}
    flops = harness.load_module(BENCH / "flops" / f"{config_name}.py", f"flops_{config_name}").count(config, traffic)
    reference = harness.reference_module(BENCH.parent, config)
    w = weights.make_weights(reference.params(config), 5, "cpu")
    assets = smpl_assets.make_assets(config["smpl"], 5, "cpu")
    g = torch.Generator().manual_seed(5)
    inputs = tuple(torch.randn(batch, c, res, res, generator=g) for c in config["channels"])
    with torch.no_grad():
        with FlopCounterMode(display=False) as network:
            out = reference.network(w, config, inputs, assets)
        with FlopCounterMode(display=False) as tail:
            verts, _ = smpl_ref.lbs(assets, out["betas"], out["rotmat"])
            smpl_ref.regress_j17(assets, verts)
    return flops, network.get_total_flops(), network.get_total_flops() + tail.get_total_flops()


@pytest.mark.parametrize("config_name,batch,res,changes", [
    ("cashmrV2", 2, 64, {}),
    ("cashmrV2", 1, 96, {}),
    ("cashmrV2", 2, 64, {"final_recon": True}),
    ("ir_depth_pm_fusion", 2, 64, {}),
])
def test_flop_count_matches_flop_counter_mode(config_name, batch, res, changes):
    flops, network, step = _count(config_name, batch, res, **changes)
    assert flops["network"] == network
    assert flops["step"] == step


def test_full_size_counts():
    """The full-size figures PERF.md records (FlopCounterMode over the
    program counted 2,266.7 GFLOP for cashmrV2 at B=32)."""
    for name, traffic, want in (("cashmrV2", "eval.b32", 2266849600384), ("ir_depth_pm_fusion", "eval.b32",
                                                                           7353572948096)):
        config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
        got = harness.load_module(BENCH / "flops" / f"{name}.py", f"flops_full_{name}").count(config, t)
        assert got["step"] == want
