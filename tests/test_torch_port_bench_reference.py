"""PyTorch port against the benchmark's plain reference of featatt_cashmr
(`benchmark/reference/multi_trunk_cascade.py`) on the CPU, RES 64, batch
2: the reference's parameters, drawn by `benchmark/weights.py` with the
cross attention's gains non-zero, load strictly into the registered model,
and the eval step that `benchmark/program.py` builds from it
(`build_model` -> `make_inference_fn`) gives the reference's answers to
1e-6 of their largest magnitude.  The control: the same model with its
gains zeroed, where the cross attention is the identity, misses by more."""

import json
import pathlib

import torch

from benchmark import harness, program, smpl_assets, traffic_gen, weights
from benchmark.reference import nets
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
RES, B, SEED = 64, 2, 2**31 + 16
KEYS = ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17")
TOL = 1e-6  # the same float32 arithmetic on the CPU; the port reads 0 here


def _run():
    config = json.loads((REPO / "benchmark" / "configs" / "featatt_cashmr.json").read_text())
    config["img_res"] = RES
    traffic = {"driver": "eval", "batch": B, "pool": 1}
    reference = harness.reference_module(REPO, config)
    dev = torch.device("cpu")
    return harness.Run(config, traffic, SEED, dev, reference, weights.make_weights(reference.params(config), SEED, dev),
                       smpl_assets.make_assets(config["smpl"], SEED, dev))


def _gaps(got, want):
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in KEYS}


def test_port_matches_the_benchmark_reference_and_the_gains_matter():
    run = _run()
    gamma = run.weights["cross_att.gamma"]
    assert gamma.shape == (4,) and bool((gamma >= 0.25).all()) and bool((gamma <= 0.75).all())
    model, infer = program.build_inference(run)  # loads the reference's weights strictly
    inputs = traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)[0]
    want = nets.infer(run.reference.network, run.weights, run.config, inputs, run.assets)
    gaps = _gaps(infer(inputs), want)
    assert max(gaps.values()) <= TOL, gaps
    with torch.no_grad():
        model.cross_att.gamma.zero_()
    control = _gaps(infer(inputs), want)
    assert max(control.values()) > TOL, control
