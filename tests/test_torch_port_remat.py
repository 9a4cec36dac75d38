"""PyTorch port, rematerialization (`--remat`, `--remat decoder`) on the
CPU, port only: RES 64, batch 2, dropout on, SMPLify in the loop (2 Adam
steps a stage), the cascade's depth feedback on.

Recomputing activations changes no number of the step: for the concat
(cashmrV2) and multi (featcat_cashmr) families the loss, every gradient and
the parameters after Adam equal the step without remat, BatchNorm's
running statistics and `num_batches_tracked` are bitwise equal (updated
once, by the forward), and the dropout generator ends where it did (the
recompute draws the forward's masks).  The fusion family and Bodies-At-Rest
take the flags and step exactly as without them, as in JAX."""

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.models.layers import checkpoint, recomputing
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.tools.bench_train import train_batch
from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

RES, B, N_FITS = 64, 2, 16


def _step(name, remat):
    """One train step of `name` from seeded weights with `--remat remat`
    (None: without), its model built with remat_decoder for "decoder":
    the loss, gradients, parameters, buffers, generator state and
    state-dict keys after it."""
    argv = ["--name", "x", "--img_res", str(RES), "--batch_size", str(B), "--run_smplify", "--num_smplify_iters", "2"]
    options = build_parser().parse_args(argv + (["--remat", remat] if remat else []))
    torch.manual_seed(0)
    model, spec = build_model(name, device="cpu", img_res=RES, remat_decoder=remat == "decoder")
    state = init_train_state(model, options, np.random.default_rng(0).normal(0, 0.2, (N_FITS, 82)), seed=3,
                             device="cpu")
    step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                           options, device="cpu")
    state, metrics = step(state, train_batch(spec, B, RES, N_FITS, 1))
    return {"loss": float(metrics["loss"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "generator": state.generator.get_state(), "keys": list(model.state_dict()), "fits": state.fits}


@pytest.fixture(scope="module")
def without_remat():
    """name -> the step without remat, the last name's kept (the tests go
    name by name; a step's state is 1-4 GB)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache.clear()
            cache[name] = _step(name, None)
        return cache[name]

    return get


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("remat", ["stage", "decoder"])
@pytest.mark.parametrize("name", ["cashmrV2", "featcat_cashmr"])
def test_remat_step_equals_the_step_without(without_remat, name, remat):
    ref, got = without_remat(name), _step(name, remat)
    assert got["keys"] == ref["keys"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    for k, g in ref["grads"].items():
        assert _rel(got["grads"][k], g) <= 1e-6, k
        assert _rel(got["params"][k], ref["params"][k]) <= 1e-6, k
    assert any(k.endswith("num_batches_tracked") for k in ref["buffers"])
    for k, b in ref["buffers"].items():
        assert torch.equal(got["buffers"][k], b), k
    assert torch.equal(got["generator"], ref["generator"])
    assert torch.equal(got["fits"], ref["fits"])


@pytest.mark.parametrize("remat", ["stage", "decoder"])
@pytest.mark.parametrize("name", ["ir_depth_fusion", "bodiesAtRest"])
def test_remat_is_ignored_outside_concat_and_multi(without_remat, name, remat):
    ref, got = without_remat(name), _step(name, remat)
    assert got["loss"] == ref["loss"] and got["keys"] == ref["keys"]
    for part in ("grads", "params", "buffers"):
        for k, v in ref[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert torch.equal(got["generator"], ref["generator"])


def test_checkpoint_recomputes_with_the_forwards_masks_and_statistics():
    """`layers.checkpoint` on a BatchNorm and a dropout: the backward
    recomputes (the BatchNorm sees `recomputing()`), the gradient is the
    plain call's, the running statistics are updated once, and the
    generator ends where the plain call left it."""
    from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d
    from inbed_pose_estimation_tpu_torch.models.heads import dropout

    seen = []

    class Probe(BatchNorm2d):
        def forward(self, x):
            seen.append(recomputing())
            return super().forward(x)

    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    runs = []
    for remat in (False, True):
        bn = Probe(3).train()
        gen = torch.Generator().manual_seed(5)
        xi = x.clone().requires_grad_(True)

        def f(t):
            return dropout(bn(t), 0.5, gen)

        out = checkpoint(f, xi, generator=gen) if remat else f(xi)
        out.square().sum().backward()
        runs.append((xi.grad, bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone(),
                     gen.get_state()))
    assert seen == [False, False, True]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
