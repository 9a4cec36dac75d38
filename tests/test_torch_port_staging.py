"""PyTorch port, the eval entry's staging on the CPU (RES 64, batch 2): on
`device="cpu"` every call passes through, as `torch.as_tensor(x,
dtype=float32)`, and the answers equal the forward, SMPL and J17 composed
by hand bit for bit; J17's index from a device constant equals the list
index.  The pinned ring on the card is tested in
tests/test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu_torch import constants
from inbed_pose_estimation_tpu_torch.evaluation import (load_j_regressor_h36m, make_forward_fn, make_inference_fn,
                                                        regress_j17)
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model

RES, B, CALLS = 64, 2, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(spec, seed):
    """One float32 array, one float64 array, then float32 tensors: the
    dtypes and types a caller may pass."""
    r = np.random.default_rng(seed)
    mods = [r.normal(0, 1, (B, 3 if m == "img" else 1, RES, RES)) for m in spec.modalities]
    return (mods[0].astype(np.float32), mods[1], *(torch.from_numpy(m.astype(np.float32)) for m in mods[2:]))


@pytest.mark.parametrize("name", ["cashmrV2", "ir_depth_pm_fusion"])
def test_cpu_calls_pass_through_as_before(name):
    torch.manual_seed(0)
    model, spec = build_model(name, device="cpu", img_res=RES)
    smpl = synthetic_smpl_model(0, device="cpu")
    jreg = load_j_regressor_h36m()
    infer = make_inference_fn(model, spec, smpl, j_regressor_h36m=jreg, final_recon=False, device="cpu")
    forward = make_forward_fn(model, spec, final_recon=False, smpl_model=smpl)
    jreg_t = torch.from_numpy(jreg)
    for call in range(CALLS):
        inputs = _inputs(spec, call)
        got = infer(inputs)
        with torch.no_grad():
            out = forward(tuple(torch.as_tensor(x, dtype=torch.float32) for x in inputs))
            verts, _ = lbs(smpl, out.betas, out.rotmat)
            k3d = torch.einsum("jv,bvc->bjc", jreg_t, verts)
            want = {"rotmat": out.rotmat, "betas": out.betas, "cam": out.cam, "vertices": verts, "recon": out.recon,
                    "keypoints_3d_17": k3d[:, constants.H36M_TO_J17] - k3d[:, 0:1]}
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, dict):
                assert v.keys() == got[k].keys() and all(torch.equal(got[k][kk], vv) for kk, vv in v.items()), k
            else:
                assert torch.equal(got[k], v), k
    assert infer.staging == {"staged": 0, "passed": CALLS, "remade": 0}


def test_regress_j17_matches_the_list_index():
    r = np.random.default_rng(3)
    jreg = torch.from_numpy(r.normal(0, 0.01, (17, 690)).astype(np.float32))
    verts = torch.from_numpy(r.normal(0, 0.5, (5, 690, 3)).astype(np.float32))
    k3d = torch.einsum("jv,bvc->bjc", jreg, verts)
    got = regress_j17(jreg, verts)
    assert got.shape == (5, 17, 3)
    assert torch.equal(got, k3d[:, constants.H36M_TO_J17] - k3d[:, 0:1])
