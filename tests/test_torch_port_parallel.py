"""PyTorch port, data parallel across processes on the CPU: ranks are real
processes joined over gloo (`parallel.dryrun.launch`, torchrun's
environment on localhost), each with one torch thread, its own time limit
and the process group's timeout.

The global BatchNorm and the global masked mean on 2 ranks against the
JAX package's on the whole batch; the cashmrV2 train step on 2 ranks
against one process (which `tests/test_torch_port_train_step.py` holds
against JAX's step), with dropout on and uneven valid counts;
`run_evaluation`, `train_gpu.py` and the dry run on 2 ranks."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from inbed_pose_estimation_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from inbed_pose_estimation_tpu.train.losses import _masked_mean as j_masked_mean
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.parallel import dryrun, mesh
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
TIMEOUT = 300  # seconds a child may run; the process group's own is mesh.DEFAULT_TIMEOUT

# The JAX test's tolerances for one step on 1 and on 8 devices
# (tests/test_train_step.py::test_sync_bn_device_count_equivalence).
LR = 5e-5
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, BN_RTOL, BN_ATOL, FITS_ATOL = 1e-4, 1e-4, 1.2 * 2 * LR, 1e-3, 2e-4, 1e-3
# One Adam step moves a parameter by at most lr whatever its gradient, so
# the parameters cannot show the gradient: it is compared itself, the worst
# parameter's ||g - g_1|| / ||g_1|| (`dryrun.gradient_distance`).  At random
# weights this model's float32 gradient carries cancellation in
# BatchNorm's backward: the global BatchNorm's formula alone, at world size
# 1, moves cashmrV2's worst parameter by 0.116.  The controls a wrong
# world-size factor gives read 0.51 and more.
GRAD_RTOL = 0.25


def _env(**extra):
    """The children's environment: no torchrun variables of our own, one
    thread."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _launch(code, *args, env=None):
    runs = dryrun.launch(["-c", code, *map(str, args)], RANKS, timeout=TIMEOUT, env=env or _env(), cwd=REPO)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exited with {rc}:\n{out[-6000:]}"
    return runs


# ---------------------------------------------------------------- pieces

BN_SHAPE = (8, 6, 5, 4)  # [B, C, H, W]: 4 rows a rank
MASKS = {"uneven": [1, 1, 0, 1, 0, 0, 0, 0], "none": [0] * 8}  # rank 1 holds no valid row

_PIECES = r"""
import sys
import numpy as np, torch
torch.set_num_threads(1)
from inbed_pose_estimation_tpu_torch.parallel import mesh
from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d
from inbed_pose_estimation_tpu_torch.train.losses import _masked_mean

out_dir, shape, masks = sys.argv[1], tuple(map(int, sys.argv[2].split(","))), eval(sys.argv[3])
mesh.initialize_distributed(device="cpu")
rows = mesh.local_rows(shape[0])
r = np.random.default_rng(0)
x, g = r.normal(1.5, 2.0, shape), r.normal(0, 1, shape)
gamma, beta = r.normal(1, 0.2, shape[1]), r.normal(0, 0.2, shape[1])
mean0, var0 = r.normal(0, 0.3, shape[1]), r.uniform(0.5, 1.5, shape[1])
bn = BatchNorm2d(shape[1]).train()
with torch.no_grad():
    bn.weight.copy_(torch.tensor(gamma)); bn.bias.copy_(torch.tensor(beta))
    bn.running_mean.copy_(torch.tensor(mean0)); bn.running_var.copy_(torch.tensor(var0))
xl = torch.tensor(x[rows], dtype=torch.float32, requires_grad=True)
out = bn(xl)
(out * torch.tensor(g[rows], dtype=torch.float32)).sum().backward()
mesh.sync_gradients([bn.weight, bn.bias])  # the mean over the ranks
res = {"out": out.detach().numpy(), "dx": xl.grad.numpy(), "dgamma": bn.weight.grad.numpy() * mesh.world_size(),
       "dbeta": bn.bias.grad.numpy() * mesh.world_size(), "mean": bn.running_mean.numpy(),
       "var": bn.running_var.numpy()}

values = np.random.default_rng(1).normal(0, 1, (8, 5, 3))
for name, mask in masks.items():
    v = torch.tensor(values[rows], dtype=torch.float32, requires_grad=True)
    m = _masked_mean(v, torch.tensor(mask, dtype=torch.float32)[rows])
    m.backward()
    res["mm_" + name] = m.detach().numpy()
    res["mm_grad_" + name] = v.grad.numpy()
res["shard"] = mesh.shard_batch(np.arange(24).reshape(8, 3))
np.savez(f"{out_dir}/rank{mesh.rank()}.npz", **res)
mesh.shutdown()
"""


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    out = tmp_path_factory.mktemp("pieces")
    _launch(_PIECES, out, ",".join(map(str, BN_SHAPE)), repr(MASKS))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


def test_pad_to_multiple_and_shard_batch_match_jax(pieces):
    tree = {"a": np.arange(10, dtype=np.float32).reshape(5, 2), "b": np.arange(5)}
    for multiple in (1, 4, 5, 8):
        got, n = mesh.pad_to_multiple(tree, multiple)
        want, wn = j_pad_to_multiple(tree, multiple)
        assert n == wn == 5
        for k in tree:
            np.testing.assert_array_equal(got[k], want[k])
    got, n = mesh.pad_to_multiple(tree["a"], 4)
    np.testing.assert_array_equal(got, j_pad_to_multiple(tree["a"], 4)[0])
    # Without a process group a shard is the whole batch; on 2 ranks the
    # ranks' rows, in rank order, are the batch.
    assert mesh.shard_batch({"x": [1, 2, 3]}) == {"x": [1, 2, 3]}
    np.testing.assert_array_equal(np.concatenate([p["shard"] for p in pieces]), np.arange(24).reshape(8, 3))


def _flax_batch_norm():
    """flax BatchNorm (two-pass variance, momentum 0.9) on the whole batch,
    NHWC: output, dx, dgamma, dbeta, new running mean and variance."""
    r = np.random.default_rng(0)
    x, g = r.normal(1.5, 2.0, BN_SHAPE), r.normal(0, 1, BN_SHAPE)
    c = BN_SHAPE[1]
    gamma, beta = r.normal(1, 0.2, c), r.normal(0, 0.2, c)
    mean0, var0 = r.normal(0, 0.3, c), r.uniform(0.5, 1.5, c)
    layer = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, use_fast_variance=False)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)), jnp.float32)  # noqa: E731
    stats = {"mean": jnp.asarray(mean0, jnp.float32), "var": jnp.asarray(var0, jnp.float32)}

    def f(x, params):
        return layer.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])

    params = {"scale": jnp.asarray(gamma, jnp.float32), "bias": jnp.asarray(beta, jnp.float32)}
    out, new = f(nhwc(x), params)
    _, pull = jax.vjp(lambda x, p: f(x, p)[0], nhwc(x), params)
    dx, dp = pull(nhwc(g))
    back = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))  # noqa: E731
    return {"out": back(out), "dx": back(dx), "dgamma": np.asarray(dp["scale"]), "dbeta": np.asarray(dp["bias"]),
            "mean": np.asarray(new["batch_stats"]["mean"]), "var": np.asarray(new["batch_stats"]["var"])}


def test_global_batch_norm_on_two_ranks_matches_flax_on_the_whole_batch(pieces):
    want = _flax_batch_norm()
    for key in ("out", "dx"):
        np.testing.assert_allclose(np.concatenate([p[key] for p in pieces]), want[key], atol=1e-5, err_msg=key)
    for key in ("dgamma", "dbeta", "mean", "var"):
        for p in pieces:
            np.testing.assert_allclose(p[key], want[key], atol=1e-5, err_msg=key)


def test_global_masked_mean_on_two_ranks_matches_jax(pieces):
    values = np.random.default_rng(1).normal(0, 1, (8, 5, 3)).astype(np.float32)
    for name, mask in MASKS.items():
        m = jnp.asarray(mask, jnp.float32)
        want, want_grad = jax.value_and_grad(lambda v: j_masked_mean(v, m))(jnp.asarray(values))
        # Each rank's value is scaled so that the mean over the ranks (what
        # the gradient average takes) is the global masked mean.
        got = np.mean([p["mm_" + name] for p in pieces])
        np.testing.assert_allclose(got, float(want), rtol=1e-6, atol=1e-7, err_msg=name)
        grad = np.concatenate([p["mm_grad_" + name] for p in pieces]) / RANKS
        np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-6, atol=1e-7, err_msg=name)
    assert np.sum(MASKS["uneven"][4:]) == 0 and all(float(p["mm_none"]) == 0.0 for p in pieces)


# ---------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The dry run (2 ranks: cashmrV2 at RES 64, global batch 4, the depth
    feedback on, SMPLify with 2 iterations, dropout on, then one eval
    batch), and the same step in one process; rank 0's state and the single
    process's saved."""
    out = tmp_path_factory.mktemp("steps")
    single = subprocess.run([sys.executable] + dryrun.worker_argv(batch=4, device="cpu", out=out / "single.pt",
                                                                  **dryrun.DRYRUN_FLAGS),
                            capture_output=True, text=True, timeout=TIMEOUT, env=_env(), cwd=REPO)
    assert single.returncode == 0, single.stdout[-4000:] + single.stderr[-4000:]
    ranks = dryrun.dryrun_multichip(RANKS, device="cpu", out=str(out / "ranks.pt"), timeout=TIMEOUT)
    return {"single": dryrun.results([(0, single.stdout)])[0], "ranks": ranks,
            "single_state": torch.load(out / "single.pt"), "ranks_state": torch.load(out / "ranks.pt")}


def test_two_rank_step_matches_one_process(steps):
    single, ranks = steps["single"], steps["ranks"]
    # The batch puts the valid fits unevenly: the ranks' masked means divide
    # by a global count that neither holds alone.
    assert [r["valid_fit_rows"] for r in ranks] == [1.0, 0.0] and single["valid_fit_rows"] == 1.0
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], single["metrics"]["loss"], rtol=LOSS_RTOL)
    # The loss's parts, which the JAX test does not weigh: each carries the
    # float32 reassociation of the forward (global BatchNorm statistics
    # summed over the ranks) into a smaller value.
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=10 * LOSS_RTOL, err_msg=k)
    a, b = steps["single_state"], steps["ranks_state"]
    dist = {"params": 0.0, "bn": 0.0}
    for k, want in a["model"].items():
        got = b["model"][k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got, want), k
            continue
        bn = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=BN_RTOL if bn else PARAM_RTOL,
                                   atol=BN_ATOL if bn else PARAM_ATOL, err_msg=k)
        dist["bn" if bn else "params"] = max(dist["bn" if bn else "params"], (got - want).abs().max().item())
    np.testing.assert_allclose(b["fits"].numpy(), a["fits"].numpy(), atol=FITS_ATOL)
    print("2 ranks vs 1 process:", {"loss_rel": abs(ranks[0]["metrics"]["loss"] / single["metrics"]["loss"] - 1),
                                    **dist, "fits": (b["fits"] - a["fits"]).abs().max().item()})


def _check_gradients(ranks_state, single_state):
    """The 2-rank step's averaged gradient against one process's, and the
    controls (`dryrun.gradient_readings`) that the limit must fail."""
    got = dryrun.gradient_readings(ranks_state, single_state, RANKS)
    assert got["sound"][0] <= GRAD_RTOL, got
    assert min(got["controls"].values()) > GRAD_RTOL, got
    return got


def test_two_rank_gradient_matches_one_process(steps):
    """The gradient Adam took on 2 ranks (averaged) is one process's, and
    a gradient summed, divided twice or left on rank 0 is not."""
    print("2 ranks vs 1 process, gradient:", _check_gradients(steps["ranks_state"], steps["single_state"]))


def test_two_ranks_end_the_step_with_bitwise_equal_states(steps):
    """Parameters, BatchNorm statistics, Adam's moments and step, the fits
    and the dropout generator: every rank holds rank 0's, bit for bit."""
    ranks = steps["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world_size"] == RANKS for r in ranks)
    assert all(r["backend"] == "gloo" and r["local_rows"] == 2 for r in ranks)
    assert all(r["state_same_on_every_rank"] for r in ranks)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def test_two_rank_step_with_stage_remat_matches_one_process(tmp_path):
    """The recompute of a checkpointed cascade stage takes back the global
    BatchNorm sums of its forward (no collective in the recompute) and
    rewinds the generator that draws the global dropout masks: hmr's 2-rank
    step with `--remat` is one process's step without it."""
    flags = {"model": "hmr", "res": 64, "batch": 4, "smplify_iters": 2, "device": "cpu"}
    single = subprocess.run([sys.executable] + dryrun.worker_argv(out=tmp_path / "single.pt", **flags),
                            capture_output=True, text=True, timeout=TIMEOUT, env=_env(), cwd=REPO)
    assert single.returncode == 0, single.stdout[-4000:] + single.stderr[-4000:]
    ranks = dryrun.results(dryrun.launch(dryrun.worker_argv(out=tmp_path / "ranks.pt", remat="stage", **flags),
                                         RANKS, timeout=TIMEOUT, env=_env(), cwd=REPO))
    assert all(r["state_same_on_every_rank"] for r in ranks)
    want = dryrun.results([(0, single.stdout)])[0]["metrics"]["loss"]
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], want, rtol=LOSS_RTOL)
    a, b = torch.load(tmp_path / "single.pt"), torch.load(tmp_path / "ranks.pt")
    for k, v in a["model"].items():
        bn = k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        np.testing.assert_allclose(b["model"][k].double().numpy(), v.double().numpy(),
                                   rtol=BN_RTOL if bn else PARAM_RTOL, atol=BN_ATOL if bn else PARAM_ATOL, err_msg=k)
    # The recompute's replayed statistics carry the gradient.
    print("2 ranks with remat vs 1 process, gradient:", _check_gradients(b, a))


def test_dryrun_multichip_completes(steps):
    for r in steps["ranks"]:
        assert r["eval_rows"] == 4 and r["eval_finite"]
        assert np.isfinite(r["metrics"]["loss"])


@pytest.mark.slow
def test_two_rank_step_matches_the_jax_step_on_a_two_device_mesh(tmp_path, monkeypatch):
    """The port's 2-rank step against the JAX package's step on a 2-device
    mesh (conftest's virtual devices), from the port's initial weights, at
    the tolerances above.  Dropout off on both sides (their generators
    differ) and the cascade's feedback cut (through it one process's port
    step is 1e-3 from JAX's, `tests/test_torch_port_train_step.py`).  Slow:
    it compiles JAX's step with SMPLify inside."""
    import functools

    import inbed_pose_estimation_tpu.models.hmr as jhmr
    from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
    from inbed_pose_estimation_tpu.models import build_model as j_build_model
    from inbed_pose_estimation_tpu.models.heads import IEFHead
    from inbed_pose_estimation_tpu.parallel import batch_sharding, make_mesh, replicated
    from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
    from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict
    from inbed_pose_estimation_tpu.train.trainer import TrainState
    from inbed_pose_estimation_tpu.train.trainer import make_train_step as j_make_train_step
    from inbed_pose_estimation_tpu_torch.train import build_parser

    batch_size, rows = 4, 16
    flags = dict(dryrun.DRYRUN_FLAGS, batch=batch_size, dropout=0.0, no_feedback=True, device="cpu")
    ranks = dryrun.results(dryrun.launch(dryrun.worker_argv(init_out=tmp_path / "init.pt", out=tmp_path / "ranks.pt",
                                                            **flags), RANKS, timeout=TIMEOUT, env=_env(), cwd=REPO))
    init, after = torch.load(tmp_path / "init.pt"), torch.load(tmp_path / "ranks.pt")

    # The worker's options, batch and fits store, for JAX.
    options = build_parser().parse_args(["--name", "dryrun", "--img_res", "64", "--batch_size", str(batch_size),
                                         "--run_smplify", "--num_smplify_iters", "2"])
    spec = build_model("cashmrV2", device="cpu")[1]
    batch = dryrun.global_batch(spec, batch_size, 64, rows)
    nhwc = {k: jnp.asarray(np.transpose(v, (0, 2, 3, 1)) if v.ndim == 4 else v) for k, v in batch.items()}
    fits = dryrun.seeded_fits(rows)

    monkeypatch.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
    jmodel, jspec = j_build_model("cashmrV2")
    import dataclasses

    step_fn, tx = j_make_train_step(jmodel, dataclasses.replace(jspec, cascade_feed_map=()), j_synthetic(0), j_prior(),
                                    options)
    variables = convert_torch_state_dict(init)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), fits=jnp.asarray(fits), rng=jax.random.PRNGKey(1),
                       step=jnp.zeros((), jnp.int32))
    mesh_ = make_mesh(jax.devices()[:RANKS])
    state = jax.device_put(state, replicated(mesh_))
    new, metrics = jax.jit(step_fn)(state, jax.device_put(nhwc, batch_sharding(mesh_)))

    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    got = convert_torch_state_dict(after["model"])
    for kind, want_tree, rtol, atol in (("params", new.params, PARAM_RTOL, PARAM_ATOL),
                                        ("batch_stats", new.batch_stats, BN_RTOL, BN_ATOL)):
        want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
        have = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(got[kind])[0]}
        assert set(have) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(have[k], v, rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(after["fits"].numpy(), np.asarray(new.fits), atol=FITS_ATOL)
    # The gradient: JAX's Adam holds (1 - b1) g after its first step.
    mu = next(s.mu for s in jax.tree_util.tree_leaves(new.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu"))
    leaves = lambda tree: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    port_grads = leaves(convert_torch_state_dict(dict(after["model"], **after["grads"]))["params"])
    jax_grads = {k: v / 0.1 for k, v in leaves(mu).items()}
    assert set(port_grads) == set(jax_grads)
    dist = dryrun.gradient_distance(port_grads, jax_grads)
    print("2 ranks vs JAX's 2-device step, gradient:", dist)
    assert dist[0] <= GRAD_RTOL, dist


# ---------------------------------------------------------------- run_evaluation and the CLI

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree: 5 samples a split (an eval batch of 4 leaves a tail
    of 1) and 10 training rows."""
    base = tmp_path_factory.mktemp("dp_tree")
    env = write_synthetic_environment(str(base), num_subjects=1, samples_per_subject=5)
    paths = {"INBED_DATA_ROOT": env["data_root"], "INBED_NPZ_PATH": env["npz_path"],
             "INBED_ASSET_DIR": str(base / "no_assets")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in paths.items():
            mp.setenv(k, v)
        yield paths


_EVAL = r"""
import json, sys
import torch
torch.set_num_threads(1)
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.parallel import mesh
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model

class Opt:
    img_res = 64

dev = mesh.initialize_distributed(device="cpu")
torch.manual_seed(0)
model, spec = build_model("cashmrV2", device=dev)
res = run_evaluation(model, spec, "slp-4mod-uncover", BaseDataset(Opt(), "slp-4mod-uncover", is_train=False),
                     synthetic_smpl_model(0, device=dev), checkpoint_dir=sys.argv[1], result_file=sys.argv[2],
                     batch_size=4, img_res=64, num_workers=1, device=dev)
res.pop("timing")
print("EVAL_RESULT " + json.dumps(res), flush=True)
mesh.shutdown()
"""


def test_run_evaluation_on_two_ranks_matches_one_process(tree, tmp_path):
    class Opt:
        img_res = 64

    for d in ("one", "ranks"):
        (tmp_path / d).mkdir()
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device="cpu")
    want = run_evaluation(model, spec, "slp-4mod-uncover", BaseDataset(Opt(), "slp-4mod-uncover", is_train=False),
                          synthetic_smpl_model(0, device="cpu"), checkpoint_dir=str(tmp_path / "one"),
                          result_file=str(tmp_path / "one_res"), batch_size=4, img_res=64, num_workers=1,
                          device="cpu")
    runs = _launch(_EVAL, tmp_path / "ranks", tmp_path / "ranks_res", env=_env(**tree))
    got = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("EVAL_RESULT "))[12:]) for _, out in runs]
    assert got[0] == got[1]
    for key in ("mpjpe", "pa_mpjpe", "pve", "mask_accuracy", "mask_f1"):
        if want[key] is None:
            assert got[0][key] is None, key
        else:
            np.testing.assert_allclose(got[0][key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    assert np.isfinite(want["mpjpe"]) and want["mask_accuracy"] is not None
    # Rank 0 alone writes log.txt (one entry: a header and a metrics line)
    # and the npz, which holds every sample as one process's does.
    with open(tmp_path / "ranks" / "log.txt") as f:
        assert len(f.read().splitlines()) == 2
    a = np.load(tmp_path / "one_res" / "smpl_fits" / "slp-4mod-uncover_fits.npz")
    b = np.load(tmp_path / "ranks_res" / "smpl_fits" / "slp-4mod-uncover_fits.npz")
    assert a["pose"].shape == b["pose"].shape == (5, 72)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
    # The dumps of the batch's first samples, each drawn once, by its rank.
    names = sorted(os.listdir(tmp_path / "ranks_res" / "slp-4mod-uncover"))
    assert names == sorted(os.listdir(tmp_path / "one_res" / "slp-4mod-uncover"))


def test_run_evaluation_in_one_process_decodes_each_sample_once(tree, tmp_path):
    """Without a process group the split is not padded before loading: the
    tail batch's 1 sample is decoded once and padded on the host."""
    class Opt:
        img_res = 64

    class Counting(BaseDataset):
        calls = []

        def __getitem__(self, i):
            self.calls.append(int(i))
            return super().__getitem__(i)

    dataset = Counting(Opt(), "slp-4mod-uncover", is_train=False)
    torch.manual_seed(0)
    model, spec = build_model("hmr", device="cpu")
    got = run_evaluation(model, spec, "slp-4mod-uncover", dataset, synthetic_smpl_model(0, device="cpu"),
                         batch_size=4, img_res=64, num_workers=1, device="cpu")
    assert sorted(Counting.calls) == list(range(5)) and got["timing"]["batches"] == 2
    assert np.isfinite(got["mpjpe"])


_TRAIN = r"""
import sys
import torch
torch.set_num_threads(1)
from inbed_pose_estimation_tpu_torch.parallel import mesh
saves = []
plain_save = torch.save
def save(obj, path, *a, **k):
    saves.append(str(path))
    return plain_save(obj, path, *a, **k)
torch.save = save
import train_gpu
trainer = train_gpu.main(sys.argv[1:])
print("TRAIN_RESULT", mesh.rank(), len(saves), trainer.step_count, flush=True)
mesh.shutdown()
"""


def _train_args(log_dir, batch=4):
    return ["--name", "dp", "--log_dir", str(log_dir), "--model", "hmr", "--img_res", "64", "--batch_size",
            str(batch), "--num_epochs", "1", "--num_workers", "1", "--summary_steps", "1", "--data_test",
            "slp-4mod-uncover", "--allow_synthetic_assets", "--device", "cpu"]


def test_train_gpu_on_two_ranks_checkpoints_once_and_resumes_in_one_process(tree, tmp_path):
    import train_gpu

    runs = _launch(_TRAIN, *_train_args(tmp_path), env=_env(**tree))
    lines = [next(ln for ln in out.splitlines() if ln.startswith("TRAIN_RESULT")).split()[1:] for _, out in runs]
    # 10 training rows, a global batch of 4: 2 steps, then the epoch's
    # checkpoint, which rank 0 alone writes.
    assert [(int(r), int(s)) for r, _, s in lines] == [(0, 2), (1, 2)]
    assert int(lines[0][1]) >= 1 and int(lines[1][1]) == 0
    ckdir = tmp_path / "dp" / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["epoch_1_0.pt", "log.txt", "slp-4mod-train_fits.npy"]
    saved = torch.load(ckdir / "epoch_1_0.pt", weights_only=True)
    assert (saved["epoch"], saved["total_step_count"], saved["batch_size"]) == (1, 2, 4)
    with open(tmp_path / "dp" / "tensorboard" / "scalars.jsonl") as f:
        assert len(f.read().splitlines()) > 0
    # One process resumes the 2-rank run's checkpoint.
    trainer = train_gpu.main(_train_args(tmp_path) + ["--resume", "--data_test", ""])
    assert (trainer.epoch0, trainer.step_count) == (1, 2)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k


def test_trainer_raises_when_the_world_size_does_not_divide_the_batch(tree, tmp_path, monkeypatch):
    import train_gpu

    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="--batch_size 6 does not split over 4 ranks; the largest rank count "
                                         "that divides it is 3"):
        train_gpu.main(_train_args(tmp_path, batch=6) + ["--data_test", ""])
