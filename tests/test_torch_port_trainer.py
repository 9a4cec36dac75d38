"""PyTorch port, the training driver on the CPU: checkpoints (the port's
`.pt` round trip, the JAX package reading it, the port reading the JAX
package's `.npz` with its optimizer leaves, `latest_checkpoint`), the
`Trainer` (one epoch, an interrupted run resumed against an uninterrupted
one, `--checkpoint`, `--pretrained_checkpoint`) and the `train_gpu.py` CLI,
over a synthetic SLP tree (8 training samples, RES 64, batch 4).

The trainer runs hmr (the concat family's smallest model, one modality):
its checkpoint with Adam's moments is 0.32 GB where cashmrV2's is 1.3 GB.
Marked slow: the port's `Trainer` against the JAX package's over 2 steps."""

import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.train.checkpoint import flatten_opt_state
from inbed_pose_estimation_tpu.train.checkpoint import load_torch_checkpoint as j_load_torch_checkpoint
from inbed_pose_estimation_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import (
    Trainer, adam_state_from_jax_leaves, init_train_state, latest_checkpoint, load_pretrained, parse_args,
    resume_train_state, save_checkpoint,
)
from inbed_pose_estimation_tpu_torch.weights import flax_path, load_jax_adam_state, load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

RES, B, MODEL = 64, 4, "hmr"
# The Trainer against JAX's, the fits store after steps 1 and 2
# (test_trainer_matches_jax_trainer's docstring).
FITS_ATOL = (1e-4, 3e-2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree with 4 samples per subject (8 training rows), the
    port's config pointed at it and at an empty asset directory."""
    base = tmp_path_factory.mktemp("train_tree")
    env = write_synthetic_environment(str(base), num_subjects=1, samples_per_subject=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INBED_DATA_ROOT", env["data_root"])
        mp.setenv("INBED_NPZ_PATH", env["npz_path"])
        mp.setenv("INBED_ASSET_DIR", str(base / "no_assets"))
        yield env


def _args(log_dir, *extra):
    """The CLI's arguments for one epoch of the tree on the CPU (`--device
    cpu` last)."""
    return ["--name", "run", "--log_dir", str(log_dir), "--model", MODEL, "--img_res", str(RES),
            "--batch_size", str(B), "--num_epochs", "1", "--num_workers", "2", "--summary_steps", "1",
            "--data_test", "", *extra, "--device", "cpu"]


def _trainer(log_dir, *extra):
    """A Trainer over the 8 training samples, augmentation off, SMPLify on
    (2 Adam steps a stage) so that the fits store changes; the weights from
    torch's seed 0."""
    options = parse_args(_args(log_dir, "--run_smplify", "--num_smplify_iters", "2", *extra))
    torch.manual_seed(0)
    model, spec = build_model(MODEL, device="cpu")
    ds = BaseDataset(options, "slp-4mod-train", is_train=True, use_augmentation=False)
    return Trainer(options, model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                   ds, device="cpu")


def _snapshot(trainer):
    """Parameters, BatchNorm statistics, Adam's moments and step, fits."""
    model, opt = trainer.state.model, trainer.state.optimizer
    return {
        "params": {k: p.detach().clone() for k, p in model.named_parameters()},
        "bn": {k: b.clone() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))},
        "adam": {k: {n: opt.state[p][n].clone() for n in ("exp_avg", "exp_avg_sq", "step")}
                 for k, p in model.named_parameters()},
        "fits": trainer.state.fits.clone(),
        "generator": trainer.state.generator.get_state(),
    }


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """An uninterrupted epoch ("whole"), the same epoch cut after its first
    step by time_to_run=0 ("cut"), and the cut run resumed ("resumed")."""
    base = tmp_path_factory.mktemp("runs")
    out = {}
    whole = _trainer(base / "whole")
    whole.train()
    out["whole"] = {"snapshot": _snapshot(whole), "history": whole.history, "step_count": whole.step_count,
                    "checkpoint_dir": whole.options.checkpoint_dir}
    del whole
    cut = _trainer(base / "cut", "--time_to_run", "0")
    cut.train()
    out["cut"] = {"step_count": cut.step_count, "checkpoint_dir": cut.options.checkpoint_dir,
                  "snapshot": _snapshot(cut)}
    del cut
    resumed = _trainer(base / "cut", "--resume")
    out["resumed_start"] = {"epoch0": resumed.epoch0, "batch_idx": resumed.checkpoint_batch_idx,
                            "step_count": resumed.step_count, "snapshot": _snapshot(resumed),
                            "dataset_perm": resumed.dataset_perm}
    resumed.train()
    out["resumed"] = {"snapshot": _snapshot(resumed), "step_count": resumed.step_count}
    return out


def test_trainer_one_epoch_writes_checkpoint_and_fits(runs):
    whole = runs["whole"]
    assert whole["step_count"] == 2  # 8 samples, batch 4, drop_last
    ckdir = whole["checkpoint_dir"]
    assert latest_checkpoint(ckdir).endswith("epoch_1_0.pt")
    assert os.path.exists(os.path.join(ckdir, "slp-4mod-train_fits.npy"))
    kinds = [h["kind"] for h in whole["history"]]
    assert kinds == ["summary", "summary", "save"]
    summary = whole["history"][1]
    assert np.isfinite(summary["metrics"]["loss"]) and set(summary["phases_ms"]) == {"data", "dispatch", "sync"}
    saved = torch.load(latest_checkpoint(ckdir), map_location="cpu", weights_only=True)
    assert (saved["epoch"], saved["batch_idx"], saved["total_step_count"], saved["batch_size"]) == (1, 0, 2, B)
    assert sorted(saved["dataset_perm"].tolist()) == list(range(8))
    fits = np.load(os.path.join(ckdir, "slp-4mod-train_fits.npy"))
    assert fits.shape == (8, 82) and np.abs(fits).max() > 0  # SMPLify improved some rows
    np.testing.assert_array_equal(fits, whole["snapshot"]["fits"].numpy())


def test_resumed_run_equals_uninterrupted(runs):
    """Cut after step 1 by time_to_run=0, resumed from its epoch_0_1.pt:
    after step 2, parameters, Adam's moments, BatchNorm statistics, fits
    and the dropout generator equal the uninterrupted run's to 1e-7."""
    assert runs["cut"]["step_count"] == 1
    assert sorted(os.listdir(runs["cut"]["checkpoint_dir"]))[:2] == ["epoch_0_1.pt", "epoch_1_0.pt"]
    start = runs["resumed_start"]
    assert (start["epoch0"], start["batch_idx"], start["step_count"]) == (0, 1, 1)
    cut, restored = runs["cut"]["snapshot"], start["snapshot"]
    for k, v in cut["adam"].items():  # Adam restored, not re-initialized
        for n in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(restored["adam"][k][n], v[n]), (k, n)
    assert any(v["exp_avg"].abs().max() > 0 for v in restored["adam"].values())
    assert torch.equal(restored["generator"], cut["generator"]) and torch.equal(restored["fits"], cut["fits"])
    assert runs["resumed"]["step_count"] == 2
    got, want = runs["resumed"]["snapshot"], runs["whole"]["snapshot"]
    for part in ("params", "bn"):
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, atol=1e-7, rtol=0, msg=f"{part} {k}")
    for k, v in want["adam"].items():
        for n in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(got["adam"][k][n], v[n], atol=1e-7, rtol=0, msg=f"adam {k} {n}")
    torch.testing.assert_close(got["fits"], want["fits"], atol=1e-7, rtol=0)
    assert torch.equal(got["generator"], want["generator"])


def test_checkpoint_option_wins_over_newest_file(runs):
    ckdir = runs["cut"]["checkpoint_dir"]
    assert latest_checkpoint(ckdir).endswith("epoch_1_0.pt")
    log_dir = os.path.dirname(os.path.dirname(ckdir))
    newest = _trainer(log_dir, "--resume")
    assert (newest.epoch0, newest.step_count) == (1, 2)
    explicit = _trainer(log_dir, "--resume", "--checkpoint", os.path.join(ckdir, "epoch_0_1.pt"))
    assert (explicit.epoch0, explicit.checkpoint_batch_idx, explicit.step_count) == (0, 1, 1)


def test_step_takes_the_uint8_feed(tree, monkeypatch):
    """The train step on a batch of the uint8 feed: its images reach the
    decode as uint8, and its loss and parts equal those of the same
    samples through the float feed (inputs within one float32 ulp)."""
    from inbed_pose_estimation_tpu_torch.data import collate
    from inbed_pose_estimation_tpu_torch.train import make_train_step, step_feed_keys
    from inbed_pose_estimation_tpu_torch.train import trainer as trainer_mod

    seen = {}
    decode = trainer_mod.decode_uint8_batch
    monkeypatch.setattr(trainer_mod, "decode_uint8_batch", lambda b: seen.update({k: v.dtype for k, v in b.items()})
                        or decode(b))
    metrics = {}
    for feed in ("uint8", "float"):
        options = parse_args(_args(tree["data_root"] + "/../logs", "--model", "cashmrV2", "--batch_size", "2",
                                   "--uint8_feed" if feed == "uint8" else "--no-uint8_feed"))
        ds = BaseDataset(options, "slp-4mod-train", is_train=True)
        batch = collate([ds.__getitem__(i, rng=np.random.default_rng(12 + i)) for i in (0, 5)])
        torch.manual_seed(0)
        model, spec = build_model("cashmrV2", device="cpu", dropout_rate=0.0)
        feed_batch = {k: v for k, v in batch.items() if k in step_feed_keys(spec)}
        assert ("pixel_noise" in feed_batch) == (feed == "uint8")
        state = init_train_state(model, options, np.zeros((8, 82)), device="cpu")
        step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                               options, device="cpu")
        seen.clear()
        metrics[feed] = {k: float(v) for k, v in step(state, feed_batch)[1].items()}
        images = ("img", "ir_img", "depth_img", "pm_img", "depth_img_uncover")
        assert all(seen[k] == (torch.uint8 if feed == "uint8" else torch.float32) for k in images), seen
    for k, v in metrics["float"].items():
        assert metrics["uint8"][k] == pytest.approx(v, rel=1e-5, abs=1e-8), k


def _stepped_state(seed, steps=2):
    """hmr with a fresh Adam moved `steps` times by random gradients."""
    torch.manual_seed(seed)
    model, _ = build_model(MODEL, device="cpu")

    class Opt:
        lr = 1e-3

    state = init_train_state(model, Opt(), np.zeros((5, 82), np.float32), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = 1e-2 * torch.randn(p.shape, generator=gen)
        state.optimizer.step()
    torch.randn(3, generator=state.generator)  # move the dropout generator off its seed
    return state


def test_pt_checkpoint_round_trip(tmp_path):
    state = _stepped_state(1)
    for m in state.model.modules():  # BatchNorm statistics off their init
        if hasattr(m, "running_var"):
            m.running_var.uniform_(0.5, 1.5)
    path = save_checkpoint(str(tmp_path), state, epoch=3, batch_idx=7, batch_size=B, dataset_perm=np.arange(9)[::-1],
                           total_step_count=40)
    assert os.path.basename(path) == "epoch_3_7.pt" and os.listdir(tmp_path) == ["epoch_3_7.pt"]
    fresh = _stepped_state(2, steps=0)
    meta = resume_train_state(path, fresh)
    assert (meta["epoch"], meta["batch_idx"], meta["batch_size"], meta["total_step_count"]) == (3, 7, B, 40)
    np.testing.assert_array_equal(meta["dataset_perm"], np.arange(9)[::-1])
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"] and set(a["state"]) == set(b["state"])
    for i, st in a["state"].items():
        for n, v in st.items():
            assert torch.equal(b["state"][i][n], v), (i, n)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())


def test_jax_reads_the_port_checkpoint(tmp_path):
    """The JAX package's load_torch_checkpoint(with_optimizer=True) on the
    port's .pt: a params tree shaped like its own model's, equal to the
    port's weights, and Adam moments equal to the port's."""
    state = _stepped_state(3)
    path = save_checkpoint(str(tmp_path), state, epoch=1, batch_idx=0, batch_size=B, dataset_perm=np.arange(4),
                           total_step_count=2)
    variables, (mu, nu, count), meta = j_load_torch_checkpoint(path, with_optimizer=True)
    assert count == 2 and meta["epoch"] == 1 and list(meta["dataset_perm"]) == [0, 1, 2, 3]
    model, _ = j_build_model(MODEL)
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    for coll in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(variables[coll]) == jax.tree_util.tree_structure(init[coll])
        for a, b in zip(jax.tree_util.tree_leaves(variables[coll]), jax.tree_util.tree_leaves(init[coll])):
            assert a.shape == b.shape
    flat = {coll: {tuple(str(k.key) for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
            for coll, tree in (("params", variables["params"]), ("mu", mu), ("nu", nu))}

    def torch_layout(a):
        return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T if a.ndim == 2 else a

    checked = 0
    for key, p in state.model.named_parameters():
        path_, leaf, _ = flax_path(key)
        src = path_ + (leaf,)
        st = state.optimizer.state[p]
        np.testing.assert_array_equal(torch_layout(flat["params"][src]), p.detach().numpy(), err_msg=key)
        np.testing.assert_array_equal(torch_layout(flat["mu"][src]), st["exp_avg"].numpy(), err_msg=key)
        np.testing.assert_array_equal(torch_layout(flat["nu"][src]), st["exp_avg_sq"].numpy(), err_msg=key)
        checked += 1
    assert checked == len(flat["params"]) > 150


def test_port_reads_jax_npz_with_optimizer(tmp_path):
    """A JAX package checkpoint written by its save_checkpoint with
    flatten_opt_state of an optax Adam state (random non-zero moments,
    count 3) resumes into the same weights as load_jax_variables and the
    same torch Adam state as load_jax_adam_state."""
    model, _ = j_build_model(MODEL)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(4),
                                                                       jnp.zeros((1, RES, RES, 3))))
    rng = np.random.default_rng(5)
    adam = optax.adam(1e-3).init(variables["params"])

    def rand(tree):
        return jax.tree_util.tree_map(lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32), tree)

    opt_state = (adam[0]._replace(count=jnp.int32(3), mu=rand(adam[0].mu),
                                  nu=jax.tree_util.tree_map(np.abs, rand(adam[0].nu))),) + tuple(adam[1:])
    path = j_save_checkpoint(str(tmp_path), variables, opt_state_flat=flatten_opt_state(opt_state),
                             metadata={"dataset_perm": np.arange(6), "total_step_count": 3, "batch_size": B},
                             epoch=0, batch_idx=3)
    got = _stepped_state(6, steps=0)
    meta = resume_train_state(path, got)
    assert (meta["epoch"], meta["batch_idx"], meta["total_step_count"], meta["dataset_perm"]) == (0, 3, 3,
                                                                                                  list(range(6)))
    want = _stepped_state(7, steps=0)
    load_jax_variables(want.model, variables)
    load_jax_adam_state(want.model, want.optimizer, opt_state)
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    pairs = list(zip(got.model.parameters(), want.model.parameters()))
    for pg, pw in pairs:
        sg, sw = got.optimizer.state[pg], want.optimizer.state[pw]
        for n in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sg[n], sw[n]), n
    assert float(got.optimizer.state[pairs[0][0]]["step"]) == 3.0
    assert all(got.optimizer.state[p]["exp_avg"].abs().max() > 0 for p, _ in pairs)
    # Leaves that do not fit the model's parameters are refused.
    with np.load(path) as data:
        opt = {k[len("opt/"):]: data[k] for k in data.files if k.startswith("opt/")}
    assert len(opt) == 1 + 2 * len(pairs)
    del opt[max(opt)]
    with pytest.raises(ValueError, match="optimizer leaves"):
        adam_state_from_jax_leaves(got.model, got.optimizer, variables["params"], opt)


def test_step_timer_keeps_window_means():
    from inbed_pose_estimation_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer("train")
    for name in ("data", "data", "sync"):
        with timer.phase(name):
            pass
    assert set(timer.means) == {"data", "sync"} and timer.counts["data"] == 2
    timer.totals["data"] = 0.5  # two entries
    assert timer.means["data"] == 0.25 and timer.summary().startswith("data=250.0ms sync=")
    timer.reset()
    assert timer.means == {} and timer.summary() == ""


def test_latest_checkpoint_orders_by_number(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("epoch_9_5.pt", "epoch_2_100.npz", "epoch_10_0.npz", "notes.txt", "epoch_3_1.pt.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_10_0.npz")
    (tmp_path / "epoch_10_0.pt").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_10_0.pt")
    (tmp_path / "epoch_10_2.npz").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_10_2.npz")


def test_pretrained_checkpoint_loads_what_fits(tmp_path):
    """--pretrained_checkpoint: entries with the same name and shape are
    taken from a .pt of another model (hmr4mod: 6 input channels, so only
    the stem differs) and from a JAX .npz; the rest keep their values."""
    torch.manual_seed(8)
    src, _ = build_model("hmr4mod", device="cpu")
    torch.save({"model": {"module." + k: v for k, v in src.state_dict().items()}}, tmp_path / "other.pt")
    torch.manual_seed(9)
    dst, _ = build_model(MODEL, device="cpu")
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    taken = load_pretrained(dst, str(tmp_path / "other.pt"))
    assert taken == len(before) - 1
    assert torch.equal(dst.state_dict()["conv1.weight"], before["conv1.weight"])
    for k, v in src.state_dict().items():
        if k != "conv1.weight":
            assert torch.equal(dst.state_dict()[k], v), k

    model, _ = j_build_model(MODEL)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(2),
                                                                       jnp.zeros((1, RES, RES, 3))))
    path = j_save_checkpoint(str(tmp_path), variables, epoch=0, batch_idx=0)
    assert load_pretrained(dst, path) == sum(1 for k in before if not k.endswith("num_batches_tracked")
                                             and not k.startswith("init_"))
    want, _ = build_model(MODEL, device="cpu")
    load_jax_variables(want, variables)
    for k, v in want.state_dict().items():
        if not k.endswith("num_batches_tracked") and not k.startswith("init_"):
            assert torch.equal(dst.state_dict()[k], v), k


def test_train_gpu_runs_on_the_cpu(tree, tmp_path, capsys):
    import train_gpu

    trainer = train_gpu.main(_args(tmp_path, "--allow_synthetic_assets", "--data_test", "slp-4mod-uncover"))
    assert trainer.step_count == 2
    log_dir = tmp_path / "run"
    config = json.loads((log_dir / "config.json").read_text())
    assert config["device"] == "cpu" and config["uint8_feed"] is True and config["model"] == MODEL
    assert config["checkpoint_dir"] == str(log_dir / "checkpoints")
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["epoch_1_0.pt", "log.txt", "slp-4mod-train_fits.npy"]
    scalars = [json.loads(line) for line in (log_dir / "tensorboard" / "scalars.jsonl").read_text().splitlines()]
    assert {s["tag"] for s in scalars} >= {"loss", "loss_keypoints", "perf/images_per_sec", "perf/step_ms"}
    assert {s["step"] for s in scalars} == {1, 2}
    out = capsys.readouterr().out
    assert re.search(r"epoch 0 step 2: loss=\S+ .* \| data=\S+ms dispatch=\S+ms sync=\S+ms wall_step=", out)
    assert "slp-4mod-uncover: MPJPE:" in out
    assert [h["kind"] for h in trainer.history] == ["summary", "summary", "save", "eval"]


@pytest.mark.parametrize("flag", [["--dtype", "bfloat16"], ["--remat"], ["--remat", "decoder"], ["--fast_preprocess"],
                                  ["--crop_cache", "x"], ["--model", "bodiesAtRest"]],
                         ids=lambda f: "_".join(f).strip("-"))
def test_train_gpu_threads_each_flag(tree, tmp_path, flag, capsys, monkeypatch):
    """Every flag is ported.  --dtype bfloat16, --remat and --remat decoder
    run one step of hmr and reach build_model (dtype, remat_decoder) and
    make_train_step (options.remat) as train.py threads them; the
    parameters stay float32.  The rest run one step of bodiesAtRest (the
    cheapest model) with the native crop, with a crop cache directory that
    holds no cache (refused with the JAX package's message, the images read
    from disk), and as it is."""
    import train_gpu

    if flag[0] in ("--dtype", "--remat"):
        import inbed_pose_estimation_tpu_torch.models as models_mod
        import inbed_pose_estimation_tpu_torch.train.trainer as trainer_mod

        seen = {"remat": []}
        real_build, real_step = models_mod.build_model, trainer_mod.make_train_step

        def build_spy(*args, **kw):
            seen["build"] = {k: kw.get(k) for k in ("dtype", "remat_decoder")}
            return real_build(*args, **kw)

        def step_spy(model, spec, smpl, prior, options, **kw):
            seen["remat"].append(options.remat)
            return real_step(model, spec, smpl, prior, options, **kw)

        monkeypatch.setattr(models_mod, "build_model", build_spy)
        monkeypatch.setattr(trainer_mod, "make_train_step", step_spy)
        trainer = train_gpu.main(_args(tmp_path, *flag, "--allow_synthetic_assets", "--time_to_run", "0"))
        bf16 = flag[0] == "--dtype"
        remat = False if bf16 else flag[1] if len(flag) > 1 else "stage"
        assert seen == {"build": {"dtype": torch.bfloat16 if bf16 else torch.float32,
                                  "remat_decoder": remat == "decoder"}, "remat": [remat]}
        assert trainer.step_count == 1 and [h["kind"] for h in trainer.history] == ["summary", "save"]
        assert all(np.isfinite(v) for v in trainer.history[0]["metrics"].values())
        model = trainer.state.model
        assert model.conv1.compute_dtype == (torch.bfloat16 if bf16 else None)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        return
    argv = _args(tmp_path, *flag, "--allow_synthetic_assets", "--time_to_run", "0")
    argv[argv.index("--model") + 1] = "bodiesAtRest"
    trainer = train_gpu.main(argv)
    assert trainer.step_count == 1 and trainer.options.model == "bodiesAtRest"
    assert [h["kind"] for h in trainer.history] == ["bar_mode", "summary", "save"]
    assert all(np.isfinite(v) for v in trainer.history[1]["metrics"].values())
    dataset = trainer.train_ds.datasets[0]
    assert (dataset._native is not None) == (flag == ["--fast_preprocess"]) and dataset._cache is None
    if flag[0] == "--crop_cache":
        assert "crop cache: no cache for slp-4mod-train (train) in x; reading from disk" in capsys.readouterr().out


@pytest.fixture(scope="module")
def guide_pt(tmp_path_factory):
    """A seeded ir_depth_fusion's state in the reference layout, as
    `--pretrained_fusion_checkpoint` takes it, and that state."""
    torch.manual_seed(7)
    donor, _ = build_model("ir_depth_fusion", device="cpu")
    path = tmp_path_factory.mktemp("guide") / "guide.pt"
    torch.save({"model": donor.state_dict()}, path)
    return str(path), donor.state_dict()


def test_train_gpu_grafts_the_fusion_guide(tree, tmp_path, guide_pt):
    """`--pretrained_fusion_checkpoint` is accepted: the guide of
    ir_depth_pm_fusion holds the file's weights and stays in eval mode in
    the training model, and Adam holds only the main stage (that a step
    leaves the guide bitwise: tests/test_torch_port_fusion.py)."""
    import train_gpu

    path, want = guide_pt
    args = _args(tmp_path, "--model", "ir_depth_pm_fusion", "--allow_synthetic_assets",
                 "--pretrained_fusion_checkpoint", path)
    _, trainer, _ = train_gpu.setup(args)
    model = trainer.state.model
    assert model.training and not model.guide.training
    assert all(torch.equal(v, want[k]) for k, v in model.guide.state_dict().items())
    assert len(trainer.state.optimizer.param_groups[0]["params"]) == len(list(model.main.parameters()))


def test_eval_gpu_grafts_the_fusion_guide(tree, guide_pt, monkeypatch, capsys):
    """eval_gpu.py --pretrained_fusion_checkpoint: the guide is grafted after
    --checkpoint and the split is scored."""
    import eval_gpu

    import inbed_pose_estimation_tpu_torch.train.checkpoint as ckpt

    path, want = guide_pt
    grafted, real = [], ckpt.load_guide

    def spy(module, p):
        real(module, p)
        grafted.append(module.guide.state_dict())

    monkeypatch.setattr(ckpt, "load_guide", spy)
    out = eval_gpu.main(["--model", "ir_depth_pm_fusion", "--pretrained_fusion_checkpoint", path, "--dataset",
                         "slp-4mod-uncover", "--img_res", str(RES), "--batch_size", "2", "--num_workers", "1",
                         "--allow_synthetic_assets", "--device", "cpu"])
    assert len(grafted) == 1 and all(torch.equal(v, want[k]) for k, v in grafted[0].items())
    r = out["slp-4mod-uncover"]
    assert np.isfinite(r["mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"] and r["timing"]["images"] == 4


def test_from_json_merges_every_option_but_the_name(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"name": "other", "lr": 1e-3, "batch_size": 2, "remat": False}))
    args = parse_args(_args(tmp_path, "--from_json", str(cfg)))
    assert (args.name, args.lr, args.batch_size) == ("run", 1e-3, 2)
    cfg.write_text(json.dumps({"dtype": "bfloat16", "remat": "decoder"}))
    args = parse_args(_args(tmp_path, "--from_json", str(cfg)))
    assert (args.name, args.dtype, args.remat) == ("run", "bfloat16", "decoder")


@pytest.mark.slow
@pytest.mark.parametrize("smplify", [False, True], ids=["no_smplify", "smplify"])
def test_trainer_matches_jax_trainer(tree, tmp_path, capsys, smplify):
    """The port's Trainer against the JAX package's over 2 steps (one epoch
    of the 8 samples): the same JAX init through --pretrained_checkpoint,
    dropout off, augmentation off, the uint8 feed, SMPLify off or on (2
    Adam steps a stage), each side logging to its own directory, whose
    fits store the other does not read.

    Step 1: the loss and its parts within 1e-4, and the weights after it.
    Adam's first step moves each weight by lr times the sign of its
    gradient, so a weight lands where JAX's does (within one rounding of
    w - lr) or, where a gradient is rounding noise and the two signs
    differ, 2 lr away.  Readings (hmr, RES 64, batch 4): JAX's weights
    part from the port's float32 ones in 150,830 of 27.0 M places and from
    its float64 ones in 148,312, the port's float32 from its float64 in
    26,156; so at most 1% may part.  Step 2 starts from weights that differ
    there: its loss and parts within 2e-2 (readings up to 7.8e-3, on
    loss_keypoints; a wrong batch moves them by 10-30%), and no weight more
    than 2 lr a step from JAX's.  The fits store: with SMPLify, 3 rows
    after step 1 and 7 after step 2 on both sides, step 1's within 1e-4
    (reading 1.43e-5, SMPLify's 2 iterations from the same prediction, the
    slow SMPLify train-step test's limit without the feedback), step 2's
    within 3e-2 (reading 9.62e-3: it fits from weights that already part
    by 2 lr, as the losses do); without SMPLify it does not move.  The loss
    and its parts hold the same limits either way (the regression losses
    on the fits count from step 2 on).  Each step's SMPLify update moves
    the store by 0.137 and 0.344, more than 3x each limit.  Slow: the JAX
    side compiles its step."""
    import functools

    import inbed_pose_estimation_tpu.models.hmr as jhmr
    from inbed_pose_estimation_tpu import config as j_config
    from inbed_pose_estimation_tpu.data.dataset import BaseDataset as JBaseDataset
    from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
    from inbed_pose_estimation_tpu.models.heads import IEFHead
    from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
    from inbed_pose_estimation_tpu.train import Trainer as JTrainer
    from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict
    from inbed_pose_estimation_tpu.train.options import parse_args as j_parse_args
    from inbed_pose_estimation_tpu_torch import config

    def flat(tree_):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree_)[0]}

    split = "slp-4mod-train"
    extra = ["--run_smplify", "--num_smplify_iters", "2"] if smplify else []
    jparams, jfits = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(j_config.DATASET_FOLDERS, split, config.dataset_folder(split))
        mp.setitem(j_config.DATASET_FILES[1], split, config.dataset_file(split, is_train=True))
        mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
        jmodel, jspec = j_build_model(MODEL)
        variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                                            jnp.zeros((1, RES, RES, 3))))
        init = j_save_checkpoint(str(tmp_path / "init"), variables, epoch=0, batch_idx=0)
        common = _args(tmp_path / "jax", "--pretrained_checkpoint", init, *extra)[:-2]  # the JAX parser has no --device
        jopts = j_parse_args(common[:1] + ["jax"] + common[2:])
        jtrainer = JTrainer(jopts, jmodel, jspec, j_synthetic(0), j_prior(),
                            JBaseDataset(jopts, split, is_train=True, use_augmentation=False))
        jstep = jtrainer.train_step

        def jax_step(state, batch):  # the weights after each step, before the next donates them
            state, metrics = jstep(state, batch)
            jparams.append(flat(jax.device_get(state.params)))
            jfits.append(np.asarray(jax.device_get(state.fits)))
            return state, metrics

        jtrainer.train_step = jax_step
        jtrainer.train(eval_fn=None)
    finally:
        mp.undo()
    lines = re.findall(r"step \d: (.*) \|", capsys.readouterr().out)
    jmetrics = [{k: float(v) for k, v in (kv.split("=") for kv in line.split())} for line in lines]
    assert len(jmetrics) == len(jparams) == jtrainer.step_count == 2

    options = parse_args(_args(tmp_path / "port", "--pretrained_checkpoint", init, *extra))
    torch.manual_seed(1)  # not the JAX init: --pretrained_checkpoint must replace it
    model, spec = build_model(MODEL, device="cpu", dropout_rate=0.0)
    trainer = Trainer(options, model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                      BaseDataset(options, split, is_train=True, use_augmentation=False), device="cpu")
    params, fits = [], []
    fits0 = trainer.state.fits.clone().numpy()
    step = trainer.train_step

    def port_step(state, batch):
        state, metrics = step(state, batch)
        params.append(flat(convert_torch_state_dict({k: v.clone() for k, v in model.state_dict().items()})["params"]))
        fits.append(state.fits.clone().numpy())
        return state, metrics

    trainer.train_step = port_step
    trainer.train()
    metrics = [h["metrics"] for h in trainer.history if h["kind"] == "summary"]
    assert len(metrics) == len(params) == 2

    lr = options.lr
    for k, want in jmetrics[0].items():  # printed to 4 decimals
        assert metrics[0][k] == pytest.approx(want, rel=1e-4, abs=1e-4), k
    assert set(params[0]) == set(jparams[0])
    apart = total = 0
    for k, want in jparams[0].items():
        diff = np.abs(params[0][k] - want)
        assert diff.max() <= 2 * lr + 1e-6, k
        apart += int((diff > 1e-6).sum())
        total += diff.size
    assert apart <= 0.01 * total, (apart, total)
    for k, want in jmetrics[1].items():
        assert metrics[1][k] == pytest.approx(want, rel=2e-2, abs=1e-4), k
    for k, want in jparams[1].items():
        assert np.abs(params[1][k] - want).max() <= 4 * lr + 1e-6, k
    # The fits store after each step: the same rows changed on both sides
    # (none without SMPLify), the values within FITS_ATOL of JAX's, and each
    # step's SMPLify update more than 3x that limit.
    for i, atol in enumerate(FITS_ATOL):
        changed = (jfits[i] != fits0).any(axis=1)
        assert np.array_equal((fits[i] != fits0).any(axis=1), changed), i
        assert changed.sum() == (0 if not smplify else (3, 7)[i]), (i, changed.sum())
        np.testing.assert_allclose(fits[i], jfits[i], atol=atol, rtol=0)
        if smplify:  # readings 0.137 and 0.344
            before = fits0 if i == 0 else jfits[0]
            assert np.abs(jfits[i] - before).max() > 3 * atol, i
