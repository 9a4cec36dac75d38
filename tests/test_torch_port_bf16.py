"""PyTorch port, bfloat16 compute (`build_model(dtype=torch.bfloat16)`)
against the JAX package's (`build_model(dtype=jnp.bfloat16)`) on the CPU,
RES 64, batch 2, with the same seeded flax variables in both, and the two
measuring tools (`bench_gpu.py`, `tools/bench_train.py`) at CPU size.

The two packages round differently in bfloat16 (the JAX decoder's TPU
rewrites round each partial sum, cuDNN / oneDNN and XLA accumulate in other
orders), so the port is held with a ratio rule: its bfloat16 output's
distance from JAX's float32 output is at most RATIO times JAX's own
bfloat16 distance from it, plus the float32 parity tolerance (FLOOR)."""

import gc
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.evaluation.pipeline import make_inference_fn as j_make_inference_fn
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.tools.bench_train import synthetic_batch
from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step
from inbed_pose_estimation_tpu_torch.weights import load_jax_variables
from tests.test_torch_port_bodies_at_rest import jax_variables as bar_variables
from tests.test_torch_port_multi import CHANNELS, GAMMA, jax_variables, nhwc
from torch_threads import one_torch_thread  # noqa: F401

RES, B = 64, 2
RATIO = 1.5
SEEDS = (1, 2, 3, 4)
FLOOR = {"rotmat": 5e-4, "betas": 2e-4, "cam": 2e-4, "depth": 5e-4, "keypoints_3d_17": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def release_jax():
    """Drop this module's compiled JAX programs when it is done: the test
    workers share the machine's memory."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def smpl():
    return j_synthetic(0), synthetic_smpl_model(0, device="cpu"), load_j_regressor_h36m()


def _variables(name, jmodel, spec, smpl_j):
    """Seeded variables of the JAX model's tree (cross-attention gains non-zero,
    so that its float32 sums show)."""
    if spec.input_mode == "pm_contact":
        return bar_variables(name, 8, mode2=True)[1]
    zeros = tuple(jnp.zeros((1, RES, RES, CHANNELS.get(m, 1))) for m in spec.modalities)
    if spec.input_mode == "concat":
        zeros = jnp.concatenate(zeros, axis=-1)
    extra = (smpl_j,) if spec.input_mode == "fusion" else ()
    variables = jax_variables(lambda: jmodel.init(jax.random.PRNGKey(0), zeros, *extra), 0)
    if "cross_att" in variables["params"]:
        variables["params"]["cross_att"]["gamma"] = GAMMA[:len(spec.modalities)]
    return variables


def _inputs(spec, seed):
    r = np.random.default_rng(seed)
    inputs = [r.normal(0, 1, (B, CHANNELS.get(m, 1), RES, RES)).astype(np.float32) for m in spec.modalities]
    if spec.input_mode == "pm_contact":
        inputs.append(r.uniform(0, 1, (B, 2, RES, RES)).astype(np.float32))
    return inputs


def _rounded(fn, *args):
    """`fn` compiled for the shapes of `args` with XLA's excess precision
    off, so that every bfloat16 value of JAX's program is rounded, as each
    of the port's eager ops rounds its output: jitted on the CPU, XLA
    otherwise keeps fused intermediates in float32 (measured: cashmrV2's
    cam 1.8e-3 from float32 that way, 2.4e-3 rounded, the port 2.4e-3)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})


def _ratio_rule(runs):
    """The ratio rule over (JAX float32, JAX bfloat16, port bfloat16)
    outputs of each batch, each distance the root mean square over all the
    batches."""
    for k in runs[0][0]:
        d_port = np.sqrt(np.mean([np.square(got[k] - want[k]).mean() for want, _, got in runs]))
        d_jax = np.sqrt(np.mean([np.square(jax16[k] - want[k]).mean() for want, jax16, _ in runs]))
        assert d_port <= RATIO * d_jax + FLOOR[k], (k, d_port, d_jax)


def _forward_outputs(out, port):
    """rotmat, betas, cam and the depth image of a model's output (a fusion
    model's stage 2 and recovered depth) as float32 numpy arrays, NCHW's
    channel dropped."""
    if hasattr(out, "stage2"):
        out, recon = out.stage2, out.recovered
    else:
        recon = out.recon
    got = {k: np.asarray(getattr(out, k).float() if port else getattr(out, k), np.float32)
           for k in ("rotmat", "betas", "cam")}
    if "depth" in recon:
        got["depth"] = recon["depth"].float().numpy()[:, 0] if port else np.asarray(recon["depth"], np.float32)[..., 0]
    return got


@pytest.mark.parametrize("name,mode", [("featatt_cashmr", None), ("ir_depth_fusion", None),
                                       ("bodiesAtRest4mod", "0"), ("bodiesAtRest4mod", "2")])
def test_bf16_forward_matches_jax(smpl, name, mode):
    """One bfloat16 forward of each family's flagship but the concat
    family's, whose cashmrV2 `test_bf16_inference_matches_jax` runs through
    the whole eval program (one cascade pass; the fusion model's two stages with its float32 body mask;
    Bodies-At-Rest's first and refinement stacks) under the ratio rule on
    rotmat, betas, cam and the depth image (recovered, for the fusion
    model) over the batches of SEEDS.  The outputs are float32 where JAX's
    are (the fusion model's recovered images stay bfloat16 in both); the
    port's bfloat16 output differs from its float32 one; its parameters
    and statistics stay float32.

    The distance is the root mean square over the batches: the largest
    difference of one batch (cam is 6 numbers at batch 2) swings between
    0.25x and 3.6x JAX's own from one seeded batch to the next, in both
    directions and for every model (measured on the CPU), because
    bfloat16's rounding of the 2048-wide products is amplified through the
    attention's softmax and the IEF."""
    j32, spec = j_build_model(name)
    j16, _ = j_build_model(name, dtype=jnp.bfloat16)
    variables = _variables(name, j32, spec, smpl[0])
    kw = {"mode": mode} if mode else {}
    jextra, textra = ((smpl[0],), (smpl[1],)) if spec.input_mode == "fusion" else ((), ())
    jfns = [lambda v, x, m=m: m.apply(v, x, *jextra, **kw) for m in (j32, j16)]
    ports = []
    for dtype in (torch.float32, torch.bfloat16):
        port, _ = build_model(name, device="cpu", img_res=RES, dtype=dtype)
        load_jax_variables(port, variables)
        ports.append(port)
    runs = []
    for seed in SEEDS:
        inputs = _inputs(spec, seed)
        if mode == "2":  # the refinement stack's extra channel: an estimated body map in {0, 1}
            inputs.append((np.random.default_rng(seed + 10).uniform(0, 1, (B, 1, RES, RES)) > 0.7).astype(np.float32))
        if spec.input_mode in ("concat", "pm_contact"):
            inputs = [np.concatenate(inputs, axis=1)]
        jin = tuple(nhwc(x) for x in inputs) if spec.input_mode in ("multi", "fusion") else nhwc(inputs[0])
        tin = tuple(torch.from_numpy(x) for x in inputs) if spec.input_mode in ("multi", "fusion") \
            else torch.from_numpy(inputs[0])
        if seed == SEEDS[0]:
            jfns = [jax.jit(jfns[0]), _rounded(jfns[1], variables, jin)]
        jo32, jo16 = (f(variables, jin) for f in jfns)
        with torch.no_grad():
            to16 = ports[1](tin, *textra, **kw)
        runs.append((_forward_outputs(jo32, False), _forward_outputs(jo16, False), _forward_outputs(to16, True)))
        assert ("depth" in runs[-1][2]) == (spec.input_mode != "pm_contact")
    _ratio_rule(runs)

    with torch.no_grad():
        got32 = _forward_outputs(ports[0](tin, *textra, **kw), True)
    got = runs[-1][2]
    assert max(np.abs(got[k] - got32[k]).max() for k in got) > 1e-4  # bfloat16 really ran
    out16, jout16 = (to16.stage2, jo16.stage2) if spec.input_mode == "fusion" else (to16, jo16)
    for k in ("rotmat", "betas", "cam", "pose6d"):
        assert getattr(out16, k).dtype == torch.float32, k
    recon16, jrecon16 = (to16.recovered, jo16.recovered) if spec.input_mode == "fusion" else (to16.recon, jo16.recon)
    assert {k: str(v.dtype).removeprefix("torch.") for k, v in recon16.items()} == {
        k: str(v.dtype) for k, v in jrecon16.items()}
    assert all(p.dtype == torch.float32 for p in ports[1].parameters())
    assert all(b.dtype == torch.float32 for k, b in ports[1].named_buffers() if not k.endswith("num_batches_tracked"))


def _compared(out, port):
    """The compared outputs of `make_inference_fn` as float32 numpy arrays
    in the port's layout."""
    got = {k: np.asarray(out[k].float() if port else out[k], np.float32)
           for k in ("rotmat", "betas", "cam", "keypoints_3d_17")}
    depth = out["recon"]["depth"]
    got["depth"] = depth.float().numpy()[:, 0] if port else np.asarray(depth, np.float32)[..., 0]
    return got


def test_bf16_inference_matches_jax(smpl):
    """`make_inference_fn` of a bfloat16 cashmrV2 (the 2-pass cascade with
    the float32 recovered depth fed back, SMPL and the J17 regression in
    float32, the skinning in float32) against JAX's under the ratio rule on
    rotmat, betas, cam, keypoints_3d_17 and the final depth over the
    batches of SEEDS; every output is float32."""
    j32, spec = j_build_model("cashmrV2")
    j16, _ = j_build_model("cashmrV2", dtype=jnp.bfloat16)
    variables = _variables("cashmrV2", j32, spec, smpl[0])
    kw = dict(j_regressor_h36m=smpl[2], num_cas_iters=2)
    jinfer32, jinfer16 = (j_make_inference_fn(m, spec, smpl[0], **kw) for m in (j32, j16))
    jinfer32 = jax.jit(jinfer32)  # one compile, not each op's at every call
    jinfer16 = _rounded(jinfer16, variables, tuple(nhwc(x) for x in _inputs(spec, SEEDS[0])))
    port, port_spec = build_model("cashmrV2", device="cpu", dtype=torch.bfloat16)
    load_jax_variables(port, variables)
    infer = make_inference_fn(port, port_spec, smpl[1], smpl[2], num_cas_iters=2, device="cpu")
    runs = []
    for seed in SEEDS:
        inputs = _inputs(spec, seed)
        jin = tuple(nhwc(x) for x in inputs)
        out = infer(inputs)
        runs.append((_compared(jinfer32(variables, jin), False), _compared(jinfer16(variables, jin), False),
                     _compared(out, True)))
    _ratio_rule(runs)
    for k in ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17"):
        assert out[k].dtype == torch.float32, k
    assert out["recon"]["depth"].dtype == torch.float32


class Opt:
    """The JAX package's bfloat16 training guardrail's options
    (tests/test_bf16_train.py)."""
    img_res = RES
    lr = 1e-4
    run_smplify = False
    num_cas_iters = 2
    num_smplify_iters = 3
    smplify_threshold = 100.0
    shape_loss_weight = 0.0
    keypoint_loss_weight = 5.0
    beta_loss_weight = 0.001
    openpose_train_weight = 0.0
    gt_train_weight = 1.0
    remat = False


def _train(dtype, batches):
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device="cpu", dtype=dtype)
    state = init_train_state(model, Opt(), np.zeros((16, 82), np.float32), seed=1, device="cpu")
    step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                           Opt(), device="cpu")
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), state


def test_bf16_train_tracks_f32():
    """The JAX package's guardrail on the port: 5 steps of cashmrV2 (dropout
    on, the same masks in both dtypes) in bfloat16 against float32 from the
    same weights: finite, both descending, within 5% at every step; the
    parameters and Adam's moments stay float32."""
    batches = [synthetic_batch(B, RES, seed) for seed in range(5)]
    f32, _ = _train(torch.float32, batches)
    bf16, state = _train(torch.bfloat16, batches)
    assert np.isfinite(bf16).all()
    assert f32[-1] < f32[0] and bf16[-1] < bf16[0]
    rel = np.abs(bf16 - f32) / np.abs(f32)
    assert rel.max() < 0.05, rel
    assert 0 < rel.max()  # bfloat16 really ran
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [v for st in state.optimizer.state.values() for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(state.model.parameters()))
    assert all(v.dtype == torch.float32 for v in moments)


@pytest.mark.slow
def test_bf16_step_matches_jax():
    """One bfloat16 train step of cashmrV2 against JAX's, from the same
    weights (dropout off, no SMPLify, the depth feedback on), under the
    ratio rule on the loss and each of its parts, each distance the root
    mean square over the batches of SEEDS (one batch's parts move by up to
    14% in either package's bfloat16, measured); the floor is the float32
    step's parity through the feedback (rel 1e-3,
    tests/test_torch_port_train_step.py).  JAX's bfloat16 step rounds
    every bfloat16 value (`_rounded`).  Slow: JAX compiles the step in both
    dtypes."""
    import functools

    import inbed_pose_estimation_tpu.models.hmr as jhmr
    from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
    from inbed_pose_estimation_tpu.models.heads import IEFHead
    from inbed_pose_estimation_tpu.train.trainer import make_train_step as j_make_train_step
    from tests.test_torch_port_train_step import Opt as StepOpt
    from tests.test_torch_port_train_step import _batch, _fits, _nhwc, _perturb_bn_stats

    sq_port, sq_jax, want_sq = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:  # flax builds IEFHead when the model is applied
        mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
        loss_fns = {}
        for dtype in (jnp.float32, jnp.bfloat16):
            jmodel, jspec = j_build_model("cashmrV2", dtype=dtype)
            if dtype == jnp.float32:
                variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 6)))
                variables = _perturb_bn_stats(jax.tree_util.tree_map(np.asarray, variables), 1)
            loss_fns[dtype] = j_make_train_step(jmodel, jspec, j_synthetic(0), j_prior(), StepOpt())[0]._loss_fn
        for seed in SEEDS:
            args = (variables["params"], variables["batch_stats"], jnp.asarray(_fits()), _nhwc(_batch(seed)),
                    jax.random.PRNGKey(3))
            if seed == SEEDS[0]:
                loss_fns = {jnp.float32: jax.jit(loss_fns[jnp.float32]),
                            jnp.bfloat16: _rounded(loss_fns[jnp.bfloat16], *args)}
            metrics = {}
            for dtype, loss_fn in loss_fns.items():
                _, (_, _, m) = loss_fn(*args)
                metrics[dtype] = {k: float(v) for k, v in m.items()}
            port, spec = build_model("cashmrV2", device="cpu", dropout_rate=0.0, dtype=torch.bfloat16)
            load_jax_variables(port, variables)
            state = init_train_state(port, StepOpt(), _fits(), device="cpu")
            step = make_train_step(port, spec, synthetic_smpl_model(0, device="cpu"),
                                   synthetic_gmm_prior(device="cpu"), StepOpt(), device="cpu")
            _, got = step(state, _batch(seed))
            want, jax16 = metrics[jnp.float32], metrics[jnp.bfloat16]
            assert set(got) == set(want)
            for k, v in want.items():
                sq_port[k] = sq_port.get(k, 0.0) + (float(got[k]) - v) ** 2
                sq_jax[k] = sq_jax.get(k, 0.0) + (jax16[k] - v) ** 2
                want_sq[k] = want_sq.get(k, 0.0) + v ** 2
    for k in sq_port:
        d_port, d_jax = np.sqrt(sq_port[k] / len(SEEDS)), np.sqrt(sq_jax[k] / len(SEEDS))
        assert d_port <= RATIO * d_jax + 1e-3 * np.sqrt(want_sq[k] / len(SEEDS)), (k, d_port, d_jax)


def test_bench_gpu_measures_at_cpu_size():
    import bench_gpu

    line = bench_gpu.headline(bench_gpu.measure(1, 64, "cpu", 1), bench_gpu.get_baseline(), 1, 64)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 0.275373894274599, rel=1e-12)
    assert "batch-1 " in line["metric"] and "64^2" in line["metric"] and "bfloat16" in line["metric"]


def test_bench_gpu_prints_the_headline(monkeypatch, capsys):
    """main() measures at the headline's size on the card (measure stubbed
    here) and prints one JSON line, the one it returns."""
    import bench_gpu

    calls = []
    monkeypatch.setattr(bench_gpu, "measure", lambda *args: calls.append(args) or 550.75)
    line = bench_gpu.main()
    assert calls == [()] and json.loads(capsys.readouterr().out) == line
    assert line == bench_gpu.headline(550.75, bench_gpu.get_baseline())
    assert "batch-32 " in line["metric"] and "224^2" in line["metric"]


def test_bench_gpu_needs_its_baseline(tmp_path, monkeypatch):
    import bench_gpu

    monkeypatch.setattr(bench_gpu, "BASELINE_FILE", str(tmp_path / "missing.json"))
    monkeypatch.setattr(bench_gpu, "measure", lambda *args: pytest.fail("measured without a baseline"))
    with pytest.raises(FileNotFoundError, match="baseline"):
        bench_gpu.main()


def test_bench_train_runs_on_the_cpu(capsys):
    from inbed_pose_estimation_tpu_torch.tools import bench_train

    r = bench_train.main(["--batch", "2", "--res", "64", "--iters", "1", "--device", "cpu", "--remat", "decoder"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == r
    assert r["value"] > 0 and r["step_ms"] > 0 and np.isfinite(r["loss"]) and r["peak_gib"] is None
    assert "bfloat16" in r["metric"] and "remat:decoder" in r["metric"]
    assert bench_train.build_parser().parse_args([]).__dict__ == {
        "batch": 32, "res": 224, "num_cas_iters": 2, "run_smplify": False, "num_smplify_iters": 100,
        "remat": False, "iters": 10, "dtype": "bfloat16", "device": "cuda"}
