"""PyTorch port, its spans on the CPU (RES 64, batch 2): a cashmrV2, an
ir_depth_pm_fusion and a featatt_cashmr eval call and a cashmrV2 train
step with SMPLify under torch.profiler, read back from the exported Chrome
trace: each span's count per call and its place in the tree under
`eval.call` / `train.step`;
the outputs bitwise equal with the profiler on and off; no
`record_function` at all with no profiler running; and `StepTimer`'s
phases as `<scope>.<phase>` spans."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys
from inbed_pose_estimation_tpu_torch.utils.profiling import StepTimer, span
from torch_threads import one_torch_thread  # noqa: F401

RES, B, CALLS = 64, 2, 2

# Spans per eval call (with the CLI's final_recon=False).
EVAL_SPANS = {
    "cashmrV2": {"eval.call": 1, "eval.h2d": 1, "hmr.trunk": 2, "hmr.decoder": 1, "hmr.ief": 2, "smpl.lbs": 1,
                 "eval.j17": 1},
    "ir_depth_pm_fusion": {"eval.call": 1, "eval.h2d": 1, "hmr.trunk": 4, "fusion.recover": 2, "hmr.ief": 4,
                           "smpl.lbs": 3, "ops.body_mask": 2, "eval.j17": 1},
    "featatt_cashmr": {"eval.call": 1, "eval.h2d": 1, "hmr.multi_trunk": 2, "hmr.trunk": 8, "hmr.cross_att": 2,
                       "hmr.decoder": 1, "hmr.ief": 2, "smpl.lbs": 1, "eval.j17": 1},
}
# The direct parent span of a span, where it is not `eval.call`.
EVAL_PARENTS = {"featatt_cashmr": {"hmr.trunk": "hmr.multi_trunk"}}


@pytest.fixture(scope="module")
def smpl():
    return synthetic_smpl_model(0, device="cpu")


def _infer(name, smpl):
    torch.manual_seed(0)
    model, spec = build_model(name, device="cpu", img_res=RES)
    infer = make_inference_fn(model, spec, smpl, j_regressor_h36m=load_j_regressor_h36m(), final_recon=False,
                              device="cpu")
    r = np.random.default_rng(1)
    inputs = tuple(r.normal(0, 1, (B, 3 if m == "img" else 1, RES, RES)).astype(np.float32) for m in spec.modalities)
    return infer, inputs


def traced_spans(fn, tmp_path):
    """fn() under torch.profiler; returns fn's result and the trace's spans
    as (name, parent span's index or None), parents found by containment
    on the same thread.  torch's own spans (`Optimizer.step#Adam.step`)
    are left out."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["tid"], round(float(e["ts"]) * 1000), -round(float(e["dur"]) * 1000), e["name"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and "#" not in e["name"])
    tree, stack = [], []
    for tid, start, neg_dur, name in spans:
        end = start - neg_dur
        while stack and (stack[-1][0] != tid or stack[-1][2] < end):
            stack.pop()
        tree.append((name, stack[-1][3] if stack else None))
        stack.append((tid, start, end, len(tree) - 1))
    return result, tree


def _ancestors(tree, i):
    names = []
    while tree[i][1] is not None:
        i = tree[i][1]
        names.append(tree[i][0])
    return names


@pytest.mark.parametrize("name", sorted(EVAL_SPANS))
def test_eval_call_spans(name, smpl, tmp_path):
    """Each call's spans sit under its own `eval.call`, in the table's
    counts, and the outputs do not change under the profiler."""
    infer, inputs = _infer(name, smpl)
    want = infer(inputs)
    outs, tree = traced_spans(lambda: [infer(inputs) for _ in range(CALLS)], tmp_path)
    counts = Counter(n for n, _ in tree)
    assert counts == Counter({k: v * CALLS for k, v in EVAL_SPANS[name].items()})
    roots = [i for i, (n, parent) in enumerate(tree) if parent is None]
    assert [tree[i][0] for i in roots] == ["eval.call"] * CALLS
    for i, (n, _) in enumerate(tree):
        if n != "eval.call":
            assert _ancestors(tree, i)[-1] == "eval.call", n
    per_call = Counter(n for i, (n, _) in enumerate(tree) if i >= roots[1])
    assert per_call == Counter(EVAL_SPANS[name])
    assert {tree[i][1] for i, (n, _) in enumerate(tree) if n == "eval.h2d"} == set(roots)
    for child, parent in EVAL_PARENTS.get(name, {}).items():
        assert {tree[p][0] for n, p in tree if n == child} == {parent}, child
    for out in outs:
        assert out.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, dict):
                assert all(torch.equal(out[k][kk], vv) for kk, vv in v.items()), k
            else:
                assert torch.equal(out[k], v), k


class Opt:
    img_res = RES
    lr = 5e-5
    run_smplify = True
    num_cas_iters = 2
    num_smplify_iters = 1
    smplify_threshold = 100.0
    shape_loss_weight = 0.0
    keypoint_loss_weight = 5.0
    beta_loss_weight = 0.001
    openpose_train_weight = 0.0
    gt_train_weight = 1.0


def _train_batch(keys):
    r = np.random.default_rng(2)
    batch = {k: r.normal(0, 1, (B, 3 if k == "img" else 1, RES, RES)).astype(np.float32)
             for k in keys if k.endswith(("img", "_uncover"))}
    batch.update({
        "keypoints": np.concatenate([r.uniform(-1, 1, (B, 49, 2)), np.ones((B, 49, 1))], -1).astype(np.float32),
        "pose": r.normal(0, 0.2, (B, 72)).astype(np.float32),
        "betas": r.normal(0, 0.5, (B, 10)).astype(np.float32),
        "pose_3d": np.concatenate([r.normal(0, 0.3, (B, 24, 3)), np.ones((B, 24, 1))], -1).astype(np.float32),
        "has_smpl": np.zeros(B, np.float32),
        "has_pose_3d": np.ones(B, np.float32),
        "is_flipped": np.array([0.0, 1.0], np.float32),
        "rot_angle": np.array([0.0, 15.0], np.float32),
        "sample_index": np.array([3, 7], np.int32),
    })
    return {k: v for k, v in batch.items() if k in keys}


def test_train_step_spans(smpl, tmp_path):
    """A cashmrV2 step with SMPLify at 1 iteration: the stages under
    `train.step`, SMPLify and the model's spans under `train.loss`, and
    SMPL's forward 6 + 2N times (the skinning kernel's launches a step)."""
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device="cpu", img_res=RES)
    state = init_train_state(model, Opt(), np.zeros((16, 82), np.float32), seed=1, device="cpu")
    step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device="cpu"), Opt(), device="cpu")
    (state, metrics), tree = traced_spans(lambda: step(state, _train_batch(step_feed_keys(spec))), tmp_path)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    counts = Counter(n for n, _ in tree)
    assert counts == Counter({"train.step": 1, "train.h2d": 1, "train.loss": 1, "fitting.smplify": 1,
                              "train.backward": 1, "train.allreduce": 1, "train.optimizer": 1,
                              "hmr.trunk": 2, "hmr.decoder": 2, "hmr.ief": 2,
                              "smpl.lbs": 6 + 2 * Opt.num_smplify_iters})
    assert [n for n, parent in tree if parent is None] == ["train.step"]
    for i, (n, parent) in enumerate(tree):
        if n.startswith("train.") and n != "train.step":
            assert tree[parent][0] == "train.step", n
        elif not n.startswith("train."):
            assert _ancestors(tree, i)[-2:] == ["train.loss", "train.step"], n
    assert _ancestors(tree, [n for n, _ in tree].index("fitting.smplify"))[0] == "train.loss"


def test_no_record_function_without_a_profiler(smpl, monkeypatch):
    """With no profiler running, a span is the gate check alone: an eval
    call and a timed phase never reach `record_function`."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("hmr.trunk") is span("smpl.lbs")
    infer, inputs = _infer("cashmrV2", smpl)
    infer(inputs)
    timer = StepTimer("train")
    with timer.phase("data"):
        pass
    assert timer.counts["data"] == 1
    with pytest.raises(AssertionError, match="hmr.trunk"), profile(activities=[ProfilerActivity.CPU]):
        span("hmr.trunk")


def test_step_timer_phases_are_spans(tmp_path):
    """Each phase is a `<scope>.<phase>` span around what it times, and
    the host-clock totals and means keep their keys and meaning."""
    timer = StepTimer("train")

    def run():
        for name in ("data", "dispatch", "data", "sync"):
            with timer.phase(name):
                with span("inner"):
                    pass

    _, tree = traced_spans(run, tmp_path)
    assert [n for n, parent in tree if parent is None] == ["train.data", "train.dispatch", "train.data", "train.sync"]
    assert all(tree[parent][0].startswith("train.") for n, parent in tree if n == "inner")
    assert dict(timer.counts) == {"data": 2, "dispatch": 1, "sync": 1}
    assert set(timer.means) == {"data", "dispatch", "sync"} and all(v >= 0 for v in timer.means.values())
    assert timer.summary().startswith("data=")
