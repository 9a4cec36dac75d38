"""PyTorch port, the host-side tools on the CPU at a tiny size: each tool's
`main` prints the JAX package's tool's JSON keys with finite values, and
`profile_mfu`'s closed-form FLOPs are the JAX tool's."""

import functools
import json

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu.tools.profile_mfu import _analytic_inference_flops as j_analytic_flops
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
from inbed_pose_estimation_tpu_torch.tools import latency_mode, loader_bench, profile_mfu

# The keys of the JAX tools' lines.
LATENCY_ROWS = ("rtt", "noop", "resident_2fetch", "resident", "u8_h2d", "u8_put_only", "f32_h2d")
LATENCY_DERIVED = ("tunnel_rtt_ms", "dispatch_overhead_ms", "compute_ms", "second_fetch_ms", "u8_upload_cost_ms",
                   "u8_put_only_ms", "f32_upload_cost_ms", "h2d_mb_per_s_u8", "h2d_mb_per_s_f32")
MFU_KEYS = ("what", "batch", "res", "step_ms", "images_per_sec", "gflops_per_step", "flops_source",
            "achieved_tflops", "mfu", "device")


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_latency_mode_prints_the_jax_rows(capsys, monkeypatch, one_torch_thread):
    # One warm-up request a row instead of 5: this is a check of the rows,
    # not a measurement.
    monkeypatch.setattr(latency_mode, "_time_requests", functools.partial(latency_mode._time_requests, warm=1))
    got = latency_mode.main(["--batch", "2", "--res", "64", "--iters", "2", "--device", "cpu"])
    lines = _lines(capsys)
    assert [ln["mode"] for ln in lines] == ["rtt", "noop", "resident_2fetch", "resident", "u8_h2d", "u8_put_only",
                                            "f32_h2d", "derived"]
    for ln in lines[:-1]:
        assert set(ln) == {"mode", "median_ms", "min_ms"} and 0 <= ln["min_ms"] <= ln["median_ms"] < 1e5
    derived = lines[-1]
    assert set(derived) == set(LATENCY_DERIVED) | {"mode", "device"} and derived["device"] == "cpu"
    assert all(np.isfinite(derived[k]) for k in LATENCY_DERIVED)
    assert set(got) == set(LATENCY_ROWS) | {"derived"}


def test_loader_bench_times_each_config_on_a_synthetic_tree(tmp_path, monkeypatch, capsys):
    env = write_synthetic_environment(str(tmp_path), num_subjects=1, samples_per_subject=3)
    monkeypatch.setenv("INBED_DATA_ROOT", env["data_root"])
    monkeypatch.setenv("INBED_NPZ_PATH", env["npz_path"])
    got = loader_bench.main(["--img_res", "64", "--batch_size", "2", "--batches", "2", "--rounds", "2"])
    assert _lines(capsys) == [got]
    assert set(got) == {"batch_size", "img_res", "dataset", "configs"} and got["dataset"] == "slp-4mod-train"
    assert set(got["configs"]) == {"disk", "disk+fast"}
    for cfg in got["configs"].values():
        assert set(cfg) == {"median_ms", "iqr_ms", "n", "speedup_vs_disk"} and cfg["n"] == 4
        assert np.isfinite(cfg["median_ms"]) and cfg["iqr_ms"][0] <= cfg["iqr_ms"][1]
    assert got["configs"]["disk"]["speedup_vs_disk"] == 1.0


@pytest.mark.parametrize("batch,res,num_cas", [(32, 224, 2), (64, 224, 2), (2, 64, 1), (7, 96, 3)])
def test_profile_mfu_closed_form_flops_are_the_jax_tools(batch, res, num_cas):
    assert profile_mfu.analytic_inference_flops(batch, res, num_cas) == j_analytic_flops(batch, res, num_cas)


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_profile_mfu_prints_the_jax_keys(train, capsys, tmp_path, one_torch_thread):
    argv = ["--batches", "2", "--res", "64", "--iters", "2", "--device", "cpu"]
    if train:
        argv += ["--train", "--dtype", "float32"]  # bfloat16 convolutions are slow on the CPU
    else:
        argv += ["--trace_dir", str(tmp_path)]
    rows = profile_mfu.main(argv)
    lines = _lines(capsys)
    assert lines[:1] == rows and len(rows) == 1
    row = rows[0]
    assert set(row) == set(MFU_KEYS) | {"gflops_counted"}
    assert row["what"] == ("cashmrV2 train step float32" if train else "cashmrV2 inference")
    assert row["batch"] == 2 and row["device"] == "cpu" and row["mfu"] is None  # no peak for the CPU
    assert row["gflops_per_step"] == (3.0 if train else 1.0) * j_analytic_flops(2, 64, 2) / 1e9
    for k in ("step_ms", "images_per_sec", "achieved_tflops", "gflops_counted"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    if not train:
        assert (tmp_path / "profile_mfu_trace.json").exists() and lines[-1] == {
            "trace": str(tmp_path / "profile_mfu_trace.json")}


def test_profile_mfu_peaks_name_the_h100():
    assert profile_mfu.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert profile_mfu.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert profile_mfu.peak_flops("cpu", "bfloat16") is None
