"""PyTorch port, the host-side tools on the CPU at a tiny size: each tool's
`main` prints the JAX package's tool's JSON keys with finite values,
`loader_bench` refuses a crop cache that the dataset refuses and turns its
order each round, and `profile_mfu`'s closed-form FLOPs are the JAX tool's,
with `mfu_counted` from the counted FLOPs beside its `mfu`."""

import functools
import json

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu.tools.profile_mfu import _analytic_inference_flops as j_analytic_flops
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
from inbed_pose_estimation_tpu_torch.tools import latency_mode, loader_bench, profile_mfu
from inbed_pose_estimation_tpu_torch.tools.build_crop_cache import main as build_cache
from torch_threads import one_torch_thread  # noqa: F401

# The keys of the JAX tools' lines.
LATENCY_ROWS = ("rtt", "noop", "resident_2fetch", "resident", "u8_h2d", "u8_put_only", "f32_h2d")
LATENCY_DERIVED = ("tunnel_rtt_ms", "dispatch_overhead_ms", "compute_ms", "second_fetch_ms", "u8_upload_cost_ms",
                   "u8_put_only_ms", "f32_upload_cost_ms", "h2d_mb_per_s_u8", "h2d_mb_per_s_f32")
MFU_KEYS = ("what", "batch", "res", "step_ms", "images_per_sec", "gflops_per_step", "flops_source",
            "achieved_tflops", "mfu", "device")
LOADER_CONFIGS = ["disk", "disk+fast", "cache", "cache+fast"]
LOADER_ARGS = ["--img_res", "64", "--batch_size", "2", "--batches", "1"]


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_latency_mode_prints_the_jax_rows(capsys, monkeypatch):
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


@pytest.fixture
def cached_tree(tmp_path, monkeypatch):
    """A synthetic tree (6 training rows) with INBED_* pointed at it and the
    train split's crop cache at RES 64; returns the cache's directory."""
    env = write_synthetic_environment(str(tmp_path), num_subjects=1, samples_per_subject=3)
    monkeypatch.setenv("INBED_DATA_ROOT", env["data_root"])
    monkeypatch.setenv("INBED_NPZ_PATH", env["npz_path"])
    cache = str(tmp_path / "cache")
    build_cache(["--dataset", "slp-4mod-train", "--out", cache, "--img_res", "64", "--progress_every", "0"])
    return cache


def test_loader_bench_turns_its_order_each_round(cached_tree, monkeypatch, capsys):
    """An accepted cache is timed, and round r starts at the r-th
    configuration (after one warm-up batch each, in the table's order)."""
    calls, time_config = [], loader_bench.time_config

    def spy(ds, batches, seed):
        calls.append((("cache" if ds._cache is not None else "disk") + ("+fast" if ds.options.fast_preprocess
                                                                           else ""), seed))
        return time_config(ds, batches, seed)

    monkeypatch.setattr(loader_bench, "time_config", spy)
    got = loader_bench.main(LOADER_ARGS + ["--rounds", "5", "--crop_cache", cached_tree])
    assert _lines(capsys)[-1] == got and list(got["configs"]) == LOADER_CONFIGS
    assert all(c["n"] == 5 and np.isfinite(c["median_ms"]) for c in got["configs"].values())
    assert calls[:4] == [(name, 999) for name in LOADER_CONFIGS]
    for r in range(5):
        turned = LOADER_CONFIGS[r % 4:] + LOADER_CONFIGS[:r % 4]
        assert calls[4 + 4 * r:8 + 4 * r] == [(name, 1000 + r) for name in turned], r


@pytest.mark.parametrize("fault", ["stale", "missing", "narrow"])
def test_loader_bench_raises_on_a_refused_cache(cached_tree, fault, tmp_path, capsys):
    """A cache that the dataset refuses (built for a longer split, absent,
    or for a narrower scale range than the run asks) raises, naming the
    configuration, where the JAX tool timed disk reads as "cache"."""
    argv = LOADER_ARGS + ["--rounds", "1", "--crop_cache", cached_tree]
    if fault == "stale":  # the split loses a row after the build
        path = config.dataset_file("slp-4mod-train", is_train=True)
        with np.load(path) as full:
            index = {k: full[k][:-1] for k in full.files}
        np.savez(path, **index)
    elif fault == "missing":
        argv[-1] = str(tmp_path / "no_cache")
    else:
        argv += ["--scale_factor", "0.3"]
    with pytest.raises(ValueError, match="configuration 'cache': the crop cache in .* was refused"):
        loader_bench.main(argv)
    assert "crop cache: " in capsys.readouterr().out  # the dataset's own reason, printed


@pytest.mark.parametrize("batch,res,num_cas", [(32, 224, 2), (64, 224, 2), (2, 64, 1), (7, 96, 3)])
def test_profile_mfu_closed_form_flops_are_the_jax_tools(batch, res, num_cas):
    assert profile_mfu.analytic_inference_flops(batch, res, num_cas) == j_analytic_flops(batch, res, num_cas)


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_profile_mfu_prints_the_jax_keys(train, capsys, tmp_path):
    argv = ["--batches", "2", "--res", "64", "--iters", "2", "--device", "cpu"]
    if train:
        argv += ["--train", "--dtype", "float32"]  # bfloat16 convolutions are slow on the CPU
    else:
        argv += ["--trace_dir", str(tmp_path)]
    rows = profile_mfu.main(argv)
    lines = _lines(capsys)
    assert lines[:1] == rows and len(rows) == 1
    row = rows[0]
    assert set(row) == set(MFU_KEYS) | {"gflops_counted", "mfu_counted"}
    assert row["what"] == ("cashmrV2 train step float32" if train else "cashmrV2 inference")
    assert row["batch"] == 2 and row["device"] == "cpu"
    assert row["mfu"] is None and row["mfu_counted"] is None  # no peak for the CPU
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


@pytest.mark.parametrize("peak", [1e12, None], ids=["peak", "no_peak"])
def test_profile_mfu_counted_mfu_is_the_counted_flops_over_the_peak(peak, monkeypatch):
    if peak is not None:
        monkeypatch.setitem(profile_mfu.PEAK_FLOPS, "cpu", {"bfloat16": peak})
    row = profile_mfu._row("x", 2, 64, 12.5, 3.0e9, 14.1e9, torch.device("cpu"), "bfloat16", torch)
    if peak is None:
        assert row["mfu"] is None and row["mfu_counted"] is None
    else:
        assert row["mfu_counted"] == pytest.approx(row["gflops_counted"] * 1e9 / (row["step_ms"] / 1e3) / peak,
                                                   rel=1e-12)
        assert row["mfu"] == pytest.approx(3.0e9 / 12.5e-3 / peak, rel=1e-12)
        assert row["mfu_counted"] / row["mfu"] == pytest.approx(14.1 / 3.0, rel=1e-12)
