"""The port's single-card utilities on the CPU: the span timer and honest
device timing, the trace analyzer behind ``profile-report`` (on a Chrome
trace the test writes, and on a real CPU capture, which it must refuse),
resampling against the reference, overlays against the reference, and the
``visualize``, ``compare``, ``profile-report``, ``data`` and ``segment
--trace-dir`` subcommands.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from braintpu import cli as ref_cli
from braintpu.pre.resample import resize_nearest as ref_resize_nearest
from braintpu.pre.resample import resize_trilinear as ref_resize_trilinear
from braintpu.viz.overlays import create_rgb_overlay as ref_create_rgb_overlay
from braintpu_torch import cli
from braintpu_torch.io import nifti
from braintpu_torch.pre import resize_nearest, resize_trilinear
from braintpu_torch.train.synthetic import write_synth_case
from braintpu_torch.utils.profiling import StageTimer, device_trace, timed_device
from braintpu_torch.utils.xprof import aggregate_trace, format_table, latest_trace
from braintpu_torch.viz import create_rgb_overlay


# ---------------------------------------------------------------- StageTimer


def test_stage_timer_nesting_exception_report_and_save(tmp_path):
    t = StageTimer()
    with t.span("outer"):
        with t.span("inner_a"):
            time.sleep(0.01)
        with t.span("inner_b"):
            pass
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError("x")
    with t.span("after"):
        pass
    summary = t.summary()
    assert [s["name"] for s in summary] == ["outer", "boom", "after"]
    outer = summary[0]
    assert [c["name"] for c in outer["children"]] == ["inner_a", "inner_b"]
    assert outer["seconds"] >= outer["children"][0]["seconds"] >= 0.01
    lines = t.report().splitlines()
    assert lines[0].startswith("outer") and lines[1].startswith("  inner_a")
    t.save(tmp_path / "spans.json")
    loaded = json.loads((tmp_path / "spans.json").read_text())
    assert loaded[0]["children"][1]["name"] == "inner_b"


def test_timed_device_returns_result_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))

    def fn(x):
        return {"s": (x * 2.0).sum(), "parts": [x + 1]}

    result, seconds = timed_device(fn, torch.arange(16.0), repeats=2)
    assert float(result["s"]) == float(np.arange(16.0).sum() * 2.0)
    assert seconds >= 0.0
    assert calls == []  # CPU tensors need no device sync


# ------------------------------------------------------------------- traces


def _event(name, ts, dur, cat="kernel", tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}


def _write_trace(path, events, gz=False):
    body = json.dumps({"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        *events]})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(body)
    else:
        path.write_text(body)


def _gpu_trace(path, gz=False):
    _write_trace(path, [
        _event("conv_stage_kernel<128, 2>", 0, 2000), _event("conv_stage_kernel<128, 2>", 3000, 2000),
        _event("conv_stage_kernel<128, 2>", 6000, 2000),
        _event("upconv2x_kernel", 9000, 3500), _event("upconv2x_kernel", 13000, 3500),
        _event("elementwise_kernel", 17000, 1000),
        # host ops: aten::conv3d encloses its children on one thread
        _event("aten::conv3d", 0, 5000, cat="cpu_op", tid=3),
        _event("aten::convolution", 100, 4000, cat="cpu_op", tid=3),
        _event("aten::conv3d", 6000, 5000, cat="cpu_op", tid=3),
        _event("aten::add", 12000, 500, cat="cpu_op", tid=3),
        _event("aten::add", 200, 300, cat="cpu_op", tid=4),  # another thread: top level there
        _event("cudaLaunchKernel", 150, 10, cat="cuda_runtime", tid=3),
    ], gz=gz)


def test_aggregate_trace_per_kernel_and_host_tables(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    _gpu_trace(d / "1.100.pt.trace.json")
    for target in (str(d), str(d / "1.100.pt.trace.json")):
        ops = aggregate_trace(target)
        assert [o.name for o in ops] == ["upconv2x_kernel", "conv_stage_kernel<128, 2>",
                                         "elementwise_kernel"]
        assert ops[0].total_ms == pytest.approx(7.0) and ops[0].count == 2
        assert ops[1].total_ms == pytest.approx(6.0) and ops[1].count == 3
        assert ops[1].mean_ms == pytest.approx(2.0)
    host = aggregate_trace(str(d), line="XLA Modules")
    assert {o.name: (o.count, o.total_ms) for o in host} == {
        "aten::conv3d": (2, pytest.approx(10.0)), "aten::add": (2, pytest.approx(0.8))}
    table = format_table(ops, top=2)
    assert "upconv2x_kernel" in table and "conv_stage_kernel" in table
    assert "elementwise_kernel" not in table and "(all 3 ops)" in table
    with pytest.raises(ValueError, match="line must be one of"):
        aggregate_trace(str(d), line="XLA Kernels")


def test_latest_trace_picks_the_newest_capture(tmp_path):
    assert latest_trace(str(tmp_path)) is None
    old, new = tmp_path / "a" / "1.1.pt.trace.json", tmp_path / "b" / "1.2.pt.trace.json.gz"
    old.parent.mkdir()
    new.parent.mkdir()
    _write_trace(old, [])
    _gpu_trace(new, gz=True)
    os.utime(old, (1, 1))
    assert latest_trace(str(tmp_path)) == str(new)
    assert aggregate_trace(str(tmp_path))[0].name == "upconv2x_kernel"  # read through gzip
    with pytest.raises(FileNotFoundError):
        aggregate_trace(str(tmp_path / "empty"))


def test_a_real_cpu_capture_is_refused(tmp_path):
    d = tmp_path / "cpu"
    with device_trace(str(d)):
        x = torch.randn(32, 32)
        (x @ x).relu().sum()
    assert latest_trace(str(d)) is not None
    with pytest.raises(ValueError, match="(?s)no device kernels.*cpu_op: "):
        aggregate_trace(str(d))
    with pytest.raises(ValueError, match="no device kernels"):
        aggregate_trace(str(d), line="XLA Modules")


# ---------------------------------------------------------------- resample


@pytest.mark.parametrize("shape,new", [((9, 7, 5), (13, 4, 5)), ((2, 8, 6, 10), (5, 11, 3)),
                                       ((16, 16, 16), (16, 16, 16))])
def test_resize_matches_reference(shape, new):
    vol = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = resize_trilinear(vol, new, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_resize_trilinear(vol, new)),
                               rtol=1e-6, atol=1e-6)
    labels = np.random.default_rng(1).integers(0, 4, shape).astype(np.int32)
    near = resize_nearest(torch.from_numpy(labels), new, device="cpu")
    np.testing.assert_array_equal(near.numpy(), np.asarray(ref_resize_nearest(labels, new)))
    assert got.shape[-3:] == new and near.dtype == torch.int32


def test_resize_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resize_trilinear(np.zeros((4, 4, 4), np.float32), (2, 2, 2))


# ---------------------------------------------------------------- overlays


def test_rgb_overlay_equals_reference():
    rng = np.random.default_rng(2)
    mri = rng.normal(300, 50, (40, 36)).astype(np.float32)
    seg = rng.integers(0, 5, (40, 36)).astype(np.float32)
    for alpha in (0.4, 0.7):
        got = create_rgb_overlay(mri, seg, alpha)
        want = ref_create_rgb_overlay(mri, seg, alpha)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- CLI


def test_cli_visualize_compare_and_data(tmp_path, capsys):
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00003-000", seed=3, shape=(40, 44, 36))
    seg_path = case / "BraTS-SYN-00003-000_seg.nii.gz"
    assert cli.main(["visualize", "--input", str(case), "--segmentation", str(seg_path),
                     "--output", str(tmp_path / "viz"), "--num-slices", "4"]) == 0
    pngs = sorted(p.name for p in (tmp_path / "viz").glob("*.png"))
    assert pngs == [f"BraTS-SYN-00003-000_{m}_overlay.png" for m in ("flair", "t1", "t1ce", "t2")]
    img = nifti.load(seg_path)
    pred = np.round(img.get_fdata(np.float32)).astype(np.uint8)
    pred[pred == 2] = 0  # a prediction that misses the edema
    nifti.save(pred, tmp_path / "pred.nii.gz", affine=img.affine)
    assert cli.main(["compare", "--gt", str(seg_path), "--pred", str(tmp_path / "pred.nii.gz"),
                     "--output", str(tmp_path / "cmp" / "grid.png"), "--background",
                     str(case / "BraTS-SYN-00003-000_t1.nii.gz")]) == 0
    for name in ("grid.png", "grid_labels.png"):
        assert (tmp_path / "cmp" / name).read_bytes()[:4] == b"\x89PNG"
    capsys.readouterr()

    assert cli.main(["data", "--root", str(tmp_path / "in")]) == 0
    out = capsys.readouterr().out
    assert "1 complete cases, 1 with ground truth" in out and "BraTS-SYN-00003-000" in out
    assert cli.main(["data"]) == 0
    port = capsys.readouterr().out
    assert ref_cli.main(["data"]) == 0
    ref = capsys.readouterr().out
    assert "synapse" in port.lower() and port == ref.replace("braintpu", "braintpu_torch")


def test_visualize_without_matplotlib_exits_with_a_message(tmp_path, monkeypatch):
    """matplotlib is imported when a figure is drawn: the overlay arithmetic
    and the rest of the package work without it, the drawing commands stop
    with a message."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    mri = np.ones((4, 5), np.float32)
    assert create_rgb_overlay(mri, np.zeros((4, 5))).shape == (4, 5, 3)
    with pytest.raises(SystemExit, match="matplotlib, which is not installed"):
        cli.main(["compare", "--gt", "a.nii.gz", "--pred", "b.nii.gz",
                  "--output", str(tmp_path / "c.png")])


def test_cli_profile_report_renders_the_kernel_table(tmp_path, capsys):
    _gpu_trace(tmp_path / "1.1.pt.trace.json")
    assert cli.main(["profile-report", str(tmp_path), "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "upconv2x_kernel" in out and "conv_stage_kernel" in out and "(all 3 ops)" in out
    assert cli.main(["profile-report", str(tmp_path), "--line", "XLA Modules"]) == 0
    assert "aten::conv3d" in capsys.readouterr().out


def test_cli_segment_trace_dir_on_the_cpu(tmp_path, capsys):
    """``segment --trace-dir`` writes a torch.profiler trace and prints the
    profile-report hint; the CPU capture holds host ops only, which
    profile-report refuses."""
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00004-000", seed=4, shape=(40, 44, 36))
    trace = tmp_path / "trace"
    assert cli.main(["segment", "--input", str(case), "--output", str(tmp_path / "out"),
                     "--models", "model1", "--folds", "1", "--no-tta", "--random-weights",
                     "--device", "cpu", "--trace-dir", str(trace)]) == 0
    out = capsys.readouterr().out
    assert f"capturing device trace to {trace}" in out and "profile-report" in out
    assert (tmp_path / "out" / "BraTS-SYN-00004-000.nii.gz").is_file()
    host = aggregate_trace_host_ops(trace)
    assert any(name.startswith("aten::") for name in host)
    with pytest.raises(ValueError, match="no device kernels"):
        cli.main(["profile-report", str(trace)])


def aggregate_trace_host_ops(trace_dir):
    """Names of the timed host ops of the newest capture (read directly:
    profile-report refuses a capture without device kernels)."""
    with open(latest_trace(str(trace_dir))) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "cpu_op"}
