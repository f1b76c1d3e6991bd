"""The PyTorch port on its own: import hygiene, no hidden fallback, the build
helper, the CLI, and the card-only checks (marked ``gpu``).

Whether a card is present is decided inside fixtures and tests, never at
import or collection time.
"""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from braintpu_torch import cli
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle, resolve_device
from braintpu_torch.io import nifti
from braintpu_torch.models import unet3d
from braintpu_torch.ops import _build
from braintpu_torch.ops.conv3d import conv3d_tap_merged, conv3d_tap_merged_ref
from braintpu_torch.ops.int8_probe import int8_matmul, int8_matmul_ref
from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref
from braintpu_torch.tools import probe
from braintpu_torch.train.synthetic import write_synth_case

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "braintpu_torch"
CKPTS = REPO / "results" / "trained_synth" / "checkpoints"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "braintpu_torch."))


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------


def test_import_pulls_in_neither_jax_nor_the_reference():
    mods = ["braintpu_torch"] + _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'braintpu' or m.startswith('braintpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(mods) >= 20  # every subpackage and module was imported


def test_no_port_file_names_jax_or_the_reference_package():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [REPO / "chip_smoke.py"]
    imports_ref = re.compile(r"^\s*(import|from)\s+braintpu(\.|\s|$)", re.M)
    for f in files:
        text = f.read_text()
        assert not imports_ref.search(text), f
        assert not re.search(r"\bbraintpu\.", text), f
        # the name of the mandated params_from_jax is no import of the framework
        assert not re.search(r"\bjax\b", text, re.I), f


# ---------------------------------------------------------------------------
# No hidden fallback
# ---------------------------------------------------------------------------


def _tiny_bundle():
    cfg = unet3d.UNetConfig(base_features=8, max_features=16, num_pool=2)
    rng = np.random.default_rng(0)

    def block(ci, co):
        return {"w": torch.from_numpy(rng.standard_normal((3, 3, 3, ci, co)).astype(np.float32)),
                **{k: torch.ones(co) for k in ("b", "scale", "shift", "mean", "var")}}

    enc = unet3d.encoder_features(cfg)
    params = {"encoder": [], "bottleneck": [], "decoder": []}
    cin = cfg.in_channels
    for f in enc:
        params["encoder"].append([block(cin, f), block(f, f)])
        cin = f
    bneck = unet3d.bottleneck_features(cfg)
    params["bottleneck"] = [block(cin, bneck), block(bneck, bneck)]
    for ch in unet3d.decoder_channels(cfg):
        params["decoder"].append({
            "up": {"w": torch.zeros(ch["from_down"], 2, 2, 2, ch["skip"])},
            "blocks": [block(2 * ch["skip"], ch["skip"]), block(ch["skip"], ch["out"])],
            "seg": {"w": torch.zeros(1, 1, 1, ch["out"], cfg.num_classes)},
        })
    return ModelBundle.from_folds(cfg, [params])


def test_engine_without_card_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = _tiny_bundle()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(models=[bundle])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    eng = InferenceEngine(models=[bundle], device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.warmup((20, 24, 16)) > 0  # a dummy case through the whole engine


def test_engine_rejects_what_is_not_ported():
    bundle = _tiny_bundle()
    with pytest.raises(NotImplementedError, match="not ported"):
        InferenceEngine(models=[bundle], mode="sliding", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        unet3d.apply_unet({}, torch.zeros(1, 32, 32, 32, 4), unet3d.MODEL1_BN, folded=False)


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "b_dtype", "shape", "channels"])
def test_conv_wrapper_validates_before_dispatch(bad):
    x = torch.zeros(1, 4, 8, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 8, 16, dtype=torch.bfloat16)
    b = torch.zeros(16)
    if bad == "x_dtype":
        x = x.float()
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "b_dtype":
        b = b.bfloat16()
    elif bad == "shape":
        w = torch.zeros(3, 3, 1, 8, 16, dtype=torch.bfloat16)
    else:
        w = torch.zeros(3, 3, 3, 4, 16, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        conv3d_tap_merged(x, w, b)


def test_conv_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU is launched on or refused -- here a
    ``meta`` tensor, which no kernel can take, must raise."""
    x = torch.zeros(1, 4, 8, 8, 8, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(3, 3, 3, 8, 16, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(16, device="meta")
    before = conv3d_tap_merged.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv3d_tap_merged(x, w, b)
    assert conv3d_tap_merged.launches == before


def test_cpu_call_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 9, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 8, 16)).astype(np.float32) * 0.1).bfloat16()
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    before = conv3d_tap_merged.launches
    y = conv3d_tap_merged(x, w, b, 0.01)
    assert conv3d_tap_merged.launches == before
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 8, 9, 16)
    assert torch.equal(y, conv3d_tap_merged_ref(x, w, b, 0.01))


def _stage_args(N=1, D=3, H=8, W=9, ci1=8, ci2=8, co=16, device="cpu"):
    g = torch.Generator().manual_seed(0)
    x1 = torch.randn(N, D, H, W, ci1, generator=g).bfloat16().to(device)
    x2 = torch.randn(N, D, H, W, ci2, generator=g).bfloat16().to(device) if ci2 else None
    w = (torch.randn(3, 3, 3, ci1 + ci2, co, generator=g) / (27 * (ci1 + ci2)) ** 0.5)
    b = torch.randn(co, generator=g) * 0.1
    aff = dict(a1=torch.rand(N, ci1, generator=g) + 0.5, c1=torch.randn(N, ci1, generator=g))
    if ci2:
        aff.update(a2=torch.rand(ci2, generator=g) + 0.5, c2=torch.randn(ci2, generator=g))
    return (x1, w.bfloat16().to(device), b.to(device), x2,
            {k: v.to(device) for k, v in aff.items()})


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "b_dtype", "channels", "x2_shape",
                                 "affine_shape", "affine_half", "affine_without_x2"])
def test_stage_wrapper_validates_before_dispatch(bad):
    x1, w, b, x2, aff = _stage_args()
    if bad == "x_dtype":
        x1 = x1.float()
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "b_dtype":
        b = b.bfloat16()
    elif bad == "channels":
        x2 = x2[..., :0]
    elif bad == "x2_shape":
        x2 = x2[:, :2]
    elif bad == "affine_shape":
        aff["a1"] = aff["a1"][:, :4]
    elif bad == "affine_half":
        del aff["c2"]
    else:
        x2 = None
        w = w[:, :, :, :8]
    with pytest.raises((TypeError, ValueError)):
        conv_stage(x1, w, b, x2=x2, stats=True, **aff)


def test_stage_and_upconv_wrappers_never_fall_back_off_cpu():
    x1, w, b, x2, aff = (t.to("meta") if isinstance(t, torch.Tensor) else t
                         for t in _stage_args(ci2=0)[:4] + (None,))
    before = conv_stage.launches, upconv2x.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv_stage(x1, w, b)
    xu = torch.zeros(1, 2, 2, 2, 16, dtype=torch.bfloat16, device="meta")
    wu = torch.zeros(16, 2, 2, 2, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        upconv2x(xu, wu)
    assert (conv_stage.launches, upconv2x.launches) == before


def test_stage_and_upconv_cpu_calls_run_the_plain_versions_and_count_no_launch():
    x1, w, b, x2, aff = _stage_args(N=2)
    before = conv_stage.launches, upconv2x.launches
    y, s1, s2 = conv_stage(x1, w, b, x2=x2, in1_slope=0.01, in2_slope=0.01, stats=True, **aff)
    ry, r1, r2 = conv_stage_ref(x1, w, b, x2=x2, in1_slope=0.01, in2_slope=0.01, stats=True,
                                **aff)
    assert torch.equal(y, ry) and torch.equal(s1, r1) and torch.equal(s2, r2)
    assert y.shape == (2, 3, 8, 9, 16) and s1.shape == s2.shape == (2, 16)
    xu = x1[..., :8].contiguous()
    wu = torch.randn(8, 2, 2, 2, 24).bfloat16()
    u = upconv2x(xu, wu)
    assert u.shape == (2, 6, 16, 18, 24) and torch.equal(u, upconv2x_ref(xu, wu))
    assert (conv_stage.launches, upconv2x.launches) == before


def test_upconv_wrapper_validates_before_dispatch():
    x = torch.zeros(1, 2, 2, 2, 16, dtype=torch.bfloat16)
    for w in (torch.zeros(16, 2, 2, 2, 8), torch.zeros(16, 3, 2, 2, 8, dtype=torch.bfloat16),
              torch.zeros(8, 2, 2, 2, 8, dtype=torch.bfloat16)):
        with pytest.raises((TypeError, ValueError)):
            upconv2x(x, w)


# ---------------------------------------------------------------------------
# Build helper (no nvcc here: only what does not compile)
# ---------------------------------------------------------------------------


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text("// v1\n")
    p1 = _build._lib_path("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    p2 = _build._lib_path("k")
    assert p1 != p2 and p1.parent == p2.parent == tmp_path / "_build"
    assert re.fullmatch(r"libk-[0-9a-f]{16}\.so", p2.name)


def test_build_without_nvcc_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("conv3d_tap_merged")
    assert not any((tmp_path / "_build").glob("*")) if (tmp_path / "_build").exists() else True


def test_ptxas_summary_reads_registers_smem_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z6kernel' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z6kernel\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers, 29696 bytes smem, 400 bytes cmem[0]\n")
    assert _build._ptxas_summary(log) == "registers=80 smem_bytes=29696 spill_stores=0 spill_loads=0"


def test_every_cuda_source_has_a_c_launcher():
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        assert re.search(rf'extern "C" int {src.stem}_launch\(', text), src
        assert "braintpu/ops/" in text  # names the TPU kernel it replaces
        assert "torch/extension.h" not in text


# ---------------------------------------------------------------------------
# CLI on the CPU
# ---------------------------------------------------------------------------


def test_cli_segment_and_evaluate_on_cpu(tmp_path, capsys):
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    out = tmp_path / "out"
    rc = cli.main(["segment", "--input", str(case), "--output", str(out), "--checkpoints",
                   str(CKPTS), "--models", "model1", "--folds", "2", "--device", "cpu"])
    assert rc == 0
    pred = out / "BraTS-SYN-00200-000.nii.gz"
    seg = nifti.load(pred).get_fdata(np.float32)
    assert seg.shape == (40, 40, 36) and set(np.unique(seg)) <= {0, 1, 2, 3}
    capsys.readouterr()
    assert cli.main(["evaluate", "--pred", str(pred), "--gt",
                     str(case / "BraTS-SYN-00200-000_seg.nii.gz")]) == 0
    report = json.loads(capsys.readouterr().out.split("\nMean Dice")[0])
    assert set(report["compound"]) == {"WT", "TC", "ET"}
    assert 0.0 <= report["mean_dice"] <= 1.0


def _model1_only_checkpoints(tmp_path):
    """A checkpoint root holding model1's trained folds and no model2."""
    root = tmp_path / "ckpts"
    (root / "model1").mkdir(parents=True)
    for f in (0, 1):
        (root / "model1" / f"fold_{f}.npz").symlink_to(CKPTS / "model1" / f"fold_{f}.npz")
    return root


def test_cli_two_models_random_weights_for_the_missing_model(tmp_path, capsys):
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00003-000", seed=3, shape=(30, 28, 26))
    root = _model1_only_checkpoints(tmp_path)
    rc = cli.main(["segment", "--input", str(case), "--output", str(tmp_path / "out"),
                   "--checkpoints", str(root), "--models", "model1,model2", "--folds", "1",
                   "--no-tta", "--random-weights", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "# model1: folds loaded [0]; random none" in out
    assert "# model2: folds loaded none; random ['0 (seed 1000)']" in out
    seg = nifti.load(tmp_path / "out" / "BraTS-SYN-00003-000.nii.gz").get_fdata(np.float32)
    assert seg.shape == (30, 28, 26) and set(np.unique(seg)) <= {0, 1, 2, 3}


def test_cli_load_engine_draws_the_reference_seeds_and_refuses_without_the_flag(tmp_path):
    root = _model1_only_checkpoints(tmp_path)
    args = cli.build_parser().parse_args(
        ["segment", "--input", "x", "--output", "y", "--checkpoints", str(root),
         "--folds", "2", "--random-weights", "--device", "cpu"])
    assert args.models == "model1,model2"  # the reference's default ensemble
    eng = cli.load_engine(args)
    m1, m2 = eng.models
    assert (m1.name, m1.folded, m2.name, m2.folded) == ("model1", True, "model2", False)
    for f, params in enumerate(m2.fold_params):
        want = unet3d.init_params(unet3d.MODEL2_GN_LARGE, 1000 + f)
        assert torch.equal(params["decoder"][0]["up"]["w"],
                           want["decoder"][0]["up"]["w"].to(torch.bfloat16))
    args.random_weights = False
    with pytest.raises(SystemExit, match="model2/fold_0 not found"):
        cli.load_engine(args)


def test_nifti_save_load_f32_round_trip(tmp_path):
    data = np.arange(4 * 5 * 6, dtype=np.int16).reshape(4, 5, 6)
    affine = np.diag([1.0, 1.5, 2.0, 1.0])
    affine[:3, 3] = (-10.0, 4.0, 7.5)
    nifti.save(data, tmp_path / "v.nii.gz", affine=affine)
    vol, aff, zooms = nifti.load_f32(tmp_path / "v.nii.gz")
    assert vol.dtype == np.float32
    np.testing.assert_array_equal(vol, data)
    np.testing.assert_allclose(aff, affine, atol=1e-6)
    assert zooms == (1.0, 1.5, 2.0)


def test_cli_refuses_missing_checkpoints(tmp_path):
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00001-000", seed=1, shape=(24, 24, 24))
    with pytest.raises(SystemExit, match="not found"):
        cli.main(["segment", "--input", str(case), "--output", str(tmp_path / "o"),
                  "--checkpoints", str(tmp_path), "--folds", "1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# On the card only (marker ``gpu``)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("slope", [None, 0.01])
@pytest.mark.parametrize("shape", [(1, 5, 9, 13, 24, 40), (2, 4, 8, 8, 8, 8),
                                   (1, 64, 64, 48, 128, 64), (1, 56, 56, 32, 256, 128)])
def test_gpu_kernel_matches_plain_version(cuda, shape, slope):
    N, D, H, W, ci, co = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(N, D, H, W, ci, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, device=cuda, generator=g) / (27 * ci) ** 0.5).bfloat16()
    b = torch.randn(co, device=cuda, generator=g) * 0.1
    before = conv3d_tap_merged.launches
    y = conv3d_tap_merged(x, w, b, slope)
    ref = conv3d_tap_merged_ref(x, w, b, slope)
    torch.cuda.synchronize()
    assert conv3d_tap_merged.launches == before + 1
    # bf16 output resolution, as the CPU parity tests hold the plain version
    tol = 0.02 * ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_gpu_kernel_refuses_wrong_dtype(cuda):
    x = torch.zeros(1, 4, 8, 8, 8, device=cuda)
    w = torch.zeros(3, 3, 3, 8, 16, dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(16, device=cuda)
    with pytest.raises(TypeError):
        conv3d_tap_merged(x, w, b)


@pytest.mark.gpu
def test_gpu_engine_segments_through_the_kernel(cuda, tmp_path):
    case = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(128, 128, 112))
    args = cli.build_parser().parse_args(
        ["segment", "--input", str(case), "--output", str(tmp_path / "o"), "--checkpoints",
         str(CKPTS), "--models", "model1", "--folds", "2"])
    eng = cli.load_engine(args)
    assert eng.device.type == "cuda"
    before = conv3d_tap_merged.launches
    from braintpu_torch.io.brats import find_cases
    seg, info = eng.predict_case(find_cases(case)[0])
    assert info["bucket_shape"] == (128, 128, 96)
    assert conv3d_tap_merged.launches - before == 16 * 3


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 3, 8, 9, 8, 0, 16), (2, 5, 9, 13, 24, 8, 40),
                                   (1, 16, 16, 12, 64, 64, 64), (1, 8, 14, 14, 320, 320, 320)])
def test_gpu_stage_kernel_matches_plain_version(cuda, shape):
    N, D, H, W, ci1, ci2, co = shape
    x1, w, b, x2, aff = _stage_args(N, D, H, W, ci1, ci2, co, device=cuda)
    aff["c1"] = aff["c1"] + 3.0  # a large shift: padding must stay untransformed
    kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01 if ci2 else None, stats=True, **aff)
    before = conv_stage.launches
    y, s1, s2 = conv_stage(x1, w, b, **kw)
    ry, r1, r2 = conv_stage_ref(x1, w, b, **kw)
    torch.cuda.synchronize()
    assert conv_stage.launches == before + 1
    assert (y.float() - ry.float()).abs().max().item() <= 0.02 * ry.float().abs().max().item()
    sum_abs = conv_stage_ref(x1, w, b, **{**kw, "stats": False}).float().abs().sum((1, 2, 3))
    assert torch.all((s1 - r1).abs() <= 1e-3 * sum_abs)
    assert torch.all((s2 - r2).abs() <= 1e-3 * r2)
    yo = conv_stage(x1, w, b, x2=x2, out_slope=0.01)
    ro = conv_stage_ref(x1, w, b, x2=x2, out_slope=0.01)
    assert (yo.float() - ro.float()).abs().max().item() <= 0.02 * ro.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 3, 5, 7, 8, 8), (2, 2, 8, 9, 24, 40),
                                   (1, 7, 7, 4, 320, 320), (1, 16, 16, 8, 64, 32)])
def test_gpu_upconv_kernel_matches_plain_version(cuda, shape):
    N, D, H, W, ci, co = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(N, D, H, W, ci, device=cuda, generator=g).bfloat16()
    w = (torch.randn(ci, 2, 2, 2, co, device=cuda, generator=g) / ci ** 0.5).bfloat16()
    before = upconv2x.launches
    y = upconv2x(x, w)
    ref = upconv2x_ref(x, w)
    torch.cuda.synchronize()
    assert upconv2x.launches == before + 1
    assert (y.float() - ref.float()).abs().max().item() <= 0.02 * ref.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_stage_and_upconv_refuse_wrong_dtype(cuda):
    x1, w, b, _, _ = _stage_args(ci2=0, device=cuda)
    with pytest.raises(TypeError):
        conv_stage(x1.float(), w, b)
    with pytest.raises(TypeError):
        upconv2x(x1, torch.zeros(8, 2, 2, 2, 8, device=cuda))


@pytest.mark.gpu
def test_gpu_two_model_engine_launches_both_new_kernels(cuda, tmp_path):
    case = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(128, 128, 112))
    args = cli.build_parser().parse_args(
        ["segment", "--input", str(case), "--output", str(tmp_path / "o"), "--checkpoints",
         str(_model1_only_checkpoints(tmp_path)), "--folds", "1", "--no-tta",
         "--random-weights"])
    eng = cli.load_engine(args)
    from braintpu_torch.io.brats import find_cases
    before = conv3d_tap_merged.launches, conv_stage.launches, upconv2x.launches
    seg, info = eng.predict_case(find_cases(case)[0])
    bucket = info["bucket_shape"]
    assert bucket == (128, 128, 96)
    stage = sum(unet3d.choose_stage_impl(s, (3, 3, 3), st, co, c2) == "kernel"
                for s, st, co, c2 in unet3d.deferred_layers(unet3d.MODEL2_GN_LARGE, bucket))
    after = conv3d_tap_merged.launches, conv_stage.launches, upconv2x.launches
    assert tuple(a - b for a, b in zip(after, before)) == (3, stage, 10)


def _int8_operands(seed, M, K, N):
    """Seeded int8 operands over the whole range, -128 in a row and a column."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    y = rng.integers(-128, 128, (K, N)).astype(np.int8)
    x[0, :] = -128
    y[:, 0] = -128
    return x, y


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 512, 384, 128, 128, 128),
    (200, 80, 48, 8, 16, 16),  # ragged against the kernel's 128 x 128 x 64 tile
    (3072, 384, 128, 128, 128, 128),
    (1, 16, 16, 1, 16, 16),
    (32, 24, 32, 8, 8, 8),  # K and N off 16: the byte-load path
    (1000, 84, 50, 8, 10, 12),
])
def test_gpu_int8_kernel_is_bit_equal_to_plain_version(cuda, M, K, N, bm, bn, bk):
    x, y = _int8_operands(M * N, M, K, N)
    tx, ty = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    before = int8_matmul.launches
    got = int8_matmul(tx, ty, bm=bm, bn=bn, bk=bk)
    ref = int8_matmul_ref(tx, ty)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert torch.equal(got, ref)
    assert torch.equal(got.cpu(), int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.gpu
def test_gpu_int8_kernel_refuses_what_it_cannot_take(cuda):
    # it refuses what the reference refuses, as the CPU path does
    x = torch.zeros(32, 24, dtype=torch.int8, device=cuda)
    y = torch.zeros(24, 32, dtype=torch.int8, device=cuda)
    for bm, bn, bk in ((12, 8, 8), (8, 12, 8), (8, 8, 16)):
        with pytest.raises(ValueError, match="must divide"):
            int8_matmul(x, y, bm=bm, bn=bn, bk=bk)
    with pytest.raises(TypeError):
        int8_matmul(x.float(), y, bm=8, bn=8, bk=8)


@pytest.mark.gpu
def test_gpu_int8_kernel_takes_unaligned_and_strided_operands(cuda):
    x, y = _int8_operands(7, 64, 48, 32)
    # x one byte past a 16-byte boundary, y a transposed view
    buf = torch.empty(64 * 48 + 1, dtype=torch.int8, device=cuda)
    tx = buf[1:].view(64, 48)
    tx.copy_(torch.from_numpy(x).to(cuda))
    ty = torch.from_numpy(np.ascontiguousarray(y.T)).to(cuda).t()
    assert tx.data_ptr() % 16 and not ty.is_contiguous()
    got = int8_matmul(tx, ty, bm=16, bn=16, bk=16)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.gpu
def test_gpu_probe_entry_point_launches_the_kernel(cuda, tmp_path, capsys):
    log = tmp_path / "probe.jsonl"
    before = int8_matmul.launches
    assert probe.main(["int8", "--log", str(log)]) == 0
    assert int8_matmul.launches > before
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["probe"] for r in lines] == [f"int8:{s[0]}" for s in probe.INT8_SHAPES]
    assert all(r["ok"] for r in lines)
