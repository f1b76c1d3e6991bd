"""The PyTorch port on its own: import hygiene, no hidden fallback, the build
helper, the CLI, and the card-only checks (marked ``gpu``).

Whether a card is present is decided inside fixtures and tests, never at
import or collection time.
"""

import ctypes
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
from braintpu_torch.ops import upconv as upconv_mod
from braintpu_torch.ops.int8_probe import int8_matmul, int8_matmul_ref, int8_route
from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref
from braintpu_torch.ops.upconv_plan import UpconvPlan, upconv_plan
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
    for m in ("braintpu_torch.native", "braintpu_torch.infer.sliding_window",
              "braintpu_torch.infer.gaussian", "braintpu_torch.serve.api",
              "braintpu_torch.serve.jobs", "braintpu_torch.rag.store",
              "braintpu_torch.rag.assistant", "braintpu_torch.utils.config",
              "braintpu_torch.utils.envcheck", "braintpu_torch.ckpt.convert",
              "braintpu_torch.ckpt.discover", "braintpu_torch.train.augment",
              "braintpu_torch.train.checkpoint", "braintpu_torch.train.data",
              "braintpu_torch.train.losses", "braintpu_torch.train.trainer",
              "braintpu_torch.models.axial", "braintpu_torch.models.modular_unet",
              "braintpu_torch.models.plans", "braintpu_torch.features.devstats",
              "braintpu_torch.utils.profiling", "braintpu_torch.utils.xprof",
              "braintpu_torch.viz.overlays", "braintpu_torch.pre.resample",
              "braintpu_torch.parallel", "braintpu_torch.parallel.launch",
              "braintpu_torch.parallel.collectives", "braintpu_torch.parallel.mesh",
              "braintpu_torch.parallel.distributed", "braintpu_torch.parallel.scenarios",
              "braintpu_torch.graft_entry"):
        assert m in mods


def test_no_port_file_names_jax_or_the_reference_package():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cpp"))
             + [REPO / "chip_smoke.py"])
    assert PORT / "native" / "nifti_native.cpp" in files
    for f in ("graft_entry.py", "parallel/launch.py", "parallel/collectives.py",
              "parallel/mesh.py", "parallel/distributed.py", "parallel/scenarios.py"):
        assert PORT / f in files
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
        InferenceEngine(models=[bundle], mode="fullconv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    eng = InferenceEngine(models=[bundle], mode="fullconv", device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.warmup((20, 24, 16)) > 0  # a dummy case through the whole engine


def test_engine_rejects_what_is_not_ported():
    """Sliding mode and the label ensemble are ported; a mode or ensemble
    the engine does not have is refused.  The reference's mesh options are
    ported: ``spatial_shard`` is accepted, and the batched runner refuses it
    with the reference's message."""
    bundle = _tiny_bundle()
    with pytest.raises(ValueError, match="mode"):
        InferenceEngine(models=[bundle], mode="axial", device="cpu")
    with pytest.raises(ValueError, match="ensemble"):
        InferenceEngine(models=[bundle], ensemble="vote", device="cpu")
    eng = InferenceEngine(models=[bundle], mode="fullconv", spatial_shard=True, device="cpu")
    with pytest.raises(ValueError, match=re.escape(
            "predict_cases_batched is case-data-parallel and incompatible with "
            "spatial_shard=True: batching places one whole volume per chip, which defeats "
            "the reason to shard spatially.")):
        eng.predict_cases_batched([])
    # an unfolded BatchNorm forward is ported: eval BatchNorm with the running
    # statistics, equal at f32 to the folded forward (tests/test_torch_repairs.py
    # holds both against the reference's folded=False)
    cfg = unet3d.UNetConfig(base_features=8, max_features=16, num_pool=2,
                            compute_dtype=torch.float32)
    params = unet3d.init_params(cfg, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, 16, 16, 4))
                         .astype(np.float32))
    want = unet3d.apply_unet(unet3d.fold_batchnorm(params, cfg), x, cfg, folded=True)
    got = unet3d.apply_unet(params, x, cfg, folded=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


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


def test_count_launch_records_launch_keys_only_while_asked():
    """``ops._build.launch_keys``: while it is a dict every counted launch
    adds its key (the chip smoke holds each kernel to its plain version at
    the keys its sharded paths recorded); while it is None nothing is kept."""
    def kernel():
        pass

    kernel.launches = 0
    assert _build.launch_keys is None
    _build.count_launch(kernel, (1, 2))
    try:
        _build.launch_keys = {}
        for key in ((1, 2), (1, 2), (3, None, 0.01)):
            _build.count_launch(kernel, key)
        _build.count_launch(kernel)
        assert _build.launch_keys == {"kernel": {(1, 2), (3, None, 0.01)}}
    finally:
        _build.launch_keys = None
    assert kernel.launches == 5


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


def test_build_hash_follows_the_shared_headers(tmp_path, monkeypatch):
    # a source that includes csrc/*.cuh builds anew when the header changes;
    # build_all still builds the *.cu sources only
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "a.cu").write_text('#include "loop.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "loop.cuh"\n')
    (tmp_path / "loop.cuh").write_text("// v1\n")
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    (tmp_path / "loop.cuh").write_text("// v2\n")
    after = {n: _build._lib_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in ("a", "b"))
    assert after == {n: _build._lib_path(n) for n in ("a", "b")}  # stable while unchanged
    monkeypatch.setattr(_build, "_start", lambda name: pytest.fail(f"built {name}"))
    for n in ("a", "b"):
        after[n].parent.mkdir(parents=True, exist_ok=True)
        after[n].touch()
    assert _build.build_all() == ["a", "b"]  # the header is no source of its own


def test_the_conv_kernels_share_the_wgmma_main_loop():
    for name in ("conv3d_tap_merged", "conv_stage"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "conv3d_wgmma.cuh"' in text
        assert "mma.sync" not in text
    loop = (_build.CSRC / "conv3d_wgmma.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.5d", "mbarrier.try_wait.parity",
                "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE"):
        assert ptx in loop, ptx
    assert "NAN_REQUEST_ZERO_FMA" not in loop


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


def test_ptxas_summary_reads_dynamic_smem_kernels_and_wgmma_notices():
    # the wgmma kernels use dynamic shared memory only (no "bytes smem"), and
    # ptxas's notice that it serialised wgmma must reach the build line
    log = ("ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]\n"
           "    104 bytes stack frame, 160 bytes spill stores, 212 bytes spill loads\n"
           "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized due to insufficient register resources for the function 'k'\n")
    assert _build._ptxas_summary(log) == (
        "registers=168 spill_stores=160 spill_loads=212 (C7512) Potential Performance Loss: "
        "wgmma.mma_async instructions are serialized due to insufficient register resources "
        "for the function 'k'")


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", [
    ("tap", (8, 64, 64, 64, 128, 64)),           # model 1, level 1 of a 128^3 patch, 8 mirrors
    ("stage", (4, 128, 128, 128, 64, 64, 64)),   # model 2, level 0 concat, 4 mirrors
    ("stage", (4, 8, 8, 8, 320, 320, 320)),
    ("upconv", (8, 64, 64, 64, 64, 32)),
    ("upconv", (4, 4, 4, 4, 320, 320)),
])
def test_gpu_kernels_at_sliding_batch_shapes(cuda, kind, shape):
    """The three segmentation kernels at the batch shapes of sliding mode
    (mirror copies of a 128^3 patch along N), against their plain versions;
    conv_stage's statistics per sample."""
    g = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, device=cuda, generator=g)
    if kind == "tap":
        N, D, H, W, ci, co = shape
        x, w = rnd(N, D, H, W, ci).bfloat16(), (rnd(3, 3, 3, ci, co) / (27 * ci) ** 0.5).bfloat16()
        b = rnd(co) * 0.1
        fn, got, ref = conv3d_tap_merged, lambda: conv3d_tap_merged(x, w, b, 0.01), \
            lambda: conv3d_tap_merged_ref(x, w, b, 0.01)
    elif kind == "upconv":
        N, D, H, W, ci, co = shape
        x, w = rnd(N, D, H, W, ci).bfloat16(), (rnd(ci, 2, 2, 2, co) / ci ** 0.5).bfloat16()
        fn, got, ref = upconv2x, lambda: upconv2x(x, w), lambda: upconv2x_ref(x, w)
    else:
        N, D, H, W, ci1, ci2, co = shape
        x1, w, b, x2, aff = _stage_args(N, D, H, W, ci1, ci2, co, device=cuda)
        kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01, stats=True, **aff)
        fn, got, ref = conv_stage, lambda: conv_stage(x1, w, b, **kw), \
            lambda: conv_stage_ref(x1, w, b, **kw)
    before = fn.launches
    out, want = got(), ref()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if kind == "stage":
        (y, s1, s2), (ry, r1, r2) = out, want
        assert s1.shape == (N, co) and s2.shape == (N, co)
        sum_abs = ry.float().abs().sum((1, 2, 3))
        assert torch.all((s1 - r1).abs() <= 1e-3 * sum_abs)
        assert torch.all((s2 - r2).abs() <= 1e-3 * r2)
        out, want = y, ry
    assert (out.float() - want.float()).abs().max().item() <= 0.02 * want.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_sliding_engine_launches_per_patch_mirror_chunk_and_fold(cuda, tmp_path):
    """Model 1 (2 trained folds) in sliding mode on a case of one 128^3
    patch: 8 mirrors in one chunk, so 2 forwards at N = 8, each through the
    tap kernel's 3 layers and 5 up-convs; Dice against the ground truth."""
    from braintpu_torch.io.brats import find_cases
    from braintpu_torch.labels.convert import normalize_to_brats2025
    from braintpu_torch.metrics.segmentation import evaluate_segmentation

    case = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(128, 128, 112))
    args = cli.build_parser().parse_args(
        ["segment", "--input", str(case), "--output", str(tmp_path / "o"), "--checkpoints",
         str(CKPTS), "--models", "model1", "--folds", "2", "--mode", "sliding"])
    eng = cli.load_engine(args)
    before = conv3d_tap_merged.launches, upconv2x.launches
    seg, info = eng.predict_case(find_cases(case)[0])
    torch.cuda.synchronize()
    assert info["mode"] == "sliding" and info["bucket_shape"] == (128, 128, 128)
    after = conv3d_tap_merged.launches, upconv2x.launches
    assert (after[0] - before[0], after[1] - before[1]) == (2 * 3, 2 * 5)
    gt = nifti.load(find_cases(case)[0].seg_path).get_fdata(np.float32).round().astype(np.int32)
    ev = evaluate_segmentation(normalize_to_brats2025(seg).astype(np.int32),
                               normalize_to_brats2025(gt).astype(np.int32))
    assert min(v["dice"] for v in ev["compound"].values()) >= 0.99


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
    (200, 80, 48, 8, 16, 16),  # ragged against the fast route's 128 x 256 x 128 tile
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", probe.INT8_SHAPES + probe.RAGGED_SHAPES, ids=lambda s: s[0])
def test_gpu_int8_kernel_at_the_seven_probe_shapes(cuda, shape):
    label, M, K, N, bm, bn, bk = shape
    x, y = _int8_operands(M + K + N, M, K, N)
    tx, ty = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    assert int8_route(M, N, K, tx.data_ptr(), ty.data_ptr()) == (
        "bytes" if label == "ragged-bytes" else "wgmma")
    before = int8_matmul.launches
    got = int8_matmul(tx, ty, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1  # one call, whichever route
    assert torch.equal(got, int8_matmul_ref(tx, ty))


@pytest.mark.gpu
def test_gpu_int8_fast_route_takes_a_strided_operand(cuda):
    x, y = _int8_operands(11, 256, 128, 512)
    tx = torch.from_numpy(x).to(cuda)
    ty = torch.from_numpy(np.ascontiguousarray(y.T)).to(cuda).t()  # made contiguous, aligned
    assert not ty.is_contiguous()
    got = int8_matmul(tx, ty, bm=128, bn=128, bk=128)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.gpu
def test_gpu_upconv_raises_on_a_plan_the_launcher_refuses(cuda, monkeypatch):
    def bad_plan(*shape):
        p = upconv_plan(*shape)
        bad = UpconvPlan(p.bh, p.bw, p.nb, p.sp, p.sg, p.splits, 3, p.stream, p.smem_bytes,
                         p.tiles, p.grid)  # 3 stages: not a multiple of the consumers
        return bad, (ctypes.c_longlong * 14)(*shape, *bad.launch_args())

    monkeypatch.setattr(upconv_mod, "_plan_args", bad_plan)
    x = torch.zeros(1, 4, 8, 8, 16, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(16, 2, 2, 2, 8, dtype=torch.bfloat16, device=cuda)
    before = upconv2x.launches
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        upconv2x(x, w)
    assert upconv2x.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("window", [(1, 9), (0, 1), (9, 10)])
def test_gpu_stage_kernel_statistics_window(cuda, window):
    """A window of output planes (an X-sharded forward's own planes): the
    kernel's planes and their statistics against the plain version's."""
    x1, w, b, x2, aff = _stage_args(1, 10, 16, 16, 64, 64, 64, device=cuda)
    kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01, stats=True, out_planes=window, **aff)
    y, s1, s2 = conv_stage(x1, w, b, **kw)
    ry, r1, r2 = conv_stage_ref(x1, w, b, **kw)
    torch.cuda.synchronize()
    lo, hi = window
    assert y.shape == ry.shape == (1, hi - lo, 16, 16, 64)
    assert (y.float() - ry.float()).abs().max().item() <= 0.02 * ry.float().abs().max().item()
    sum_abs = ry.float().abs().sum((1, 2, 3))
    assert torch.all((s1 - r1).abs() <= 1e-3 * sum_abs + 1e-3)
    assert torch.all((s2 - r2).abs() <= 1e-3 * r2 + 1e-3)


@pytest.mark.gpu
def test_gpu_sharded_fullconv_on_two_gloo_ranks_launches_the_kernels(cuda):
    """Two gloo ranks sharing the card: the X-sharded forward of a bf16
    GroupNorm net (``conv_stage`` with halos and the statistics' window,
    ``upconv2x``) and of a folded BatchNorm net in the tap kernel's band,
    and the mirror-sharded forward, each rank launching the kernels; labels
    against the unsharded forward: on >= 0.999 of voxels for the mirrors
    (the order of the mirror sum changes, and ``conv_stage``'s atomic
    statistics vary from run to run: 0.9997 on the card), >= 0.99 for the
    X-sharded forwards (bf16 convs at a slab's shapes round some outputs the
    other way, and random weights leave many voxels near 0.5: 0.9983 on the
    card)."""
    from braintpu_torch.infer.fullconv import region_probs_to_labels
    from braintpu_torch.parallel.launch import spawn
    from braintpu_torch.parallel.scenarios import run

    gn = unet3d.UNetConfig(base_features=16, max_features=64, num_pool=2, norm="group",
                           group_norm_groups=4)
    bn = unet3d.UNetConfig(base_features=64, max_features=64, num_pool=2, norm="batch")
    rng = np.random.default_rng(0)
    v_gn = rng.standard_normal((32, 32, 32, 4)).astype(np.float32)
    v_bn = rng.standard_normal((64, 16, 16, 4)).astype(np.float32)
    specs = [("gn", "spatial", dict(cfg=gn, seeds=[0], vol=v_gn, num_mirror=1)),
             ("bn", "spatial", dict(cfg=bn, seeds=[0], vol=v_bn, num_mirror=1, fold_bn=True)),
             ("mirror", "mirror", dict(cfg=gn, seeds=[0], vol=v_gn))]
    ranks = spawn(run, 2, devices=["cuda:0", "cuda:0"], args=(specs,), timeout_s=600)
    for r in ranks:
        assert r["gn"]["route"] == "gloo-cuda-allreduce"
        assert r["gn"]["launches"]["conv_stage"] > 0 and r["gn"]["launches"]["upconv2x"] > 0
        assert r["bn"]["launches"]["conv3d_tap_merged"] > 0
        assert r["mirror"]["launches"]["conv_stage"] > 0
    for name, floor in (("gn", 0.99), ("bn", 0.99), ("mirror", 0.999)):
        got, want = (torch.from_numpy(ranks[0][name][k]) for k in ("sharded", "plain"))
        agree = (region_probs_to_labels(got) == region_probs_to_labels(want)).float().mean()
        assert float(agree) >= floor, (name, float(agree))
