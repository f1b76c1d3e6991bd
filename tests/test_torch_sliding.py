"""Sliding-window inference and the label ensemble of the PyTorch port,
held against the JAX package on the CPU.

Seeded numpy inputs and weights go through both packages: the patch grid and
the Gaussian (bit-equal), ``sliding_window_predict`` in f32 (probabilities
within 1e-5) for a BatchNorm and a GroupNorm config and in bf16 (label
agreement), the engines in sliding mode with both ensembles, the label
ensemble's round-half-to-even ties and its missing ET rule, and the dispatch
at the sliding batch shapes.  Narrow configs (2 pool levels, base width 4-8,
16^3 patches) on volumes that take several patches per axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ckpt import load_pytree_npz as jax_load_npz
from braintpu.infer import gaussian as jax_gauss
from braintpu.infer import sliding_window as jax_sw
from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.io.brats import find_cases as jax_find_cases
from braintpu.models import unet3d as jax_unet
from braintpu.ops.conv3d_pallas import plan_tiles as jax_plan_tiles
from braintpu.ops.stage_pallas import conv_stage_supported as jax_stage_supported
from braintpu.ops.stage_pallas import plan_stage_tiles as jax_plan_stage_tiles
from braintpu.ops.upconv_pallas import _plan_band as jax_plan_band
from braintpu.ops.upconv_pallas import upconv2x_supported as jax_upconv_supported

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.infer import fullconv, gaussian, sliding_window
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import nifti
from braintpu_torch.io.brats import find_cases
from braintpu_torch.models import unet3d
from braintpu_torch.pre.preprocess import preprocess_case
from braintpu_torch.train.synthetic import synth_case_arrays, write_synth_case

CKPTS = "results/trained_synth/checkpoints"
_NARROW = dict(base_features=4, max_features=16, num_pool=2, patch_size=(16, 16, 16))


def _cfgs(norm="batch", dtype="f32", **kw):
    kw = {**_NARROW, "norm": norm, **kw}
    if norm == "group":
        kw["group_norm_groups"] = 2
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return jax_unet.UNetConfig(compute_dtype=jdt, **kw), unet3d.UNetConfig(compute_dtype=tdt, **kw)


def _tree(jcfg, seed, seg_gain=8.0):
    """Random weights as a numpy tree: the reference's init, random biases,
    norm statistics / scales / shifts, and seg heads scaled so that most
    sigmoids leave 0.5 (so labels have something to agree on)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))
    blocks = [b for st in tree["encoder"] for b in st] + list(tree["bottleneck"])
    blocks += [b for st in tree["decoder"] for b in st["blocks"]]
    for blk in blocks:
        co = blk["b"].shape[0]
        blk["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        blk["scale"] = rng.uniform(0.8, 1.2, co).astype(np.float32)
        blk["shift"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        if "mean" in blk:
            blk["mean"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
            blk["var"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
    for st in tree["decoder"]:
        st["seg"]["w"] = st["seg"]["w"] * np.float32(seg_gain)
    return tree


def _both_params(jcfg, tcfg, trees):
    """(reference stacked params, folded flag), (port fold params, folded)."""
    folded = jcfg.norm == "batch"
    if folded:
        jp = [jax_unet.fold_batchnorm(t, jcfg) for t in trees]
        tp = [unet3d.fold_batchnorm(params_from_jax(t, tcfg), tcfg) for t in trees]
    else:
        jp, tp = trees, [params_from_jax(t, tcfg) for t in trees]
    return jax_sw.stack_folds(jp), tp, folded


def _volume(seed, shape=(4, 40, 36, 28)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Patch grid and Gaussian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("patch", [(16, 16, 16), (32, 32, 32), (24, 32, 16), (128, 128, 128)])
def test_gaussian_importance_map_bit_equal(patch):
    got = gaussian.gaussian_importance_map(patch)
    ref = jax_gauss.gaussian_importance_map(patch)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("image,patch,step", [
    ((40, 36, 28), (16, 16, 16), 0.5),
    ((224, 224, 128), (128, 128, 128), 0.5),
    ((197, 211, 140), (128, 128, 128), 0.5),
    ((128, 128, 128), (128, 128, 128), 0.5),
    ((50, 33, 17), (16, 16, 16), 0.25),
    ((50, 33, 17), (16, 16, 16), 1.0),
])
def test_sliding_window_starts_and_patch_grid_bit_equal(image, patch, step):
    assert gaussian.sliding_window_starts(image, patch, step) == \
        jax_gauss.sliding_window_starts(image, patch, step)
    got = gaussian.patch_grid(image, patch, step)
    ref = jax_gauss.patch_grid(image, patch, step)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_sliding_window_starts_refuses_a_volume_smaller_than_the_patch():
    with pytest.raises(ValueError, match="pad first"):
        gaussian.sliding_window_starts((15, 16, 16), (16, 16, 16))


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_mirror_flag_groups_match_reference(chunk):
    got = sliding_window.mirror_flag_groups(sliding_window.MIRROR_COMBOS, chunk)
    ref = jax_sw.mirror_flag_groups(jax_sw.MIRROR_COMBOS, chunk)
    np.testing.assert_array_equal(got, ref)
    assert sliding_window.MIRROR_COMBOS == jax_sw.MIRROR_COMBOS
    with pytest.raises(ValueError, match="must divide"):
        sliding_window.mirror_flag_groups(sliding_window.MIRROR_COMBOS, 3)


def test_default_mirror_chunk_and_patch_match_reference():
    for jcfg, tcfg in ((jax_unet.MODEL1_BN, unet3d.MODEL1_BN),
                       (jax_unet.MODEL2_GN_LARGE, unet3d.MODEL2_GN_LARGE)):
        assert sliding_window.default_mirror_chunk(tcfg) == jax_sw.default_mirror_chunk(jcfg)
        assert tuple(tcfg.patch_size) == tuple(jcfg.patch_size) == (128, 128, 128)
    assert sliding_window.default_mirror_chunk(unet3d.MODEL1_BN) == 8
    assert sliding_window.default_mirror_chunk(unet3d.MODEL2_GN_LARGE) == 4


def test_region_probs_to_labels_moved_and_re_exported():
    assert fullconv.region_probs_to_labels is sliding_window.region_probs_to_labels
    assert fullconv.MIRROR_COMBOS is sliding_window.MIRROR_COMBOS


# ---------------------------------------------------------------------------
# sliding_window_predict against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_sliding_window_predict_f32_matches_reference(norm):
    """Two folds, 8-flip TTA, 3 x 2 x 2 patches of 16^3: probabilities within
    1e-5 (f32 on both sides; only the summation order differs)."""
    jcfg, tcfg = _cfgs(norm)
    trees = [_tree(jcfg, s) for s in (31, 32)]
    jp, tp, folded = _both_params(jcfg, tcfg, trees)
    vol = _volume(5, (4, 28, 24, 20))
    assert len(gaussian.patch_grid(vol.shape[1:], tcfg.patch_size)) == 3 * 2 * 2
    ref = np.asarray(jax_sw.predict_probs(jp, jnp.asarray(vol), jcfg, folded=folded))
    got = sliding_window.predict_probs(tp, torch.from_numpy(vol), tcfg, folded=folded)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (28, 24, 20, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert 0.05 < float((ref > 0.5).mean()) < 0.95, "degenerate: probabilities all on one side"


def test_sliding_window_predict_without_tta_and_step_matches_reference():
    jcfg, tcfg = _cfgs("batch")
    jp, tp, folded = _both_params(jcfg, tcfg, [_tree(jcfg, 41)])
    vol = _volume(6, (4, 33, 20, 16))
    for step in (0.5, 0.25):
        ref = np.asarray(jax_sw.predict_probs(jp, jnp.asarray(vol), jcfg, step_size=step,
                                              tta=False, folded=folded))
        got = sliding_window.predict_probs(tp, torch.from_numpy(vol), tcfg, step_size=step,
                                           tta=False, folded=folded)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_sliding_window_predict_bf16_trained_fold_label_agreement():
    """MODEL1_BN at full width in bf16, trained fold 0, 32^3 patches on a
    small synthetic case (no TTA): the reference accumulates its bf16 convs
    in bf16 and the port in f32, so decisions are compared (as
    ``test_torch_parity.test_unet_forward_bf16_label_agreement`` does)."""
    jcfg = dataclasses.replace(jax_unet.MODEL1_BN, patch_size=(32, 32, 32))
    tcfg = dataclasses.replace(unet3d.MODEL1_BN, patch_size=(32, 32, 32))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_load_npz(f"{CKPTS}/model1/fold_0.npz"))
    jp, tp, folded = _both_params(jcfg, tcfg, [tree])
    mods, _ = synth_case_arrays(200, shape=(56, 52, 44))
    data = np.stack([mods[m] for m in ("t1", "t1ce", "t2", "flair")])
    vol = preprocess_case(data, patch_size=(32,) * 3, device="cpu").data
    assert len(gaussian.patch_grid(vol.shape[1:], (32, 32, 32))) == 2 * 2 * 1
    ref = np.asarray(jax_sw.predict_probs(jp, jnp.asarray(vol.numpy()), jcfg, tta=False,
                                          folded=folded))
    got = sliding_window.predict_probs(tp, vol, tcfg, tta=False, folded=folded)
    lab = lambda p: np.asarray(jax_sw.region_probs_to_labels(jnp.asarray(p)))
    ref_lab, got_lab = lab(ref), lab(got.numpy())
    assert (ref_lab > 0).mean() > 0.02, "degenerate: no foreground to compare"
    assert float(np.mean(got_lab == ref_lab)) >= 0.999


@pytest.mark.parametrize("chunk", [4, 2, 1])
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_sliding_result_does_not_depend_on_the_mirror_chunk(norm, chunk):
    """Chunks of 8, 4, 2 or 1 mirror copies differ only in summation order
    (GroupNorm statistics stay per copy: the batch axis is the boundary), so
    they agree within the f32 tolerance held against the reference, 1e-5."""
    jcfg, tcfg = _cfgs(norm)
    _, tp, folded = _both_params(jcfg, tcfg, [_tree(jcfg, 51), _tree(jcfg, 52)])
    vol = torch.from_numpy(_volume(7, (4, 24, 20, 16)))
    want = sliding_window.predict_probs(tp, vol, tcfg, folded=folded, mirror_chunk=8)
    got = sliding_window.predict_probs(tp, vol, tcfg, folded=folded, mirror_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_sliding_runs_patches_times_chunks_times_folds_forwards(monkeypatch):
    """The loop's structure, which the launch counts on the card follow:
    patches x (8 / chunk) x folds forwards, each on ``chunk`` mirror copies."""
    jcfg, tcfg = _cfgs()
    _, tp, folded = _both_params(jcfg, tcfg, [_tree(jcfg, 81), _tree(jcfg, 82)])
    vol = torch.from_numpy(_volume(9, (4, 28, 24, 20)))
    batches = []
    real = sliding_window.apply_unet
    monkeypatch.setattr(sliding_window, "apply_unet",
                        lambda p, x, cfg, folded: batches.append(x.shape[0]) or real(p, x, cfg,
                                                                                    folded=folded))
    sliding_window.predict_probs(tp, vol, tcfg, folded=folded, mirror_chunk=4)
    patches = len(gaussian.patch_grid(tuple(vol.shape[1:]), tcfg.patch_size))
    assert batches == [4] * (patches * 2 * 2)


def test_sliding_window_predict_refuses_a_partial_mirror_set():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="num_mirror"):
        sliding_window.sliding_window_predict([], torch.zeros(16, 16, 16, 4), np.zeros((1, 3)),
                                              torch.ones(16, 16, 16), tcfg, num_mirror=4)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_fullconv_equals_sliding_on_a_one_patch_volume(norm):
    """A volume of exactly one patch: the grid has one patch, the Gaussian
    normalizes out, and fullconv must give the same probabilities, with and
    without TTA (the port's side of the reference's own test)."""
    jcfg, tcfg = _cfgs(norm)
    _, tp, folded = _both_params(jcfg, tcfg, [_tree(jcfg, 61), _tree(jcfg, 62)])
    vol = torch.from_numpy(_volume(8, (4, 16, 16, 16)))
    for tta in (False, True):
        sw = sliding_window.predict_probs(tp, vol, tcfg, tta=tta, folded=folded)
        fc = fullconv.predict_probs_fullconv(tp, vol, tcfg, tta=tta, folded=folded)
        np.testing.assert_allclose(fc.numpy(), sw.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The engines in sliding mode, both ensembles
# ---------------------------------------------------------------------------


def _engine_pair(trees_by_model, cfgs, **kw):
    jmodels, tmodels = [], []
    for (jcfg, tcfg), trees in zip(cfgs, trees_by_model):
        jmodels.append(JaxBundle.from_folds(jcfg, trees))
        tmodels.append(ModelBundle.from_folds(tcfg, [params_from_jax(t, tcfg) for t in trees]))
    return (JaxEngine(models=jmodels, mode="sliding", **kw),
            InferenceEngine(models=tmodels, mode="sliding", device="cpu", **kw))


@pytest.mark.parametrize("ensemble", ["softmax", "label"])
def test_sliding_engine_matches_reference(tmp_path, ensemble):
    """A BatchNorm and a GroupNorm narrow model, 2 folds each, TTA, f32,
    sliding mode on a synthetic case: the same labels and volumes."""
    case_dir = write_synth_case(tmp_path, "BraTS-SYN-00011-000", seed=11, shape=(44, 48, 40))
    cfgs = [_cfgs("batch"), _cfgs("group")]
    trees = [[_tree(cfgs[0][0], 71), _tree(cfgs[0][0], 72)],
             [_tree(cfgs[1][0], 73), _tree(cfgs[1][0], 74)]]
    jeng, teng = _engine_pair(trees, cfgs, ensemble=ensemble, tta=True)
    ref_seg, ref_info = jeng.predict_case(jax_find_cases(case_dir)[0])
    seg, info = teng.predict_case(find_cases(case_dir)[0])
    assert info["bucket_shape"] == ref_info["bucket_shape"]
    assert (info["mode"], info["ensemble"]) == ("sliding", ensemble) and \
        ref_info["ensemble"] == ensemble
    assert seg.shape == ref_seg.shape and seg.dtype == ref_seg.dtype
    assert (ref_seg > 0).mean() > 0.01, "degenerate: no foreground to compare"
    assert float(np.mean(seg == ref_seg)) >= 0.999
    for k, v in ref_info["volumes_cm3"].items():
        assert abs(info["volumes_cm3"][k] - v) <= 0.001 * max(v, 1.0), k


class _Pre:
    """The part of a preprocess result the ensemble reads."""

    undo_slices = (slice(None),) * 3


def _probs_for(labels: np.ndarray) -> np.ndarray:
    """Region probabilities whose labels (region order 1, 2, 3, later
    overwriting) are ``labels``: WT covers 1..3, TC 2..3, ET 3."""
    p = np.full(labels.shape + (3,), 0.1, np.float32)
    for k in range(3):
        p[..., k] = np.where(labels >= k + 1, 0.9, 0.1)
    return p


def test_label_ensemble_rounds_half_to_even_as_the_reference():
    """round(mean of label maps) with numpy's round-half-to-even: 1.5 -> 2,
    2.5 -> 2, 0.5 -> 0; the ET rule never runs, even on a 1-voxel ET."""
    a = np.array([0, 1, 2, 3, 1, 0, 3, 2], np.uint8).reshape(2, 2, 2)
    b = np.array([1, 2, 3, 3, 1, 3, 0, 2], np.uint8).reshape(2, 2, 2)
    probs = [_probs_for(a), _probs_for(b)]
    jeng = JaxEngine(models=[], ensemble="label")
    _, tcfg = _cfgs()
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 0)])
    teng = InferenceEngine(models=[bundle, bundle], ensemble="label", mode="sliding",
                           device="cpu")
    ref = jeng._ensemble_labels([jnp.asarray(p) for p in probs], _Pre)
    got = teng._ensemble_labels([torch.from_numpy(p) for p in probs], _Pre)
    np.testing.assert_array_equal(got, ref)
    # the ties: (0+1)/2 = 0.5 -> 0, (1+2)/2 = 1.5 -> 2, (2+3)/2 = 2.5 -> 2, (0+3)/2 -> 2
    assert got.ravel().tolist() == [0, 2, 2, 3, 1, 2, 2, 2]


def test_single_model_label_ensemble_skips_the_et_rule():
    """One model, a 2-voxel ET component: the softmax ensemble's ET rule
    (200 voxels) turns it into 2; the label ensemble keeps it, as the
    reference does with any model count."""
    labels = np.zeros((6, 6, 6), np.uint8)
    labels[1:4, 1:4, 1:4] = 2
    labels[2, 2, 2:4] = 3
    probs = _probs_for(labels)
    _, tcfg = _cfgs()
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 0)])
    for ensemble, want_et in (("label", 2), ("softmax", 0)):
        jeng = JaxEngine(models=[], ensemble=ensemble)
        teng = InferenceEngine(models=[bundle], ensemble=ensemble, device="cpu")
        ref = jeng._ensemble_labels([jnp.asarray(probs)], _Pre)
        got = teng._ensemble_labels([torch.from_numpy(probs)], _Pre)
        np.testing.assert_array_equal(got, ref)
        assert int((got == 3).sum()) == want_et


def test_label_engine_equals_the_manual_recipe_and_differs_from_softmax(tmp_path):
    """Two models in the label ensemble equal round((l1 + l2) / 2) of the
    single-model label runs, where ties occur, and differ from the softmax
    ensemble somewhere (else the test compares nothing)."""
    mods, _ = synth_case_arrays(11, shape=(40, 36, 32))
    data = np.stack([mods[m] for m in ("t1", "t1ce", "t2", "flair")])
    _, tcfg = _cfgs("batch")
    b1 = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 1)])
    b2 = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 2)])
    kw = dict(tta=False, mode="sliding", device="cpu", output_convention="internal")
    seg_label, _ = InferenceEngine(models=[b1, b2], ensemble="label", **kw).predict_case_array(data)
    seg_soft, _ = InferenceEngine(models=[b1, b2], **kw).predict_case_array(data)
    l1, _ = InferenceEngine(models=[b1], ensemble="label", **kw).predict_case_array(data)
    l2, _ = InferenceEngine(models=[b2], ensemble="label", **kw).predict_case_array(data)
    manual = np.round((l1.astype(np.float32) + l2.astype(np.float32)) / 2.0).astype(np.uint8)
    np.testing.assert_array_equal(seg_label, manual)
    assert ((l1.astype(int) + l2) % 2 == 1).any(), "no tie to round"
    assert (seg_soft != seg_label).any()


# ---------------------------------------------------------------------------
# C5: the default mode, and the CLI's
# ---------------------------------------------------------------------------


def test_engine_defaults_to_sliding_as_the_reference():
    _, tcfg = _cfgs()
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 0)])
    eng = InferenceEngine(models=[bundle], device="cpu")
    assert eng.mode == "sliding" == JaxEngine.__dataclass_fields__["mode"].default
    assert eng.ensemble == "softmax" == JaxEngine.__dataclass_fields__["ensemble"].default
    assert eng.step_size == 0.5 == JaxEngine.__dataclass_fields__["step_size"].default


@pytest.mark.parametrize("flags,mode,ensemble", [
    ([], "fullconv", "softmax"),
    (["--mode", "sliding"], "sliding", "softmax"),
    (["--mode", "sliding", "--ensemble", "label"], "sliding", "label"),
    (["--ensemble", "label"], "fullconv", "label"),
])
def test_cli_mode_and_ensemble_flags(flags, mode, ensemble):
    """Without --mode the CLI runs fullconv (the reference's load_engine
    default for non-axial models); both flags reach the engine, on segment
    and pipeline."""
    for sub in (["segment", "--input", "x", "--output", "y"], ["pipeline", "x"]):
        args = cli.build_parser().parse_args(
            sub + ["--checkpoints", CKPTS, "--models", "model1", "--folds", "1",
                   "--device", "cpu"] + flags)
        eng = cli.load_engine(args)
        assert (eng.mode, eng.ensemble) == (mode, ensemble)


def test_cli_segment_sliding_label_end_to_end_on_cpu(tmp_path, capsys):
    """``segment --mode sliding --ensemble label`` on a small synthetic case
    with the trained model-1 fold (one 128^3 patch, no TTA)."""
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    out = tmp_path / "out"
    rc = cli.main(["segment", "--input", str(case), "--output", str(out), "--checkpoints",
                   CKPTS, "--models", "model1", "--folds", "1", "--no-tta", "--mode", "sliding",
                   "--ensemble", "label", "--device", "cpu"])
    assert rc == 0
    seg = nifti.load(out / "BraTS-SYN-00200-000.nii.gz").get_fdata(np.float32)
    gt = nifti.load(case / "BraTS-SYN-00200-000_seg.nii.gz").get_fdata(np.float32)
    assert seg.shape == (40, 40, 36) and set(np.unique(seg)) <= {0, 1, 2, 3}
    assert ((seg > 0) == (gt > 0)).mean() > 0.95


# ---------------------------------------------------------------------------
# Dispatch at the sliding batch shapes (128^3 patch, N = 8 and 4)
# ---------------------------------------------------------------------------


def test_sliding_shapes_dispatch_matches_reference(monkeypatch):
    """At the 128^3 patch with the mirror chunk as the batch (N = 8 for
    model 1, N = 4 for model 2), every layer goes where the reference sends
    it, but for the reference's TPU-only VMEM gates; the counts pin the
    sliding shapes the kernels see."""
    monkeypatch.setattr(jax_unet, "_on_tpu", lambda: True)
    patch = (128, 128, 128)
    n_tap = 0
    for shape, stride, co in unet3d.conv_layers(unet3d.MODEL1_BN, patch, batch=8):
        assert shape[0] == 8
        got = unet3d.choose_impl(shape, (3, 3, 3), stride, co) == "kernel"
        ref = jax_unet._choose_impl(shape, (3, 3, 3), stride, co) == "pallas"
        if got != ref:
            assert got and jax_plan_tiles(shape[2], shape[3], shape[4], co) is None
        n_tap += got
    n_stage = 0
    for (N, D, H, W, ci1), stride, co, ci2 in unet3d.deferred_layers(
            unet3d.MODEL2_GN_LARGE, patch, batch=4):
        assert N == 4
        got = unet3d.choose_stage_impl((N, D, H, W, ci1), (3, 3, 3), stride, co, ci2) == "kernel"
        ref = stride == (1, 1, 1) and jax_stage_supported((N, D, H, W, ci1), co, ci2=ci2)
        if got != ref:
            split = (ci1, ci2) if ci2 else None
            assert got and jax_plan_stage_tiles(H, W, ci1 + ci2, co, ci_split=split) is None
        n_stage += got
    n_up = 0
    for cfg, batch in ((unet3d.MODEL1_BN, 8), (unet3d.MODEL2_GN_LARGE, 4)):
        for shape, co in unet3d.upconv_layers(cfg, patch, batch=batch):
            got = unet3d.upconv_supported(shape, co)
            ref = jax_upconv_supported(shape, co)
            if got != ref:
                _, _, H, W, ci = shape
                assert got and (H < 8 or W < 8 or jax_plan_band(H, W, ci, co) is None)
            n_up += got
    assert (n_tap, n_stage, n_up) == (3, 15, 10)
