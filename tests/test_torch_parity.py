"""The PyTorch port (``braintpu_torch``) held against the JAX package.

Every test makes its inputs with numpy from a seed, hands the same arrays to
both packages, and compares the outputs with a stated tolerance.  JAX runs
on the CPU (tests/conftest.py); Pallas kernels run in interpret mode, as the
JAX package's own tests run them.  The port runs on the CPU, where the conv
kernel's wrapper takes its plain PyTorch version.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ckpt import load_pytree_npz as jax_load_npz
from braintpu.infer import sliding_window as jax_sw
from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.infer.engine import uncrop_labels as jax_uncrop
from braintpu.io.brats import find_cases as jax_find_cases
from braintpu.io.brats import load_case_volumes as jax_load_case
from braintpu.labels import convert as jax_convert
from braintpu.labels.postprocess import et_min_size_postprocess as jax_et_rule
from braintpu.metrics import evaluate_segmentation as jax_evaluate
from braintpu.models import unet3d as jax_unet
from braintpu.ops.conv3d_pallas import conv3d_tap_merged as jax_tap_merged
from braintpu.ops.conv3d_pallas import plan_tiles as jax_plan_tiles
from braintpu.pre.preprocess import preprocess_case as jax_preprocess
from braintpu.train.synthetic import write_synth_case as jax_write_synth

from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle, uncrop_labels
from braintpu_torch.infer.fullconv import region_probs_to_labels
from braintpu_torch.io.brats import find_cases
from braintpu_torch.labels import convert
from braintpu_torch.labels.postprocess import et_min_size_postprocess
from braintpu_torch.metrics.segmentation import evaluate_segmentation
from braintpu_torch.models import unet3d
from braintpu_torch.ops.conv3d import conv3d_tap_merged
from braintpu_torch.pre.preprocess import preprocess_case
from braintpu_torch.train.synthetic import synth_case_arrays, write_synth_case

CKPT = "results/trained_synth/checkpoints/model1/fold_0.npz"


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16-representable f32 values (exact in both packages)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _conv_inputs(seed, N, D, H, W, ci, co):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((N, D, H, W, ci)))
    w = _bf16(rng.standard_normal((3, 3, 3, ci, co)) / np.sqrt(27 * ci))
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return x, w, b


def _port_conv(x, w, b, slope):
    return conv3d_tap_merged(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(b), slope).float().numpy()


# ---------------------------------------------------------------------------
# Kernel semantics: the plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slope", [None, 0.01])
@pytest.mark.parametrize(
    "N,D,H,W,ci,co",
    [(1, 4, 8, 12, 8, 16), (1, 5, 16, 20, 16, 8), (2, 3, 8, 13, 24, 40)],
)
def test_conv_matches_pallas_interpret(N, D, H, W, ci, co, slope):
    x, w, b = _conv_inputs(0, N, D, H, W, ci, co)
    ref = np.asarray(jax_tap_merged(x, w, b, negative_slope=slope, interpret=True)
                     .astype(jnp.float32))
    got = _port_conv(x, w, b, slope)
    # both round the f32 accumulator to bf16 once: bf16 output resolution
    # (as tests/test_ops_pallas.py holds the Pallas kernel)
    np.testing.assert_allclose(got, ref, atol=0.02 * float(np.abs(ref).max()))


@pytest.mark.parametrize("slope", [None, 0.01])
@pytest.mark.parametrize("N,D,H,W,ci,co", [(1, 5, 9, 11, 8, 16), (1, 3, 13, 10, 16, 24)])
def test_conv_ragged_h_matches_xla_conv(N, D, H, W, ci, co, slope):
    """H not a multiple of 8 (the Pallas kernel cannot tile it): hold the plain
    version to the reference's own f32 XLA conv oracle instead."""
    x, w, b = _conv_inputs(1, N, D, H, W, ci, co)
    ref = np.asarray(jax_unet._conv3d_xla(x, w, b, (1, 1, 1), jnp.float32))
    if slope is not None:
        ref = np.where(ref >= 0, ref, ref * slope)
    got = _port_conv(x, w, b, slope)
    np.testing.assert_allclose(got, ref, atol=0.02 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# Weights carried across
# ---------------------------------------------------------------------------


def _assert_tree_equal(port, ref, path="", exact_dtype=True):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{path}/{k}", exact_dtype)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_tree_equal(p, r, f"{path}/{i}", exact_dtype)
    else:
        r = np.asarray(ref)
        p = port.numpy()
        if exact_dtype:
            assert p.dtype == r.dtype, path
        np.testing.assert_array_equal(p, r, err_msg=path)


def test_params_from_jax_trained_fold_is_f16_exact():
    ref = jax_load_npz(CKPT)
    port = params_from_jax(load_pytree_npz(CKPT), unet3d.MODEL1_BN)
    _assert_tree_equal(port, ref)  # same structure, f16 dtype, same values


def test_params_from_jax_rejects_wrong_architecture():
    tree = load_pytree_npz(CKPT)
    narrow = unet3d.UNetConfig(base_features=16)
    with pytest.raises(ValueError, match="expected shape"):
        params_from_jax(tree, narrow)


def test_fold_batchnorm_matches_reference():
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax_load_npz(CKPT))
    ref = jax_unet.fold_batchnorm(tree, jax_unet.MODEL1_BN)
    port = unet3d.fold_batchnorm(params_from_jax(tree, unet3d.MODEL1_BN), unet3d.MODEL1_BN)
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(ref)
    for keypath, r in flat_ref:
        node = port
        for k in keypath:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        r = np.asarray(r)
        # same f32 arithmetic in the same order: 1e-6 of each tensor's scale
        np.testing.assert_allclose(node.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=jax.tree_util.keystr(keypath))


# ---------------------------------------------------------------------------
# U-Net forward
# ---------------------------------------------------------------------------


def _narrow_cfgs(dtype_name):
    kw = dict(base_features=8, max_features=32, num_pool=3)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    return jax_unet.UNetConfig(compute_dtype=jdt, **kw), unet3d.UNetConfig(compute_dtype=tdt, **kw)


def _random_tree(jcfg, seed, seg_gain=12.0):
    """Random BN-model weights as a numpy tree: He-init convs from the
    reference's init, random BN statistics, and seg heads scaled so that
    sigmoids saturate (near-0.5 probabilities would flip on any rounding)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))

    def perturb(block):
        co = block["b"].shape[0]
        block["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        block["mean"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        block["var"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
        block["scale"] = rng.uniform(0.8, 1.2, co).astype(np.float32)
        block["shift"] = (rng.standard_normal(co) * 0.1).astype(np.float32)

    for stage in tree["encoder"]:
        for blk in stage:
            perturb(blk)
    for blk in tree["bottleneck"]:
        perturb(blk)
    for stage in tree["decoder"]:
        for blk in stage["blocks"]:
            perturb(blk)
        stage["seg"]["w"] = stage["seg"]["w"] * np.float32(seg_gain)
    return tree


def _forward_both(dtype_name, shape=(1, 32, 32, 24, 4), seed=3):
    jcfg, tcfg = _narrow_cfgs(dtype_name)
    tree = _random_tree(jcfg, seed)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_unet.apply_unet(jax_unet.fold_batchnorm(tree, jcfg), jnp.asarray(x),
                                         jcfg, folded=True))
    port_params = unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg)
    got = unet3d.apply_unet(port_params, torch.from_numpy(x), tcfg, folded=True).numpy()
    return ref, got


def test_unet_forward_f32_matches_reference():
    ref, got = _forward_both("f32")
    assert got.shape == ref.shape
    # f32 throughout; only summation order differs
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def _trained_fold(i):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax_load_npz(f"results/trained_synth/checkpoints/model1/fold_{i}.npz"))


def test_unet_forward_bf16_label_agreement():
    """bf16 at full MODEL1_BN width: trained fold 0 on a small synthetic case.

    The reference accumulates its bf16 XLA convs in bf16 (_acc_dtype), the
    port in f32, so decisions are compared, not values.  Trained weights
    give the decisive probabilities real cases have; narrow random weights
    leave ~0.3 % of voxels within bf16 noise of the 0.5 threshold, where the
    reference's own bf16 and f32 forwards disagree just as often.
    """
    jcfg, tcfg = jax_unet.MODEL1_BN, unet3d.MODEL1_BN
    tree = _trained_fold(0)
    mods, _ = synth_case_arrays(200, shape=(40, 40, 36))
    data = np.stack([mods[m] for m in ("t1", "t1ce", "t2", "flair")])
    x = preprocess_case(data, patch_size=(32,) * 3, pad_multiple=32, device="cpu").data.movedim(0, -1)[None]
    ref = np.asarray(jax_unet.apply_unet(jax_unet.fold_batchnorm(tree, jcfg),
                                         jnp.asarray(x.numpy()), jcfg, folded=True))
    got = unet3d.apply_unet(unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg), x, tcfg,
                            folded=True)
    lab = lambda z: np.asarray(jax_sw.region_probs_to_labels(jax.nn.sigmoid(jnp.asarray(z))))
    ref_lab, got_lab = lab(ref), lab(got.numpy())
    assert (ref_lab > 0).mean() > 0.02, "degenerate: no foreground to compare"
    assert float(np.mean(got_lab == ref_lab)) >= 0.999


@pytest.mark.parametrize("bucket", [(128, 128, 96), (224, 224, 128), (128, 128, 128),
                                    (160, 192, 160), (192, 192, 160)])
def test_dispatch_matches_reference_choice(bucket, monkeypatch):
    """Every MODEL1_BN conv goes to the Hopper kernel where the reference's
    _choose_impl picks its Pallas kernel on a TPU; the one difference is the
    reference's VMEM gate, which the Hopper kernel does not need."""
    monkeypatch.setattr(jax_unet, "_on_tpu", lambda: True)
    layers = unet3d.conv_layers(unet3d.MODEL1_BN, bucket)
    assert len(layers) == 2 * 5 + 2 + 2 * 5
    n_kernel = n_vmem_only = 0
    for shape, stride, co in layers:
        ref = jax_unet._choose_impl(shape, (3, 3, 3), stride, co) == "pallas"
        got = unet3d.choose_impl(shape, (3, 3, 3), stride, co, torch.bfloat16) == "kernel"
        if got != ref:
            # the one permitted difference: the reference's TPU VMEM gate
            assert got and jax_plan_tiles(shape[2], shape[3], shape[4], co) is None, (shape, co)
            n_vmem_only += 1
        n_kernel += got
    expect = {(128, 128, 96): (3, 0), (224, 224, 128): (3, 0), (160, 192, 160): (3, 3)}
    if bucket in expect:
        assert (n_kernel, n_vmem_only) == expect[bucket]


def test_conv_layers_account_for_the_reference_flops():
    cfg, jcfg = unet3d.MODEL1_BN, jax_unet.MODEL1_BN
    for bucket in [(128, 128, 96), (224, 224, 128)]:
        conv = sum(2 * int(np.prod(shape[1:4])) // int(np.prod(stride)) * 27 * shape[4] * co
                   for shape, stride, co in unet3d.conv_layers(cfg, bucket))
        vox = int(np.prod(bucket))
        up = sum(2 * vox // 8 ** (cfg.num_pool - 1 - u) * ch["from_down"] * ch["skip"]
                 for u, ch in enumerate(unet3d.decoder_channels(cfg)))
        seg = 2 * vox * unet3d.decoder_channels(cfg)[-1]["out"] * cfg.num_classes
        assert conv + up + seg == jax_unet.forward_flops(jcfg, bucket)


def test_forward_flops_matches_reference():
    for kw in ({}, dict(base_features=8, max_features=32, num_pool=3), dict(conv_per_stage=3)):
        j = jax_unet.UNetConfig(**kw)
        t = unet3d.UNetConfig(**kw)
        for shape in [(128, 128, 96), (224, 224, 128)]:
            assert unet3d.forward_flops(t, shape) == jax_unet.forward_flops(j, shape)


# ---------------------------------------------------------------------------
# Preprocess, labels, postprocess, metrics
# ---------------------------------------------------------------------------


def _brain_stack(seed, shape=(4, 40, 44, 36)):
    rng = np.random.default_rng(seed)
    data = np.zeros(shape, np.float32)
    data[:, 5:33, 7:40, 4:30] = rng.integers(1, 900, (4, 28, 33, 26))
    data[:, 15:18, 20:22, 10:12] = 0  # an interior hole (filled into the mask)
    return data


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_matches_reference(seed):
    data = _brain_stack(seed)
    ref = jax_preprocess(data, patch_size=(32, 32, 32), pad_multiple=32)
    got = preprocess_case(data, patch_size=(32, 32, 32), pad_multiple=32, device="cpu")
    fields = lambda c: (c.original_shape, c.lo, c.hi)
    assert fields(got.crop) == fields(ref.crop) and got.undo_slices == ref.undo_slices
    np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data), rtol=1e-5, atol=1e-5)


def test_region_labels_et_rule_conventions_uncrop_dice_bit_equal():
    rng = np.random.default_rng(7)
    probs = rng.uniform(0, 1, (20, 18, 16, 3)).astype(np.float32)
    ref = np.asarray(jax_sw.region_probs_to_labels(jnp.asarray(probs)))
    got = region_probs_to_labels(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype == np.uint8

    seg = rng.integers(0, 4, (20, 18, 16)).astype(np.uint8)
    small = np.zeros_like(seg)
    small[3:5, 3:5, 3:5] = 3
    for s in (seg, small):
        np.testing.assert_array_equal(et_min_size_postprocess(s), jax_et_rule(s))
    for name in ("internal_to_brats2025", "internal_to_brats2021", "normalize_to_brats2025"):
        for s in (seg, seg.astype(np.int32), seg.astype(np.float32) + 0.2):
            np.testing.assert_array_equal(getattr(convert, name)(s),
                                          np.asarray(getattr(jax_convert, name)(s)))

    class Crop:
        original_shape = (30, 25, 20)
        slices = (slice(4, 24), slice(2, 20), slice(1, 17))

    np.testing.assert_array_equal(uncrop_labels(seg, Crop), jax_uncrop(seg, Crop))

    pred = rng.integers(0, 4, (30, 25, 20)).astype(np.int32)
    gt = rng.integers(0, 4, (30, 25, 20)).astype(np.int32)
    assert evaluate_segmentation(pred, gt) == jax_evaluate(pred, gt)


# ---------------------------------------------------------------------------
# Engine end to end
# ---------------------------------------------------------------------------


def test_synthetic_case_files_decode_identical(tmp_path):
    """Same seed, same NIfTI bytes (the gzip containers differ only in the
    writer's OS byte: the reference may use its native gzip writer)."""
    a = write_synth_case(tmp_path / "port", "BraTS-SYN-00007-000", seed=7, shape=(40, 44, 36))
    b = jax_write_synth(tmp_path / "ref", "BraTS-SYN-00007-000", seed=7, shape=(40, 44, 36))
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) == 5
    for name in names:
        assert gzip.decompress((a / name).read_bytes()) == gzip.decompress((b / name).read_bytes())


def _engines_on_case(case_dir, jcfg, tcfg, trees):
    jcase = jax_find_cases(case_dir)[0]
    jeng = JaxEngine(models=[JaxBundle.from_folds(jcfg, trees)], mode="fullconv", tta=True)
    ref = jeng.predict_case(jcase)
    bundle = ModelBundle.from_folds(tcfg, [params_from_jax(t, tcfg) for t in trees])
    eng = InferenceEngine(models=[bundle], mode="fullconv", tta=True, device="cpu")
    got = eng.predict_case(find_cases(case_dir)[0])
    zooms = jax_load_case(jcase)[2]
    return ref, got, float(np.prod(zooms[:3])) / 1000.0


def test_engine_fullconv_matches_reference(tmp_path):
    """Narrow random weights, 2 folds, 8-flip TTA, f32 on both sides."""
    case_dir = write_synth_case(tmp_path, "BraTS-SYN-00011-000", seed=11, shape=(44, 48, 40))
    jcfg, tcfg = _narrow_cfgs("f32")
    trees = [_random_tree(jcfg, seed) for seed in (21, 22)]
    (ref_seg, ref_info), (seg, info), voxel_cm3 = _engines_on_case(case_dir, jcfg, tcfg, trees)
    assert seg.shape == ref_seg.shape and seg.dtype == ref_seg.dtype
    assert info["bucket_shape"] == ref_info["bucket_shape"]
    assert (ref_seg > 0).mean() > 0.01, "degenerate: no foreground to compare"
    assert float(np.mean(seg == ref_seg)) >= 0.999
    # f32 on both sides: each volume within one voxel's volume
    for k, v in ref_info["volumes_cm3"].items():
        assert abs(info["volumes_cm3"][k] - v) <= voxel_cm3 + 1e-12, (k, v, info["volumes_cm3"][k])


def test_engine_fullconv_bf16_trained_folds_match_reference(tmp_path):
    """The production recipe: MODEL1_BN in bf16, trained folds 0-1, TTA."""
    case_dir = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    trees = [_trained_fold(0), _trained_fold(1)]
    (ref_seg, ref_info), (seg, info), _ = _engines_on_case(
        case_dir, jax_unet.MODEL1_BN, unet3d.MODEL1_BN, trees)
    assert info["bucket_shape"] == ref_info["bucket_shape"]
    assert (ref_seg > 0).mean() > 0.01, "degenerate: no foreground to compare"
    # bf16 with different accumulation (see test_unet_forward_bf16_label_agreement)
    assert float(np.mean(seg == ref_seg)) >= 0.999
