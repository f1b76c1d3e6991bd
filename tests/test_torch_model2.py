"""The port's second slice held against the JAX package: the stage kernel's
and the up-conv kernel's plain versions, ``init_params``, the GroupNorm /
InstanceNorm deferred-norm forward, trained MODEL2_GN_LARGE, the two-model
engine, and the dispatch of both kernels.

Inputs are made with numpy from a seed and handed to both packages.  JAX
runs on the CPU (tests/conftest.py); its Pallas kernels run in interpret
mode, and its deferred-norm path (``_apply_unet_fused``) is called directly
with ``_on_tpu`` patched, as the JAX package's own tests do.  The port runs
on the CPU, where each kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ckpt import load_pytree_npz as jax_load_npz
from braintpu.infer import sliding_window as jax_sw
from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.io.brats import find_cases as jax_find_cases
from braintpu.models import unet3d as jax_unet
from braintpu.ops.stage_pallas import _xla_reference as jax_stage_oracle
from braintpu.ops.stage_pallas import conv_stage as jax_conv_stage
from braintpu.ops.stage_pallas import conv_stage_supported as jax_stage_supported
from braintpu.ops.stage_pallas import plan_stage_tiles as jax_plan_stage_tiles
from braintpu.ops.upconv_pallas import _plan_band as jax_plan_band
from braintpu.ops.upconv_pallas import upconv2x as jax_upconv2x
from braintpu.ops.upconv_pallas import upconv2x_supported as jax_upconv_supported

from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io.brats import find_cases
from braintpu_torch.models import unet3d
from braintpu_torch.ops.stage import conv_stage_ref
from braintpu_torch.ops.upconv import upconv2x_ref
from braintpu_torch.pre.preprocess import preprocess_case
from braintpu_torch.train.synthetic import synth_case_arrays, write_synth_case

CKPTS = "results/trained_synth/checkpoints"


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16-representable f32 values (exact in both packages)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# conv_stage: the plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

# (N, D, H, W, ci1, ci2, co, affine, per_sample, in1_slope, in2_slope, out_slope, stats);
# H a multiple of 8 (the reference's band planner), W irregular.
_STAGE_CASES = [
    (1, 3, 8, 9, 8, 0, 16, True, False, 0.01, None, None, True),
    (2, 4, 8, 13, 16, 8, 8, True, True, 0.01, 0.2, None, True),
    (1, 3, 16, 10, 24, 16, 24, False, False, None, None, 0.5, False),
    (2, 3, 8, 11, 8, 24, 16, True, False, 0.01, 0.01, 0.01, True),
    (1, 4, 8, 9, 16, 0, 8, False, False, 0.1, None, None, True),
    (2, 3, 8, 12, 8, 8, 24, True, True, None, None, None, False),
]


def _stage_inputs(seed, N, D, H, W, ci1, ci2, co, affine, per_sample):
    rng = np.random.default_rng(seed)
    x1 = _bf16(rng.standard_normal((N, D, H, W, ci1)))
    x2 = _bf16(rng.standard_normal((N, D, H, W, ci2))) if ci2 else None
    w = _bf16(rng.standard_normal((3, 3, 3, ci1 + ci2, co)) / np.sqrt(27 * (ci1 + ci2)))
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    aff = {}
    if affine:
        lead = (N,) if per_sample else ()
        aff["a1"] = rng.uniform(0.5, 1.5, lead + (ci1,)).astype(np.float32)
        aff["c1"] = (rng.standard_normal(lead + (ci1,)) * 0.5).astype(np.float32)
        if ci2:
            aff["a2"] = rng.uniform(0.5, 1.5, lead + (ci2,)).astype(np.float32)
            aff["c2"] = (rng.standard_normal(lead + (ci2,)) * 0.5).astype(np.float32)
    return x1, x2, w, b, aff


@pytest.mark.parametrize("case", _STAGE_CASES, ids=[f"case{i}" for i in range(len(_STAGE_CASES))])
def test_conv_stage_ref_matches_pallas_interpret(case):
    N, D, H, W, ci1, ci2, co, affine, per_sample, s1_, s2_, out_slope, stats = case
    x1, x2, w, b, aff = _stage_inputs(0, N, D, H, W, ci1, ci2, co, affine, per_sample)
    ref = jax_conv_stage(
        jnp.asarray(x1, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        x2=None if x2 is None else jnp.asarray(x2, jnp.bfloat16),
        **{k: jnp.asarray(v) for k, v in aff.items()},
        in1_affine="a1" in aff, in2_affine="a2" in aff, in1_slope=s1_,
        in2_slope=s2_ if ci2 else None, out_slope=out_slope, stats=stats, interpret=True)
    got = conv_stage_ref(
        _t(x1, torch.bfloat16), _t(w, torch.bfloat16), _t(b),
        x2=None if x2 is None else _t(x2, torch.bfloat16),
        **{k: _t(v) for k, v in aff.items()},
        in1_slope=s1_, in2_slope=s2_ if ci2 else None, out_slope=out_slope, stats=stats)
    if stats:
        (ref, rs1, rs2), (got, s1, s2) = ref, got
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    # bf16 output: one rounding apart at most where the f32 sums differ in order
    assert np.abs(got.float().numpy() - ref).max() <= 0.02 * np.abs(ref).max()
    if stats:
        # f32 sums of the same f32 conv output, summed in another order:
        # s2 to rel 1e-4; s1 (a signed sum) to 1e-4 of the sum of |y| per channel
        scale = np.abs(ref).sum(axis=(1, 2, 3))
        assert np.all(np.abs(s1.numpy() - np.asarray(rs1)) <= 1e-4 * scale)
        np.testing.assert_allclose(s2.numpy(), np.asarray(rs2), rtol=1e-4)


@pytest.mark.parametrize("two_inputs", [False, True])
def test_conv_stage_padding_stays_zero_at_every_face(two_inputs):
    """With a large shift ``c`` the transformed padding would be leaky(c) != 0.
    The plain version equals the reference oracle at every face, and differs
    from a conv over a transformed padded volume there (so the test sees it)."""
    N, D, H, W, ci1, co = 1, 3, 8, 9, 8, 8
    ci2 = 8 if two_inputs else 0
    x1, x2, w, b, _ = _stage_inputs(4, N, D, H, W, ci1, ci2, co, False, False)
    a1 = np.full(ci1, 0.5, np.float32)
    c1 = np.full(ci1, 6.0, np.float32)
    kw = dict(a1=a1, c1=c1, in1_slope=0.01)
    cfgd = dict(in1_affine=True, in1_slope=0.01, in2_affine=two_inputs,
                in2_slope=0.01 if two_inputs else None, out_slope=None)
    a2 = c2 = None
    if two_inputs:
        a2, c2 = np.full(ci2, 2.0, np.float32), np.full(ci2, -4.0, np.float32)
        kw.update(a2=a2, c2=c2, in2_slope=0.01)
    ref, _, _ = jax_stage_oracle(
        jnp.asarray(x1, jnp.bfloat16), None if x2 is None else jnp.asarray(x2, jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(a1), jnp.asarray(c1),
        None if a2 is None else jnp.asarray(a2), None if c2 is None else jnp.asarray(c2), cfgd)
    ref = np.asarray(ref, np.float32)
    targs = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = conv_stage_ref(_t(x1, torch.bfloat16), _t(w, torch.bfloat16), _t(b),
                         x2=None if x2 is None else _t(x2, torch.bfloat16), **targs)
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()

    # the wrong semantics: pad first, then transform the padding too
    def pad_then_transform(x, a, c):
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
        t = xp * a + c
        return _bf16(np.where(t >= 0, t, t * 0.01))

    tp = pad_then_transform(x1, a1, c1)
    if two_inputs:
        tp = np.concatenate([tp, pad_then_transform(x2, a2, c2)], axis=-1)
    wrong = torch.nn.functional.conv3d(
        _t(tp).permute(0, 4, 1, 2, 3), _t(w).permute(4, 3, 0, 1, 2), _t(b)
    ).permute(0, 2, 3, 4, 1).numpy()
    faces = [np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1],
             np.s_[:, :, :, 0], np.s_[:, :, :, -1]]
    for f in faces:
        assert np.abs(got[f] - ref[f]).max() <= 0.02 * np.abs(ref).max()
        assert np.abs(wrong[f] - ref[f]).max() > 0.1 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# upconv2x: the plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of each value (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("N,D,H,W,ci,co", [(1, 3, 16, 16, 8, 8), (2, 2, 8, 24, 16, 8),
                                           (1, 4, 40, 16, 32, 16), (1, 2, 8, 9, 24, 24)])
def test_upconv2x_ref_matches_pallas_interpret(N, D, H, W, ci, co):
    rng = np.random.default_rng(5)
    x = _bf16(rng.standard_normal((N, D, H, W, ci)))
    w = _bf16(rng.standard_normal((ci, 2, 2, 2, co)) / np.sqrt(ci))
    ref = np.asarray(jax_upconv2x(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                  interpret=True), np.float32)
    got = upconv2x_ref(_t(x, torch.bfloat16), _t(w, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (N, 2 * D, 2 * H, 2 * W, co)
    # the two f32 sums, taken in another order, may round a rare value to the
    # neighbouring bf16; where the sum cancels to near zero their f32 rounding
    # (~1e-7 of the terms) exceeds a bf16 ulp of the result, hence the floor
    tol = np.maximum(_bf16_ulp(ref), 1e-6 * np.abs(ref).max())
    assert np.all(np.abs(got.float().numpy() - ref) <= tol)


# ---------------------------------------------------------------------------
# Weights: init_params and the model-2 checkpoint
# ---------------------------------------------------------------------------

_NARROW = dict(base_features=8, max_features=32, num_pool=3)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("seed", [0, 1001])
@pytest.mark.parametrize("name", ["model1", "model2", "narrow_gn"])
def test_init_params_bit_identical(name, seed):
    jcfg, tcfg = {
        "model1": (jax_unet.MODEL1_BN, unet3d.MODEL1_BN),
        "model2": (jax_unet.MODEL2_GN_LARGE, unet3d.MODEL2_GN_LARGE),
        "narrow_gn": (jax_unet.UNetConfig(norm="group", **_NARROW),
                      unet3d.UNetConfig(norm="group", **_NARROW)),
    }[name]
    ref = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))
    got = unet3d.init_params(tcfg, seed)
    jr, jg = _leaves(ref), _leaves(got)
    assert len(jr) == len(jg) and len(jr) > 0
    for r, g in zip(jr, jg):
        g = g.numpy()
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        assert np.array_equal(g.view(np.uint32), r.view(np.uint32))


def test_params_from_jax_model2_fold_is_f16_exact_and_bundle_stores_bf16_of_it():
    path = f"{CKPTS}/model2/fold_0.npz"
    ref = jax_load_npz(path)
    port = params_from_jax(load_pytree_npz(path), unet3d.MODEL2_GN_LARGE)
    jr, jg = _leaves(ref), _leaves(port)
    assert len(jr) == len(jg)
    for r, g in zip(jr, jg):
        assert g.numpy().dtype == np.asarray(r).dtype == np.float16
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    bundle = ModelBundle.from_folds(unet3d.MODEL2_GN_LARGE, [port])
    assert not bundle.folded
    for g, s in zip(jg, _leaves(bundle.fold_params[0])):
        if g.dim() >= 5:  # conv, up-conv and seg kernels: one rounding f16 -> bf16
            assert s.dtype == torch.bfloat16
            assert torch.equal(s.view(torch.int16), g.to(torch.bfloat16).view(torch.int16))
        else:  # bias, scale, shift: f32, exact
            assert s.dtype == torch.float32 and torch.equal(s, g.float())


# ---------------------------------------------------------------------------
# GroupNorm / InstanceNorm forward
# ---------------------------------------------------------------------------


def _gn_cfgs(norm, dtype_name):
    kw = dict(norm=norm, group_norm_groups=4, **_NARROW)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    return jax_unet.UNetConfig(compute_dtype=jdt, **kw), unet3d.UNetConfig(compute_dtype=tdt, **kw)


def _gn_tree(jcfg, seed):
    """Random weights with non-trivial biases, scales and shifts."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))
    blocks = [b for st in tree["encoder"] for b in st] + list(tree["bottleneck"])
    blocks += [b for st in tree["decoder"] for b in st["blocks"]]
    for blk in blocks:
        co = blk["b"].shape[0]
        blk["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        blk["scale"] = rng.uniform(0.8, 1.2, co).astype(np.float32)
        blk["shift"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return tree


_X_SHAPE = (1, 16, 32, 32, 4)  # 3 pools: kernel-sized levels down to 4x8x8


@pytest.mark.parametrize("norm", ["group", "instance"])
def test_deferred_forward_f32_matches_reference(norm):
    """f32 config: every conv takes the fallback (materialize, F.conv3d,
    statistics); the reference's plain forward normalizes explicitly."""
    jcfg, tcfg = _gn_cfgs(norm, "f32")
    tree = _gn_tree(jcfg, 7)
    x = np.random.default_rng(7).standard_normal(_X_SHAPE).astype(np.float32)
    ref = np.asarray(jax_unet.apply_unet(tree, jnp.asarray(x), jcfg))
    got = unet3d.apply_unet(params_from_jax(tree, tcfg), _t(x), tcfg).numpy()
    assert got.shape == ref.shape
    # f32 throughout; summation order and the folded affine differ
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("norm", ["group", "instance"])
def test_deferred_forward_bf16_matches_fused_reference(norm, monkeypatch):
    """bf16 config: the port's deferred path (stage kernel's plain version on
    the CPU) vs the reference's ``_apply_unet_fused`` (Pallas ``conv_stage``
    in interpret mode).  Logits within 0.05 of their largest magnitude (bf16
    intermediates, bf16-accumulated fallback convs in the reference), labels
    >= 0.99: random weights leave voxels near the threshold (ROADMAP C)."""
    jcfg, tcfg = _gn_cfgs(norm, "bf16")
    tree = _gn_tree(jcfg, 8)
    x = np.random.default_rng(8).standard_normal(_X_SHAPE).astype(np.float32)
    monkeypatch.setattr(jax_unet, "_on_tpu", lambda: True)
    ref = np.asarray(jax_unet._apply_unet_fused(tree, jnp.asarray(x), jcfg, False))
    layers = unet3d.deferred_layers(tcfg, _X_SHAPE[1:4])
    assert sum(unet3d.choose_stage_impl(s, (3, 3, 3), st, co, c2) == "kernel"
               for s, st, co, c2 in layers) == 9  # the stage kernel is on this path
    got = unet3d.apply_unet(params_from_jax(tree, tcfg), _t(x), tcfg).numpy()
    assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()
    lab = lambda z: np.asarray(jax_sw.region_probs_to_labels(jax.nn.sigmoid(jnp.asarray(z))))
    assert float(np.mean(lab(got) == lab(ref))) >= 0.99


def _trained(model, fold):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_load_npz(f"{CKPTS}/{model}/fold_{fold}.npz"))


def test_model2_trained_fold_bf16_label_agreement():
    """MODEL2_GN_LARGE at full width, trained fold 0, one bf16 forward of the
    seed-200 case, vs the reference's ``apply_unet``.  The reference
    accumulates its bf16 GroupNorm convs in bf16, the port in f32; with
    trained weights the labels agree on >= 0.999 of voxels."""
    jcfg, tcfg = jax_unet.MODEL2_GN_LARGE, unet3d.MODEL2_GN_LARGE
    tree = _trained("model2", 0)
    mods, _ = synth_case_arrays(200, shape=(40, 40, 36))
    data = np.stack([mods[m] for m in ("t1", "t1ce", "t2", "flair")])
    x = preprocess_case(data, patch_size=(32,) * 3, pad_multiple=32).data.movedim(0, -1)[None]
    ref = np.asarray(jax_unet.apply_unet(tree, jnp.asarray(x.numpy()), jcfg))
    got = unet3d.apply_unet(params_from_jax(tree, tcfg), x, tcfg)
    lab = lambda z: np.asarray(jax_sw.region_probs_to_labels(jax.nn.sigmoid(jnp.asarray(z))))
    ref_lab, got_lab = lab(ref), lab(got.numpy())
    assert (ref_lab > 0).mean() > 0.02, "degenerate: no foreground to compare"
    assert float(np.mean(got_lab == ref_lab)) >= 0.999


def test_engine_two_models_trained_match_reference(tmp_path):
    """The reference CLI's default ensemble: model1 (BN, folded) + model2
    (GN) with trained folds 0-1, bf16, fullconv, 8-flip TTA, softmax mean,
    ET rule."""
    case_dir = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    trees = {m: [_trained(m, 0), _trained(m, 1)] for m in ("model1", "model2")}
    jeng = JaxEngine(models=[JaxBundle.from_folds(jax_unet.MODEL1_BN, trees["model1"]),
                             JaxBundle.from_folds(jax_unet.MODEL2_GN_LARGE, trees["model2"])],
                     mode="fullconv", tta=True)
    ref_seg, ref_info = jeng.predict_case(jax_find_cases(case_dir)[0])
    bundles = [ModelBundle.from_folds(cfg, [params_from_jax(t, cfg) for t in trees[m]], name=m)
               for m, cfg in (("model1", unet3d.MODEL1_BN), ("model2", unet3d.MODEL2_GN_LARGE))]
    assert [b.folded for b in bundles] == [True, False]
    eng = InferenceEngine(models=bundles, mode="fullconv", tta=True, device="cpu")
    seg, info = eng.predict_case(find_cases(case_dir)[0])
    assert info["bucket_shape"] == ref_info["bucket_shape"] and info["num_models"] == 2
    assert (ref_seg > 0).mean() > 0.01, "degenerate: no foreground to compare"
    assert float(np.mean(seg == ref_seg)) >= 0.999


# ---------------------------------------------------------------------------
# Dispatch of both kernels at the production buckets
# ---------------------------------------------------------------------------

# bucket -> (model-2 convs the port sends to conv_stage, of which the
# reference's planner rejects; up-convs of both models the port sends to
# upconv2x, of which the reference rejects).  Derived with the reference's
# own conv_stage_supported / upconv2x_supported.
_DISPATCH = {
    (128, 128, 96): (12, 1, 10, 4),
    (224, 224, 128): (15, 6, 10, 6),
    (128, 128, 128): (15, 2, 10, 2),
    (160, 192, 160): (15, 4, 10, 4),
    (192, 192, 160): (15, 4, 10, 4),
}


@pytest.mark.parametrize("bucket", sorted(_DISPATCH))
def test_stage_and_upconv_dispatch_match_reference(bucket):
    """MODEL2_GN_LARGE's stride-1 3x3x3 convs go to the Hopper stage kernel
    where the reference's ``_fused_block`` takes its Pallas kernel, and the
    up-convs of both models go to the Hopper up-conv kernel where the
    reference's ``upconv2x_supported`` admits them.  The only permitted
    differences are the reference's TPU-only gates: its VMEM planners
    (``plan_stage_tiles`` / ``_plan_band`` -> None) and the up-conv's
    H, W >= 8 floor."""
    cfg = unet3d.MODEL2_GN_LARGE
    n_kernel = n_tpu_only = 0
    for (N, D, H, W, ci1), stride, co, ci2 in unet3d.deferred_layers(cfg, bucket):
        got = unet3d.choose_stage_impl((N, D, H, W, ci1), (3, 3, 3), stride, co, ci2) == "kernel"
        ref = stride == (1, 1, 1) and jax_stage_supported((N, D, H, W, ci1), co, ci2=ci2)
        if got != ref:
            split = (ci1, ci2) if ci2 else None
            assert got and jax_plan_stage_tiles(H, W, ci1 + ci2, co, ci_split=split) is None
            n_tpu_only += 1
        n_kernel += got
    n_up = n_up_tpu_only = 0
    for tcfg in (unet3d.MODEL1_BN, cfg):
        for shape, co in unet3d.upconv_layers(tcfg, bucket):
            got = unet3d.upconv_supported(shape, co)
            ref = jax_upconv_supported(shape, co)
            if got != ref:
                _, _, H, W, ci = shape
                assert got and (H < 8 or W < 8 or jax_plan_band(H, W, ci, co) is None)
                n_up_tpu_only += 1
            n_up += got
    assert (n_kernel, n_tpu_only, n_up, n_up_tpu_only) == _DISPATCH[bucket]


def test_upconv_layers_account_for_the_reference_upconv_flops():
    for cfg in (unet3d.MODEL1_BN, unet3d.MODEL2_GN_LARGE):
        for bucket in [(128, 128, 96), (224, 224, 128)]:
            ups = unet3d.upconv_layers(cfg, bucket)
            assert len(ups) == cfg.num_pool and ups[-1][0][1:4] == tuple(s // 2 for s in bucket)
            vox = int(np.prod(bucket))
            want = sum(2 * vox // 8 ** (cfg.num_pool - 1 - u) * ch["from_down"] * ch["skip"]
                       for u, ch in enumerate(unet3d.decoder_channels(cfg)))
            assert sum(2 * int(np.prod(s[1:4])) * s[4] * 8 * co for s, co in ups) == want
