"""The reference's config fields, argument order and defaults, held against
the JAX package: ``UNetConfig.conv_impl`` / ``param_dtype`` /
``final_nonlin``, ``ModularUNetConfig.param_dtype``, and positional calls
of ``ModelBundle``, ``InferenceEngine``, ``TrainState`` and
``FeatureContext``.

Inputs are made with numpy from a seed at a small config (``base_features``
8, ``max_features`` 64, two pools, a 16^3 input) and handed to both
packages; the bf16 label agreement takes the trained folds, as the other
bf16 label tests do.  JAX runs on the CPU (tests/conftest.py), where the reference's
"auto" dispatch takes its XLA lowerings; the port runs on the CPU, where
the kernel wrappers take their plain versions, so these tests compare
numerics and the dispatch's decisions, not launches.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ckpt import load_pytree_npz as jax_load_npz
from braintpu.features.context import FeatureContext as JaxFeatureContext
from braintpu.infer import sliding_window as jax_sw
from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.models import modular_unet as jax_mod
from braintpu.models import unet3d as jax_unet
from braintpu.train.trainer import TrainState as JaxTrainState

from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.features.context import FeatureContext
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.models import modular_unet as mod
from braintpu_torch.models import unet3d
from braintpu_torch.ops.conv3d import kernel_supported
from braintpu_torch.parallel.mesh import make_mesh
from braintpu_torch.pre.preprocess import preprocess_case
from braintpu_torch.train.synthetic import synth_case_arrays
from braintpu_torch.train.trainer import TrainConfig, TrainState, make_optimizer

CKPTS = "results/trained_synth/checkpoints"

_SMALL = dict(base_features=8, max_features=64, num_pool=2)
_X = (1, 16, 16, 16, 4)
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
_LIBRARY_IMPLS = ("xla3d", "decomp2d", "merged2d")


def _cfgs(kind, dtype="f32", **kw):
    """MODEL1-like (BatchNorm, folded) or MODEL2-like (GroupNorm, double
    encoder) small configs of both packages."""
    fields = dict(_SMALL, **kw)
    if kind == "model2":
        fields.update(norm="group", encoder_scale=2, group_norm_groups=4)
    return (jax_unet.UNetConfig(compute_dtype=_JDT[dtype], **fields),
            unet3d.UNetConfig(compute_dtype=_TDT[dtype], **fields))


def _tree(jcfg, seed, seg_gain=12.0):
    """The reference's random weights with non-trivial biases, norms and
    statistics, and seg heads scaled so that the sigmoids saturate (labels
    near 0.5 would flip on any rounding)."""
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
    for stage in tree["decoder"]:
        stage["seg"]["w"] = stage["seg"]["w"] * np.float32(seg_gain)
    return tree


def _forwards(kind, jcfg, tcfg, seed):
    """The reference's and the port's eval forward of the same weights and
    input (model 1 with its BatchNorm folded, as the engines run it)."""
    tree = _tree(jcfg, seed)
    x = np.random.default_rng(seed).standard_normal(_X).astype(np.float32)
    if kind == "model1":
        ref = jax_unet.apply_unet(jax_unet.fold_batchnorm(tree, jcfg), jnp.asarray(x), jcfg,
                                  folded=True)
        got = unet3d.apply_unet(unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg),
                                torch.from_numpy(x), tcfg, folded=True)
    else:
        ref = jax_unet.apply_unet(tree, jnp.asarray(x), jcfg)
        got = unet3d.apply_unet(params_from_jax(tree, tcfg), torch.from_numpy(x), tcfg)
    return np.asarray(ref, np.float32), got.float().numpy()


def _labels(z):
    return np.asarray(jax_sw.region_probs_to_labels(jax.nn.sigmoid(jnp.asarray(z))))


# ---------------------------------------------------------------------------
# conv_impl: the forward under each value
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["model1", "model2"])
@pytest.mark.parametrize("impl", [*_LIBRARY_IMPLS, "pallas"])
def test_f32_forward_under_each_conv_impl_matches_reference(impl, kind):
    """f32 compute: every value sends every conv to the library in both
    packages ("pallas" falls back, as the reference's ``_conv3d_pallas`` does
    at f32), so the forwards agree to f32 summation order."""
    jcfg, tcfg = _cfgs(kind, "f32", conv_impl=impl)
    assert set(unet3d.conv_routes(tcfg, _X[1:4])) == {"library"}
    ref, got = _forwards(kind, jcfg, tcfg, seed=11)
    assert got.shape == ref.shape
    # the existing f32 parity tolerance (tests/test_torch_parity.py, test_torch_model2.py)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def _trained(model):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_load_npz(f"{CKPTS}/{model}/fold_0.npz"))


@pytest.mark.parametrize("kind", ["model1", "model2"])
def test_bf16_pallas_forward_agrees_with_reference_xla3d_on_labels(kind):
    """bf16 compute, "pallas" in the port (the tap kernel's plain version on
    the CPU for every conv it takes, the rest on the library) against the
    reference's "xla3d" (its bf16 Pallas path cannot run on the CPU): the
    labels agree on >= 0.999 of the voxels.  Trained fold 0 of each model
    at full width on the seed-200 input at 32^3 (as the bf16 label tests of
    tests/test_torch_parity.py and test_torch_model2.py): random weights
    leave too many voxels within bf16 noise of the threshold, where the
    reference's own bf16 and f32 forwards disagree on 0.3-0.7 % of them."""
    name = {"model1": "MODEL1_BN", "model2": "MODEL2_GN_LARGE"}[kind]
    jcfg = dataclasses.replace(getattr(jax_unet, name), conv_impl="xla3d")
    tcfg = dataclasses.replace(getattr(unet3d, name), conv_impl="pallas")
    mods, _ = synth_case_arrays(200, shape=(40, 40, 36))
    data = np.stack([mods[m] for m in ("t1", "t1ce", "t2", "flair")])
    x = preprocess_case(data, patch_size=(32,) * 3, pad_multiple=32,
                        device="cpu").data.movedim(0, -1)[None]
    routes = Counter(unet3d.conv_routes(tcfg, tuple(x.shape[1:4])))
    assert routes["kernel"] > 0 and routes["stage"] == 0
    tree = _trained(kind)
    if kind == "model1":
        ref = jax_unet.apply_unet(jax_unet.fold_batchnorm(tree, jcfg), jnp.asarray(x.numpy()),
                                  jcfg, folded=True)
        got = unet3d.apply_unet(unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg), x,
                                tcfg, folded=True)
    else:
        ref = jax_unet.apply_unet(tree, jnp.asarray(x.numpy()), jcfg)
        got = unet3d.apply_unet(params_from_jax(tree, tcfg), x, tcfg)
    ref_lab, got_lab = _labels(np.asarray(ref)), _labels(got.numpy())
    assert (ref_lab > 0).mean() > 0.02, "degenerate: no foreground to compare"
    assert float(np.mean(got_lab == ref_lab)) >= 0.999


@pytest.mark.parametrize("kind", ["model1", "model2"])
def test_bf16_pallas_and_library_values_agree_in_the_port(kind):
    """The small config at bf16: "pallas" (the tap kernel's plain version
    where it takes the conv) and "xla3d" (the library everywhere) compute
    the same bf16-rounded f32 convs, so the logits agree to bf16 output
    resolution (the kernels' tolerance, 0.02 of the largest magnitude)."""
    jcfg, tcfg = _cfgs(kind, "bf16", conv_impl="pallas")
    assert Counter(unet3d.conv_routes(tcfg, _X[1:4]))["kernel"] > 0
    tree = _tree(jcfg, 12)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(_X).astype(np.float32))
    out = {}
    for impl in ("pallas", "xla3d"):
        cfg = dataclasses.replace(tcfg, conv_impl=impl)
        params = params_from_jax(tree, cfg)
        if kind == "model1":
            out[impl] = unet3d.apply_unet(unet3d.fold_batchnorm(params, cfg), x, cfg, folded=True)
        else:
            out[impl] = unet3d.apply_unet(params, x, cfg)
    ref = out["xla3d"].float()
    assert (out["pallas"].float() - ref).abs().max() <= 0.02 * ref.abs().max()


@pytest.mark.parametrize("kind", ["model1", "model2"])
def test_unknown_conv_impl_raises_the_reference_message(kind):
    jcfg, tcfg = _cfgs(kind, "f32", conv_impl="fast")
    tree = _tree(jcfg, 3)
    x = np.zeros(_X, np.float32)
    folded = kind == "model1"
    with pytest.raises(ValueError) as ref:
        jax_unet.apply_unet(jax_unet.fold_batchnorm(tree, jcfg) if folded else tree,
                            jnp.asarray(x), jcfg, folded=folded)
    params = params_from_jax(tree, tcfg)
    with pytest.raises(ValueError) as got:
        unet3d.apply_unet(unet3d.fold_batchnorm(params, tcfg) if folded else params,
                          torch.from_numpy(x), tcfg, folded=folded)
    assert str(got.value) == str(ref.value)
    assert "unknown conv_impl 'fast'" in str(got.value)


def test_config_fields_construct_and_bind_by_position():
    """Every field of the reference's UNetConfig, given by position, binds
    the same field in the port (``jnp`` dtypes read as ``torch``)."""
    ref = jax_unet.UNetConfig(param_dtype=jnp.bfloat16, conv_impl="pallas",
                              final_nonlin="softmax")
    values = [getattr(ref, f.name) for f in dataclasses.fields(ref)]
    as_torch = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    values = [as_torch.get(v, v) if not isinstance(v, (tuple, list)) else v for v in values]
    port = unet3d.UNetConfig(*values)
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        assert getattr(port, f.name) == as_torch.get(want, want), f.name
    assert (port.param_dtype, port.conv_impl, port.final_nonlin) == (
        torch.bfloat16, "pallas", "softmax")
    assert unet3d.UNetConfig().final_nonlin == jax_unet.UNetConfig().final_nonlin == "sigmoid"
    mref = jax_mod.ModularUNetConfig(param_dtype=jnp.bfloat16)
    mport = mod.ModularUNetConfig(*[as_torch.get(getattr(mref, f.name), getattr(mref, f.name))
                                    for f in dataclasses.fields(mref)])
    assert mport.param_dtype == torch.bfloat16 and mport.final_nonlin == "softmax"
    assert mport.block_cfg((3, 3, 3)).param_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# param_dtype
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("seed", [0, 1001])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kind", ["model1", "model2"])
def test_init_params_at_param_dtype_is_the_reference_bit_for_bit(kind, dtype, seed):
    jcfg, tcfg = _cfgs(kind, "bf16")
    jcfg = dataclasses.replace(jcfg, param_dtype=_JDT[dtype])
    tcfg = dataclasses.replace(tcfg, param_dtype=_TDT[dtype])
    ref = _leaves(jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed)))
    got = _leaves(unet3d.init_params(tcfg, seed))
    assert len(ref) == len(got) > 0
    for r, g in zip(ref, got):
        assert g.dtype == _TDT[dtype] and str(r.dtype) == str(np.dtype(_JDT[dtype]))
        assert tuple(g.shape) == r.shape
        gn = g.view({2: torch.int16, 4: torch.int32}[g.element_size()]).numpy()
        assert np.array_equal(_bits(gn), _bits(r))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_modular_unet_at_param_dtype(dtype):
    """The modular U-Net's leaves at ``param_dtype``: the reference's dtypes
    and shapes; the non-random leaves bit-equal; each He leaf the f32 draw of
    the same seed cast once, as the reference's (its values come from random
    keys of its own, a recorded delta)."""
    kw = dict(base_features=8, max_features=32, pool_kernels=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
              conv_kernels=((3, 3, 3),) * 3, blocks_per_stage_encoder=(2, 2, 2), norm="batch")
    jcfg = jax_mod.ModularUNetConfig(param_dtype=_JDT[dtype], **kw)
    tcfg = mod.ModularUNetConfig(param_dtype=_TDT[dtype], **kw)
    ref = _leaves(jax.tree_util.tree_map(np.asarray,
                                         jax_mod.init_modular_unet(jcfg, jax.random.PRNGKey(0))))
    got = _leaves(mod.init_modular_unet(tcfg, 0))
    f32 = _leaves(mod.init_modular_unet(dataclasses.replace(tcfg, param_dtype=torch.float32), 0))
    assert len(ref) == len(got) == len(f32) > 0
    for r, g, g32 in zip(ref, got, f32):
        assert g.dtype == _TDT[dtype] and str(r.dtype) == str(np.dtype(_JDT[dtype]))
        assert tuple(g.shape) == r.shape
        if g.dim() == 1:  # bias, scale, shift, mean, var: zeros and ones
            assert np.array_equal(g.float().numpy(), r.astype(np.float32))
        else:
            assert torch.equal(g, g32.to(_TDT[dtype]))


# ---------------------------------------------------------------------------
# The resolver, per bucket
# ---------------------------------------------------------------------------

# bucket -> config -> conv_impl -> (tap kernel, conv_stage, library) convs
# of one forward
_ROUTES = {
    (128, 128, 96): {"MODEL1_BN": {"auto": (3, 0, 19), "pallas": (12, 0, 10)},
                     "MODEL2_GN_LARGE": {"auto": (0, 12, 10), "pallas": (12, 0, 10)}},
    (192, 192, 128): {"MODEL1_BN": {"auto": (3, 0, 19), "pallas": (15, 0, 7)},
                      "MODEL2_GN_LARGE": {"auto": (0, 15, 7), "pallas": (15, 0, 7)}},
    (224, 224, 128): {"MODEL1_BN": {"auto": (3, 0, 19), "pallas": (15, 0, 7)},
                      "MODEL2_GN_LARGE": {"auto": (0, 15, 7), "pallas": (15, 0, 7)}},
    (160, 192, 160): {"MODEL1_BN": {"auto": (3, 0, 19), "pallas": (15, 0, 7)},
                      "MODEL2_GN_LARGE": {"auto": (0, 15, 7), "pallas": (15, 0, 7)}},
}


@pytest.mark.parametrize("bucket", sorted(_ROUTES))
@pytest.mark.parametrize("name", ["MODEL1_BN", "MODEL2_GN_LARGE"])
def test_resolver_routes_per_bucket(name, bucket):
    """Which convs each value sends to the tap kernel and to ``conv_stage``:
    "auto" is the dispatch the pins in tests/test_torch_parity.py and
    test_torch_model2.py hold; "pallas" is every stride-1 3x3x3 conv the tap
    kernel takes, never ``conv_stage``; the library values send everything
    to ``F.conv3d``."""
    base = getattr(unet3d, name)
    for impl, want in _ROUTES[bucket][name].items():
        c = Counter(unet3d.conv_routes(dataclasses.replace(base, conv_impl=impl), bucket))
        assert (c["kernel"], c["stage"], c["library"]) == want, impl
    auto = unet3d.conv_routes(base, bucket)
    pallas = unet3d.conv_routes(dataclasses.replace(base, conv_impl="pallas"), bucket)
    layers = unet3d.conv_layers(base, bucket)
    for (shape, stride, co), a, p in zip(layers, auto, pallas):
        admitted = stride == (1, 1, 1) and kernel_supported(shape, co)
        assert p == ("kernel" if admitted else "library"), (shape, stride, co)
        if a == "kernel":  # the band stays on the kernel under "pallas"
            assert p == "kernel"
        # "auto" is exactly the dispatch functions' choice
        if base.norm == "batch":
            assert a == unet3d.choose_impl(shape, (3, 3, 3), stride, co)
    if base.norm == "group":
        stage = [unet3d.choose_stage_impl(s, (3, 3, 3), st, co, c2) == "kernel"
                 for s, st, co, c2 in unet3d.deferred_layers(base, bucket)]
        assert [a == "stage" for a in auto] == stage
    for impl in _LIBRARY_IMPLS:
        assert set(unet3d.conv_routes(dataclasses.replace(base, conv_impl=impl), bucket)) == {
            "library"}
    f32 = dataclasses.replace(base, conv_impl="pallas", compute_dtype=torch.float32)
    assert set(unet3d.conv_routes(f32, bucket)) == {"library"}


def test_resolver_reads_the_shape_it_is_given_and_raises_on_an_unknown_value():
    """An X-sharded conv passes its global shape: the same decision on every
    rank.  An unknown value raises only when a conv is dispatched, as in the
    reference (the config itself takes any string)."""
    cfg = dataclasses.replace(unet3d.MODEL1_BN, conv_impl="pallas")
    assert unet3d.resolve_conv_impl(cfg, (1, 192, 192, 128, 32), (3, 3, 3), (1, 1, 1), 32) \
        == "kernel"
    assert unet3d.resolve_conv_impl(cfg, (1, 6, 6, 4, 320), (3, 3, 3), (1, 1, 1), 320) \
        == "library"
    assert unet3d.resolve_conv_impl(cfg, (1, 64, 64, 64, 32), (3, 3, 3), (2, 2, 2), 64) \
        == "library"
    # a deferred-norm conv with a skip: the tap kernel sees both inputs' channels
    assert unet3d.resolve_conv_impl(cfg, (1, 96, 96, 64, 64), (3, 3, 3), (1, 1, 1), 64, 64) \
        == "kernel"
    bad = dataclasses.replace(unet3d.MODEL1_BN, conv_impl="Pallas")
    with pytest.raises(ValueError, match="unknown conv_impl 'Pallas'"):
        unet3d.resolve_conv_impl(bad, (1, 64, 64, 64, 32), (3, 3, 3), (1, 1, 1), 64)


# ---------------------------------------------------------------------------
# Positional binding of the engine, the bundle, the train state and the
# feature context
# ---------------------------------------------------------------------------


def test_model_bundle_binds_folded_third_and_defaults_to_unfolded():
    jcfg, tcfg = _cfgs("model1", "f32")
    tree = _tree(jcfg, 5)
    stacked = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], tree)
    params = params_from_jax(tree, tcfg)
    ref, got = JaxBundle(jcfg, stacked, False), ModelBundle(tcfg, [params], False)
    assert (got.folded, got.name) == (ref.folded, ref.name) == (False, "")
    ref, got = JaxBundle(jcfg, stacked, True, "m"), ModelBundle(tcfg, [params], True, "m")
    assert (got.folded, got.name) == (ref.folded, ref.name) == (True, "m")
    assert ModelBundle(tcfg, [params]).folded is JaxBundle(jcfg, stacked).folded is False


def test_unfolded_batchnorm_bundle_runs_its_norms_as_the_reference():
    """A bundle built without ``folded`` runs an unfolded BatchNorm tree with
    its norms in the forward (eval statistics), through positional engines
    of both packages: the labels equal the reference's, and the forward the
    reference's ``folded=False`` forward."""
    jcfg, tcfg = _cfgs("model1", "f32")
    tree = _tree(jcfg, 6)
    stacked = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], tree)
    bundle = ModelBundle(tcfg, [params_from_jax(tree, tcfg)])
    x = np.random.default_rng(6).standard_normal(_X).astype(np.float32)
    ref = np.asarray(jax_unet.apply_unet(tree, jnp.asarray(x), jcfg, folded=False))
    got = unet3d.apply_unet(bundle.fold_params[0], torch.from_numpy(x), tcfg,
                            folded=bundle.folded).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))

    rng = np.random.default_rng(6)
    data = np.zeros((4, 20, 18, 16), np.float32)
    data[:, 2:18, 1:17, 0:16] = rng.uniform(1, 900, (4, 16, 16, 16))
    # models, step_size, tta, ensemble, et_min_voxels, output_convention, mode
    args = (0.5, False, "softmax", 0, "internal", "fullconv")
    jeng = JaxEngine([JaxBundle(jcfg, stacked)], *args)
    teng = InferenceEngine([bundle], *args, device="cpu")
    assert teng.mode == jeng.mode == "fullconv" and teng.output_convention == "internal"
    ref_seg, _ = jeng.predict_case_array(data)
    got_seg, _ = teng.predict_case_array(data)
    assert 0 < int((ref_seg > 0).sum()) < ref_seg.size
    np.testing.assert_array_equal(got_seg, ref_seg)


def test_inference_engine_binds_mesh_and_spatial_shard_by_position():
    jcfg, tcfg = _cfgs("model1", "f32")
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 0)])
    mesh = make_mesh(devices=["cpu"])
    # the reference's nine fields, by position
    eng = InferenceEngine([bundle], 0.25, False, "label", 7, "brats2021", "fullconv", mesh, True)
    assert (eng.step_size, eng.tta, eng.ensemble, eng.et_min_voxels, eng.output_convention,
            eng.mode, eng.mesh, eng.spatial_shard) == (0.25, False, "label", 7, "brats2021",
                                                       "fullconv", mesh, True)
    assert eng.device == torch.device("cpu")  # the mesh's device
    ref = JaxEngine([], 0.25, False, "label", 7, "brats2021", "fullconv", "a mesh", True)
    assert (ref.mesh, ref.spatial_shard) == ("a mesh", True)
    assert [f.name for f in dataclasses.fields(InferenceEngine)][:9] == [
        f.name for f in dataclasses.fields(JaxEngine)]


def test_train_state_binds_opt_state_by_position():
    params = {"w": torch.zeros(3, requires_grad=True)}
    opt = make_optimizer(TrainConfig(), params)
    got = TrainState(params, opt, 4)
    ref = JaxTrainState({"w": np.zeros(3)}, "state", 4)
    assert (got.params, got.opt_state, got.step) == (params, opt, 4)
    assert ref.opt_state == "state" and ref._fields == ("params", "opt_state", "step")
    assert [f.name for f in dataclasses.fields(TrainState)] == list(ref._fields)
    assert not hasattr(got, "optimizer")  # one name on the surface


def test_feature_context_binds_every_reference_field_by_position():
    """Every field of the reference's FeatureContext, given by position,
    binds the same field in the port; the port's own ``device`` and
    ``_device_upload_error`` come after them."""
    names = [f.name for f in dataclasses.fields(JaxFeatureContext)]
    values = [f"value of {n}" for n in names]
    ref, got = JaxFeatureContext(*values), FeatureContext(*values)
    for n in names:
        assert getattr(got, n) == getattr(ref, n) == f"value of {n}"
    port_names = [f.name for f in dataclasses.fields(FeatureContext)]
    assert port_names[:len(names)] == names
    assert port_names[len(names):] == ["device", "_device_upload_error"]
    assert got.device is None and got._device_upload_error is None
