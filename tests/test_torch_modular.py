"""The modular U-Net and nnU-Net plans on the port against the JAX package.

``apply_modular_unet`` with instance norm, group norm and an anisotropic
plan (``(1,3,3)`` convs, ``(1,2,2)`` pools), with and without deep
supervision, in f32 from the reference's parameters; the dispatch of its
bf16 convs and up-convs to the Hopper kernels' wrappers; the config checks,
the stage plan, ``estimate_activation_bytes`` and the initialisation; and
``config_from_plans`` / ``load_nnunet_plans`` on plans dicts built here
(the reference's plans pickle is not in the repository), the anisotropic
refusal included.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.models import modular_unet as jax_mod
from braintpu.models import plans as jax_plans
from braintpu.models import unet3d as jax_unet

from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.models import modular_unet as mod
from braintpu_torch.models import plans, unet3d

ANISO = dict(pool_kernels=((1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
             conv_kernels=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)),
             blocks_per_stage_encoder=(1, 2, 2, 1))
ISO = dict(pool_kernels=((1, 1, 1), (2, 2, 2), (2, 2, 2)), conv_kernels=((3, 3, 3),) * 3,
           blocks_per_stage_encoder=(2, 2, 2))
_CASES = {
    "instance": (dict(norm="instance", **ISO), (2, 16, 16, 16, 3)),
    "group": (dict(norm="group", group_norm_groups=2, **ISO), (2, 16, 16, 16, 3)),
    "anisotropic": (dict(norm="instance", blocks_per_stage_decoder=(1, 2, 1), **ANISO),
                    (1, 8, 16, 16, 3)),
    "batch": (dict(norm="batch", **ISO), (1, 16, 16, 16, 3)),
}


def _cfgs(name, dtype="f32", **kw):
    fields, _ = _CASES[name]
    kw = dict(in_channels=3, num_classes=2, base_features=4, max_features=16, **fields, **kw)
    return (jax_mod.ModularUNetConfig(compute_dtype=jnp.float32 if dtype == "f32"
                                      else jnp.bfloat16, **kw),
            mod.ModularUNetConfig(compute_dtype=torch.float32 if dtype == "f32"
                                  else torch.bfloat16, **kw))


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_port(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _reference_params(jcfg, seed):
    """The reference's init (jax keys) with random norm leaves."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_mod.init_modular_unet(jcfg, jax.random.PRNGKey(seed)))
    blocks = [b for st in tree["encoder"] for b in st] + \
        [b for st in tree["decoder"] for b in st["blocks"]]
    for blk in blocks:
        co = blk["b"].shape[0]
        blk["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        blk["scale"] = rng.uniform(0.8, 1.2, co).astype(np.float32)
        blk["shift"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        if "mean" in blk:
            blk["mean"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
            blk["var"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
    return tree


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


# ---------------------------------------------------------------------------
# The modular U-Net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["instance", "group", "anisotropic", "batch"])
@pytest.mark.parametrize("deep", [False, True], ids=["final", "deep_supervision"])
def test_modular_unet_equals_reference(name, deep):
    """f32 logits of the final head, or every head (full resolution first),
    within 1e-5 of the reference's max."""
    jcfg, tcfg = _cfgs(name)
    tree = _reference_params(jcfg, 1)
    x = np.random.default_rng(2).standard_normal(_CASES[name][1]).astype(np.float32)
    want = jax_mod.apply_modular_unet(tree, jnp.asarray(x), jcfg, deep_supervision=deep)
    got = mod.apply_modular_unet(_to_port(tree), torch.from_numpy(x), tcfg,
                                 deep_supervision=deep)
    if not deep:
        got, want = [got], [want]
    assert len(got) == len(want) == (tcfg.num_stages - 1 if deep else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= 1e-5
    # the encoder alone: the skips, bottleneck last
    skips = mod.apply_encoder(_to_port(tree)["encoder"], torch.from_numpy(x), tcfg)
    jskips = jax_mod.apply_encoder(tree["encoder"], jnp.asarray(x), jcfg)
    assert [tuple(s.shape) for s in skips] == [tuple(s.shape) for s in jskips]
    for s, j in zip(skips, jskips):
        assert _rel(s.numpy(), j) <= 1e-5


def test_modular_bf16_dispatch_reaches_the_kernel_wrappers(monkeypatch):
    """bf16: the stride-1 3x3x3 convs in the band (D = 48, co = 64) go to
    the tap kernel's wrapper without LeakyReLU (the norm sits between), the
    2x2x2 up-conv to ``upconv2x``; anisotropic kernels and strides take the
    library.  Labels agree with the reference's bf16 forward."""
    taps, ups = [], []
    real_tap, real_up = unet3d.conv3d_tap_merged, unet3d.upconv2x
    monkeypatch.setattr(unet3d, "conv3d_tap_merged", lambda x, w, b, slope=None: taps.append(
        (tuple(x.shape), int(w.shape[4]), slope)) or real_tap(x, w, b, slope))
    monkeypatch.setattr(unet3d, "upconv2x",
                        lambda x, w: ups.append(tuple(x.shape)) or real_up(x, w))
    kw = dict(in_channels=4, num_classes=3, base_features=64, max_features=64,
              pool_kernels=((1, 1, 1), (2, 2, 2)), conv_kernels=((3, 3, 3), (3, 3, 3)),
              blocks_per_stage_encoder=(2, 1))
    tcfg = mod.ModularUNetConfig(compute_dtype=torch.bfloat16, **kw)
    jcfg = jax_mod.ModularUNetConfig(compute_dtype=jnp.bfloat16, **kw)
    tree = _reference_params(jcfg, 3)
    x = np.random.default_rng(4).standard_normal((1, 48, 8, 8, 4)).astype(np.float32)
    got = mod.apply_modular_unet(_to_port(tree), torch.from_numpy(x), tcfg)
    # encoder stage 0: 4 -> 64 (ci 4 is no multiple of 8: library), 64 -> 64;
    # decoder stage 0: 128 -> 64, 64 -> 64
    assert taps == [((1, 48, 8, 8, 64), 64, None), ((1, 48, 8, 8, 128), 64, None),
                    ((1, 48, 8, 8, 64), 64, None)]
    assert ups == [(1, 24, 4, 4, 64)]
    want = jax_mod.apply_modular_unet(tree, jnp.asarray(x), jcfg)
    agree = (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).mean()
    assert agree >= 0.99
    taps.clear(), ups.clear()
    acfg = mod.ModularUNetConfig(compute_dtype=torch.bfloat16, **{
        **kw, "pool_kernels": ((1, 1, 1), (1, 2, 2)), "conv_kernels": ((1, 3, 3), (1, 3, 3))})
    mod.apply_modular_unet(mod.init_modular_unet(acfg, 0), torch.from_numpy(x), acfg)
    assert taps == [] and ups == []


def test_config_checks_and_stage_plan():
    with pytest.raises(ValueError, match="multiples of group_norm_groups=4"):
        mod.ModularUNetConfig(norm="group", base_features=6, group_norm_groups=4)
    with pytest.raises(ValueError, match="multiples of group_norm_groups=4"):
        jax_mod.ModularUNetConfig(norm="group", base_features=6, group_norm_groups=4)
    with pytest.raises(ValueError, match="equal length"):
        mod.ModularUNetConfig(conv_kernels=((3, 3, 3),) * 5)
    with pytest.raises(ValueError, match="one entry per stage"):
        mod.ModularUNetConfig(blocks_per_stage_decoder=(2, 2))
    mod.ModularUNetConfig(norm="group", base_features=8, group_norm_groups=8)  # divides all
    assert mod.stage_features(mod.REFERENCE_3D) == jax_mod.stage_features(jax_mod.REFERENCE_3D) \
        == [32, 64, 128, 256, 512, 512]
    for name in _CASES:
        jcfg, tcfg = _cfgs(name)
        assert tcfg.decoder_blocks() == jcfg.decoder_blocks()
        assert tcfg.num_stages == jcfg.num_stages


@pytest.mark.parametrize("name", ["reference_3d", "anisotropic"])
def test_estimate_activation_bytes_equals_reference(name):
    if name == "reference_3d":
        pairs = [(mod.REFERENCE_3D, jax_mod.REFERENCE_3D, (160, 128, 128), 2)]
    else:
        jcfg, tcfg = _cfgs("anisotropic", "bf16")
        pairs = [(tcfg, jcfg, (24, 96, 96), 1), (tcfg, jcfg, (24, 96, 96), 3)]
    for tcfg, jcfg, patch, batch in pairs:
        got = mod.estimate_activation_bytes(tcfg, patch, batch)
        assert got == jax_mod.estimate_activation_bytes(jcfg, patch, batch) > 0


@pytest.mark.parametrize("name", ["instance", "anisotropic", "batch"])
def test_init_modular_unet_shapes_and_draws(name):
    """The port draws from a numpy Generator: the reference's shapes and
    dtypes, He-scaled values, the same draw for the same seed."""
    jcfg, tcfg = _cfgs(name)
    got = mod.init_modular_unet(tcfg, 0)
    want = jax_mod.init_modular_unet(jcfg, jax.random.PRNGKey(0))
    assert _shapes(got) == _shapes(want)
    again = mod.init_modular_unet(tcfg, 0)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b) and a.dtype == torch.float32
    w = got["encoder"][1][0]["w"]
    fan_in = int(np.prod(w.shape[:-1]))
    assert abs(float(w.std()) * np.sqrt(fan_in) / np.sqrt(2 / (1 + 0.01**2)) - 1) < 0.2


# ---------------------------------------------------------------------------
# nnU-Net plans
# ---------------------------------------------------------------------------


def _plans(pool, convs, patch=(128, 128, 128), base=32, stages=2):
    """An nnU-Net v1 plans dict with the keys the converter reads."""
    per_stage = {}
    for s in range(stages):
        per_stage[s] = {"pool_op_kernel_sizes": [list(k) for k in pool],
                        "conv_kernel_sizes": [list(k) for k in convs],
                        "patch_size": np.array(patch) // (2 ** (stages - 1 - s)),
                        "current_spacing": np.array([1.0, 1.0, 1.0]) * (2 ** (stages - 1 - s)),
                        "batch_size": 2 + s}
    return {"plans_per_stage": per_stage, "num_modalities": 4, "num_classes": 3,
            "base_num_features": base, "conv_per_stage": 2, "all_classes": [1, 2, 3],
            "normalization_schemes": {0: "nonCT", 1: "nonCT", 2: "nonCT", 3: "nonCT"},
            "use_mask_for_norm": {0: True, 1: True, 2: True, 3: True},
            "transpose_forward": np.array([0, 1, 2]), "transpose_backward": np.array([0, 1, 2])}


_CFG_FIELDS = ("in_channels", "num_classes", "base_features", "num_pool", "conv_per_stage",
               "norm", "encoder_scale", "patch_size", "pool_kernel", "conv_kernel",
               "dropout_rate")


@pytest.mark.parametrize("stage", [None, 0])
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_config_from_plans_equals_reference(stage, norm):
    p = _plans([(2, 2, 2)] * 5, [(3, 3, 3)] * 6)
    got_cfg, got_pre = plans.config_from_plans(p, norm=norm, stage=stage, dropout_rate=0.1)
    want_cfg, want_pre = jax_plans.config_from_plans(p, norm=norm, stage=stage, dropout_rate=0.1)
    for f in _CFG_FIELDS:
        assert getattr(got_cfg, f) == getattr(want_cfg, f), f
    assert dataclasses.asdict(got_pre) == dataclasses.asdict(want_pre)
    assert got_pre.patch_size == ((64,) * 3 if stage == 0 else (128,) * 3)
    assert got_pre.batch_size == (2 if stage == 0 else 3)


def test_config_from_plans_refuses_anisotropic_plans():
    p = _plans([(1, 2, 2), (2, 2, 2), (2, 2, 2)], [(1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)],
               patch=(24, 96, 96))
    with pytest.raises(ValueError, match="anisotropic plans") as got:
        plans.config_from_plans(p)
    with pytest.raises(ValueError, match="anisotropic plans") as want:
        jax_plans.config_from_plans(p)
    assert str(got.value) == str(want.value)


def test_plans_file_to_a_network_that_equals_the_reference(tmp_path):
    """A small plans file, pickled: ``load_nnunet_plans`` reads it back,
    ``config_from_plans`` gives a config whose ``init_params`` is the
    reference's bit for bit and whose forward equals the reference's."""
    p = _plans([(2, 2, 2)] * 2, [(3, 3, 3)] * 3, patch=(32, 32, 32), base=4, stages=1)
    path = tmp_path / "nnUNetPlansv2.1_plans_3D.pkl"
    with open(path, "wb") as f:
        pickle.dump(p, f)
    loaded = plans.load_nnunet_plans(path)
    assert pickle.dumps(loaded) == pickle.dumps(jax_plans.load_nnunet_plans(path))
    tcfg, _ = plans.config_from_plans(loaded, compute_dtype=torch.float32)
    jcfg, _ = jax_plans.config_from_plans(loaded, compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, 5))
    got = unet3d.init_params(tcfg, 5)
    flat_t, flat_j = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)
    assert len(flat_t) == len(flat_j)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(flat_t, flat_j))
    x = np.random.default_rng(6).standard_normal((1, 32, 32, 32, 4)).astype(np.float32)
    out = unet3d.apply_unet(params_from_jax(tree, tcfg), torch.from_numpy(x), tcfg)
    assert _rel(out.numpy(), jax_unet.apply_unet(tree, jnp.asarray(x), jcfg)) <= 1e-5
