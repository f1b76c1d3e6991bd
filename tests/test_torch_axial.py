"""The axial U-Net families on the port against the JAX package, on the CPU.

Axial attention (sequential and summed, with and without the converted
checkpoints' output bias, chunked and not), the AxialAttention3D block in
eval and train mode, ``AXIAL_UNET`` / ``AXIAL_UNET_FULL`` cut to
``base_features`` 4, ``num_pool`` 3 and 32^3 patches (folded, unfolded, deep
supervision, one training step), the tree functions (``fold_batchnorm``,
``params_from_jax`` / ``params_to_jax``, the npz round trip), the conversion
of both axial namespaces, the initialisation, the CLI and the refusals.  The
same numpy-seeded inputs and the reference's parameters (carried across by
``params_from_jax``) go through both packages; f32 is held to 1e-5 of each
tensor's max, bf16 by label agreement.  Every test that runs a network also
fails if an attention subtree is lost on the way: ``apply_unet`` refuses a
tree whose attention is not where the config puts it, and the tests below
check that it does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the reference trainer's dependency, imported first)
import pytest
import torch

from braintpu.ckpt import convert as jax_convert
from braintpu.infer import fullconv as jax_fullconv
from braintpu.models import axial as jax_axial
from braintpu.models import unet3d as jax_unet
from braintpu.train import trainer as jax_trainer

from braintpu_torch import cli
from braintpu_torch.ckpt import convert
from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax, params_to_jax, save_pytree_npz
from braintpu_torch.infer import fullconv
from braintpu_torch.models import axial, unet3d
from braintpu_torch.train import synthetic, trainer

from test_axial_convert import add_axial_sd
from test_unet_parity import make_torch_state_dict

SMALL = dict(base_features=4, max_features=32, num_pool=3, patch_size=(32, 32, 32))


def _cfgs(mode, dtype="f32"):
    jbase = jax_unet.AXIAL_UNET_FULL if mode == "full" else jax_unet.AXIAL_UNET
    tbase = unet3d.AXIAL_UNET_FULL if mode == "full" else unet3d.AXIAL_UNET
    return (dataclasses.replace(jbase, compute_dtype=jnp.float32 if dtype == "f32"
                                else jnp.bfloat16, **SMALL),
            dataclasses.replace(tbase, compute_dtype=torch.float32 if dtype == "f32"
                                else torch.bfloat16, **SMALL))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_tree(jcfg, seed):
    """The reference's ``init_params`` with every BatchNorm given random
    statistics, scales and shifts and every positional embedding random, so
    the forward depends on all of them, and the QKV projections halved.

    Halved because at these narrow widths the reference's He init (fan-in
    4-32 channels against 1-128 dims per head) makes the softmaxes nearly
    one-hot: there both packages' f32 networks lie 2e-4 to 1.4e-3 (of the
    max) from a float64 evaluation of the same weights, the port the closer,
    and 1e-5 between them is out of f32's reach.  Halved, they agree to
    about 1e-6."""
    rng = np.random.default_rng(seed + 100)
    tree = _np_tree(jax_unet.init_params(jcfg, seed))

    def fill(node, key=None):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, key) for v in node]
        if key in ("mean", "shift", "d", "h", "w"):
            return (rng.standard_normal(node.shape) * 0.1).astype(np.float32)
        if key in ("var", "scale"):
            return (rng.random(node.shape) + 0.5).astype(np.float32)
        if key == "qkv":
            return node * np.float32(0.5)
        return node

    return fill(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree.detach() if hasattr(tree, "detach") else tree)


def _attn_params(C, shape, heads, dim_head, bias, seed):
    """The reference's ``init_axial_params`` (jax.random) with random
    positional embeddings and, with ``bias``, a converted checkpoint's
    ``out_b``: (numpy tree, port tree)."""
    tree = _np_tree(jax_axial.init_axial_params(jax.random.PRNGKey(seed), C, shape, heads,
                                                dim_head))
    rng = np.random.default_rng(seed)
    for k in "dhw":
        tree["pos"][k] = (rng.standard_normal(tree["pos"][k].shape) * 0.3).astype(np.float32)
    if bias:
        for ax in tree["axes"]:
            ax["out_b"] = (rng.standard_normal(C) * 0.1).astype(np.float32)
    port = {"pos": {k: torch.from_numpy(np.array(v)) for k, v in tree["pos"].items()},
            "axes": [{k: torch.from_numpy(np.array(v)) for k, v in ax.items()} for ax in tree["axes"]]}
    return tree, port


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Attention and blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("summed", [False, True], ids=["sequential", "summed"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_out_b", "out_b"])
def test_axial_attention_equals_reference(summed, bias):
    """(N, D, H, W, C) with every axis a different length, 2 heads of 4.
    The input has standard deviation 0.5: at unit scale this draw puts the
    sequential composition of three attentions near a softmax tie, where
    both packages' f32 results lie 1.5e-5 and 3.4e-5 (of the max) from a
    float64 evaluation, the port the closer."""
    tree, port = _attn_params(8, (6, 5, 4), 2, 4, bias, seed=1)
    x = _x((2, 6, 5, 4, 8), 2, scale=0.5)
    got = axial.apply_axial_attention(port, torch.from_numpy(x), 4, summed)
    want = jax_axial.apply_axial_attention(tree, jnp.asarray(x), 4, summed)
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_axial_block_equals_reference(train, residual):
    """The block's output and, in training, its new BatchNorm statistics."""
    tree, port = _attn_params(8, (6, 5, 4), 2, 4, False, seed=3)
    rng = np.random.default_rng(4)
    bn = {"scale": (rng.random(8) + 0.5).astype(np.float32),
          "shift": (rng.standard_normal(8) * 0.1).astype(np.float32),
          "mean": (rng.standard_normal(8) * 0.1).astype(np.float32),
          "var": (rng.random(8) + 0.5).astype(np.float32)}
    jblock = {"attn": tree, "bn": bn}
    tblock = {"attn": port, "bn": {k: torch.from_numpy(v) for k, v in bn.items()}}
    x = _x((2, 6, 5, 4, 8), 5, scale=0.5)
    got = axial.apply_axial_block(tblock, torch.from_numpy(x), 4, 0.01, True, residual,
                                  train=train)
    want = jax_axial.apply_axial_block(jblock, jnp.asarray(x), 4, 0.01, True, residual,
                                       train=train)
    if train:
        (got, got_bn), (want, want_bn) = got, want
        for k in ("mean", "var"):
            assert _rel(got_bn[k].numpy(), want_bn[k]) <= 1e-5, k
        assert not np.allclose(got_bn["mean"].numpy(), bn["mean"])  # the statistics moved
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("summed", [False, True], ids=["sequential", "summed"])
def test_chunked_attention_equals_unchunked(monkeypatch, summed):
    """A logit budget of a few rows splits the folded batch into chunks: the
    port's chunked output is its unchunked output bit for bit, and the
    reference's chunked output to 1e-5."""
    tree, port = _attn_params(8, (8, 8, 8), 2, 4, True, seed=6)
    x = _x((2, 8, 8, 8, 8), 7, scale=0.5)
    whole = axial.apply_axial_attention(port, torch.from_numpy(x), 4, summed)
    row_bytes = 2 * 8 * 8 * 4
    monkeypatch.setattr(axial, "_MAX_LOGIT_BYTES", 16 * row_bytes)
    monkeypatch.setattr(jax_axial, "_MAX_LOGIT_BYTES", 16 * row_bytes)
    assert axial._chunk_rows(128, row_bytes) == 16
    calls = []
    real = axial._axis_attention
    monkeypatch.setattr(axial, "_axis_attention",
                        lambda xc, *a: calls.append(xc.shape[0]) or real(xc, *a))
    chunked = axial.apply_axial_attention(port, torch.from_numpy(x), 4, summed)
    assert calls == [128, 128, 128]
    assert torch.equal(chunked, whole)
    want = jax_axial.apply_axial_attention(tree, jnp.asarray(x), 4, summed)
    assert _rel(chunked.numpy(), want) <= 1e-5


@pytest.mark.parametrize("patch,num_pool,skip", [((128, 128, 128), 5, (0,)),
                                                  ((96, 128, 112), 4, (0, 2)), ((32,) * 3, 3, ())])
def test_axial_stage_shapes_equal_reference(patch, num_pool, skip):
    assert axial.axial_stage_shapes(patch, num_pool, skip) == \
        jax_axial.axial_stage_shapes(patch, num_pool, skip)


def test_chunk_rule_is_the_reference_rule():
    """All rows within the budget; else the largest power of two dividing B
    whose logits fit (1 for an odd B)."""
    budget = axial._MAX_LOGIT_BYTES
    for B, row in ((131072, 2 * 128 * 128 * 4), (32768, 4 * 64 * 64 * 4), (100, budget // 3),
                   (7, budget // 2), (1, budget * 2), (24, 1024)):
        chunk = axial._chunk_rows(B, row)
        assert B % chunk == 0 and (chunk == B or chunk * row <= budget or chunk == 1)
        if chunk != B:
            assert chunk & (chunk - 1) == 0
            assert B % (2 * chunk) or 2 * chunk * row > budget


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["decoder", "full"])
@pytest.mark.parametrize("how", ["folded", "unfolded", "deep_supervision"])
def test_axial_unet_equals_reference(mode, how):
    """The whole network at 32^3, batch 2, f32: final logits (folded: both
    packages fold BatchNorm first) or every deep-supervision head."""
    jcfg, tcfg = _cfgs(mode)
    tree = _reference_tree(jcfg, 0)
    port = params_from_jax(tree, tcfg)
    x = _x((2, 32, 32, 32, 4), 8)
    if how == "folded":
        want = jax_unet.apply_unet(jax_unet.fold_batchnorm(jax.tree_util.tree_map(
            jnp.asarray, tree), jcfg), jnp.asarray(x), jcfg, folded=True)
        got = unet3d.apply_unet(unet3d.fold_batchnorm(port, tcfg), torch.from_numpy(x), tcfg,
                                folded=True)
    elif how == "unfolded":
        want = jax_unet.apply_unet(tree, jnp.asarray(x), jcfg)
        got = unet3d.apply_unet(port, torch.from_numpy(x), tcfg)
    else:
        want, _ = jax_unet.apply_unet(tree, jnp.asarray(x), jcfg, deep_supervision=True)
        got, _ = unet3d.apply_unet(port, torch.from_numpy(x), tcfg, deep_supervision=True)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-5
        return
    assert got.shape == (2, 32, 32, 32, 3)
    assert _rel(got.numpy(), want) <= 1e-5
    # the attention is live: the same weights without it give other logits
    plain = dataclasses.replace(tcfg, axial_attention=False)
    stripped = {k: v for k, v in port.items() if k != "encoder_attn"}
    stripped["decoder"] = [{k: v for k, v in st.items() if k not in ("attn", "attn_block")}
                           for st in port["decoder"]]
    other = unet3d.apply_unet(stripped, torch.from_numpy(x), plain)
    assert _rel(other.numpy(), want) > 1e-2


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_axial_unet_bf16_labels_agree_with_reference(mode):
    """bf16 through the folded forward (the engine's).  The reference
    accumulates its bf16 convs in bf16, the port in f32 (a known delta), so
    the yardstick is the reference's own bf16 against its f32: the port's
    bf16 region labels agree with the f32 labels at least as well as the
    reference's bf16 labels do, and with the reference's bf16 labels on
    >= 0.98 of voxels; in f32 the two packages' labels are equal."""
    trees = {}
    labels = {}
    for dtype in ("bf16", "f32"):
        jcfg, tcfg = _cfgs(mode, dtype)
        tree = trees.setdefault("t", _reference_tree(jcfg, 1))
        x = _x((1, 32, 32, 32, 4), 9)
        labels["ref", dtype] = np.asarray(jax_unet.apply_unet(jax_unet.fold_batchnorm(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg), jnp.asarray(x), jcfg,
            folded=True)) > 0
        labels["port", dtype] = unet3d.apply_unet(
            unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg), torch.from_numpy(x),
            tcfg, folded=True).numpy() > 0
    agree = lambda a, b: float((labels[a] == labels[b]).mean())  # noqa: E731
    assert 0.02 < labels["ref", "f32"].mean() < 0.98  # not a trivial map
    assert agree(("port", "f32"), ("ref", "f32")) >= 0.9999
    assert agree(("port", "bf16"), ("ref", "f32")) >= agree(("ref", "bf16"), ("ref", "f32"))
    assert agree(("port", "bf16"), ("ref", "bf16")) >= 0.98


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_axial_training_forward_and_step_equal_reference(mode):
    """The training forward's heads and new statistics (the attention
    blocks' under ``encoder_attn`` / ``decoder_attn``), then one
    ``train_step``: loss, gradient norm, and every leaf (the attention
    projections, embeddings and BatchNorm statistics merged) within 1e-5 of
    its max."""
    jcfg, tcfg = _cfgs(mode)
    tree = _reference_tree(jcfg, 2)
    rng = np.random.default_rng(10)
    batch = {"image": rng.standard_normal((2, 32, 32, 32, 4)).astype(np.float32),
             "labels": rng.integers(0, 4, (2, 32, 32, 32)).astype(np.int32)}
    jheads, jstats = jax_unet.apply_unet(tree, jnp.asarray(batch["image"]), jcfg, train=True,
                                         deep_supervision=True)
    heads, stats = unet3d.apply_unet(params_from_jax(tree, tcfg),
                                     torch.from_numpy(batch["image"]), tcfg, train=True,
                                     deep_supervision=True)
    for h, jh in zip(heads, jheads):
        assert _rel(h.detach().numpy(), jh) <= 1e-5
    got, want = dict(_flat(stats)), dict(_flat(jstats))
    assert set(got) == set(want)
    assert any(k.startswith("decoder_attn") for k in want) == (mode == "full")
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k

    jtc = jax_trainer.TrainConfig(base_lr=0.01, max_steps=10)
    ttc = trainer.TrainConfig(base_lr=0.01, max_steps=10)
    js = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jtc)
    ts = trainer.create_train_state(params_from_jax(tree, tcfg), ttc, device="cpu")
    js, jm = jax_trainer.train_step(js, jax.tree_util.tree_map(jnp.asarray, batch), jcfg, jtc)
    ts, tm = trainer.train_step(ts, batch, tcfg, ttc)
    assert _rel(float(tm["loss"]), float(jm["loss"])) <= 1e-5
    assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-5
    got = dict(_flat(params_to_jax(ts.params, tcfg)))
    want = dict(_flat(_np_tree(js.params)))
    assert set(got) == set(want)
    assert any("attn" in k for k in want)
    for k in want:
        if k.endswith("/b"):
            # conv biases ahead of a BatchNorm (zero at init): a zero
            # gradient in exact arithmetic, f32 noise in both packages
            assert np.abs(got[k]).max() < 1e-6 and np.abs(want[k]).max() < 1e-6, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * float(np.abs(want[k]).max()) + 1e-8, err_msg=k)
    if mode == "full":  # the attention blocks' statistics were merged
        k = "encoder_attn/1/bn/mean"
        assert not np.allclose(got[k], tree_leaf(tree, k))


def tree_leaf(tree, path):
    for p in path.split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# Tree functions: fold, npz, refusals, initialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_fold_batchnorm_keeps_the_attention(mode):
    """Every attention subtree survives the fold unchanged, and the folded
    tree is the reference's fold leaf for leaf."""
    jcfg, tcfg = _cfgs(mode)
    tree = _reference_tree(jcfg, 3)
    got = dict(_flat(unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg)))
    want = dict(_flat(_np_tree(jax_unet.fold_batchnorm(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg))))
    assert set(got) == set(want)
    attn = [k for k in want if "attn" in k]
    assert attn and (mode != "full" or any(k.startswith("encoder_attn/") for k in attn))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_npz_round_trip_of_an_axial_full_tree_is_read_by_the_reference(tmp_path):
    """``params_to_jax`` + ``save_pytree_npz`` of an AXIAL_UNET_FULL tree
    carrying ``out_b``: the reference's ``load_pytree_npz`` reads the same
    arrays, and its forward of them equals the port's."""
    jcfg, tcfg = _cfgs("full")
    tree = _reference_tree(jcfg, 4)
    rng = np.random.default_rng(5)
    for st in tree["decoder"]:
        for ax in st.get("attn_block", {}).get("attn", {}).get("axes", []):
            ax["out_b"] = (rng.standard_normal(ax["out"].shape[1]) * 0.1).astype(np.float32)
    port = params_from_jax(tree, tcfg)
    path = tmp_path / "axial-full" / "fold_0.npz"
    save_pytree_npz(params_to_jax(port, tcfg), path)
    back = jax_convert.load_pytree_npz(path)
    a, b = dict(_flat(back)), dict(_flat(tree))
    assert set(a) == set(b) and any(k.endswith("out_b") for k in a)
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    again = dict(_flat(params_from_jax(load_pytree_npz(path), tcfg)))
    assert set(again) == set(a)
    x = _x((1, 32, 32, 32, 4), 11)
    want = jax_unet.apply_unet(back, jnp.asarray(x), jcfg)
    got = unet3d.apply_unet(port, torch.from_numpy(x), tcfg)
    assert _rel(got.numpy(), want) <= 1e-5


def _drop(tree, path):
    *head, last = path.split("/")
    node = tree
    for p in head:
        node = node[int(p)] if isinstance(node, list) else node[p]
    if isinstance(node, list):
        del node[int(last)]
    else:
        del node[last]
    return tree


@pytest.mark.parametrize("mode,path", [
    ("full", "encoder_attn"), ("full", "encoder_attn/2"), ("full", "decoder/0/attn_block"),
    ("full", "encoder_attn/1/bn"), ("full", "decoder/1/attn_block/attn/pos"),
    ("decoder", "decoder/2/attn"), ("decoder", "decoder/1/attn/axes/0/qkv")])
def test_a_dropped_attention_subtree_is_refused_everywhere(mode, path):
    """A tree that lost an attention subtree raises in ``params_from_jax``,
    ``params_to_jax`` and ``apply_unet`` (folded or not), instead of running
    as a plain U-Net."""
    jcfg, tcfg = _cfgs(mode)
    tree = _drop(_reference_tree(jcfg, 5), path)
    with pytest.raises(ValueError):
        params_from_jax(tree, tcfg)
    port = params_from_jax(_reference_tree(jcfg, 5), tcfg)
    if path.count("/") <= 2:  # a whole subtree: the forwards refuse it too
        port = _drop(port, path)
        x = torch.from_numpy(_x((1, 32, 32, 32, 4), 12))
        with pytest.raises(ValueError, match="attention|encoder_attn"):
            unet3d.apply_unet(port, x, tcfg)
        with pytest.raises(ValueError, match="attention|encoder_attn"):
            unet3d.apply_unet(unet3d.fold_batchnorm(port, tcfg), x, tcfg, folded=True)
    else:
        port = _drop(port, path)
    with pytest.raises((ValueError, KeyError)):
        params_to_jax(port, tcfg)


@pytest.mark.parametrize("where", ["top", "stage"])
def test_an_extra_subtree_is_refused(where):
    """An attention subtree where the config puts none (a plain config, or
    a stage the config skips) raises in ``params_from_jax`` and in the
    forward."""
    jcfg, tcfg = _cfgs("decoder")
    tree = _reference_tree(jcfg, 6)
    if where == "top":
        tcfg = dataclasses.replace(tcfg, axial_attention=False)
    else:
        tree["decoder"][0]["attn"] = tree["decoder"][1]["attn"]
    with pytest.raises(ValueError):
        params_from_jax(tree, tcfg)
    port = params_from_jax(_reference_tree(jcfg, 6), _cfgs("decoder")[1])
    if where == "stage":
        port["decoder"][0]["attn"] = port["decoder"][1]["attn"]
    with pytest.raises(ValueError, match="attention"):
        unet3d.apply_unet(port, torch.from_numpy(_x((1, 32, 32, 32, 4), 13)), tcfg)


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_init_conv_leaves_bit_equal_attention_from_numpy(mode):
    """``init_params(cfg, 0)``: every conv, up-conv and seg leaf (and norm
    leaf) bit-equal to the reference's; the attention leaves sit at the
    same paths with the same shapes, drawn from the port's numpy generator
    (the reference draws them from jax.random: their values differ)."""
    jcfg, tcfg = _cfgs(mode)
    got = dict(_flat(unet3d.init_params(tcfg, 0)))
    want = dict(_flat(_np_tree(jax_unet.init_params(jcfg, 0))))
    assert set(got) == set(want)
    attn = [k for k in want if "attn" in k]
    assert attn
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k in attn:
            if k.endswith(("qkv", "out")):
                assert not np.array_equal(got[k], want[k]), k  # the known delta
                assert abs(got[k].std() / want[k].std() - 1) < 0.3, k  # the same He scale
            else:
                assert np.array_equal(got[k], want[k]), k  # zeros, ones
        else:
            assert np.array_equal(got[k], want[k]), k
    again = dict(_flat(unet3d.init_params(tcfg, 0)))
    assert all(np.array_equal(again[k], got[k]) for k in got)  # deterministic


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_full_width_attention_shapes_equal_the_reference_init(mode):
    """At the configs' full widths (base 32, cap 320, five pools; the patch
    cut to 32^3, which only the positional embeddings see) the port's
    attention leaves have the reference's paths and shapes: the per-depth
    heads and dim_head and the decoder variant's cap."""
    jbase = jax_unet.AXIAL_UNET_FULL if mode == "full" else jax_unet.AXIAL_UNET
    tbase = unet3d.AXIAL_UNET_FULL if mode == "full" else unet3d.AXIAL_UNET
    small = dict(patch_size=(32, 32, 32))
    want = {k: v.shape for k, v in _flat(_np_tree(jax_unet.init_params(
        dataclasses.replace(jbase, **small), 0))) if "attn" in k}
    got = {k: tuple(v.shape) for k, v in _flat(unet3d.init_params(
        dataclasses.replace(tbase, **small), 0)) if "attn" in k}
    assert got == want and len(got) >= 4 * 8


# ---------------------------------------------------------------------------
# Conversion of both axial namespaces
# ---------------------------------------------------------------------------


def _axial_state_dict(jcfg, seed):
    """A Generic_UNet / Axial_UNet state dict in torch naming (the naming of
    ``tests/test_axial_convert.py``), attention at every level the config
    attends, with output biases and, for the full family, BatchNorms."""
    g = torch.Generator().manual_seed(seed)
    sd = dict(make_torch_state_dict(jcfg, seed=seed))
    P = jcfg.num_pool
    enc = jax_unet.encoder_features(jcfg)
    chans = jax_unet.decoder_channels(jcfg)
    if jcfg.axial_mode == "full":
        def block(prefix, C, d):
            shape = tuple(s // 2**d for s in jcfg.patch_size)
            add_axial_sd(sd, f"{prefix}.0", f"{prefix}.1", C=C, shape_dhw=shape,
                         heads=jcfg.attn_heads * 2**d, dim_head=jcfg.attn_dim_head * 2**d, g=g)
            sd[f"{prefix}.2.weight"] = torch.rand(C, generator=g) + 0.5
            sd[f"{prefix}.2.bias"] = torch.randn(C, generator=g) * 0.1
            sd[f"{prefix}.2.running_mean"] = torch.randn(C, generator=g) * 0.2
            sd[f"{prefix}.2.running_var"] = torch.rand(C, generator=g) + 0.5

        levels = [d for d in range(P) if d not in jcfg.no_attention_levels]
        for j, d in enumerate(levels):
            block(f"axial_attention_down.{j}.axial_attention", enc[d], d)
        ups = [u for u in range(P) if (P - u - 1) not in jcfg.no_attention_levels]
        for k, u in enumerate(ups):
            block(f"axial_attention_up.{k}.axial_attention", chans[u]["skip"], P - u - 1)
    else:
        ups = [u for u in range(P) if u not in jcfg.no_attention_levels]
        for j, u in enumerate(ups):
            d = P - u - 1
            add_axial_sd(sd, f"axial_embedding.{j}", f"axial_attention.{j}",
                         C=chans[u]["skip"], shape_dhw=tuple(s // 2**d for s in jcfg.patch_size),
                         heads=jcfg.attn_heads * 2**d, dim_head=jcfg.attn_dim_head * 2**d, g=g)
    return sd


@pytest.mark.parametrize("mode", ["decoder", "full"])
def test_convert_axial_state_dict_equals_reference(mode):
    """``convert_state_dict`` of both namespaces equals the reference's tree
    leaf for leaf (the as-built sequential indexing, ``out_b`` kept, the
    decoder variant's uncapped head count), and ``params_from_jax`` takes
    it.  (The networks' forwards from the same trees are held above.)"""
    jcfg, tcfg = _cfgs(mode)
    sd = _axial_state_dict(jcfg, 20)
    got = convert.convert_state_dict(sd, tcfg)
    want = jax_convert.convert_state_dict(sd, jcfg)
    a, b = dict(_flat(got)), dict(_flat(want))
    assert set(a) == set(b) and any(k.endswith("out_b") for k in b)
    assert any(k.startswith("encoder_attn/") for k in b) == (mode == "full")
    for k in b:
        assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
    port = params_from_jax(got, tcfg)  # the checkpoint's own head count passes the checks
    assert set(dict(_flat(port))) == set(b)
    # an axial config given a plain state dict misses its attention tensors
    plain = {k: v for k, v in sd.items() if not k.startswith("axial_")}
    with pytest.raises(KeyError, match="axial"):
        convert.convert_state_dict(plain, tcfg)


# ---------------------------------------------------------------------------
# Inference refusals, the engine and the CLI
# ---------------------------------------------------------------------------


def test_fullconv_refuses_the_axial_families():
    for mode in ("decoder", "full"):
        jcfg, tcfg = _cfgs(mode)
        port = params_from_jax(_reference_tree(jcfg, 7), tcfg)
        vol = torch.zeros(32, 32, 32, 4)
        with pytest.raises(ValueError, match="axial") as got:
            fullconv.fullconv_predict([port], vol, tcfg)
        with pytest.raises(ValueError, match="axial") as want:
            jax_fullconv.fullconv_predict(jax.tree_util.tree_map(lambda a: a[None],
                                                                 _reference_tree(jcfg, 7)),
                                          jnp.zeros((32, 32, 32, 4)), jcfg)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="axial"):
            fullconv.predict_probs_fullconv([port], vol.movedim(-1, 0), tcfg)


def _small_axial(monkeypatch):
    """``cli``'s axial configs cut to the test size and f32 (the
    reference's too, in both of its namespaces)."""
    import braintpu.models as jax_models

    for mod in (unet3d, jax_unet, jax_models):
        dt = torch.float32 if mod is unet3d else jnp.float32
        for name in ("AXIAL_UNET", "AXIAL_UNET_FULL"):
            monkeypatch.setattr(mod, name, dataclasses.replace(getattr(mod, name),
                                                               compute_dtype=dt, **SMALL))


@pytest.mark.parametrize("models,mode", [("axial", None), ("axial-full", None),
                                         ("model1,axial", "fullconv"),
                                         ("axial-full", "sliding")])
def test_load_engine_mode_for_axial_models_matches_reference(monkeypatch, models, mode):
    """Without ``--mode`` an axial selection runs sliding; ``--mode
    fullconv`` with an axial model exits with the reference's message."""
    from braintpu import cli as jax_cli

    _small_axial(monkeypatch)
    argv = ["segment", "--input", "x", "--output", "y", "--models", models, "--folds", "1",
            "--random-weights", "--no-tta"] + (["--mode", mode] if mode else [])
    targs = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    jargs = jax_cli.build_parser().parse_args(argv)
    if mode == "fullconv":
        with pytest.raises(SystemExit) as got:
            cli.load_engine(targs)
        with pytest.raises(SystemExit) as want:
            jax_cli.load_engine(jargs)
        assert str(got.value) == str(want.value) and "axial" in str(got.value)
        return
    engine = cli.load_engine(targs)
    assert engine.mode == jax_cli.load_engine(jargs).mode == "sliding"
    assert [m.cfg.axial_mode for m in engine.models] == \
        ["full" if models == "axial-full" else "decoder"]


def test_cli_segment_axial_writes_the_reference_labels(monkeypatch, tmp_path):
    """``cli segment --models axial-full --random-weights`` (small config,
    the reference's fold from the same npz) runs sliding and writes the
    labels the reference's engine writes for that fold."""
    from braintpu import cli as jax_cli
    from braintpu.io import nifti as jax_nifti

    _small_axial(monkeypatch)
    synthetic.write_synth_case(tmp_path / "in", "BraTS-SYN-00007-000", seed=7, shape=(40, 36, 32))
    jcfg, tcfg = _cfgs("full")
    save_pytree_npz(params_to_jax(params_from_jax(_reference_tree(jcfg, 8), tcfg), tcfg),
                    tmp_path / "ck" / "axial-full" / "fold_0.npz")
    argv = ["segment", "--input", str(tmp_path / "in"), "--models", "axial-full", "--folds", "1",
            "--no-tta", "--checkpoints", str(tmp_path / "ck")]
    assert cli.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--output", str(tmp_path / "ref")]) == 0
    name = "BraTS-SYN-00007-000.nii.gz"
    got = np.asarray(jax_nifti.load(tmp_path / "port" / name).dataobj)
    want = np.asarray(jax_nifti.load(tmp_path / "ref" / name).dataobj)
    assert got.shape == want.shape == (40, 36, 32)
    assert float((got == want).mean()) >= 0.999


@pytest.mark.parametrize("model", ["axial"])
def test_cli_train_axial(monkeypatch, tmp_path, capsys, model):
    """``cli train --model axial`` (small config) takes two steps and
    checkpoints a tree that keeps its attention."""
    from braintpu_torch.train import checkpoint

    _small_axial(monkeypatch)
    synthetic.write_synth_dataset(tmp_path / "data", 2, shape=(40, 36, 32))
    args = ["train", "--model", model, "--data", str(tmp_path / "data"), "--batch-size", "1",
            "--patch", "32,32,32", "--checkpoint-dir", str(tmp_path / "ck"), "--log-every", "1",
            "--steps", "2", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "training axial" in out and "done at step 2" in out
    assert checkpoint.latest_step(tmp_path / "ck") == 2
    saved = torch.load(tmp_path / "ck" / "2" / "train_state.pt", weights_only=False)["params"]
    for u in (1, 2):  # the decoder variant attends at every stage but the deepest
        assert any(k.startswith(f"decoder/{u}/attn/axes/") for k in saved), u
