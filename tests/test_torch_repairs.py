"""Repairs of the port against the JAX package, each pinned on the CPU.

* unfolded BatchNorm params raise instead of running with the norm dropped,
  and the folded forward matches the reference's unfolded one;
* stored f32 conv kernels are used at the compute dtype (they used to reach
  the bf16 kernel as f32 and raise, or convolve unrounded on the CPU);
* the seg head rounds its input and weights to the compute dtype;
* a model named twice in ``--models`` draws the reference's random folds;
* C6: ``preprocess_case`` runs on the card unless asked for the CPU, and
  raises where there is no card (it used to default to the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.models import unet3d as jax_unet

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.infer.engine import ModelBundle
from braintpu_torch.infer.fullconv import fullconv_predict, predict_probs_fullconv
from braintpu_torch.models import unet3d


def _narrow(dtype_name, **kw):
    kw = {"base_features": 8, "max_features": 32, "num_pool": 3, **kw}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    return jax_unet.UNetConfig(compute_dtype=jdt, **kw), unet3d.UNetConfig(compute_dtype=tdt, **kw)


def _bn_tree(jcfg, seed):
    """The reference's init with random BatchNorm statistics (numpy leaves)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))

    def perturb(block):
        co = block["b"].shape[0]
        block["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        block["mean"] = (rng.standard_normal(co) * 0.5).astype(np.float32)
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
    return tree


def test_unfolded_batchnorm_params_raise():
    _, tcfg = _narrow("f32")
    params = unet3d.init_params(tcfg, 0)
    x = torch.zeros(1, 16, 16, 16, 4)
    with pytest.raises(NotImplementedError, match="not ported"):
        unet3d.apply_unet(params, x, tcfg)  # the reference's default: folded=False
    with pytest.raises(ValueError, match="running statistics"):
        unet3d.apply_unet(params, x, tcfg, folded=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        fullconv_predict([params], x[0], tcfg, num_mirror=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        predict_probs_fullconv([params], x[0].movedim(-1, 0), tcfg, tta=False)


def test_folded_forward_matches_reference_unfolded_f32():
    jcfg, tcfg = _narrow("f32")
    tree = _bn_tree(jcfg, 5)
    x = np.random.default_rng(5).standard_normal((1, 32, 24, 16, 4)).astype(np.float32)
    ref = np.asarray(jax_unet.apply_unet(tree, jnp.asarray(x), jcfg, folded=False))
    params = unet3d.fold_batchnorm(params_from_jax(tree, tcfg), tcfg)
    got = unet3d.apply_unet(params, torch.from_numpy(x), tcfg, folded=True).numpy()
    # f32 throughout (the parity tests' bound): folding and summation order differ
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_f32_folded_weights_run_through_the_band_and_match_the_bundle():
    # base 64 and one pool: the first encoder conv and the decoder's conv at
    # D = 48 with co = 64 are band layers (48 <= D < 96, co >= 64)
    _, tcfg = _narrow("bf16", base_features=64, max_features=64, num_pool=1)
    folded = unet3d.fold_batchnorm(unet3d.init_params(tcfg, 3), tcfg)
    assert folded["encoder"][0][0]["w"].dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 48, 8, 8, 4))
                         .astype(np.float32))
    band = [s for s, st, co in unet3d.conv_layers(tcfg, (48, 8, 8))
            if unet3d.choose_impl(s, (3, 3, 3), st, co, tcfg.compute_dtype) == "kernel"]
    assert len(band) >= 2
    got = unet3d.apply_unet(folded, x, tcfg, folded=True)
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 3)])
    assert bundle.fold_params[0]["encoder"][0][0]["w"].dtype == torch.bfloat16
    want = unet3d.apply_unet(bundle.fold_params[0], x, tcfg, folded=True)
    # the same bf16 kernels and f32 biases reach the same ops: equal bits
    assert torch.equal(got, want)


def test_seg_head_rounds_to_the_compute_dtype_like_the_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 6, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 1, 16, 3)).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        ref = np.asarray(jax_unet._seg_head(jnp.asarray(x), {"w": jnp.asarray(w)}, jdt))
        got = unet3d._seg_head(torch.from_numpy(x), torch.from_numpy(w), tdt).numpy()
        # products of rounded operands are exact in f32; the sums differ in order
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def test_repeated_model_name_draws_the_reference_folds(tmp_path, capsys):
    args = cli.build_parser().parse_args(
        ["segment", "--input", "x", "--output", "y", "--models", "model1,model1", "--folds", "1",
         "--random-weights", "--device", "cpu"])
    eng = cli.load_engine(args)
    out = capsys.readouterr().out
    assert out.count("random ['0 (seed 0)']") == 2, out
    # the reference seeds a random fold with selected.index(name) * 1000 + f
    jtree = jax_unet.init_params(jax_unet.MODEL1_BN, 0)
    want = ModelBundle.from_folds(
        unet3d.MODEL1_BN, [params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                                           unet3d.MODEL1_BN)])
    for m in eng.models:
        for got_stage, want_stage in zip(m.fold_params[0]["encoder"],
                                         want.fold_params[0]["encoder"]):
            for g, w in zip(got_stage, want_stage):
                assert torch.equal(g["w"], w["w"]) and torch.equal(g["b"], w["b"])


def test_preprocess_case_defaults_to_the_card(monkeypatch):
    from braintpu.pre.preprocess import preprocess_case as jax_preprocess_case
    from braintpu_torch.pre.preprocess import preprocess_case

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(6).standard_normal((4, 12, 10, 9)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_case(data, patch_size=(8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_case(data, patch_size=(8, 8, 8), device="cuda")
    got = preprocess_case(data, patch_size=(8, 8, 8), device="cpu")
    assert got.data.device.type == "cpu"
    ref = jax_preprocess_case(data, patch_size=(8, 8, 8))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data), rtol=1e-6, atol=1e-6)
