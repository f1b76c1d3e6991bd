"""Repairs of the port against the JAX package, each pinned on the CPU.

* unfolded BatchNorm params raise under ``folded=True`` instead of running
  with the norm dropped; ``folded=False`` runs the norms (eval BatchNorm with
  the running statistics) and matches the reference's unfolded forward, as
  does the folded forward;
* stored f32 conv kernels are used at the compute dtype (they used to reach
  the bf16 kernel as f32 and raise, or convolve unrounded on the CPU);
* the seg head rounds its input and weights to the compute dtype;
* a model named twice in ``--models`` draws the reference's random folds;
* C6: ``preprocess_case`` runs on the card unless asked for the CPU, and
  raises where there is no card (it used to default to the CPU);
* C8: ``check-env`` counts ``.npz`` and ``.model`` checkpoints and fails its
  required checkpoint check without either, and requires the knowledge
  base's 7 documents, with the reference's exit codes;
* C9: ``fullconv_predict`` takes a (B, X, Y, Z, C) batch and returns each
  case's probabilities, as the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu import cli as jax_cli
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.infer.fullconv import fullconv_predict as jax_fullconv
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
    """Unfolded BatchNorm params with ``folded=True`` would run with the norm
    dropped: they raise (the folded forward and both fullconv entry points)."""
    _, tcfg = _narrow("f32")
    params = unet3d.init_params(tcfg, 0)
    x = torch.zeros(1, 16, 16, 16, 4)
    with pytest.raises(ValueError, match="running statistics"):
        unet3d.apply_unet(params, x, tcfg, folded=True)
    with pytest.raises(ValueError, match="running statistics"):
        fullconv_predict([params], x[0], tcfg, num_mirror=1, folded=True)
    with pytest.raises(ValueError, match="running statistics"):
        predict_probs_fullconv([params], x[0].movedim(-1, 0), tcfg, tta=False, folded=True)


def test_unfolded_batchnorm_forward_matches_reference_f32():
    """``folded=False`` (the reference's default) keeps eval BatchNorm in the
    forward; the forward, ``fullconv_predict`` and an unfolded bundle
    (``fold_bn=False``) equal the reference's at f32."""
    jcfg, tcfg = _narrow("f32")
    tree = _bn_tree(jcfg, 7)
    x = np.random.default_rng(7).standard_normal((1, 32, 24, 16, 4)).astype(np.float32)
    ref = np.asarray(jax_unet.apply_unet(tree, jnp.asarray(x), jcfg, folded=False))
    params = params_from_jax(tree, tcfg)
    got = unet3d.apply_unet(params, torch.from_numpy(x), tcfg).numpy()
    tol = 1e-5 * float(np.abs(ref).max())  # f32 throughout: summation order only
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=tol)
    probs = fullconv_predict([params], torch.from_numpy(x[0]), tcfg, num_mirror=8).numpy()
    jbundle = JaxBundle.from_folds(jcfg, [tree], fold_bn=False)
    jprobs = np.asarray(jax_fullconv(jbundle.params_stacked, jnp.asarray(x[0]), jcfg,
                                     num_mirror=8, folded=False))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)  # probabilities in [0, 1]
    bundle = ModelBundle.from_folds(tcfg, [params], fold_bn=False)
    assert not bundle.folded and bundle.fold_params[0]["encoder"][0][0]["mean"].dtype == torch.float32
    got_b = fullconv_predict(bundle.fold_params, torch.from_numpy(x[0]), tcfg, num_mirror=8,
                             folded=bundle.folded).numpy()
    np.testing.assert_allclose(got_b, jprobs, rtol=0, atol=1e-5)


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


def _card_present(monkeypatch):
    """The port's card checks as they read on a machine with the card, so
    that the checks this file compares decide the exit code."""
    from braintpu_torch.ops import _build
    from braintpu_torch.utils import envcheck

    monkeypatch.setattr(envcheck, "_torch_checks", lambda: [
        envcheck._check("torch with CUDA", True, "stubbed"),
        envcheck._check("CUDA device (sm_90)", True, "stubbed")])
    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")


@pytest.mark.parametrize("holds", ["nothing", "npz", "model", "six_kb_documents"])
def test_check_env_checkpoints_and_kb_exit_like_the_reference(holds, tmp_path, monkeypatch,
                                                              capsys):
    """C8: the checkpoint check counts ``.npz`` and ``.model`` files and is
    required; the knowledge base needs 7 documents.  Exit codes equal the
    reference's for each directory."""
    from braintpu import rag as jax_rag
    from braintpu_torch import rag as port_rag

    _card_present(monkeypatch)
    ck = tmp_path / "ck"
    (ck / "model1").mkdir(parents=True)
    if holds == "npz":
        np.savez(ck / "model1" / "fold_0.npz", w=np.zeros(1))
    elif holds in ("model", "six_kb_documents"):
        torch.save({"state_dict": {}}, ck / "model1" / "model_final_checkpoint.model")
    if holds == "six_kb_documents":
        for pkg in (jax_rag, port_rag):
            docs = pkg.builtin_knowledge_base()[:6]
            monkeypatch.setattr(pkg, "builtin_knowledge_base", lambda docs=docs: docs)
    ref_rc = jax_cli.cmd_check_env(jax_cli.build_parser().parse_args(
        ["check-env", "--checkpoints", str(ck)]))
    ref_out = capsys.readouterr().out
    port_rc = cli.cmd_check_env(cli.build_parser().parse_args(
        ["check-env", "--checkpoints", str(ck)]))
    port_out = capsys.readouterr().out
    assert ref_rc == {"nothing": 1, "npz": 0, "model": 0, "six_kb_documents": 1}[holds], ref_out
    assert port_rc == ref_rc, port_out
    ckpt_line = next(ln for ln in port_out.splitlines() if "model checkpoints" in ln)
    assert ("[FAIL]" in ckpt_line) == (holds == "nothing"), ckpt_line


def test_fullconv_takes_a_batch_like_the_reference():
    """C9: a (B, X, Y, Z, C) batch gives each case's probabilities: equal to
    the per-case calls (to 1e-6: the library conv sums in another order at
    another batch size), and to the reference's batched call at f32."""
    jcfg, tcfg = _narrow("f32", norm="group", group_norm_groups=2, base_features=4,
                         max_features=16, num_pool=2)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, 9))
    params = params_from_jax(tree, tcfg)
    vols = np.random.default_rng(9).standard_normal((2, 8, 12, 8, 4)).astype(np.float32)
    got = fullconv_predict([params], torch.from_numpy(vols), tcfg, num_mirror=8).numpy()
    assert got.shape == (2, 8, 12, 8, 3)
    for i in range(2):
        one = fullconv_predict([params], torch.from_numpy(vols[i]), tcfg, num_mirror=8).numpy()
        np.testing.assert_allclose(got[i], one, rtol=0, atol=1e-6)
    jbundle = JaxBundle.from_folds(jcfg, [tree])
    ref = np.asarray(jax_fullconv(jbundle.params_stacked, jnp.asarray(vols), jcfg, num_mirror=8))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)  # probabilities, f32 sums
