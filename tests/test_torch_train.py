"""Training on the port against the JAX package, on the CPU at tiny sizes.

Same inputs (seeded numpy, the same synthetic cases, the reference's
``init_params`` draws) through both packages: losses, the patch sampler and
augmentation, the training forward (heads and BatchNorm statistics), three
optimizer steps, the tap kernel's gradient, resume, export, the dataset
writer and ``cli train``.  Configs are tiny (base 4, max 16, two pools, 16^3
patches) and f32, where the point is the algorithm; the tap kernel's
gradient is held in bf16 against the Pallas kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.io.brats import find_cases as jax_find_cases
from braintpu.models import unet3d as jax_unet
from braintpu.ops.conv3d_pallas import conv3d_tap_merged as jax_tap
from braintpu.train import augment as jax_augment
from braintpu.train import data as jax_data
from braintpu.train import losses as jax_losses
from braintpu.train import synthetic as jax_synth
from braintpu.train import trainer as jax_trainer

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax, params_to_jax, save_pytree_npz
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import nifti
from braintpu_torch.io.brats import find_cases
from braintpu_torch.models import unet3d
from braintpu_torch.ops import conv3d as tap
from braintpu_torch.train import augment, checkpoint, data, losses, synthetic, trainer

KW = dict(base_features=4, max_features=16, num_pool=2, group_norm_groups=2)


def _cfgs(norm, **kw):
    kw = {**KW, "norm": norm, **kw}
    return (jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw),
            unet3d.UNetConfig(compute_dtype=torch.float32, **kw))


def _tree(jcfg, seed):
    return jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))


def _batches(seed, n, shape=(2, 16, 16, 16)):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal(shape + (4,)).astype(np.float32),
             "labels": rng.integers(0, 4, shape).astype(np.int32)} for _ in range(n)]


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


# ---------------------------------------------------------------------------
# Losses (1e-6 relative: f32 reductions in another order)
# ---------------------------------------------------------------------------


def _loss_inputs():
    rng = np.random.default_rng(1)
    heads = [rng.standard_normal((2, 16 // 2**i, 16 // 2**i, 16 // 2**i, 3)).astype(np.float32) * 3
             for i in range(3)]
    labels = rng.integers(0, 4, (2, 16, 16, 16)).astype(np.int32)
    targets = np.array(jax_losses.labels_to_region_targets(jnp.asarray(labels)))
    return heads, labels, targets


@pytest.mark.parametrize("fn", ["labels_to_region_targets", "soft_dice_loss", "bce_with_logits",
                                "dice_bce_loss", "deep_supervision_weights",
                                "_downsample_targets", "deep_supervision_loss"])
def test_losses_equal_reference(fn):
    heads, labels, targets = _loss_inputs()
    t = torch.from_numpy
    if fn == "labels_to_region_targets":
        got, ref = losses.labels_to_region_targets(t(labels)), targets
    elif fn == "deep_supervision_weights":
        got = [losses.deep_supervision_weights(n) for n in (1, 2, 5)]
        ref = [jax_losses.deep_supervision_weights(n) for n in (1, 2, 5)]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
        assert float(got[2][-1]) == 0.0  # the coarsest head muted
        return
    elif fn == "_downsample_targets":
        got = losses._downsample_targets(t(targets), 4)
        ref = jax_losses._downsample_targets(jnp.asarray(targets), 4)
    elif fn == "deep_supervision_loss":
        got = losses.deep_supervision_loss([t(h) for h in heads], t(labels))
        ref = jax_losses.deep_supervision_loss([jnp.asarray(h) for h in heads], jnp.asarray(labels))
    else:
        got = getattr(losses, fn)(t(heads[0]), t(targets))
        ref = getattr(jax_losses, fn)(jnp.asarray(heads[0]), jnp.asarray(targets))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6, atol=0)


def test_poly_schedule_equals_optax():
    tc = trainer.TrainConfig(base_lr=0.01, max_steps=250)
    sched = optax.polynomial_schedule(init_value=0.01, end_value=0.0, power=0.9,
                                      transition_steps=250)
    for count in (0, 1, 7, 100, 249, 250, 300):
        assert trainer.poly_lr(tc, count) == pytest.approx(float(sched(count)), rel=1e-6)
    assert trainer.poly_lr(tc, 0) == pytest.approx(0.01)  # the first update at base_lr


# ---------------------------------------------------------------------------
# Data: the same seed gives the same batches, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    synthetic.write_synth_dataset(root, 3, seed0=7, shape=(40, 36, 32))
    return root


def test_write_synth_dataset_equals_reference(tmp_path):
    got = synthetic.write_synth_dataset(tmp_path / "port", 2, seed0=11, shape=(24, 20, 16))
    ref = jax_synth.write_synth_dataset(tmp_path / "ref", 2, seed0=11, shape=(24, 20, 16))
    assert [p.name for p in got] == [p.name for p in ref]
    for g, r in zip(got, ref):
        names = sorted(f.name for f in r.iterdir())
        assert sorted(f.name for f in g.iterdir()) == names and len(names) == 5
        for n in names:
            a, b = nifti.load(g / n), nifti.load(r / n)
            assert np.array_equal(a.get_fdata(np.float32), b.get_fdata(np.float32)), n
            assert np.array_equal(a.affine, b.affine), n


@pytest.mark.parametrize("kw", [{}, {"mixed_batches": True, "oversample_fg": 1.0},
                                {"augment": "default"}], ids=["plain", "mixed", "augment"])
def test_patch_sampler_yields_the_reference_batches(kw, synth_root):
    kw = dict(kw)
    aug = kw.pop("augment", None)
    common = dict(patch_size=(16, 24, 16), batch_size=2, seed=3, **kw)
    port = iter(data.PatchSampler(find_cases(synth_root), augment=aug and augment.AugmentConfig(),
                                  **common))
    ref = iter(jax_data.PatchSampler(jax_find_cases(synth_root),
                                     augment=aug and jax_augment.AugmentConfig(), **common))
    for _ in range(4):
        a, b = next(port), next(ref)
        for k in ("image", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_patch_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    img = rng.standard_normal((4, 16, 16, 16)).astype(np.float32)
    seg = rng.integers(0, 4, (16, 16, 16)).astype(np.int32)
    every = {f.name: 1.0 for f in dataclasses.fields(augment.AugmentConfig)
             if f.name.startswith("p_")}  # every transform, once per call
    for cfg_kw in ({}, every):
        a = augment.augment_patch(np.random.default_rng(seed), img, seg,
                                  augment.AugmentConfig(**cfg_kw))
        b = jax_augment.augment_patch(np.random.default_rng(seed), img, seg,
                                      jax_augment.AugmentConfig(**cfg_kw))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# The training forward and three steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "group", "instance"])
def test_training_forward_equals_reference(norm):
    """Heads (full resolution first) and the new BatchNorm statistics of the
    f32 training forward, within 1e-5 of each leaf's max."""
    jcfg, tcfg = _cfgs(norm)
    tree = _tree(jcfg, 3)
    x = _batches(4, 1)[0]["image"]
    (jheads, jstats) = jax_unet.apply_unet(tree, jnp.asarray(x), jcfg, train=True,
                                           deep_supervision=True)
    heads, stats = unet3d.apply_unet(params_from_jax(tree, tcfg), torch.from_numpy(x), tcfg,
                                     train=True, deep_supervision=True)
    assert [h.shape[1] for h in heads] == [16, 8]
    for h, jh in zip(heads, jheads):
        assert _rel(h.detach().numpy(), jh) <= 1e-5
    got, want = dict(_flat(stats)), dict(_flat(jstats))
    assert set(got) == set(want) and (len(got) > 0) == (norm == "batch")
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_three_train_steps_equal_reference(norm):
    """Three ``train_step``s from the same params and batches: loss and
    gradient norm within 1e-5 relative, the learning rate equal, and every
    leaf (BatchNorm statistics merged) within 1e-5 of its max plus 1e-8
    absolute (the shifts start at zero).  The conv biases ahead of a
    BatchNorm have a zero gradient in exact arithmetic (the norm removes any
    constant): in both packages they only take f32 noise, so they are held
    to staying below 1e-6 on both sides instead of to each other."""
    jcfg, tcfg = _cfgs(norm)
    tree = _tree(jcfg, 3)
    batches = _batches(5, 3)
    jtc = jax_trainer.TrainConfig(base_lr=0.01, max_steps=10)
    ttc = trainer.TrainConfig(base_lr=0.01, max_steps=10)
    js = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jtc)
    ts = trainer.create_train_state(params_from_jax(tree, tcfg), ttc, device="cpu")
    sched = optax.polynomial_schedule(0.01, 0.0, 0.9, 10)
    for i, b in enumerate(batches):
        js, jm = jax_trainer.train_step(js, jax.tree_util.tree_map(jnp.asarray, b), jcfg, jtc)
        ts, tm = trainer.train_step(ts, b, tcfg, ttc)
        assert tm["step"] == int(jm["step"]) == i + 1
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= 1e-5
        assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-5
        assert ts.opt_state.param_groups[0]["lr"] == pytest.approx(float(sched(i)), rel=1e-6)
    got = dict(_flat(params_to_jax(ts.params, tcfg)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, js.params)))
    assert set(got) == set(want)
    for k in want:
        if norm == "batch" and k.endswith("/b"):
            assert np.abs(got[k]).max() < 1e-6 and np.abs(want[k]).max() < 1e-6, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * float(np.abs(want[k]).max()) + 1e-8, err_msg=k)
    if norm == "batch":  # the statistics moved off their init
        assert not np.allclose(got["encoder/0/0/mean"], 0)


def test_tap_kernel_gradient_equals_pallas_interpret():
    """The tap autograd Function's bf16 gradients on CPU tensors against
    ``jax.grad`` of the reference's Pallas kernel in interpret mode, within
    1e-2 of max |ref| (bf16 outputs of f32 library gradients on both sides)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 4, 8, 128, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 8, 16)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    cot = rng.standard_normal((1, 4, 8, 128, 16)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)

    def loss(x_, w_, b_):
        return jnp.sum(jax_tap(x_, w_, b_, None, True).astype(jnp.float32) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jx, jw, jnp.asarray(b))
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16().requires_grad_()
    wt = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    before = tap.conv3d_tap_merged.launches
    y = tap.conv3d_tap_merged(xt, wt, bt)
    assert y.grad_fn is not None and tap.conv3d_tap_merged.launches == before
    (y.float() * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((xt.grad, wt.grad, bt.grad), ref):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert got.dtype == (torch.float32 if got is bt.grad else torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * float(np.abs(want).max()))
    with torch.no_grad():  # inference records nothing
        assert tap.conv3d_tap_merged(xt, wt, bt).grad_fn is None


@pytest.mark.parametrize("cfg_name", ["MODEL1_BN", "MODEL2_GN_LARGE"])
def test_training_dispatch_sends_the_three_level1_convs_to_the_kernel(cfg_name, monkeypatch):
    """At the default ``cli train`` patch (128^3, batch 2, bf16) exactly the
    three level-1 convs (D = 64) of each model take the tap kernel: the
    encoder's second conv and both decoder convs.  A narrow bf16 training
    forward with a band calls the differentiable kernel there and nowhere
    else."""
    cfg = getattr(unet3d, cfg_name)
    layers = unet3d.conv_layers(cfg, (128, 128, 128), 2)
    band = [i for i, (s, st, co) in enumerate(layers)
            if unet3d.choose_impl(s, (3, 3, 3), st, co, cfg.compute_dtype) == "kernel"]
    n_enc = (cfg.num_pool + 1) * cfg.conv_per_stage
    last_dec = len(layers) - 2  # the decoder's level-1 stage is the one before the last
    assert band == [3, last_dec - 2, last_dec - 1] and band[0] < n_enc
    assert all(layers[i][0][1] == 64 for i in band)
    # a narrow bf16 model whose level 0 is the band (D = 48, co = 64)
    ncfg = dataclasses.replace(cfg, base_features=64, max_features=64, num_pool=1)
    calls = []
    real = unet3d.conv3d_tap_merged

    def spy(x, w, b, slope):
        calls.append((tuple(x.shape), slope, w.requires_grad))
        return real(x, w, b, slope)

    monkeypatch.setattr(unet3d, "conv3d_tap_merged", spy)
    state = trainer.create_train_state(unet3d.init_params(ncfg, 0), trainer.TrainConfig(),
                                       device="cpu")
    b = _batches(2, 1, shape=(1, 48, 8, 8))[0]
    state, m = trainer.train_step(state, b, ncfg, trainer.TrainConfig())
    want = [s for s, st, co in unet3d.conv_layers(ncfg, (48, 8, 8), 1)
            if unet3d.choose_impl(s, (3, 3, 3), st, co, ncfg.compute_dtype) == "kernel"]
    assert [c[0] for c in calls] == want and len(want) >= 2
    assert all(slope is None and grad for _, slope, grad in calls)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_dropout_is_channelwise_before_the_norm():
    """Dropout draws one keep flag per (sample, channel) from the generator,
    scales kept channels by 1/keep and runs only in ``dropout_levels`` in
    training (semantics only: torch's bits are not JAX's)."""
    _, tcfg = _cfgs("batch", dropout_rate=0.5, dropout_levels=(1,))
    y = torch.ones(2, 4, 4, 4, 6)
    out = unet3d._dropout(y, 0.5, torch.Generator().manual_seed(0))
    per_channel = out.reshape(2, -1, 6)
    assert torch.all(per_channel == per_channel[:, :1])  # one flag per (sample, channel)
    assert set(torch.unique(out).tolist()) <= {0.0, 2.0}
    params = unet3d.init_params(tcfg, 0)
    x = torch.from_numpy(_batches(6, 1)[0]["image"])
    base = unet3d.apply_unet(params, x, tcfg, train=True)[0][0]
    assert torch.equal(base, unet3d.apply_unet(params, x, tcfg, train=True)[0][0])
    dropped = unet3d.apply_unet(params, x, tcfg, train=True,
                                generator=torch.Generator().manual_seed(1))[0][0]
    assert not torch.equal(base, dropped)
    assert torch.equal(unet3d.apply_unet(params, x, tcfg, generator=torch.Generator()),
                       unet3d.apply_unet(params, x, tcfg))  # no dropout at eval


# ---------------------------------------------------------------------------
# fit, checkpoints, export, the CLI
# ---------------------------------------------------------------------------


def test_fit_interrupted_and_resumed_equals_uninterrupted(tmp_path):
    _, tcfg = _cfgs("batch")
    tc = trainer.TrainConfig(base_lr=0.01, max_steps=8)
    batches = _batches(9, 4)
    fresh = lambda: trainer.create_train_state(unet3d.init_params(tcfg, 2), tc, device="cpu")  # noqa: E731
    whole = trainer.fit(fresh(), batches, tcfg, tc, num_steps=4)
    seen = []
    trainer.fit(fresh(), batches[:2], tcfg, tc, num_steps=4, checkpoint_dir=tmp_path / "ck",
                checkpoint_every=1, on_metrics=lambda m: seen.append(m["step"]))
    assert seen == [1, 2] and checkpoint.latest_step(tmp_path / "ck") == 2  # the batches ran out
    resumed = trainer.fit(fresh(), batches[2:], tcfg, tc, num_steps=4,
                          checkpoint_dir=tmp_path / "ck", checkpoint_every=1,
                          on_metrics=lambda m: seen.append(m["step"]))
    assert seen == [1, 2, 3, 4] and resumed.step == 4
    for (k, a), (_, b) in zip(_flat(resumed.params), _flat(whole.params)):
        assert np.array_equal(a, b), k
    mgr = checkpoint.CheckpointManager(tmp_path / "ck")
    assert mgr._steps() == [2, 3, 4]  # max_to_keep = 3
    _, other = _cfgs("batch", base_features=8)
    with pytest.raises(ValueError, match="architecture"):
        mgr.restore(trainer.create_train_state(unet3d.init_params(other, 0), tc, device="cpu"))


def test_exported_fold_segments_identically_in_both_engines(tmp_path):
    """A tiny BatchNorm fold trained two steps by the port, exported with
    ``save_pytree_npz(params_to_jax(...))``: both packages' fullconv engines
    (f32, BatchNorm folded, 8-flip TTA) give the same labels on a case."""
    jcfg, tcfg = _cfgs("batch")
    tc = trainer.TrainConfig(base_lr=0.05, max_steps=10)
    state = trainer.create_train_state(unet3d.init_params(tcfg, 4), tc, device="cpu")
    state = trainer.fit(state, _batches(10, 2), tcfg, tc, num_steps=2)
    save_pytree_npz(params_to_jax(state.params, tcfg), tmp_path / "fold_0.npz")
    tree = load_pytree_npz(tmp_path / "fold_0.npz")
    case = synthetic.write_synth_case(tmp_path / "in", "BraTS-SYN-00012-000", seed=12,
                                      shape=(40, 36, 32))
    port = InferenceEngine(models=[ModelBundle.from_folds(tcfg, [params_from_jax(tree, tcfg)])],
                           mode="fullconv", device="cpu")
    ref = JaxEngine(models=[JaxBundle.from_folds(jcfg, [tree])], mode="fullconv")
    seg_p, _ = port.predict_case(find_cases(case)[0])
    seg_r, _ = ref.predict_case(jax_find_cases(case)[0])
    assert np.array_equal(np.asarray(seg_p), np.asarray(seg_r))


def test_cli_train_writes_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """``cli train --device cpu`` (model 1's config made tiny) runs 2 steps
    and checkpoints, then resumes to 3; ``--model axial`` on the same
    checkpoint directory refuses model 1's checkpoint.  ``--dp-devices 2
    --batch-size 2`` trains over two CPU ranks and resumes (the checkpoint is
    the whole state: one process resumes it too), and ``--batch-size 1
    --dp-devices 2`` exits with the reference's message."""
    monkeypatch.setattr(unet3d, "MODEL1_BN", dataclasses.replace(unet3d.MODEL1_BN, **KW))
    synthetic.write_synth_dataset(tmp_path / "data", 2, shape=(40, 36, 32))
    args = ["train", "--data", str(tmp_path / "data"), "--batch-size", "1", "--patch",
            "16,16,16", "--checkpoint-dir", str(tmp_path / "ck"), "--log-every", "1",
            "--device", "cpu"]
    assert cli.main(args + ["--steps", "2"]) == 0
    first = capsys.readouterr().out
    assert "step       2" in first and "done at step 2" in first
    assert checkpoint.latest_step(tmp_path / "ck") == 2
    assert cli.main(args + ["--steps", "3"]) == 0
    second = capsys.readouterr().out
    assert "step       3" in second and "step       1" not in second
    assert checkpoint.latest_step(tmp_path / "ck") == 3
    with pytest.raises(ValueError, match="architecture mismatch"):
        cli.main(args + ["--model", "axial"])
    dp = args + ["--checkpoint-dir", str(tmp_path / "dp"), "--batch-size", "2",
                 "--dp-devices", "2"]
    assert cli.main(dp + ["--steps", "2"]) == 0
    assert checkpoint.latest_step(tmp_path / "dp") == 2
    assert cli.main(dp + ["--steps", "3"]) == 0
    assert checkpoint.latest_step(tmp_path / "dp") == 3
    assert cli.main(dp[:-2] + ["--steps", "4"]) == 0
    assert "step       4" in capsys.readouterr().out
    assert checkpoint.latest_step(tmp_path / "dp") == 4
    with pytest.raises(SystemExit, match=r"--batch-size 1 must be a multiple of --dp-devices 2 "
                                         r"\(per-device batch sharding\)"):
        cli.main(args + ["--dp-devices", "2"])
