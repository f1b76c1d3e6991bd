"""The reference's last public functions and arguments, held against the
JAX package on the CPU: the label constants, largest-component filtering,
the device confusion counts and ``evaluate_pair``, ``param_count`` and
``estimate_activation_bytes``, ``stack_folds``, the one-shot train-state
checkpoint helpers and ``fit(resume=)``, ``build_native(force=)``, the axial
initialisers' ``param_dtype``, and the argument order of ``pad_to_patch``
and ``preprocess_case``.  Inputs are drawn from seeds with numpy and kept
small (a whole file runs in seconds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.infer import sliding_window as jax_sw
from braintpu.labels import convert as jax_convert
from braintpu.labels import postprocess as jax_post
from braintpu.metrics import segmentation as jax_seg
from braintpu.models import axial as jax_axial
from braintpu.models import unet3d as jax_unet
from braintpu.pre import preprocess as jax_pre

from braintpu_torch import models, native
from braintpu_torch.ckpt.npz import flatten_pytree, params_to_jax
from braintpu_torch.infer.sliding_window import stack_folds
from braintpu_torch.labels import convert, postprocess
from braintpu_torch.metrics import segmentation as seg
from braintpu_torch.models import axial, unet3d
from braintpu_torch.pre import preprocess
from braintpu_torch.train import checkpoint, trainer

SMALL = dict(base_features=4, max_features=32, num_pool=3, patch_size=(32, 32, 32))
TINY = dict(base_features=2, max_features=8, num_pool=2, patch_size=(16, 16, 16))
BRATS_REGIONS = (((1, 2, 3), (1, 3), (3,)), ((1,), (2,), (3,), (4,)), ((0,), (1, 4), (2,)))


def _labels(seed, shape=(20, 24, 16), top=4):
    return np.random.default_rng(seed).integers(0, top + 1, size=shape).astype(np.uint8)


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------


def test_internal_label_constants_equal_the_reference():
    got = (convert.INTERNAL_ED, convert.INTERNAL_NCR, convert.INTERNAL_ET)
    assert got == (jax_convert.INTERNAL_ED, jax_convert.INTERNAL_NCR, jax_convert.INTERNAL_ET)
    from braintpu_torch import labels
    assert labels.INTERNAL_ET == jax_convert.INTERNAL_ET


def _masks():
    rng = np.random.default_rng(11)
    shape = (12, 14, 10)
    single = np.zeros(shape, bool)
    single[3:7, 4:9, 2:5] = True
    tie = np.zeros(shape, bool)
    tie[1:3, 1:3, 1:3] = True
    tie[8:10, 8:10, 6:8] = True  # two components of 8 voxels: the first label wins
    diagonal = np.zeros(shape, bool)
    diagonal[2, 2, 2] = diagonal[3, 3, 3] = diagonal[6, 6, 6] = True
    return {"empty": np.zeros(shape, bool), "single": single, "tie": tie,
            "diagonal": diagonal,
            **{f"random_{p}": rng.random(shape) < p for p in (0.05, 0.3, 0.6)}}


@pytest.mark.parametrize("conn26", [True, False], ids=["26", "6"])
@pytest.mark.parametrize("name", list(_masks()))
def test_keep_largest_component_equals_the_reference(name, conn26):
    mask = _masks()[name]
    got, n = postprocess.keep_largest_component(mask, conn26)
    want, n_ref = jax_post.keep_largest_component(mask, connectivity_26=conn26)
    assert n == n_ref
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert np.array_equal(postprocess.STRUCT_26, jax_post.STRUCT_26)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regions", BRATS_REGIONS, ids=["compound", "labels", "mixed"])
def test_confusion_counts_equal_the_reference(regions):
    pred, gt = _labels(1), _labels(2)
    want = np.asarray(jax_seg.confusion_counts(jnp.asarray(pred), jnp.asarray(gt), regions))
    # the reference sums in f32: exact here (7,680 voxels, far below 2^24)
    want = want.astype(np.int64)
    got = seg.confusion_counts(torch.from_numpy(pred), torch.from_numpy(gt), regions)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    host = seg.confusion_counts(pred, gt.astype(np.int32), regions, device="cpu")
    assert np.array_equal(host.numpy(), want)
    assert np.array_equal(seg._region_counts_np(pred, gt, regions), want)


def test_confusion_counts_sends_host_arrays_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seg.confusion_counts(_labels(1), _labels(2), ((1,),))
    with pytest.raises(ValueError, match="voxels"):
        seg.confusion_counts(torch.zeros(3), torch.zeros(4), ((1,),))


@pytest.mark.parametrize("label", [1, 2, 3, 4])
def test_evaluate_pair_equals_the_reference_field_by_field(label):
    pred, gt = _labels(3), _labels(4)
    got = seg.evaluate_pair(pred, gt, label, device="cpu")
    want = jax_seg.evaluate_pair(pred, gt, label)
    for f in ("tp", "fp", "fn", "tn"):
        assert getattr(got, f) == getattr(want, f), f
    # the ratios: float64 of the exact counts (the reference's own host
    # arithmetic, metrics_from_counts over integers); the reference's
    # evaluate_pair takes them from f32 counts, so it agrees to f32 rounding
    exact = jax_seg.metrics_from_counts(want.tp, want.fp, want.fn, want.tn)
    assert got.as_dict() == exact.as_dict()
    for f in ("dice", "iou", "sensitivity", "specificity"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6, abs=1e-7), f


def test_evaluate_segmentation_counts_tensors_on_their_device():
    pred, gt = _labels(5, top=3), _labels(6, top=3)
    host = seg.evaluate_segmentation(pred, gt)
    assert seg.evaluate_segmentation(torch.from_numpy(pred), gt) == host
    assert seg.evaluate_segmentation(pred, torch.from_numpy(gt)) == host
    assert host == jax_seg.evaluate_segmentation(pred, gt)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


_EXPORTED = ["MODEL1_BN", "MODEL2_GN_LARGE", "AXIAL_UNET", "AXIAL_UNET_FULL"]


@pytest.mark.parametrize("name", _EXPORTED)
def test_param_count_equals_the_reference_at_full_width(name, monkeypatch):
    """Full-width trees, counted and never run; the random draws are
    replaced by zeros of the same shapes (the count reads shapes only)."""
    monkeypatch.setattr(unet3d, "_he_init", lambda rng, shape, slope: torch.zeros(shape))
    monkeypatch.setattr(axial, "_he", lambda rng, shape, dtype: torch.zeros(shape))
    cfg = getattr(models, name)
    tree = unet3d.init_params(cfg, 0)
    want = jax_unet.param_count(params_to_jax(tree, cfg))
    assert models.param_count(tree) == want
    assert unet3d.param_count(params_to_jax(tree, cfg)) == want  # numpy leaves too


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("variant", ["as_exported", "f32", "anisotropic_pool"])
@pytest.mark.parametrize("name", _EXPORTED)
def test_estimate_activation_bytes_equals_the_reference(name, variant, batch):
    tcfg, jcfg = getattr(unet3d, name), getattr(jax_unet, name)
    if variant == "f32":
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    elif variant == "anisotropic_pool":
        tcfg = dataclasses.replace(tcfg, pool_kernel=(1, 2, 2))
        jcfg = dataclasses.replace(jcfg, pool_kernel=(1, 2, 2))
    want = jax_unet.estimate_activation_bytes(jcfg, batch)
    assert models.estimate_activation_bytes(tcfg, batch) == want > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_axial_initialisers_take_param_dtype(dtype):
    """Keys, shapes, dtypes and the constant leaves are the reference's.  The
    He-normal leaves come from the port's numpy generator (the reference
    draws its own JAX keys): drawn at ``param_dtype`` and scaled into f32, as
    the reference's f64 scale promotes them."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    args = (16, (4, 6, 8), 2, 8)
    got = axial.init_axial_block(np.random.default_rng(0), *args, bn=True, param_dtype=tdt)
    want = jax_axial.init_axial_block(jax.random.PRNGKey(0), *args, bn=True, param_dtype=jdt)
    f32 = axial.init_axial_block(np.random.default_rng(0), *args, bn=True)
    g, w, f = (dict(_flat(t)) for t in (got, want, f32))
    assert set(g) == set(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert str(g[k].dtype) == f"torch.{w[k].dtype}", k
        if k.endswith(("qkv", "out")):
            assert g[k].dtype == torch.float32, k
            err = (g[k] - f[k]).abs().max().item()
            assert err <= (0.0 if dtype == "f32" else 2**-8 * f[k].abs().max().item()), k
            fan_in = g[k].shape[0]
            assert g[k].std().item() == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.15)
        else:
            assert g[k].dtype == tdt, k
            assert np.array_equal(g[k].float().numpy(), np.asarray(w[k], np.float32)), k
    bare = axial.init_axial_params(np.random.default_rng(0), *args, param_dtype=tdt)
    assert {k: t.dtype for k, t in _flat(bare)} == {
        k: t.dtype for k, t in _flat(got["attn"])}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_apply_unet_positional_call_binds_as_the_reference():
    """``apply_unet(params, x, cfg, train, deep_supervision, rng, folded)``:
    the port's ``generator`` sits in the reference's ``rng`` slot, so a
    positional ``folded`` reaches ``folded``."""
    cfg = dataclasses.replace(unet3d.MODEL1_BN, **TINY)
    params = unet3d.fold_batchnorm(unet3d.init_params(cfg, 3), cfg)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 16, 16, 16, 4))
                         .astype(np.float32))
    want = unet3d.apply_unet(params, x, cfg, folded=True)
    assert torch.equal(unet3d.apply_unet(params, x, cfg, False, False, None, True), want)


# ---------------------------------------------------------------------------
# stack_folds
# ---------------------------------------------------------------------------


def test_stack_folds_equals_the_reference():
    cfg = dataclasses.replace(unet3d.MODEL2_GN_LARGE, **SMALL)
    folds = [unet3d.init_params(cfg, s) for s in (0, 1, 2)]
    host = [params_to_jax(f, cfg) for f in folds]
    want = flatten_pytree(jax_sw.stack_folds(host))
    stacked_np = stack_folds(host)
    stacked_t = stack_folds(folds)
    got_np, got_t = flatten_pytree(stacked_np), flatten_pytree(stacked_t)
    assert set(got_np) == set(got_t) == set(want)
    for k in want:
        assert got_np[k].shape[0] == 3
        assert np.array_equal(got_np[k], want[k]) and np.array_equal(got_t[k], want[k]), k
    assert all(isinstance(v, np.ndarray) for _, v in _flat(stacked_np))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for _, v in _flat(stacked_t))
    # a host leaf beside a tensor goes where the tensor is
    mixed = stack_folds([{"w": np.ones(2, np.float32)}, {"w": torch.zeros(2)}])
    assert torch.equal(mixed["w"], torch.tensor([[1.0, 1.0], [0.0, 0.0]]))


# ---------------------------------------------------------------------------
# train-state checkpoints and fit(resume=)
# ---------------------------------------------------------------------------


def _state(seed=0):
    cfg = dataclasses.replace(unet3d.MODEL1_BN, **TINY)
    tc = trainer.TrainConfig(max_steps=8)
    return cfg, tc, trainer.create_train_state(unet3d.init_params(cfg, seed), tc, device="cpu")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32),
             "labels": rng.integers(0, 4, (1, 16, 16, 16)).astype(np.int64)}
            for _ in range(n)]


def test_save_and_restore_train_state_round_trip_bit_equal(tmp_path):
    cfg, tc, state = _state(0)
    state, _ = trainer.train_step(state, _batches(1)[0], cfg, tc)  # momentum buffers exist
    assert checkpoint.save_train_state(tmp_path, state, max_to_keep=2) == 1
    want = {k: v.detach().clone() for k, v in _flat(state.params)}
    want_opt = [s["momentum_buffer"].clone() for s in state.opt_state.state.values()]
    _, _, other = _state(1)
    assert checkpoint.restore_train_state(tmp_path / "missing", other) is None
    restored = checkpoint.restore_train_state(tmp_path, other)
    assert restored is other and restored.step == 1
    got = dict(_flat(restored.params))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    got_opt = [s["momentum_buffer"] for s in restored.opt_state.state.values()]
    assert len(got_opt) == len(want_opt)
    assert all(torch.equal(a, b) for a, b in zip(got_opt, want_opt))
    assert checkpoint.latest_step(tmp_path) == 1


def test_fit_resume_false_runs_every_step_resume_true_the_rest(tmp_path):
    cfg, tc, state = _state(0)
    trainer.fit(state, _batches(2), cfg, tc, num_steps=2, checkpoint_dir=tmp_path)
    assert checkpoint.latest_step(tmp_path) == 2

    def run(resume):
        steps = []
        _, _, fresh = _state(0)
        out = trainer.fit(fresh, _batches(3, seed=1), cfg, tc, num_steps=3,
                          checkpoint_dir=tmp_path, resume=resume,
                          on_metrics=lambda m: steps.append(int(m["step"])))
        return steps, out.step

    assert run(True) == ([3], 3)  # restored at step 2: the remaining step
    assert run(False) == ([1, 2, 3], 3)  # the checkpoint is not read


# ---------------------------------------------------------------------------
# build_native(force=)
# ---------------------------------------------------------------------------


def test_build_native_force_rebuilds_an_existing_library(tmp_path, monkeypatch):
    calls = []

    def fake_compiler(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"rebuilt")
        return type("Proc", (), {"returncode": 0, "stderr": "", "stdout": ""})()

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: "/usr/bin/g++")
    monkeypatch.setattr(native.subprocess, "run", fake_compiler)
    lib = native.library_path()
    assert lib.parent == tmp_path
    lib.write_bytes(b"old")
    assert native.build_native() == lib and calls == [] and lib.read_bytes() == b"old"
    assert native.build_native(force=True) == lib
    assert len(calls) == 1 and lib.read_bytes() == b"rebuilt"
    assert native.build_native(False) == lib and len(calls) == 1


# ---------------------------------------------------------------------------
# the argument order of pad_to_patch and preprocess_case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_to_patch_positional_call_equals_the_reference(mode):
    data = np.random.default_rng(7).standard_normal((2, 11, 7, 9)).astype(np.float32)
    got, undo = preprocess.pad_to_patch(data, (8, 12, 8), mode, 4)
    want, undo_ref = jax_pre.pad_to_patch(data, (8, 12, 8), mode, 4)
    assert got.shape == (2, 12, 12, 12)
    assert np.array_equal(got, np.asarray(want)) and undo == undo_ref
    assert np.array_equal(got[(slice(None),) + undo], data)


def test_preprocess_case_positional_call_equals_the_reference():
    rng = np.random.default_rng(8)
    data = np.zeros((4, 14, 12, 10), np.float32)
    data[:, 2:12, 3:10, 1:9] = rng.integers(1, 300, (4, 10, 7, 8))
    affine = np.diag([-1.0, 1.0, 1.0, 1.0])
    zooms = (1.0, 1.0, 1.2)
    got = preprocess.preprocess_case(data, (8, 8, 8), affine, zooms, 16, "cpu")
    want = jax_pre.preprocess_case(data, (8, 8, 8), affine, zooms, 16)
    assert tuple(got.data.shape) == (4, 16, 16, 16) == tuple(want.data.shape)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-6, atol=1e-6)
    assert got.undo_slices == want.undo_slices
    assert dataclasses.astuple(got.crop) == dataclasses.astuple(want.crop)
    assert got.affine is affine and got.zooms == zooms == want.zooms
    bare = preprocess.preprocess_case(data, (8, 8, 8), device="cpu")
    assert bare.affine is None and bare.zooms is None


# ---------------------------------------------------------------------------
# the trained2 probe (card work; its refusal and its launch formula here)
# ---------------------------------------------------------------------------


def test_trained2_probe_refuses_without_fold_0(tmp_path):
    from braintpu_torch.tools import probe

    with pytest.raises(SystemExit, match="model2/fold_0.npz is absent"):
        probe.main(["trained2", "--checkpoints", str(tmp_path)])


def test_trained2_launch_formula_at_seed_200s_bucket():
    from braintpu_torch.tools import probe

    bucket = (192, 192, 128)
    assert probe._kernel_layers(unet3d.MODEL1_BN, bucket) == {"conv3d_tap_merged": 3,
                                                              "upconv2x": 5}
    assert probe._kernel_layers(unet3d.MODEL2_GN_LARGE, bucket) == {"conv_stage": 15,
                                                                    "upconv2x": 5}
