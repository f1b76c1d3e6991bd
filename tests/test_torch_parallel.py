"""The port's parallelism (``braintpu_torch.parallel``, the sharded fullconv
paths, the engine's mesh, ``train`` / ``segment --dp-devices``) held against
the reference's and against the port's own unsharded paths, on the CPU.

The reference runs on the conftest's virtual CPU devices; the port runs on
``gloo`` ranks that ``parallel.launch.spawn`` starts.  One set of ranks per
module fixture runs every scenario (``parallel.scenarios``); each scenario
stays its own test.  Inputs are seeded numpy arrays; the parameters are
``init_params`` seeds, bit-equal in both packages.

Tolerances:

* port vs reference (f32 configs): rtol 1e-4 with atol 1e-4 * max|ref|, as
  the port's forward parity tests;
* port sharded vs port unsharded: atol 2e-5 for the spatial, mirror and fold
  paths, 2e-4 for the patch runner, loss rtol 1e-4 for the data-parallel
  step on a BatchNorm net (the reference's own tests' bounds);
* bf16 (the kernels' dtype, their plain versions on the CPU): spatial vs
  unsharded probabilities within 1e-2 (a few bf16 steps through the
  sigmoid) and labels equal on at least 0.99 of the voxels (a slab's convs
  run at other shapes and round some outputs the other way; random weights
  leave many voxels within 1e-2 of 0.5), the floor the card's check uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from braintpu.infer import engine as jax_engine
from braintpu.infer import fullconv as jax_fullconv
from braintpu.infer.sliding_window import stack_folds as jax_stack
from braintpu.models import unet3d as jax_unet
from braintpu import parallel as jax_parallel
from braintpu.train import trainer as jax_trainer

from braintpu_torch import cli
from braintpu_torch.infer import fullconv
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import nifti
from braintpu_torch.io.brats import find_cases
from braintpu_torch.models import unet3d
from braintpu_torch import parallel
from braintpu_torch.parallel import collectives
from braintpu_torch.parallel.launch import spawn
from braintpu_torch.parallel.mesh import Mesh
from braintpu_torch.parallel.scenarios import run
from braintpu_torch.train import checkpoint, synthetic


def _cfgs(dtype="f32", **kw):
    return (jax_unet.UNetConfig(compute_dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16,
                                **kw),
            unet3d.UNetConfig(compute_dtype=torch.float32 if dtype == "f32" else torch.bfloat16,
                              **kw))


TINY = dict(base_features=4, max_features=16, num_pool=2, patch_size=(16, 16, 16))
INST = dict(in_channels=2, base_features=4, max_features=16, num_pool=2, patch_size=(8, 8, 8),
            norm="instance")
GN8 = dict(base_features=8, max_features=16, num_pool=2, norm="group", group_norm_groups=4,
           patch_size=(8, 8, 8))
WIDE = dict(base_features=32, max_features=64, num_pool=2, patch_size=(16, 16, 16))
#: level 1 of a 96-plane X is the tap kernel's band (48 planes, 64 channels)
BAND = dict(base_features=64, max_features=64, num_pool=2, patch_size=(16, 16, 16))


def _jtree(jcfg, seed):
    return jax.tree_util.tree_map(jnp.asarray, jax_unet.init_params(jcfg, seed))


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jnp_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _close_to_ref(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def _rng(seed):
    return np.random.default_rng(seed)


VOL = _rng(0).normal(size=(16, 16, 16, 4)).astype(np.float32)
VOL_BAND = _rng(1).normal(size=(96, 16, 16, 4)).astype(np.float32)
XF = _rng(9).normal(size=(2, 8, 8, 8, 2)).astype(np.float32)
BATCHES = [{"image": _rng(s).normal(size=(4, 16, 16, 16, 4)).astype(np.float32),
            "labels": _rng(s + 10).integers(0, 4, (4, 16, 16, 16)).astype(np.int32)}
           for s in (3, 4)]
TP_BATCHES = [{"image": b["image"][:2], "labels": b["labels"][:2]} for b in BATCHES]
PATCH_VOLS = [_rng(20 + i).normal(size=(4, 24, 16, 16)).astype(np.float32) for i in range(3)]
ENGINE_DATA = np.zeros((4, 30, 24, 20), np.float32)
ENGINE_DATA[:, 2:21, 3:21, 2:18] = _rng(5).normal(500, 60, (4, 19, 18, 16))  # X 20: off the grid


def _write_cases(root, n=3):
    for i in range(n):
        cid = f"BraTS-GLI-0900{i}-000"
        d = root / cid
        d.mkdir(parents=True)
        rng = _rng(100 + i)
        shape = (24, 24, 20) if i < 2 else (24, 20, 20)
        for mod in ("t1", "t1ce", "t2", "flair"):
            v = np.abs(rng.normal(300, 60, shape)).astype(np.float32)
            nifti.save(v, d / f"{cid}_{mod}.nii.gz", affine=np.eye(4))
    return root


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every two-rank scenario, in one set of gloo ranks."""
    root = _write_cases(tmp_path_factory.mktemp("cases"))
    out = tmp_path_factory.mktemp("out")
    c = {k: _cfgs(**kw)[1] for k, kw in (("inst", INST), ("gn", GN8), ("tiny", TINY))}
    c["bn"] = _cfgs(norm="batch", **TINY)[1]
    c["gn_bf16"] = _cfgs("bf16", **GN8)[1]
    c["bn_bf16"] = _cfgs("bf16", norm="batch", **BAND)[1]
    c["mirror"] = _cfgs(norm="instance", base_features=8, num_pool=2, patch_size=(8, 8, 8))[1]
    specs = [
        ("fold", "fold", dict(cfg=c["inst"], seeds=range(5), x=XF, pad_to=8)),
        ("mirror", "mirror", dict(cfg=c["mirror"], seeds=[0, 1], vol=VOL)),
        ("spatial_bn", "spatial", dict(cfg=c["bn"], seeds=[0, 1], vol=VOL, num_mirror=8,
                                       fold_bn=True)),
        ("spatial_gn", "spatial", dict(cfg=c["gn"], seeds=[0, 1], vol=VOL, num_mirror=8)),
        ("spatial_gn_bf16", "spatial", dict(cfg=c["gn_bf16"], seeds=[0, 1], vol=VOL,
                                            num_mirror=1)),
        ("spatial_bn_bf16", "spatial", dict(cfg=c["bn_bf16"], seeds=[0], vol=VOL_BAND,
                                            num_mirror=1, fold_bn=True)),
        ("engine_spatial", "engine_spatial", dict(cfg=c["bn"], seeds=[0, 1], data=ENGINE_DATA)),
        ("batched", "batched", dict(cfg=c["bn"], seeds=[0], root=str(root), out=str(out))),
        ("dp", "train", dict(cfg=c["bn"], seed=1, batches=BATCHES, data=2, model=1)),
        ("patch", "patch_runner", dict(cfg=c["tiny"], seeds=[0], vols=PATCH_VOLS,
                                       batch_size=4)),
    ]
    ranks = spawn(run, 2, args=(specs,), timeout_s=600, threads=1)
    return {"rank0": ranks[0], "rank1": ranks[1], "root": root, "out": out}


@pytest.fixture(scope="module")
def four():
    """The four-rank scenarios: the fold ensemble on 4 and the 2 x 2 DP x TP step."""
    inst = _cfgs(**INST)[1]
    wide = _cfgs(norm="batch", **WIDE)[1]
    specs = [("fold", "fold", dict(cfg=inst, seeds=range(5), x=XF, pad_to=8)),
             ("tp", "train", dict(cfg=wide, seed=0, batches=TP_BATCHES, data=2, model=2))]
    return spawn(run, 4, args=(specs,), timeout_s=600, threads=1)


# ---------------------------------------------------------------------------
# Mesh and layouts (no ranks needed)
# ---------------------------------------------------------------------------


def _fake_mesh(data, model=1):
    comm = collectives.Comm(None, 1, 0, "none")
    return Mesh(data, model, 0, torch.device("cpu"), "none", {"data": comm, "model": comm})


def test_parallel_exports_the_reference_names():
    assert sorted(parallel.__all__) == sorted(jax_parallel.__all__)
    assert len(parallel.__all__) == 10


def test_make_mesh_defaults_and_error_as_the_reference():
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0 and mesh.is_main
    with pytest.raises(ValueError, match="only 1 rank"):
        parallel.make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError) as ours:
        parallel.make_mesh(["cpu"], data=2)
    with pytest.raises(ValueError) as theirs:
        jax_parallel.make_mesh(jax.devices()[:1], data=2)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("axial", [None, "decoder", "full"])
def test_param_shardings_mirror_the_tree_and_the_reference(axial):
    kw = dict(WIDE, norm="batch")
    if axial:
        kw.update(axial_attention=True, axial_mode=axial, attn_heads=1, attn_dim_head=4)
    jcfg, tcfg = _cfgs(**kw)
    jsh = jax_parallel.param_shardings(jax_unet.init_params(jcfg, 0), jcfg,
                                       jax_parallel.make_mesh(data=4, model=2))
    params = unet3d.init_params(tcfg, 0)
    sh = parallel.param_shardings(params, tcfg, _fake_mesh(4, 2))
    want = {k: tuple(v.spec) for k, v in _leaves(jsh)}
    got = {k: v.spec for k, v in _leaves(sh)}
    assert set(got) == {k for k, _ in _leaves(params)} == set(want)
    assert got == want
    assert any(s and s[-1] == "model" for s in got.values())
    flat = parallel.param_shardings(params, tcfg, _fake_mesh(8, 1))
    assert all(v.spec == () for _, v in _leaves(flat))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_layout_rules_as_the_reference():
    m = _fake_mesh(2, 2)
    jm = jax_parallel.make_mesh(data=2, model=2)
    assert parallel.replicated(m).spec == tuple(jax_parallel.replicated(jm).spec)
    assert parallel.batch_sharding(m, 5).spec == tuple(jax_parallel.batch_sharding(jm, 5).spec)
    assert (parallel.spatial_sharding(m, 5, 2).spec
            == tuple(jax_parallel.spatial_sharding(jm, 5, 2).spec))


def test_pad_folds_tiles_and_zero_weights_as_the_reference():
    folds = [{"w": torch.full((3,), float(i))} for i in range(5)]
    padded, w = parallel.pad_folds_for_axis(folds, 5, 16)
    jpadded, jw = jax_parallel.pad_folds_for_axis({"w": jnp.arange(5.0)[:, None] * jnp.ones(3)},
                                                  5, 16)
    assert len(padded) == 16 and w.dtype == torch.float32
    np.testing.assert_array_equal([float(p["w"][0]) for p in padded], np.asarray(jpadded["w"])[:, 0])
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert float(w.sum()) == pytest.approx(1.0) and not w[5:].any()


def test_spatial_alignment_guard_as_the_reference():
    jcfg, tcfg = _cfgs(norm="batch", **TINY)
    bad = np.zeros((24, 16, 16, 4), np.float32)  # a multiple of 4, not of 4 shards x 4
    with pytest.raises(ValueError) as ours:
        fullconv.fullconv_predict_spatial([unet3d.init_params(tcfg, 0)], torch.from_numpy(bad),
                                          tcfg, _fake_mesh(4))
    with pytest.raises(ValueError) as theirs:
        jax_fullconv.fullconv_predict_spatial(jax_stack([_jtree(jcfg, 0)]), jnp.asarray(bad),
                                              jcfg, jax_parallel.make_mesh(jax.devices()[:4],
                                                                           data=4))
    assert str(ours.value) == str(theirs.value)
    assert "pad the bucket to 32" in str(ours.value)
    with pytest.raises(ValueError, match="must divide the 8 mirrors"):
        fullconv.fullconv_predict_sharded([], torch.from_numpy(bad), tcfg, _fake_mesh(3))


def test_engine_takes_mesh_and_spatial_shard_and_batching_refuses_it():
    cfg = unet3d.UNetConfig(compute_dtype=torch.float32, **TINY)
    bundle = ModelBundle.from_folds(cfg, [unet3d.init_params(cfg, 0)])
    mesh = _fake_mesh(1)
    eng = InferenceEngine(models=[bundle], mode="fullconv", mesh=mesh, spatial_shard=True)
    assert eng.device == torch.device("cpu") and eng.spatial_shard
    jeng = jax_engine.InferenceEngine(models=[], mode="fullconv", spatial_shard=True)
    with pytest.raises(ValueError) as ours:
        eng.predict_cases_batched([])
    with pytest.raises(ValueError) as theirs:
        jeng.predict_cases_batched([])
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mesh's rank runs on"):
        InferenceEngine(models=[bundle], mesh=mesh, device="meta")


def test_stage_statistics_window_sums_only_its_planes():
    """``conv_stage`` over a window of output planes (``out_planes``, the
    X-sharded forward's own planes): the plain version returns exactly those
    planes of the whole conv's output and sums exactly them, the default is
    every plane, and a window off the volume raises before any dispatch."""
    import torch.nn.functional as F

    from braintpu_torch.ops.stage import conv_stage

    rng = _rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 8, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 8, 16)).astype(np.float32) / 15).bfloat16()
    b = torch.zeros(16)
    y32 = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2), b,
                   padding=1).permute(0, 2, 3, 4, 1)
    y, s1, s2 = conv_stage(x, w, b, stats=True)
    ya, a1, a2 = conv_stage(x, w, b, stats=True, out_planes=(0, 6))
    yw, w1, w2 = conv_stage(x, w, b, stats=True, out_planes=(1, 5))
    assert torch.equal(ya, y) and torch.equal(a1, s1) and torch.equal(a2, s2)
    assert torch.equal(s1, y32.sum(dim=(1, 2, 3)))
    win = y32[:, 1:5]
    assert yw.shape == (2, 4, 8, 8, 16) and yw.is_contiguous() and torch.equal(yw, y[:, 1:5])
    assert torch.equal(w1, win.sum(dim=(1, 2, 3))) and torch.equal(w2, (win * win).sum((1, 2, 3)))
    for bad in ((0, 7), (3, 3), (-1, 2)):
        with pytest.raises(ValueError, match="out_planes"):
            conv_stage(x, w, b, stats=True, out_planes=bad)


# ---------------------------------------------------------------------------
# Sharded paths on gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 4])
def test_fold_parallel_forward_on_5_folds_padded_to_8(ranks, two, four):
    r = (two["rank0"] if ranks == 2 else four[0])["fold"]
    assert r["padded"] == 8 and r["weights"][5:].sum() == 0
    np.testing.assert_allclose(r["sharded"], r["serial"], atol=2e-5)
    jcfg, _ = _cfgs(**INST)
    stacked = jax_stack([_jtree(jcfg, s) for s in range(5)])
    padded, w = jax_parallel.pad_folds_for_axis(stacked, 5, 8)
    mesh = jax_parallel.make_mesh(jax.devices()[:ranks], data=ranks)
    ref = jax_parallel.make_fold_parallel_forward(jcfg, mesh, num_folds=5)(padded, w, XF)
    _close_to_ref(r["sharded"], ref)


def test_mirror_sharded_fullconv_on_2_ranks(two):
    r = two["rank0"]["mirror"]
    assert r["route"] == "gloo-cpu-allreduce" and r["traffic"]["probs"]["calls"] == 1
    np.testing.assert_allclose(r["sharded"], r["plain"], atol=2e-5)
    jcfg, _ = _cfgs(norm="instance", base_features=8, num_pool=2, patch_size=(8, 8, 8))
    stacked = jax_stack([_jtree(jcfg, s) for s in (0, 1)])
    ref = jax_fullconv.fullconv_predict_sharded(stacked, jnp.asarray(VOL), jcfg,
                                                jax_parallel.make_mesh(jax.devices()[:2],
                                                                       data=2))
    _close_to_ref(r["sharded"], ref)


@pytest.mark.parametrize("which", ["spatial_bn", "spatial_gn"])
def test_spatial_fullconv_f32_on_2_ranks(which, two):
    """BatchNorm folded (halos only) and GroupNorm deferred (halos and
    statistics summed over the slabs), 8 mirrors, against the port's
    unsharded fullconv and the reference's spatial fullconv."""
    r = two["rank0"][which]
    np.testing.assert_allclose(r["sharded"], r["plain"], atol=2e-5)
    assert r["traffic"]["halo"]["calls"] > 0
    assert ("stats" in r["traffic"]) == (which == "spatial_gn")
    kw = dict(TINY, norm="batch") if which == "spatial_bn" else GN8
    jcfg, tcfg = _cfgs(**kw)
    trees = [_jtree(jcfg, s) for s in (0, 1)]
    folded = which == "spatial_bn"
    if folded:  # the port's f32 fold, handed to the reference
        trees = [_jnp_tree(unet3d.fold_batchnorm(unet3d.init_params(tcfg, s), tcfg))
                 for s in (0, 1)]
    ref = jax_fullconv.fullconv_predict_spatial(
        jax_stack(trees), jnp.asarray(VOL), jcfg,
        jax_parallel.make_mesh(jax.devices()[:2], data=2), num_mirror=8, folded=folded)
    _close_to_ref(r["sharded"], ref)


@pytest.mark.parametrize("which", ["spatial_gn_bf16", "spatial_bn_bf16"])
def test_spatial_fullconv_bf16_on_2_ranks(which, two):
    """bf16 (the kernels' dtype, their plain versions here) against the
    unsharded forward: GroupNorm through the deferred path's ``conv_stage``
    route with halo-extended inputs, the statistics' window and the summed
    statistics; folded BatchNorm with level 1 in the tap kernel's band (the
    dispatch reads the global 48 planes, each slab holds 24)."""
    r = two["rank0"][which]
    assert ("stats" in r["traffic"]) == (which == "spatial_gn_bf16")
    if which == "spatial_bn_bf16":  # the whole volume's level 1 is in the band, a slab's not
        impl = lambda D: unet3d.choose_impl((1, D, 8, 8, 64), (3, 3, 3), (1, 1, 1), 64,
                                            torch.bfloat16)
        assert impl(48) == "kernel" and impl(26) == "library"
    np.testing.assert_allclose(r["sharded"], r["plain"], atol=1e-2)
    agree = (fullconv.region_probs_to_labels(torch.from_numpy(r["sharded"]))
             == fullconv.region_probs_to_labels(torch.from_numpy(r["plain"]))).float().mean()
    assert float(agree) >= 0.99


def test_engine_spatial_path_pads_x_off_the_grid(two):
    r = two["rank0"]["engine_spatial"]
    assert r["X"] % (2 * 4) and r["target"] > r["X"]  # the padding path ran
    np.testing.assert_allclose(r["sharded"], r["plain"], atol=2e-5)
    assert r["seg"].shape == ENGINE_DATA.shape[1:] and set(np.unique(r["seg"])) <= {0, 1, 2, 3}
    np.testing.assert_array_equal(two["rank1"]["engine_spatial"]["seg"], r["seg"])


def test_batched_engine_on_a_2_rank_mesh(two):
    """Each rank forwards its rows of every padded batch; the labels equal the
    per-case calls and the reference's batched engine; rank 0 wrote the files."""
    r0, r1 = two["rank0"]["batched"], two["rank1"]["batched"]
    assert r0["target"] == 2 and len(r0["segs"]) == 3
    for seg, seg1, per_case in zip(r0["segs"], r1["segs"], r0["per_case"]):
        np.testing.assert_array_equal(seg, per_case)
        np.testing.assert_array_equal(seg1, seg)
    assert all("output_path" in i for i in r0["infos"])
    assert not any("output_path" in i for i in r1["infos"])
    for cid, seg in zip(r0["case_ids"], r0["segs"]):
        np.testing.assert_array_equal(np.asarray(nifti.load(two["out"] / f"{cid}.nii.gz").dataobj),
                                      seg)
    jcfg, _ = _cfgs(norm="batch", **TINY)
    jeng = jax_engine.InferenceEngine(
        models=[jax_engine.ModelBundle.from_folds(jcfg, [_jtree(jcfg, 0)])], mode="fullconv",
        tta=False, et_min_voxels=0, mesh=jax_parallel.make_mesh(jax.devices()[:2], data=2))
    from braintpu.io.brats import find_cases as jax_find_cases

    ref = jeng.predict_cases_batched(jax_find_cases(str(two["root"])), batch_size=2)
    for (jseg, _), seg in zip(ref, r0["segs"]):
        assert float((np.asarray(jseg) == seg).mean()) >= 0.999


def _params_close(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k in want:
        if k.endswith("/b") and np.abs(want[k]).max() < 1e-6:
            continue  # biases ahead of a BatchNorm: f32 noise only
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * float(np.abs(want[k]).max()) + 1e-8, err_msg=k)


def test_dp_step_on_a_batchnorm_net_equals_the_single_process_step(two):
    """Two steps, the global batch of 4 split over 2 ranks: the BatchNorm
    statistics are the global batch's, so loss, gradient norm and every leaf
    (running statistics included) match one process on the whole batch."""
    r = two["rank0"]["dp"]
    assert r["mesh"] == {"data": 2, "model": 1}
    for got, want in zip(r["sharded"], r["single"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        assert got["step"] == want["step"]
    _params_close(r["params"], r["single_params"])
    assert two["rank1"]["dp"]["sharded"] == r["sharded"]
    assert r["traffic"]["grad"]["calls"] == 2 and r["traffic"]["stats"]["calls"] > 0


def test_dp_tp_step_on_a_2x2_mesh(four):
    """Two steps on data 2 x model 2: the 64-channel blocks column-parallel.
    Held to the single-process step and to the reference's sharded step."""
    r = four[0]["tp"]
    assert r["mesh"] == {"data": 2, "model": 2}
    assert r["traffic"]["gather"]["calls"] > 0 and r["traffic"]["input_grad"]["calls"] > 0
    for got, want in zip(r["sharded"], r["single"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    _params_close(r["params"], r["single_params"])
    for other in four[1:]:
        assert other["tp"]["sharded"] == r["sharded"]
    jcfg, _ = _cfgs(norm="batch", **WIDE)
    jtc = jax_trainer.TrainConfig(base_lr=1e-3, max_steps=100)
    mesh = jax_parallel.make_mesh(jax.devices()[:4], data=2, model=2)
    st, sh = jax_parallel.shard_train_state(
        jax_trainer.create_train_state(_jtree(jcfg, 0), jtc), jcfg, mesh)
    step = jax_parallel.make_sharded_train_step(mesh, jcfg, jtc, sh)
    for got, b in zip(r["sharded"], TP_BATCHES):
        st, m = step(st, jax.tree_util.tree_map(jnp.asarray, b))
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-4)


def test_patch_runner_on_2_ranks(two):
    r = two["rank0"]["patch"]
    assert len(r["sharded"]) == 3 and r["sharded"][0].shape == (24, 16, 16, 3)
    for got, plain in zip(r["sharded"], r["plain"]):
        np.testing.assert_allclose(got, plain, atol=2e-4)
    jcfg, _ = _cfgs(**TINY)
    runner = jax_parallel.DataParallelPatchRunner(
        jax_stack([_jtree(jcfg, 0)]), jcfg, jax_parallel.make_mesh(jax.devices()[:2], data=2),
        batch_size=4)
    for got, ref in zip(r["sharded"], runner.run(PATCH_VOLS)):
        _close_to_ref(got, ref)


def test_spawn_reports_a_failing_rank_with_its_traceback():
    bad = [("x", "train", dict(cfg=None, seed=0, batches=[], data=3, model=1))]
    with pytest.raises(RuntimeError, match=r"rank \d of 2 \(gloo\) raised:(.|\n)*mesh 3x1"):
        spawn(run, 2, args=(bad,), timeout_s=120, threads=1)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_segment_dp_devices_checks_as_the_reference(tmp_path):
    synthetic.write_synth_case(tmp_path / "in", "BraTS-SYN-00001-000", seed=1,
                               shape=(40, 36, 32))
    base = ["segment", "--input", str(tmp_path / "in"), "--output", str(tmp_path / "out"),
            "--models", "model1", "--folds", "1", "--random-weights", "--device", "cpu"]
    with pytest.raises(SystemExit, match=r"--spatial-shard requires --dp-devices N \(N > 1\)"):
        cli.main(base + ["--spatial-shard"])
    with pytest.raises(SystemExit, match="--spatial-shard requires --mode fullconv"):
        cli.main(base + ["--spatial-shard", "--dp-devices", "2", "--mode", "sliding"])
    with pytest.raises(SystemExit, match="--dp-devices 2 but only 0 device"):
        cli.main(base[:-2] + ["--dp-devices", "2"])
    # a refusal inside the ranks exits the command with its message
    with pytest.raises(SystemExit, match="checkpoint for model1/fold_0 not found"):
        cli.main([a for a in base if a != "--random-weights"] + ["--dp-devices", "2"])


def test_cli_segment_batched_over_2_cpu_ranks(tmp_path, capsys):
    """``segment --device cpu --dp-devices 2 --batch-cases 2`` (full-width
    model 1 in bf16, one random fold, no TTA, two small cases): each rank
    forwards one case of the batch and rank 0 writes each case's labels.
    They agree with the single-process per-case run's (the same one-case
    forwards) on at least 0.995 of the voxels: the CPU's f32 convolution
    sums in an order that depends on its thread count, and bf16 rounding
    turns that into label flips at random weights' many near-0.5 voxels
    (the ranks' exact equality is held in f32 by
    ``test_batched_engine_on_a_2_rank_mesh``)."""
    for i, seed in enumerate((1, 2)):
        synthetic.write_synth_case(tmp_path / "in", f"BraTS-SYN-0000{i}-000", seed=seed,
                                   shape=(40, 36, 32))
    base = ["segment", "--input", str(tmp_path / "in"), "--models", "model1", "--folds", "1",
            "--random-weights", "--no-tta", "--device", "cpu", "--batch-cases", "2"]
    assert cli.main(base + ["--output", str(tmp_path / "dp"), "--dp-devices", "2"]) == 0
    assert cli.main(base[:-1] + ["0", "--output", str(tmp_path / "one")]) == 0
    for c in find_cases(tmp_path / "in"):
        got = np.asarray(nifti.load(tmp_path / "dp" / f"{c.case_id}.nii.gz").dataobj)
        want = np.asarray(nifti.load(tmp_path / "one" / f"{c.case_id}.nii.gz").dataobj)
        assert got.shape == want.shape and float((got == want).mean()) >= 0.995
    assert sorted(p.name for p in (tmp_path / "dp").iterdir()) == sorted(
        f"{c.case_id}.nii.gz" for c in find_cases(tmp_path / "in"))
    assert "2 ranks on cpu, cpu" in capsys.readouterr().out


def test_segment_rank_body_and_sharded_diffs_on_2_cpu_ranks(tmp_path):
    """What the card's smoke runs at full width (phases 14c and 14f), here
    with full-width model 1 in bf16, one random fold, no TTA, one small case
    on 2 CPU ranks: the ``segment`` scenario runs ``segment
    --spatial-shard`` through the CLI's rank body; only rank 0 writes, and
    its labels agree with the unsharded engine's on at least 0.99 of the
    voxels (the bf16 X-sharded floor above).  ``two_model_case``'s
    ``diffs`` hold the X-sharded probabilities within 1e-2 of the unsharded
    (the bf16 bound above), and ``run(..., launch_keys=True)`` returns the
    launch keys (none here: the CPU runs the plain versions)."""
    cid = "BraTS-SYN-00003-000"
    synthetic.write_synth_case(tmp_path / "in", cid, seed=3, shape=(40, 36, 32))
    argv = ["--input", str(tmp_path / "in"), "--models", "model1", "--folds", "1",
            "--random-weights", "--no-tta", "--device", "cpu"]
    specs = [("seg", "segment", dict(argv=argv + ["--spatial-shard"], out=str(tmp_path / "o"))),
             ("two", "two_model_case", dict(argv=argv + ["--output", str(tmp_path / "t")],
                                            case_dir=str(tmp_path / "in"),
                                            paths=("plain", "spatial"), return_probs=False,
                                            diffs=(("spatial", "plain"),)))]
    r0, r1 = spawn(run, 2, args=(specs, True), timeout_s=600, threads=1)
    assert r0["seg"]["written"] == [f"{cid}.nii.gz"] and r1["seg"]["written"] == []
    assert r0["seg"]["label_agreement"][cid] >= 0.99
    assert r0["seg"]["launches"] == {"conv3d_tap_merged": 0, "conv_stage": 0, "upconv2x": 0}
    assert "halo" in r0["seg"]["traffic"]
    for r in (r0, r1):
        assert r["two"]["max_abs"]["spatial vs plain"][0] <= 1e-2
        assert r["launch_keys"] == {}
