"""Multi-case batching on the port against the JAX package, on the CPU.

``InferenceEngine.predict_cases_batched`` over three small synthetic cases
at batch 2 (two buckets, so one padded batch): the port's per-case labels,
the reference's batched labels, the padding, ``max_pending``,
``keep_volumes`` / ``output_dir``, ``warmup(batch_size=2)``, ``cli segment
--batch-cases 2`` (the same files as the per-case run) and the refusals.
Narrow f32 configs (a BatchNorm and a GroupNorm model, 2 pool levels), 2
folds each, mirror TTA on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.io.brats import find_cases as jax_find_cases
from braintpu.models import unet3d as jax_unet

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import params_from_jax, params_to_jax, save_pytree_npz
from braintpu_torch.infer import engine as engine_mod
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import nifti
from braintpu_torch.io.brats import find_cases
from braintpu_torch.models import unet3d
from braintpu_torch.train.synthetic import write_synth_case

_NARROW = dict(base_features=4, max_features=16, num_pool=2)
#: three cases, the first two in one fullconv bucket (36x32x28), the third
#: in another (32x32x28)
_CASES = (("BraTS-SYN-00050-000", 50, (40, 36, 32)), ("BraTS-SYN-00047-000", 47, (40, 36, 32)),
          ("BraTS-SYN-00045-000", 45, (40, 36, 32)))


def _cfgs(norm):
    kw = {**_NARROW, "norm": norm, "group_norm_groups": 2}
    return (jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw),
            unet3d.UNetConfig(compute_dtype=torch.float32, **kw))


def _tree(jcfg, seed):
    """The reference's init with random norm statistics and louder seg heads
    (so the labels have foreground to agree on)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, seed))
    blocks = [b for st in tree["encoder"] for b in st] + list(tree["bottleneck"])
    blocks += [b for st in tree["decoder"] for b in st["blocks"]]
    for blk in blocks:
        co = blk["b"].shape[0]
        blk["b"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        blk["shift"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
        if "mean" in blk:
            blk["mean"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
            blk["var"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
    for st in tree["decoder"]:
        st["seg"]["w"] = st["seg"]["w"] * np.float32(8.0)
    return tree


def _trees():
    return {norm: [_tree(_cfgs(norm)[0], 80 + 2 * i + f) for f in (0, 1)]
            for i, norm in enumerate(("batch", "group"))}


def _engines(trees, **kw):
    jmodels, tmodels = [], []
    for norm, folds in trees.items():
        jcfg, tcfg = _cfgs(norm)
        jmodels.append(JaxBundle.from_folds(jcfg, folds))
        tmodels.append(ModelBundle.from_folds(tcfg, [params_from_jax(t, tcfg) for t in folds]))
    return (JaxEngine(models=jmodels, mode="fullconv", **kw),
            InferenceEngine(models=tmodels, mode="fullconv", device="cpu", **kw))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("batched")
    for case_id, seed, shape in _CASES:
        write_synth_case(root / "in", case_id, seed=seed, shape=shape)
    return root / "in"


@pytest.fixture(scope="module")
def engines():
    return _engines(_trees())


@pytest.fixture(scope="module")
def per_case(engines, cases):
    """The port's per-case labels of the three cases."""
    _, teng = engines
    return {c.case_id: teng.predict_case(c)[0] for c in find_cases(cases)}


def test_batched_equals_per_case_and_the_reference_batched(engines, cases, per_case):
    jeng, teng = engines
    got = teng.predict_cases_batched(find_cases(cases), batch_size=2)
    want = jeng.predict_cases_batched(jax_find_cases(cases), batch_size=2)
    # results in the order of the cases (find_cases sorts them): seed 45 alone
    # in its bucket, seeds 47 and 50 together
    assert [i["case_id"] for _, i in got] == [i["case_id"] for _, i in want] == \
        sorted(c[0] for c in _CASES)
    assert [i["batch_size"] for _, i in got] == [i["batch_size"] for _, i in want] == [1, 2, 2]
    for (seg, info), (ref, rinfo) in zip(got, want):
        assert (ref > 0).mean() > 0.01, "degenerate: no foreground to compare"
        assert np.array_equal(seg, per_case[info["case_id"]]), info["case_id"]
        assert float((seg == ref).mean()) >= 0.999, info["case_id"]
        for k, v in rinfo["volumes_cm3"].items():
            assert abs(info["volumes_cm3"][k] - v) <= 0.001 * max(v, 1.0), k
        assert info["batch_seconds"] > 0 and info["ensemble_host_s"] >= 0


def test_every_batch_is_padded_to_one_shape(engines, cases, monkeypatch):
    """Each batch runs at ``batch_size`` rows (the lone third case with a
    copy of itself), whichever the order of the buckets; ``max_pending``
    flushes the fullest bucket early."""
    _, teng = engines
    rows = []
    real = engine_mod.fullconv_predict

    def spy(params, vols, cfg, **kw):
        rows.append((vols.shape[0], tuple(vols.shape[1:4])))
        return real(params, vols, cfg, **kw)

    monkeypatch.setattr(engine_mod, "fullconv_predict", spy)
    teng.predict_cases_batched(find_cases(cases), batch_size=2)
    assert [r[0] for r in rows] == [2] * 4  # two batches x two models
    assert len({r[1] for r in rows}) == 2  # two buckets
    rows.clear()
    # cap at 1 pending case: every case runs as soon as it arrives, padded
    out = teng.predict_cases_batched(find_cases(cases), batch_size=2, max_pending=1)
    assert [r[0] for r in rows] == [2] * 6 and [i["batch_size"] for _, i in out] == [1, 1, 1]


def test_output_dir_and_keep_volumes(engines, cases, per_case, tmp_path):
    _, teng = engines
    out = teng.predict_cases_batched(find_cases(cases), output_dir=tmp_path, batch_size=2)
    assert all(seg is None for seg, _ in out)
    for _, info in out:
        saved = np.asarray(nifti.load(info["output_path"]).dataobj)
        assert np.array_equal(saved, per_case[info["case_id"]])
    kept = teng.predict_cases_batched(find_cases(cases)[:2], output_dir=tmp_path / "k",
                                      batch_size=2, keep_volumes=True)
    assert all(np.array_equal(seg, per_case[i["case_id"]]) for seg, i in kept)


def test_warmup_runs_the_batch_shape(engines, monkeypatch):
    """``warmup(batch_size=2)`` runs each model once at batch 2 on the
    bucket, and no per-case path; without it, one dummy case."""
    _, teng = engines
    seen = []
    real = engine_mod.fullconv_predict
    monkeypatch.setattr(engine_mod, "fullconv_predict",
                        lambda p, v, c, **kw: seen.append(tuple(v.shape)) or real(p, v, c, **kw))
    calls = []
    monkeypatch.setattr(teng, "predict_case_array", lambda d: calls.append(d.shape))
    assert teng.warmup((32, 32, 32), batch_size=2) > 0
    assert seen == [(2, 32, 32, 32, 4)] * 2 and calls == []
    teng.warmup((32, 32, 32))
    assert calls == [(4, 32, 32, 32)]


def test_batched_refuses_sliding_mode(cases):
    _, tcfg = _cfgs("batch")
    bundle = ModelBundle.from_folds(tcfg, [unet3d.init_params(tcfg, 0)])
    eng = InferenceEngine(models=[bundle], mode="sliding", device="cpu")
    with pytest.raises(ValueError, match="requires mode='fullconv'"):
        eng.predict_cases_batched(find_cases(cases))
    jcfg, _ = _cfgs("batch")
    jeng = JaxEngine(models=[JaxBundle.from_folds(jcfg, [_tree(jcfg, 0)])], mode="sliding")
    with pytest.raises(ValueError, match="requires mode='fullconv'"):
        jeng.predict_cases_batched(jax_find_cases(cases))


def test_cli_segment_batch_cases_writes_the_per_case_files(cases, tmp_path, monkeypatch):
    """``segment --batch-cases 2 --warmup`` (the narrow configs in place of
    model 1 and model 2, their folds from npz) writes the files the per-case
    run writes; ``--batch-cases`` in sliding mode exits."""
    trees = _trees()
    for name, norm in (("model1", "batch"), ("model2", "group")):
        jcfg, tcfg = _cfgs(norm)
        monkeypatch.setattr(unet3d, "MODEL1_BN" if name == "model1" else "MODEL2_GN_LARGE", tcfg)
        for f, t in enumerate(trees[norm]):
            save_pytree_npz(params_to_jax(params_from_jax(t, tcfg), tcfg),
                            tmp_path / "ck" / name / f"fold_{f}.npz")
    real_warmup, warmed = engine_mod.InferenceEngine.warmup, []
    monkeypatch.setattr(engine_mod.InferenceEngine, "warmup",  # a small bucket on the CPU
                        lambda self, bucket_shape=None, batch_size=0: warmed.append(batch_size)
                        or real_warmup(self, (32, 32, 32), batch_size))
    base = ["segment", "--input", str(cases), "--checkpoints", str(tmp_path / "ck"),
            "--folds", "2", "--device", "cpu"]
    assert cli.main(base + ["--output", str(tmp_path / "serial")]) == 0
    assert cli.main(base + ["--output", str(tmp_path / "batched"), "--batch-cases", "2",
                            "--warmup"]) == 0
    assert warmed == [2]
    for case_id, _, _ in _CASES:
        a = np.asarray(nifti.load(tmp_path / "serial" / f"{case_id}.nii.gz").dataobj)
        b = np.asarray(nifti.load(tmp_path / "batched" / f"{case_id}.nii.gz").dataobj)
        assert np.array_equal(a, b), case_id
    with pytest.raises(SystemExit, match="--batch-cases requires --mode fullconv"):
        cli.main(base + ["--output", str(tmp_path / "s"), "--batch-cases", "2", "--mode",
                         "sliding"])
