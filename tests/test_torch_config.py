"""The framework config of the port (``utils/config.py``, ``init-config``,
``pipeline --config``) and the ``PipelineConfig`` fields that only a config
sets (repair C7), held against the JAX package on the CPU.

The pipeline tests run one tiny f32 U-Net (the JAX package's own test
engine) in both packages, with the same weights, on the same synthetic case.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu import cli as jax_cli
from braintpu.infer import InferenceEngine as JaxEngine
from braintpu.infer import ModelBundle as JaxBundle
from braintpu.io import nifti as jax_nifti
from braintpu.models import UNetConfig as JaxUNetConfig
from braintpu.models import init_params as jax_init_params
from braintpu.pipeline import Pipeline as JaxPipeline
from braintpu.pipeline import PipelineConfig as JaxPipelineConfig
from braintpu.utils import config as jax_config

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.models import unet3d
from braintpu_torch.pipeline import Pipeline, PipelineConfig
from braintpu_torch.utils import config
from braintpu_torch.utils.config import FrameworkConfig, load_config, save_config

_TINY = dict(in_channels=4, num_classes=3, base_features=4, max_features=16, num_pool=2,
             conv_per_stage=2, norm="batch", patch_size=(16, 16, 16))


@pytest.fixture(scope="module")
def engines():
    """The JAX package's test engine and the port's with the same weights."""
    jcfg = JaxUNetConfig(compute_dtype=jnp.float32, **_TINY)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jax_engine = JaxEngine(models=[JaxBundle.from_folds(jcfg, [params])], tta=False,
                           output_convention="internal")
    tcfg = unet3d.UNetConfig(compute_dtype=torch.float32, **_TINY)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port_engine = InferenceEngine(models=[ModelBundle.from_folds(tcfg, [params_from_jax(tree, tcfg)])],
                                  tta=False, output_convention="internal", device="cpu")
    return {"jax": (jax_engine, JaxPipeline, JaxPipelineConfig),
            "torch": (port_engine, Pipeline, PipelineConfig)}


def _stages(result):
    return [(e.stage, e.status) for e in result.events]


# ---------------------------------------------------------------------------
# FrameworkConfig (copies of tests/test_pipeline.py's config tests)
# ---------------------------------------------------------------------------


def test_framework_config_roundtrip(tmp_path):
    cfg = FrameworkConfig()
    cfg.segmentation.folds = 3
    cfg.report.generate_pdf = False
    p = tmp_path / "cfg.json"
    save_config(cfg, p)
    back = load_config(p)
    assert back.segmentation.folds == 3
    assert back.report.generate_pdf is False
    pc = back.pipeline_config()
    assert isinstance(pc, PipelineConfig)
    assert pc.generate_pdf is False


def test_framework_config_validation(tmp_path):
    bad = FrameworkConfig().to_dict()
    bad["segmentation"]["ensemble"] = "mean"
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="ensemble"):
        load_config(p)
    bad2 = FrameworkConfig().to_dict()
    bad2["segmentation"]["typo_key"] = 1
    p2 = tmp_path / "bad2.json"
    p2.write_text(json.dumps(bad2))
    with pytest.raises(ValueError, match="unknown"):
        load_config(p2)


# ---------------------------------------------------------------------------
# The same bytes and the same projection as the reference
# ---------------------------------------------------------------------------


def _edit(cfg):
    cfg.segmentation.models = ["model1"]
    cfg.segmentation.folds = 2
    cfg.segmentation.mode = "sliding"
    cfg.segmentation.output_convention = "brats2021"
    cfg.report.generate_pdf = False
    cfg.serve.port = 9000
    cfg.evaluate_if_gt = False
    cfg.fail_fast = True
    return cfg


@pytest.mark.parametrize("edited", [False, True])
def test_save_config_writes_the_reference_bytes(tmp_path, edited):
    port, ref = config.FrameworkConfig(), jax_config.FrameworkConfig()
    if edited:
        port, ref = _edit(port), _edit(ref)
    save_config(port, tmp_path / "port.json")
    jax_config.save_config(ref, tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    # and each package loads the other's file to the same settings
    assert load_config(tmp_path / "ref.json").to_dict() == ref.to_dict()
    assert jax_config.load_config(tmp_path / "port.json").to_dict() == port.to_dict()


def test_init_config_is_byte_equal_to_the_reference(tmp_path, capsys):
    assert cli.main(["init-config", str(tmp_path / "port.json")]) == 0
    jax_cli.cmd_init_config(argparse.Namespace(output=str(tmp_path / "ref.json")))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert "wrote default config" in capsys.readouterr().out


def test_pipeline_config_fields_and_projection_match_the_reference(tmp_path):
    port_fields = [(f.name, f.default) for f in dataclasses.fields(PipelineConfig)]
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(JaxPipelineConfig)]
    assert port_fields == ref_fields
    port = _edit(config.FrameworkConfig()).pipeline_config()
    ref = _edit(jax_config.FrameworkConfig()).pipeline_config()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.save_brats_convention == "brats2021" and port.evaluate_if_gt is False


# ---------------------------------------------------------------------------
# C7: the PipelineConfig fields act as in the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_segmentation_retry_on_transient_fault(tmp_path, engines, synth_case, package):
    """A transient segmentation fault is retried (with a 'retry' event)
    instead of failing the case; a persistent fault still fails it."""
    engine, Pipe, Cfg = engines[package]
    calls = {"n": 0, "stages": []}

    def flaky(stage):
        calls["stages"].append(stage)
        if stage == "segmenting":
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected transient device fault")

    cfg = Cfg(output_root=tmp_path / "out", generate_pdf=False, segment_retries=1,
              fault_hook=flaky)
    result = Pipe(engine, cfg).run_case(synth_case)
    assert result.succeeded
    assert any(e.stage == "segmenting" and e.status == "retry" for e in result.events)
    assert calls["stages"] == ["segmenting", "segmenting"]

    def always(stage):
        if stage == "segmenting":
            raise RuntimeError("injected persistent fault")

    cfg2 = Cfg(output_root=tmp_path / "out2", generate_pdf=False, segment_retries=1,
               fault_hook=always)
    result2 = Pipe(engine, cfg2).run_case(synth_case)
    assert not result2.succeeded
    assert "injected persistent fault" in result2.summary["error"]
    retries = [e for e in result2.events if e.status == "retry"]
    assert len(retries) == 1  # segment_retries=1: one retry, then the error

    cfg0 = Cfg(output_root=tmp_path / "out3", generate_pdf=False, segment_retries=0,
               fault_hook=flaky)
    calls["n"] = 0
    assert not Pipe(engine, cfg0).run_case(synth_case).succeeded  # no retry left


def test_retry_and_fault_events_match_the_reference(tmp_path, engines, synth_case):
    runs = {}
    for package, (engine, Pipe, Cfg) in engines.items():
        n = {"calls": 0}

        def flaky(stage, n=n):
            n["calls"] += 1
            if n["calls"] == 1:
                raise RuntimeError("injected transient device fault")

        cfg = Cfg(output_root=tmp_path / package, generate_pdf=False, fault_hook=flaky)
        runs[package] = Pipe(engine, cfg).run_case(synth_case)
    assert _stages(runs["torch"]) == _stages(runs["jax"])
    port_seg = np.asarray(jax_nifti.load(runs["torch"].output_folder / f"{synth_case.name}.nii.gz").dataobj)
    ref_seg = np.asarray(jax_nifti.load(runs["jax"].output_folder / f"{synth_case.name}.nii.gz").dataobj)
    np.testing.assert_array_equal(port_seg, ref_seg)


@pytest.mark.parametrize("convention", ["brats2025", "brats2021"])
def test_save_convention_and_evaluate_if_gt(tmp_path, engines, synth_case, convention):
    """The conversion stage writes the configured convention; evaluation is
    skipped when evaluate_if_gt is False; both packages agree on the files
    and the events."""
    out = {}
    for package, (engine, Pipe, Cfg) in engines.items():
        for evaluate in (True, False):
            cfg = Cfg(output_root=tmp_path / f"{package}_{evaluate}", generate_pdf=False,
                      save_brats_convention=convention, evaluate_if_gt=evaluate)
            r = Pipe(engine, cfg).run_case(synth_case)
            assert r.succeeded, r.summary.get("traceback")
            conv = next(e for e in r.events if e.stage == "converting" and e.status == "ok")
            assert conv.detail["convention"] == convention
            assert (r.output_folder / "evaluation.json").exists() == evaluate
            if not evaluate:
                assert r.metrics is None
                assert ("evaluating", "skip") in _stages(r)
            brats = np.asarray(jax_nifti.load(
                r.output_folder / f"{synth_case.name}_brats.nii.gz").dataobj)
            out[package, evaluate] = (brats, _stages(r), r.metrics)
    for evaluate in (True, False):
        port, ref = out["torch", evaluate], out["jax", evaluate]
        np.testing.assert_array_equal(port[0], ref[0])
        assert port[1] == ref[1]
        if evaluate:
            assert port[2]["mean_dice"] == pytest.approx(ref[2]["mean_dice"], rel=1e-12)
    labels = set(np.unique(out["torch", True][0]).tolist())
    assert labels <= ({0, 1, 2, 4} if convention == "brats2021" else {0, 1, 2, 3})


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_fail_fast_raises(tmp_path, engines, package):
    engine, Pipe, Cfg = engines[package]
    empty = tmp_path / "empty_case"
    empty.mkdir()
    soft = Pipe(engine, Cfg(output_root=tmp_path / "soft")).run_case(empty)
    assert not soft.succeeded
    with pytest.raises(FileNotFoundError, match="no complete BraTS case"):
        Pipe(engine, Cfg(output_root=tmp_path / "hard", fail_fast=True)).run_case(empty)
    with pytest.raises(FileNotFoundError, match="no complete BraTS case"):
        Pipe(engine, Cfg(output_root=tmp_path / "hard2", fail_fast=True)).run_cases([empty])


# ---------------------------------------------------------------------------
# cli pipeline --config
# ---------------------------------------------------------------------------


def test_pipeline_config_flag_applies_the_config_before_the_engine(tmp_path, engines,
                                                                    synth_case, monkeypatch):
    fc = _edit(FrameworkConfig())
    fc.segmentation.tta = False
    fc.segmentation.et_min_voxels = 0
    fc.segmentation.step_size = 0.25
    fc.segmentation.checkpoints = "some/ckpts"
    fc.output_root = str(tmp_path / "results")
    fc.evaluate_if_gt = True
    fc.fail_fast = False
    path = tmp_path / "cfg.json"
    save_config(fc, path)
    seen = {}
    engine = engines["torch"][0]

    def fake_load_engine(args):
        seen.update(vars(args))
        return engine

    monkeypatch.setattr(cli, "load_engine", fake_load_engine)
    try:
        rc = cli.main(["pipeline", str(synth_case), "--config", str(path), "--device", "cpu"])
        assert rc == 0
        assert (seen["models"], seen["folds"], seen["no_tta"], seen["mode"]) == \
            ("model1", 2, True, "sliding")
        assert seen["no_et_postprocess"] is True and seen["checkpoints"] == "some/ckpts"
        assert (engine.step_size, engine.et_min_voxels) == (0.25, 0)
    finally:
        engine.step_size, engine.et_min_voxels = 0.5, 200
    out = tmp_path / "results" / synth_case.name
    brats = np.asarray(jax_nifti.load(out / f"{synth_case.name}_brats.nii.gz").dataobj)
    assert set(np.unique(brats).tolist()) <= {0, 1, 2, 4}  # the config's brats2021
    assert not (out / "feature_extraction" / "radiology_report.pdf").exists()  # generate_pdf off


def test_pipeline_config_naming_axial_raises_unknown_model(tmp_path, synth_case):
    fc = FrameworkConfig()
    fc.segmentation.models = ["model1", "axial"]
    path = tmp_path / "cfg.json"
    save_config(fc, path)
    # the config's default mode is fullconv, which the axial models refuse
    # with the reference's message
    with pytest.raises(SystemExit, match=r"--mode fullconv is incompatible with axial models "
                                         r"\['axial'\]"):
        cli.main(["pipeline", str(synth_case), "--config", str(path), "--device", "cpu",
                  "--random-weights"])
