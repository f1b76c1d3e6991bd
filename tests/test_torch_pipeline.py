"""The report half of the main path in the port (labels, rename, features,
governed report, PDF, the pipeline orchestrator and its CLI), held against
the JAX package on the CPU.

These modules are host numpy/scipy code, copied into the port; the tests
feed both packages the same files and arrays and ask for the same JSON,
text and bytes.  Fields that carry a wall-clock time or a path are left out
of the comparison (``analysis_timestamp`` and the like), and the report's
DATE line is fixed or blanked.  Floats agree to 1e-9 relative.
"""

import gzip
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from braintpu import cli as jax_cli
from braintpu.features import run_all_steps as jax_run_all_steps
from braintpu.infer.engine import InferenceEngine as JaxEngine
from braintpu.infer.engine import ModelBundle as JaxBundle
from braintpu.io.brats import rename_brats2025_folder as jax_rename
from braintpu.labels import convert as jax_convert
from braintpu.models import unet3d as jax_unet
from braintpu.ckpt import load_pytree_npz as jax_load_npz
from braintpu.pipeline import Pipeline as JaxPipeline
from braintpu.pipeline import PipelineConfig as JaxPipelineConfig
from braintpu.report import ReportEngine as JaxReportEngine
from braintpu.report import generate_pdf_report as jax_pdf
from braintpu.report import generate_report_from_summary as jax_report

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax
from braintpu_torch.features import run_all_steps
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import nifti
from braintpu_torch.io.brats import rename_brats2025_folder
from braintpu_torch.labels import convert
from braintpu_torch.models import unet3d
from braintpu_torch.pipeline import Pipeline, PipelineConfig
from braintpu_torch.report import (ReportEngine, SlotValidator, generate_pdf_report,
                                   generate_report_from_summary)
from braintpu_torch.train.synthetic import write_synth_case

REPO = Path(__file__).resolve().parent.parent
CKPTS = REPO / "results" / "trained_synth" / "checkpoints"
FLAGSHIP = REPO / "results" / "flagship_trained" / "BraTS-SYN-00200-000"
STEPS = ["step1_sequence_findings", "step2_mass_effect", "step3_multiplicity",
         "step4_morphology", "step5_quality", "step6_normal_structures"]
#: fields that carry a wall-clock time, a duration or a path
VOLATILE = {"analysis_timestamp", "analysis_date", "input_folder", "segmentation_path",
            "output_folder", "segmentation", "path", "t", "seconds", "decode_s",
            "preprocess_s", "predict_s", "pipeline_duration_seconds",
            "pipeline_duration_minutes", "step_spans", "gt_join_s", "normalize_s", "dice_s",
            "stages", "traceback"}


def _text(s: str) -> str:
    """A report text without its date lines."""
    s = re.sub(r"Analysis Date: .*", "Analysis Date:", s)
    return re.sub(r"(?m)^DATE: .*$", "DATE:", s)


def _diff(a, b, path="", out=None):
    """Differences between two JSON values: floats to 1e-9 relative,
    VOLATILE keys skipped, report texts compared without their dates."""
    out = [] if out is None else out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k in VOLATILE:
                continue
            if k not in a or k not in b:
                out.append((f"{path}/{k}", "missing on one side"))
            else:
                _diff(a[k], b[k], f"{path}/{k}", out)
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.append((path, f"lengths {len(a)} != {len(b)}"))
        for i, (x, y) in enumerate(zip(a, b)):
            _diff(x, y, f"{path}[{i}]", out)
    elif isinstance(a, float) or isinstance(b, float):
        if not (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and abs(a - b) <= 1e-9 * max(abs(a), abs(b))):
            out.append((path, a, b))
    elif isinstance(a, str) and isinstance(b, str):
        if _text(a) != _text(b):
            out.append((path, a[:80], b[:80]))
    elif a != b:
        out.append((path, a, b))
    return out


def _same_json_files(dir_a: Path, dir_b: Path, names):
    for name in names:
        a = json.loads((dir_a / f"{name}.json").read_text())
        b = json.loads((dir_b / f"{name}.json").read_text())
        d = _diff(a, b)
        assert not d, (name, d[:5])


# ---------------------------------------------------------------------------
# Labels and naming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["brats2025_to_internal", "brats2021_to_internal",
                                  "brats2021_to_brats2025", "brats2025_to_brats2021",
                                  "internal_to_brats2025", "internal_to_brats2021",
                                  "normalize_to_brats2025"])
def test_label_conversions_match_reference(name):
    rng = np.random.default_rng(4)
    seg = rng.integers(-1, 7, (9, 10, 11))
    for arr in (seg.astype(np.int32), np.clip(seg, 0, 6).astype(np.uint8),
                seg.astype(np.float32) + 0.2):
        want = np.asarray(getattr(jax_convert, name)(arr))
        got = getattr(convert, name)(arr)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_rename_matches_reference(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for suffix, ext in (("t1n", "nii"), ("t1c", "nii.gz"), ("t2w", "nii"), ("t2f", "nii.gz"),
                        ("seg", "nii")):
        payload = f"volume {suffix}".encode() * 50
        data = gzip.compress(payload) if ext.endswith("gz") else payload
        (src / f"BraTS-GLI-00012-000-{suffix}.{ext}").write_bytes(data)
    (src / "notes.txt").write_text("left alone")
    a, b = tmp_path / "port", tmp_path / "ref"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    assert rename_brats2025_folder(a, dry_run=True) == jax_rename(b, dry_run=True)
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in src.iterdir())
    assert rename_brats2025_folder(a) == jax_rename(b)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "BraTS-GLI-00012-000_t1ce.nii.gz" in names
    for n in names:
        read = lambda p: gzip.decompress(p.read_bytes()) if n.endswith(".gz") else p.read_bytes()
        assert read(a / n) == read(b / n), n


# ---------------------------------------------------------------------------
# Features, report, PDF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    """One seeded synthetic case (80 x 88 x 72) on disk, read by both packages."""
    return write_synth_case(tmp_path_factory.mktemp("case"), "BraTS-SYN-00007-000", seed=7,
                            shape=(80, 88, 72))


def _segmentation(case: Path, kind: str, out: Path) -> Path:
    img = nifti.load(case / f"{case.name}_seg.nii.gz")
    seg = np.round(img.get_fdata(np.float32)).astype(np.uint8)
    if kind == "empty":
        seg[:] = 0
    elif kind == "brats2021":  # the other vintage: ET spelled 4
        seg[seg == 3] = 4
    path = out / f"seg_{kind}.nii.gz"
    nifti.save(seg, path, affine=img.affine)
    return path


@pytest.mark.parametrize("kind", ["ground_truth", "empty", "brats2021"])
def test_features_match_reference(small_case, tmp_path, monkeypatch, kind):
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)  # the host route
    seg = _segmentation(small_case, kind, tmp_path)
    got = run_all_steps(small_case, seg, tmp_path / "port")
    want = jax_run_all_steps(small_case, seg, tmp_path / "ref")
    assert not _diff(got, want)
    _same_json_files(tmp_path / "port", tmp_path / "ref",
                     STEPS + ["llm_ready_summary", "comprehensive_analysis"])
    assert _text((tmp_path / "port" / "radiology_report.txt").read_text()) == \
        _text((tmp_path / "ref" / "radiology_report.txt").read_text())
    if kind != "empty":
        assert got["step3_multiplicity"]["component_analysis"]["num_components"] >= 1


def test_features_match_committed_flagship(tmp_path, monkeypatch):
    """The committed flagship segmentation with the seed-200 modalities
    regenerated at 240 x 240 x 155: the port's step JSONs equal the committed
    ones (which the JAX package reproduces as they are)."""
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)
    case = write_synth_case(tmp_path, "BraTS-SYN-00200-000", seed=200, shape=(240, 240, 155))
    run_all_steps(case, FLAGSHIP / "BraTS-SYN-00200-000_brats.nii.gz", tmp_path / "port")
    _same_json_files(tmp_path / "port", FLAGSHIP / "feature_extraction",
                     STEPS + ["llm_ready_summary", "comprehensive_analysis"])


def _summaries():
    base = json.loads((FLAGSHIP / "feature_extraction" / "llm_ready_summary.json").read_text())
    out = {"flagship": base}
    no_enh = json.loads(json.dumps(base))
    no_enh["enhancement"] = {"present": False, "pattern": "Non-enhancing"}
    out["non_enhancing"] = no_enh
    multi = json.loads(json.dumps(base))
    multi["multiplicity"] = {"lesion_count": 3, "distribution_pattern": "Multifocal"}
    out["multifocal"] = multi
    return out


@pytest.mark.parametrize("which", ["flagship", "non_enhancing", "multifocal"])
def test_governed_report_matches_reference(which):
    summary = _summaries()[which]
    port = ReportEngine(summary, exam_date="October 17, 2026")
    ref = JaxReportEngine(summary, exam_date="October 17, 2026")
    text = port.fill_template()
    assert text == ref.fill_template()
    assert port.validation_log == ref.validation_log
    assert not _diff(port.facts, ref.facts)
    got, vlog, facts = generate_report_from_summary(summary)
    want, jvlog, jfacts = jax_report(summary)
    assert _text(got) == _text(want) and vlog == jvlog
    assert SlotValidator().report_violations(text) == []
    assert SlotValidator().report_violations(text + "\nThis is definitely cancer.\n")
    if which == "flagship":  # the committed report, dated as committed
        committed = (FLAGSHIP / "feature_extraction" / "radiology_report.txt").read_text()
        assert ReportEngine(summary, exam_date="August 21, 2026").fill_template() == committed


def test_pdf_bytes_match_reference(tmp_path):
    text = (FLAGSHIP / "feature_extraction" / "radiology_report.txt").read_text()
    a = generate_pdf_report(text, tmp_path / "port.pdf", case_id="BraTS-SYN-00200-000",
                            exam_date="August 21, 2026")
    b = jax_pdf(text, tmp_path / "ref.pdf", case_id="BraTS-SYN-00200-000",
                exam_date="August 21, 2026")
    data = Path(a).read_bytes()
    assert data.startswith(b"%PDF") and data == Path(b).read_bytes()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class _FixedSegmentation:
    """An engine stand-in that returns one given internal-label segmentation,
    so the host stages of both packages see the same labels."""

    output_convention = "internal"

    def __init__(self, seg: np.ndarray):
        self.seg = seg

    def predict_case(self, case, output_path=None, loaded=None):
        _, affine, zooms = loaded
        if output_path is not None:
            nifti.save(self.seg.astype(np.uint8), output_path, affine=affine)
        vox = float(np.prod(zooms[:3])) / 1000.0
        counts = {k: float((self.seg == v).sum()) * vox for k, v in (("ED", 1), ("NCR", 2),
                                                                      ("ET", 3))}
        return self.seg, {"total_s": 0.0, "volumes_cm3": counts, "case_id": case.case_id}


def _stage_list(result):
    return [(e.stage, e.status) for e in result.events]


def _compare_pipeline_outputs(got, want):
    assert got.succeeded and want.succeeded, (got.summary, want.summary)
    assert _stage_list(got) == _stage_list(want)
    assert sorted(got.summary) == sorted(want.summary)
    assert not _diff(got.summary, want.summary)
    a, b = got.output_folder, want.output_folder
    assert sorted(p.name for p in a.rglob("*")) == sorted(p.name for p in b.rglob("*"))
    assert not _diff(json.loads((a / "evaluation.json").read_text()),
                     json.loads((b / "evaluation.json").read_text()))
    _same_json_files(a / "feature_extraction", b / "feature_extraction",
                     STEPS + ["llm_ready_summary", "comprehensive_analysis", "radiology_report"])
    assert _text(got.report_text) == _text(want.report_text)
    assert (a / "feature_extraction" / "radiology_report.pdf").read_bytes().startswith(b"%PDF")


def test_pipeline_host_stages_match_reference_on_one_segmentation(small_case, tmp_path,
                                                                  monkeypatch):
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)
    gt = np.round(nifti.load(small_case / f"{small_case.name}_seg.nii.gz").get_fdata(np.float32))
    seg = convert.brats2025_to_internal(gt)
    seg[40:44, 40:44, 30:34] = 3  # not the ground truth: evaluation has work to do
    engine = _FixedSegmentation(seg)
    got = Pipeline(engine, PipelineConfig(output_root=tmp_path / "port")).run_case(small_case)
    want = JaxPipeline(engine, JaxPipelineConfig(output_root=tmp_path / "ref")).run_case(small_case)
    _compare_pipeline_outputs(got, want)
    assert 0.9 < got.metrics["mean_dice"] < 1.0


def test_pipeline_engines_match_reference(tmp_path, monkeypatch):
    """Both packages' own fullconv engines (MODEL1_BN in bf16, trained fold 0,
    no TTA) under their pipelines on one case.  The bf16 forwards accumulate
    differently (f32 on the port's side, bf16 in the reference), so the
    segmentations may differ in a few voxels near the 0.5 threshold: the
    stage lists and summary keys must agree, and the volumes and Dice within
    what the differing voxels can move."""
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    npz = CKPTS / "model1" / "fold_0.npz"
    jeng = JaxEngine(models=[JaxBundle.from_folds(jax_unet.MODEL1_BN, [jax_load_npz(npz)])],
                     mode="fullconv", tta=False, output_convention="internal")
    teng = InferenceEngine(
        models=[ModelBundle.from_folds(
            unet3d.MODEL1_BN, [params_from_jax(load_pytree_npz(npz), unet3d.MODEL1_BN)])],
        mode="fullconv", tta=False, output_convention="internal", device="cpu")
    want = JaxPipeline(jeng, JaxPipelineConfig(output_root=tmp_path / "ref")).run_case(case)
    got = Pipeline(teng, PipelineConfig(output_root=tmp_path / "port")).run_case(case)
    assert got.succeeded and want.succeeded
    assert _stage_list(got) == _stage_list(want)
    assert sorted(got.summary) == sorted(want.summary)
    differing = int((got.seg != want.seg).sum())
    assert differing <= 0.001 * got.seg.size, f"{differing} voxels differ"
    assert (want.seg > 0).mean() > 0.01, "degenerate: no tumor to compare"
    vox = 1e-3  # 1 mm^3 voxels, in cm^3
    for k, v in want.features["llm_summary"]["tumor_characteristics"].items():
        if isinstance(v, float) and k.endswith("cm3"):
            assert abs(got.features["llm_summary"]["tumor_characteristics"][k] - v) <= \
                differing * vox + 1e-9, k
    assert abs(got.metrics["mean_dice"] - want.metrics["mean_dice"]) <= 0.01
    if differing == 0:
        _compare_pipeline_outputs(got, want)


class _Flaky(_FixedSegmentation):
    """Fails its first ``faults`` calls, as a transient device fault would."""

    def __init__(self, seg: np.ndarray, faults: int):
        super().__init__(seg)
        self.faults = faults

    def predict_case(self, case, output_path=None, loaded=None):
        if self.faults:
            self.faults -= 1
            raise RuntimeError("injected device fault")
        return super().predict_case(case, output_path, loaded)


@pytest.mark.parametrize("faults,succeeds", [(1, True), (2, False)])
def test_segmentation_retries_a_transient_fault(small_case, tmp_path, faults, succeeds):
    """One fault is retried (with a 'retry' event); a second fails the case,
    as in the reference's pipeline."""
    gt = np.round(nifti.load(small_case / f"{small_case.name}_seg.nii.gz").get_fdata(np.float32))
    engine = _Flaky(convert.brats2025_to_internal(gt), faults)
    result = Pipeline(engine, PipelineConfig(output_root=tmp_path / "out",
                                             generate_pdf=False)).run_case(small_case)
    assert result.succeeded == succeeds
    assert ("segmenting", "retry") in _stage_list(result)
    if not succeeds:
        assert result.summary["status"] == "error"
        assert "injected device fault" in result.summary["error"]


@pytest.mark.parametrize("convention", ["internal", "brats2021", "brats2025"])
def test_pipeline_saves_brats2025_labels_from_any_engine_convention(small_case, tmp_path,
                                                                    convention):
    gt = np.round(nifti.load(small_case / f"{small_case.name}_seg.nii.gz").get_fdata(np.float32))
    internal = convert.brats2025_to_internal(gt)
    engine = _FixedSegmentation({"internal": internal,
                                 "brats2021": convert.internal_to_brats2021(internal),
                                 "brats2025": gt}[convention])
    engine.output_convention = convention
    result = Pipeline(engine, PipelineConfig(output_root=tmp_path / "out",
                                             generate_pdf=False)).run_case(small_case)
    assert result.succeeded, result.summary.get("traceback")
    saved = nifti.load(result.output_folder / f"{small_case.name}_brats.nii.gz")
    np.testing.assert_array_equal(np.asarray(saved.dataobj), gt)
    assert result.metrics["mean_dice"] == pytest.approx(1.0, abs=1e-9)  # smoothed Dice


def test_run_cases_overlap_matches_serial(small_case, tmp_path):
    gt = np.round(nifti.load(small_case / f"{small_case.name}_seg.nii.gz").get_fdata(np.float32))
    engine = _FixedSegmentation(convert.brats2025_to_internal(gt))
    broken = tmp_path / "cases" / "BraTS-SYN-00008-000"
    broken.mkdir(parents=True)  # no modalities: the middle case fails
    twin = write_synth_case(tmp_path / "cases", "BraTS-SYN-00009-000", seed=7, shape=(80, 88, 72))
    pipe = Pipeline(engine, PipelineConfig(output_root=tmp_path / "overlap", generate_pdf=False))
    results = pipe.run_cases([small_case, broken, twin])
    assert [r.succeeded for r in results] == [True, False, True]
    assert results[1].summary["status"] == "error"
    serial = Pipeline(engine, PipelineConfig(output_root=tmp_path / "serial",
                                             generate_pdf=False)).run_case(small_case)
    for r in (results[0], results[2]):
        assert _stage_list(r) == _stage_list(serial)
        assert r.metrics == serial.metrics
        assert _text(r.report_text).replace("00009", "00007") == _text(serial.report_text)
        lines = (r.output_folder / "events.jsonl").read_text().splitlines()
        assert {json.loads(ln)["stage"] for ln in lines} >= {"renaming", "segmenting",
                                                             "extracting", "done"}


def test_cli_pipeline_and_host_subcommands_on_cpu(tmp_path, capsys):
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00200-000", seed=200, shape=(40, 40, 36))
    out = tmp_path / "out"
    rc = cli.main(["pipeline", str(case), "--output", str(out), "--checkpoints", str(CKPTS),
                   "--models", "model1", "--folds", "1", "--no-tta", "--device", "cpu"])
    assert rc == 0
    stages = re.findall(r"^STAGE:(\w+):ok", capsys.readouterr().out, re.M)
    assert stages == ["renaming", "segmenting", "converting", "evaluating", "extracting",
                      "generating", "exporting", "done"]
    res = out / "BraTS-SYN-00200-000"
    fe = res / "feature_extraction"
    assert (fe / "radiology_report.pdf").read_bytes().startswith(b"%PDF")
    assert json.loads((res / "evaluation.json").read_text())["mean_dice"] > 0.9

    def both(argv):
        """The port's subcommand and the reference's, on the same arguments."""
        assert cli.main(argv) == 0
        mine = capsys.readouterr().out
        args = jax_cli.build_parser().parse_args(argv)
        assert args.fn(args) == 0
        return mine, capsys.readouterr().out

    seg = str(res / "BraTS-SYN-00200-000.nii.gz")
    mine, ref = both(["check-labels", seg])
    assert mine == ref and "convention" in mine
    for fmt in ("brats2025", "brats2021"):
        a, b = str(tmp_path / f"a_{fmt}.nii.gz"), str(tmp_path / f"b_{fmt}.nii.gz")
        assert cli.main(["convert-labels", seg, a, "--format", fmt]) == 0
        args = jax_cli.build_parser().parse_args(["convert-labels", seg, b, "--format", fmt])
        assert args.fn(args) == 0
        capsys.readouterr()
        np.testing.assert_array_equal(nifti.load(a).get_fdata(np.float32),
                                      nifti.load(b).get_fdata(np.float32))
    assert cli.main(["features", "--input", str(case), "--segmentation", str(res /
                    "BraTS-SYN-00200-000_brats.nii.gz"), "--output", str(tmp_path / "fa")]) == 0
    args = jax_cli.build_parser().parse_args(
        ["features", "--input", str(case), "--segmentation",
         str(res / "BraTS-SYN-00200-000_brats.nii.gz"), "--output", str(tmp_path / "fb")])
    assert args.fn(args) == 0
    capsys.readouterr()
    _same_json_files(tmp_path / "fa", tmp_path / "fb", STEPS + ["llm_ready_summary"])
    summary = str(tmp_path / "fa" / "llm_ready_summary.json")
    mine, ref = both(["report", "--summary", summary, "--output", str(tmp_path / "r.txt")])
    assert _text(mine) == _text(ref)
    assert cli.main(["pdf", "--report", str(tmp_path / "r.txt")]) == 0
    assert (tmp_path / "r.pdf").read_bytes().startswith(b"%PDF")
    capsys.readouterr()
    mine, ref = both(["rename", str(case), "--dry-run"])
    assert mine == ref == "0 file(s)\n"
