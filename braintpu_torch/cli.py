"""Command-line interface of the port.

    python -m braintpu_torch.cli pipeline CASE_DIR [CASE_DIR ...] --output OUT \\
        --checkpoints results/trained_synth/checkpoints --folds 2
    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT \\
        --checkpoints results/trained_synth/checkpoints --models model1,model2 --folds 2
    python -m braintpu_torch.cli evaluate --pred OUT/CASE.nii.gz --gt CASE_seg.nii.gz
    python -m braintpu_torch.cli features --input CASE_DIR --segmentation SEG --output DIR
    python -m braintpu_torch.cli report --summary DIR/llm_ready_summary.json
    python -m braintpu_torch.cli pdf --report DIR/radiology_report.txt
    python -m braintpu_torch.cli convert-labels SEG [OUT] --format brats2025
    python -m braintpu_torch.cli check-labels SEG
    python -m braintpu_torch.cli rename CASE_DIR [--dry-run]

The subcommands and flags follow ``braintpu/cli.py`` for what the port has
(fullconv mode with the softmax-level ensemble of model1 and model2, npz
checkpoints, ``--random-weights``), plus ``--device`` on the commands that
build an engine: the card by default, ``cpu`` only when asked for.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

__all__ = ["build_parser", "load_engine", "main"]


def load_engine(args):
    """Build an InferenceEngine from ``--checkpoints``/``--models``/``--folds``.

    A fold whose ``<checkpoints>/<model>/fold_<f>.npz`` is missing raises,
    unless ``--random-weights`` is given: then it gets ``init_params(cfg,
    selected.index(name) * 1000 + f)``, as in the reference (a name listed
    twice draws the same folds twice).  The label convention is
    ``--convention`` where the subcommand has it, else internal labels (the
    pipeline converts in its own stage).
    Prints, per model, which folds were loaded and which were drawn.
    """
    from .ckpt.npz import load_pytree_npz, params_from_jax
    from .infer.engine import InferenceEngine, ModelBundle
    from .models.unet3d import MODEL1_BN, MODEL2_GN_LARGE, init_params

    configs = {"model1": MODEL1_BN, "model2": MODEL2_GN_LARGE}
    selected = [n.strip() for n in args.models.split(",") if n.strip()]
    unknown = [n for n in selected if n not in configs]
    if unknown:
        raise SystemExit(f"unknown model(s) {unknown}; choose from {sorted(configs)}")
    bundles = []
    for name in selected:
        cfg = configs[name]
        seed0 = selected.index(name) * 1000  # a repeated name draws the same folds
        fold_params, loaded, drawn = [], [], []
        for f in range(args.folds):
            npz = Path(args.checkpoints) / name / f"fold_{f}.npz" if args.checkpoints else None
            if npz is not None and npz.exists():
                fold_params.append(params_from_jax(load_pytree_npz(npz), cfg))
                loaded.append(f)
            elif args.random_weights:
                fold_params.append(init_params(cfg, seed0 + f))
                drawn.append(f"{f} (seed {seed0 + f})")
            else:
                raise SystemExit(f"checkpoint for {name}/fold_{f} not found under "
                                 f"{args.checkpoints!r}; pass --random-weights for a dry run")
        print(f"# {name}: folds loaded {loaded or 'none'}; random {drawn or 'none'}", flush=True)
        bundles.append(ModelBundle.from_folds(cfg, fold_params, name=name))
    return InferenceEngine(
        models=bundles,
        tta=not args.no_tta,
        et_min_voxels=0 if args.no_et_postprocess else 200,
        output_convention=getattr(args, "convention", None) or "internal",
        device=args.device,
    )


def cmd_segment(args) -> int:
    from .io.brats import find_cases

    cases = find_cases(args.input)
    if not cases:
        raise SystemExit(f"no complete BraTS case under {args.input}")
    engine = load_engine(args)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    if args.warmup:
        print(f"# warmup: {engine.warmup():.1f}s")
    for case in cases:
        seg, info = engine.predict_case(case, out / f"{case.case_id}.nii.gz")
        print(f"{case.case_id}: {info['total_s']:.1f}s  volumes={info['volumes_cm3']}")
    return 0


def cmd_evaluate(args) -> int:
    from .io import nifti
    from .labels.convert import normalize_to_brats2025
    from .metrics.segmentation import evaluate_segmentation

    pred = np.round(nifti.load(args.pred).get_fdata(dtype=np.float32)).astype(np.int32)
    gt = np.round(nifti.load(args.gt).get_fdata(dtype=np.float32)).astype(np.int32)
    # both sides to BraTS-2025 space whatever their vintage (ET spelled 3 or 4)
    pred = normalize_to_brats2025(pred).astype(np.int32)
    gt = normalize_to_brats2025(gt).astype(np.int32)
    results = evaluate_segmentation(pred, gt)
    print(json.dumps(results, indent=2))
    print(f"\nMean Dice (WT, TC, ET): {results['mean_dice']:.4f} ({results['mean_dice']*100:.2f}%)")
    return 0


def cmd_pipeline(args) -> int:
    from .pipeline import Pipeline, PipelineConfig

    engine = load_engine(args)
    cfg = PipelineConfig(
        output_root=Path(args.output),
        use_llm_refinement=args.use_llm,
        generate_pdf=not args.no_pdf,
    )
    pipeline = Pipeline(
        engine,
        cfg,
        on_event=lambda e: print(f"STAGE:{e.stage}:{e.status} {e.detail or ''}"),
    )
    folders = [args.case_folder] + list(args.more_case_folders or [])
    if len(folders) == 1:
        result = pipeline.run_case(folders[0])
        print(json.dumps(result.summary, indent=2, default=str))
        return 0 if result.succeeded else 1
    # multi-case: case N's host stages overlap case N+1's segmentation
    results = pipeline.run_cases(folders)
    print(json.dumps([r.summary for r in results], indent=2, default=str))
    return 0 if all(r.succeeded for r in results) else 1


def cmd_convert_labels(args) -> int:
    from .io import nifti
    from .labels.convert import internal_to_brats2021, internal_to_brats2025

    img = nifti.load(args.input)
    data = img.get_fdata(dtype=np.float32)
    fn = internal_to_brats2021 if args.format == "brats2021" else internal_to_brats2025
    converted = np.asarray(fn(data)).astype(np.uint8)
    name = Path(args.input).name
    derived = name.replace(".nii", "_brats.nii")
    if derived == name:  # input without '.nii' (the codec loads by content)
        derived = name + "_brats.nii.gz"
    out = args.output or str(Path(args.input).with_name(derived))
    if Path(out).resolve() == Path(args.input).resolve():
        raise SystemExit(f"refusing to overwrite the input {args.input!r}; pass a different --output")
    nifti.save(converted, out, affine=img.affine)
    print(f"labels before: {sorted(np.unique(np.round(data)).astype(int).tolist())}")
    print(f"labels after:  {sorted(np.unique(converted).astype(int).tolist())}")
    print(f"saved: {out}")
    return 0


def cmd_check_labels(args) -> int:
    from .viz.diagnostics import audit_labels_file, format_label_audit

    print(format_label_audit(audit_labels_file(args.input)))
    return 0


def cmd_features(args) -> int:
    from .features import run_all_steps

    run_all_steps(args.input, args.segmentation, args.output)
    print(f"feature extraction complete → {args.output}")
    return 0


def cmd_report(args) -> int:
    from .report import generate_report_from_summary, refine_report

    if args.summary:
        summary_path = Path(args.summary)
    elif args.results_folder:
        summary_path = Path(args.results_folder) / "feature_extraction" / "llm_ready_summary.json"
    else:
        raise SystemExit("report: pass --summary or --results-folder")
    with open(summary_path) as f:
        summary = json.load(f)
    report, vlog, _ = generate_report_from_summary(summary)
    if args.use_llm:
        report = refine_report(report)
    out = args.output or summary_path.parent / "radiology_report.txt"
    Path(out).write_text(report, encoding="utf-8")
    print(report)
    if vlog:
        print(f"\n[{len(vlog)} validation event(s) logged]", file=sys.stderr)
    return 0


def cmd_pdf(args) -> int:
    from .report import generate_pdf_report

    text = Path(args.report).read_text(encoding="utf-8")
    out = args.output or str(Path(args.report).with_suffix(".pdf"))
    generate_pdf_report(text, out)
    print(f"saved: {out}")
    return 0


def cmd_rename(args) -> int:
    from .io.brats import rename_brats2025_folder

    changes = rename_brats2025_folder(args.folder, dry_run=args.dry_run)
    for old, new in changes:
        print(f"{'would rename' if args.dry_run else 'renamed'}: {old} → {new}")
    print(f"{len(changes)} file(s)")
    return 0


def _add_engine_args(p, convention_default=None) -> None:
    """The flags that build an engine (see :func:`load_engine`)."""
    p.add_argument("--checkpoints", help="checkpoint root: model{1,2}/fold_N.npz layout")
    p.add_argument("--models", default="model1,model2", help="comma list: model1,model2")
    p.add_argument("--folds", type=int, default=5)
    if convention_default:
        p.add_argument("--convention", choices=["internal", "brats2025", "brats2021"],
                       default=convention_default, help="label convention of saved segmentations")
    p.add_argument("--no-tta", action="store_true")
    p.add_argument("--no-et-postprocess", action="store_true")
    p.add_argument("--random-weights", action="store_true",
                   help="random init for folds without a checkpoint (demo/bench)")
    p.add_argument("--device", default=None, help="torch device; default: the card (cuda)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="braintpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("pipeline", help="full case pipeline: segment → features → report → PDF")
    p.add_argument("case_folder")
    p.add_argument("more_case_folders", nargs="*",
                   help="additional case folders: case N's host stages run while case N+1 "
                        "segments on the device")
    p.add_argument("--output", default="results")
    p.add_argument("--use-llm", action="store_true")
    p.add_argument("--no-pdf", action="store_true")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("segment", help="ensemble segmentation only")
    p.add_argument("--input", required=True, help="case folder (or a root of case folders)")
    p.add_argument("--output", required=True)
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy case of the standard bucket before the first case")
    # standalone segment saves BraTS-2025 labels by default (the pipeline
    # keeps internal labels and converts in its own stage)
    _add_engine_args(p, convention_default="brats2025")
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("convert-labels", help="internal labels → BraTS convention")
    p.add_argument("input")
    p.add_argument("output", nargs="?")
    p.add_argument("--format", choices=["brats2025", "brats2021"], default="brats2025")
    p.set_defaults(fn=cmd_convert_labels)

    p = sub.add_parser("evaluate", help="Dice/IoU/sensitivity/specificity vs ground truth")
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("check-labels", help="label audit of a segmentation file")
    p.add_argument("input")
    p.set_defaults(fn=cmd_check_labels)

    p = sub.add_parser("features", help="6-step radiology feature extraction")
    p.add_argument("--input", required=True)
    p.add_argument("--segmentation", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_features)

    p = sub.add_parser("report", help="governed template report from llm_ready_summary.json")
    p.add_argument("--summary")
    p.add_argument("--results-folder")
    p.add_argument("--output")
    p.add_argument("--use-llm", action="store_true")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("pdf", help="render a text report to PDF")
    p.add_argument("--report", required=True)
    p.add_argument("--output")
    p.set_defaults(fn=cmd_pdf)

    p = sub.add_parser("rename", help="BraTS-2025 → 2021 filename conversion")
    p.add_argument("folder")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_rename)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
