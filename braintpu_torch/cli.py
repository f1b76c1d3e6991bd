"""Command-line interface of the port: ``segment`` and ``evaluate``.

    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT \\
        --checkpoints results/trained_synth/checkpoints --models model1,model2 --folds 2
    python -m braintpu_torch.cli evaluate --pred OUT/CASE.nii.gz --gt CASE_seg.nii.gz

The flags follow ``braintpu/cli.py``'s ``segment`` for what the port has
(fullconv mode with the softmax-level ensemble of model1 and model2, npz
checkpoints, ``--random-weights``), plus ``--device``: the card by default,
``cpu`` only when asked for.
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
    i * 1000 + f)`` for the i-th selected model, as in the reference.
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
    for i, name in enumerate(selected):
        cfg = configs[name]
        fold_params, loaded, drawn = [], [], []
        for f in range(args.folds):
            npz = Path(args.checkpoints) / name / f"fold_{f}.npz" if args.checkpoints else None
            if npz is not None and npz.exists():
                fold_params.append(params_from_jax(load_pytree_npz(npz), cfg))
                loaded.append(f)
            elif args.random_weights:
                fold_params.append(init_params(cfg, i * 1000 + f))
                drawn.append(f"{f} (seed {i * 1000 + f})")
            else:
                raise SystemExit(f"checkpoint for {name}/fold_{f} not found under "
                                 f"{args.checkpoints!r}; pass --random-weights for a dry run")
        print(f"# {name}: folds loaded {loaded or 'none'}; random {drawn or 'none'}", flush=True)
        bundles.append(ModelBundle.from_folds(cfg, fold_params, name=name))
    return InferenceEngine(
        models=bundles,
        tta=not args.no_tta,
        et_min_voxels=0 if args.no_et_postprocess else 200,
        output_convention=args.convention,
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="braintpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("segment", help="ensemble segmentation only")
    p.add_argument("--input", required=True, help="case folder (or a root of case folders)")
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoints", help="checkpoint root: model{1,2}/fold_N.npz layout")
    p.add_argument("--models", default="model1,model2", help="comma list: model1,model2")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--convention", choices=["internal", "brats2025", "brats2021"],
                   default="brats2025", help="label convention of saved segmentations")
    p.add_argument("--no-tta", action="store_true")
    p.add_argument("--no-et-postprocess", action="store_true")
    p.add_argument("--random-weights", action="store_true",
                   help="random init for folds without a checkpoint (demo/bench)")
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy case of the standard bucket before the first case")
    p.add_argument("--device", default=None, help="torch device; default: the card (cuda)")
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("evaluate", help="Dice/IoU/sensitivity/specificity vs ground truth")
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    p.set_defaults(fn=cmd_evaluate)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
