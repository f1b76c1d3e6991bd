"""Command-line interface of the port.

    python -m braintpu_torch.cli pipeline CASE_DIR [CASE_DIR ...] --output OUT \\
        --checkpoints results/trained_synth/checkpoints --folds 2
    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT \\
        --checkpoints results/trained_synth/checkpoints --models model1,model2 --folds 2
    python -m braintpu_torch.cli segment --input CASES --output OUT --batch-cases 2 ...
    python -m braintpu_torch.cli segment --input CASES --output OUT --batch-cases 2 \
        --dp-devices 2 [--device cpu] ...
    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT --dp-devices 2 \
        --spatial-shard ...
    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT --models axial \\
        --folds 1 --random-weights
    python -m braintpu_torch.cli evaluate --pred OUT/CASE.nii.gz --gt CASE_seg.nii.gz
    python -m braintpu_torch.cli features --input CASE_DIR --segmentation SEG --output DIR
    python -m braintpu_torch.cli report --summary DIR/llm_ready_summary.json
    python -m braintpu_torch.cli pdf --report DIR/radiology_report.txt
    python -m braintpu_torch.cli convert-labels SEG [OUT] --format brats2025
    python -m braintpu_torch.cli check-labels SEG
    python -m braintpu_torch.cli rename CASE_DIR [--dry-run]
    python -m braintpu_torch.cli init-config [braintpu_torch.config.json]
    python -m braintpu_torch.cli pipeline CASE_DIR --config braintpu_torch.config.json
    python -m braintpu_torch.cli serve --port 8000 --root serve_data \\
        --checkpoints results/trained_synth/checkpoints --folds 2 --random-weights
    python -m braintpu_torch.cli rag --question "What is midline shift?" [--report R]
    python -m braintpu_torch.cli build-kb --output kb.npz [--knowledge-dir DIR]
    python -m braintpu_torch.cli check-env [--checkpoints DIR]
    python -m braintpu_torch.cli train --model model1 --data CASES --checkpoint-dir CK
    python -m braintpu_torch.cli train --data CASES --batch-size 2 --dp-devices 2 [--device cpu]
    python -m braintpu_torch.cli convert-checkpoint --input fold_0/model_final_checkpoint.model \
        --output ckpts/model1/fold_0.npz --config model1
    python -m braintpu_torch.cli convert-checkpoint --input nnUNet_results --output ckpts
    python -m braintpu_torch.cli segment --input CASE_DIR --output OUT --trace-dir TRACE ...
    python -m braintpu_torch.cli profile-report TRACE [--line "XLA Ops"] [--top 30]
    python -m braintpu_torch.cli visualize --input CASE_DIR --segmentation SEG --output DIR
    python -m braintpu_torch.cli compare --gt GT --pred PRED --output grid.png [--background MRI]
    python -m braintpu_torch.cli data [--root BRATS_ROOT]

The subcommands and flags follow ``braintpu/cli.py`` for what the port has
(``--models`` from model1, model2, axial and axial-full, checkpoints as npz
folds, nnU-Net ``.model`` files or a raw nnU-Net results tree,
``--random-weights``, ``--mode {sliding,fullconv}`` with fullconv as the
default unless an axial model is selected, as the reference's
``load_engine`` chooses, ``--ensemble {softmax,label}``, ``segment
--batch-cases N``, ``segment --trace-dir``, ``profile-report``,
``visualize``, ``compare``, ``data``), plus
``--device`` on the commands that build an engine or a vector store: the
card by default, ``cpu`` only when asked for.  ``profile-report`` reads the
``torch.profiler`` Chrome trace that ``segment --trace-dir`` writes: its
``--line "XLA Ops"`` tables the card's kernels, ``"XLA Modules"`` the
top-level host ops.  One deliberate change:
``serve`` exits non-zero when its warm-up fails (the reference prints that
the first request will compile and serves on), because warm-up is where
the kernels build and load, and no job could succeed after it failed.

``--dp-devices N`` (N > 1) runs N ranks (``parallel.launch.spawn``), each
the same command on its share: on the card one card per rank with
``nccl`` (N must not exceed the visible cards), with ``--device cpu`` N
``gloo`` ranks on the CPU.  Rank 0 prints and writes the files.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

__all__ = ["build_parser", "load_engine", "main"]


def _engine_mode(args) -> str:
    """``--mode``, or its default for the selected models (fullconv unless an
    axial model is selected); exits on fullconv with an axial model."""
    configs = _model_configs()
    selected = [n.strip() for n in args.models.split(",") if n.strip()]
    unknown = [n for n in selected if n not in configs]
    if unknown:
        raise SystemExit(f"unknown model(s) {unknown}; choose from {sorted(configs)}")
    axial_selected = [n for n in selected if configs[n].axial_attention]
    if args.mode is None:
        args.mode = "sliding" if axial_selected else "fullconv"
    elif args.mode == "fullconv" and axial_selected:
        raise SystemExit(
            f"--mode fullconv is incompatible with axial models "
            f"{axial_selected} (patch-shape-bound positional embeddings); "
            "use --mode sliding")
    return args.mode


def load_engine(args, mesh=None):
    """Build an InferenceEngine from ``--checkpoints``/``--models``/``--folds``.

    Each fold is read from the first of the reference's three sources that
    holds it: ``<checkpoints>/<model>/fold_<f>.npz``, then
    ``<checkpoints>/<model>/fold_<f>/model_final_checkpoint.model`` (an
    nnU-Net checkpoint, converted), then a raw nnU-Net results tree under
    ``<checkpoints>`` (discovered once, at the first fold that needs it).
    A fold found in none of them raises,
    unless ``--random-weights`` is given: then it gets ``init_params(cfg,
    selected.index(name) * 1000 + f)``, as in the reference (a name listed
    twice draws the same folds twice).  The label convention is
    ``--convention`` where the subcommand has it, else internal labels (the
    pipeline converts in its own stage).  Without ``--mode`` the engine runs
    fullconv, unless an axial model is selected: then sliding (their
    positional embeddings are bound to the patch shape), as the reference's
    ``load_engine`` chooses; ``--mode fullconv`` with an axial model exits
    with the reference's message.  ``InferenceEngine`` itself defaults to
    sliding.  Prints, per model, which folds were loaded and which were
    drawn, and the engine's mode.  ``mesh``: a ``parallel.mesh.Mesh`` of
    this rank (the engine then runs on the mesh's device); ``--spatial-shard``
    splits each case's X axis over it.
    """
    from .ckpt.convert import convert_torch_checkpoint
    from .ckpt.npz import load_pytree_npz, params_from_jax
    from .infer.engine import InferenceEngine, ModelBundle
    from .models.unet3d import init_params

    configs = _model_configs()
    _engine_mode(args)
    selected = [n.strip() for n in args.models.split(",") if n.strip()]
    nnunet_tree = None  # a raw nnU-Net results tree, discovered at first need

    def nnunet_fold(name: str, f: int):
        nonlocal nnunet_tree
        if nnunet_tree is None:
            from .ckpt.discover import discover_nnunet_tree

            nnunet_tree = discover_nnunet_tree(args.checkpoints)
        entry = nnunet_tree.get(name)
        return entry.folds.get(f) if entry else None

    def read_fold(name: str, f: int, cfg):
        """The fold's reference-layout tree from the first source holding it."""
        if not args.checkpoints:
            return None
        root = Path(args.checkpoints)
        npz = root / name / f"fold_{f}.npz"
        if npz.exists():
            return load_pytree_npz(npz)
        model = root / name / f"fold_{f}" / "model_final_checkpoint.model"
        if not model.exists():
            model = nnunet_fold(name, f)
        if model is None:
            return None
        print(f"# {name}/fold_{f}: converting {model}", flush=True)
        return convert_torch_checkpoint(model, cfg)

    bundles = []
    for name in selected:
        cfg = configs[name]
        seed0 = selected.index(name) * 1000  # a repeated name draws the same folds
        fold_params, loaded, drawn = [], [], []
        for f in range(args.folds):
            tree = read_fold(name, f, cfg)
            if tree is not None:
                fold_params.append(params_from_jax(tree, cfg))
                loaded.append(f)
            elif args.random_weights:
                fold_params.append(init_params(cfg, seed0 + f))
                drawn.append(f"{f} (seed {seed0 + f})")
            else:
                raise SystemExit(f"checkpoint for {name}/fold_{f} not found under "
                                 f"{args.checkpoints!r}; pass --random-weights for a dry run")
        print(f"# {name}: folds loaded {loaded or 'none'}; random {drawn or 'none'}", flush=True)
        bundles.append(ModelBundle.from_folds(cfg, fold_params, name=name))
    print(f"# engine: mode {args.mode}, ensemble {args.ensemble}, tta {not args.no_tta}",
          flush=True)
    return InferenceEngine(
        models=bundles,
        tta=not args.no_tta,
        ensemble=args.ensemble,
        mode=args.mode,
        et_min_voxels=0 if args.no_et_postprocess else 200,
        output_convention=getattr(args, "convention", None) or "internal",
        device=args.device if mesh is None else None,
        mesh=mesh,
        spatial_shard=bool(getattr(args, "spatial_shard", False)) and mesh is not None,
    )


def _model_configs():
    from .models.unet3d import AXIAL_UNET, AXIAL_UNET_FULL, MODEL1_BN, MODEL2_GN_LARGE

    return {"model1": MODEL1_BN, "model2": MODEL2_GN_LARGE, "axial": AXIAL_UNET,
            "axial-full": AXIAL_UNET_FULL}


def _dp_devices(n: int, device, what: str = "device(s) visible") -> list:
    """The ranks' devices for ``--dp-devices n``: ``n`` CPU ranks with
    ``--device cpu``, else one card each (exits when fewer are visible)."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise SystemExit(f"--dp-devices {n} but only {count} {what}")
    return [f"cuda:{i}" for i in range(n)]


def cmd_segment(args) -> int:
    from .io.brats import find_cases

    cases = find_cases(args.input)
    if not cases:
        raise SystemExit(f"no complete BraTS case under {args.input}")
    n = args.dp_devices
    devices = _dp_devices(n, args.device) if n > 1 else None
    mode = _engine_mode(args)
    if args.spatial_shard:
        if devices is None:
            raise SystemExit("--spatial-shard requires --dp-devices N (N > 1)")
        if mode != "fullconv":
            raise SystemExit("--spatial-shard requires --mode fullconv")
    # the path is decided once, so the mode check fires before the warm-up
    # and the warm-up runs the batch shape the run will use
    use_batched = args.batch_cases > 0 and len(cases) > 1
    if use_batched and mode != "fullconv":
        raise SystemExit("--batch-cases requires --mode fullconv")
    if use_batched and args.spatial_shard:
        raise SystemExit(
            "--batch-cases and --spatial-shard are mutually exclusive: "
            "batching is case-data-parallel (one whole volume per chip), "
            "spatial sharding splits ONE volume across chips. Drop one.")
    if devices is not None and not args.spatial_shard and not use_batched:
        print(
            "# warning: --dp-devices builds a device mesh, but this run "
            "takes the per-case path (single case or no --batch-cases) "
            "which does not use it; add --batch-cases N with multiple "
            "cases, or --spatial-shard, to engage the mesh")
    if devices is None:
        return _segment(args, cases, use_batched)
    from .parallel.launch import spawn

    print(f"# {n} ranks on {', '.join(devices)}", flush=True)
    return max(spawn(_segment_rank, n, devices=devices, args=(args, use_batched)))


def _rank_mesh(n: int):
    """This rank's ``data = n`` mesh, and a context that silences its prints
    unless it is rank 0."""
    import contextlib
    import io

    from .parallel.mesh import make_mesh

    mesh = make_mesh(data=n)
    quiet = contextlib.nullcontext() if mesh.is_main else contextlib.redirect_stdout(io.StringIO())
    return mesh, quiet


def _segment_rank(args, use_batched: bool) -> int:
    """One rank of ``segment --dp-devices N``: rank 0 prints and writes."""
    from .io.brats import find_cases

    mesh, quiet = _rank_mesh(args.dp_devices)
    with quiet:
        return _segment(args, find_cases(args.input), use_batched, mesh)


def _segment(args, cases, use_batched: bool, mesh=None) -> int:
    import contextlib

    engine = load_engine(args, mesh=mesh)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    if args.warmup:
        print(f"# warmup: {engine.warmup(batch_size=args.batch_cases if use_batched else 0):.1f}s")
    trace_ctx = contextlib.nullcontext()
    if args.trace_dir and (mesh is None or mesh.is_main):
        from .utils.profiling import device_trace

        trace_ctx = device_trace(args.trace_dir)
        print(f"capturing device trace to {args.trace_dir} "
              "(analyze with: braintpu_torch profile-report <dir>)", flush=True)
    with trace_ctx:
        return _run_segment(args, engine, cases, out, use_batched)


def _run_segment(args, engine, cases, out: Path, use_batched: bool) -> int:
    from .io.brats import CasePrefetcher

    if use_batched:
        for _, info in engine.predict_cases_batched(cases, output_dir=out,
                                                    batch_size=args.batch_cases):
            print(f"{info['case_id']}: batch of {info['batch_size']} in "
                  f"{info['batch_seconds']:.1f}s  volumes={info['volumes_cm3']}")
        return 0
    # the next case decodes on a host thread while the device segments this
    # one; over a mesh rank 0 writes
    writes = engine.mesh is None or engine.mesh.is_main
    for case, loaded in CasePrefetcher(cases):
        seg, info = engine.predict_case(case, out / f"{case.case_id}.nii.gz" if writes else None,
                                        loaded=loaded)
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

    if args.config:
        from .utils.config import load_config

        fc = load_config(args.config)
        s = fc.segmentation
        args.models = ",".join(s.models)
        args.folds = s.folds
        args.no_tta = not s.tta
        args.ensemble = s.ensemble
        args.no_et_postprocess = s.et_min_voxels == 0
        args.checkpoints = args.checkpoints or s.checkpoints
        # the config's mode is applied before the engine is built, as the
        # reference does (its load_engine validates the mode per model)
        args.mode = s.mode
        engine = load_engine(args)
        engine.step_size = s.step_size
        engine.et_min_voxels = s.et_min_voxels
        cfg = fc.pipeline_config()
    else:
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


def cmd_visualize(args) -> int:
    from .viz import visualize_case

    written = visualize_case(args.input, args.segmentation, args.output, args.num_slices)
    for p in written:
        print(f"saved: {p}")
    return 0


def cmd_compare(args) -> int:
    from .viz import compare_segmentations

    out = compare_segmentations(args.gt, args.pred, args.output, args.background)
    print(f"saved: {out}")
    return 0


def cmd_data(args) -> int:
    """BraTS data access guide + optional local-folder audit (parity with
    the upstream downloader helper, download_more_brats_data.py:13-30: an
    instructions printer; BraTS data is gated and cannot be fetched
    anonymously, so nothing is downloaded)."""
    if args.root:
        from .io.brats import find_cases

        # find_cases already returns only complete cases
        complete = find_cases(args.root)
        with_gt = [c for c in complete if c.seg_path]
        print(f"{args.root}: {len(complete)} complete cases, {len(with_gt)} with ground truth")
        for c in complete[:20]:
            print(f"  {c.case_id}  (gt={'yes' if c.seg_path else 'no'})")
        if len(complete) > 20:
            print(f"  ... and {len(complete) - 20} more")
        return 0
    print(
        """BraTS data is gated behind Synapse registration (no anonymous download):

1. Create an account at https://www.synapse.org
2. Request access to the BraTS challenge project:
     BraTS 2021: syn25829067      BraTS 2023+ (GLI): syn51156910
3. Accept the data-use agreement, then download the training archive
   via the web UI or the synapse CLI:
     pip install synapseclient
     synapse get -r <syn-id>
4. Point the framework at the extracted folder:
     braintpu_torch data --root /path/to/BraTS   # audit what you have
     braintpu_torch pipeline /path/to/BraTS/<case_folder>

Each case folder must contain the four modalities
(<case>_t1 / _t1ce / _t2 / _flair, or 2025 naming t1n/t1c/t2w/t2f —
run `braintpu_torch rename` to convert) as .nii/.nii.gz, plus optional _seg."""
    )
    return 0


def cmd_profile_report(args) -> int:
    from .utils.xprof import aggregate_trace, format_table

    ops = aggregate_trace(args.trace, line=args.line)
    print(format_table(ops, top=args.top))
    return 0


def cmd_init_config(args) -> int:
    from .utils.config import FrameworkConfig, save_config

    save_config(FrameworkConfig(), args.output)
    print(f"wrote default config → {args.output}")
    return 0


def cmd_rag(args) -> int:
    from .rag import RagAssistant, build_vector_store, load_vector_store

    store = load_vector_store(args.store, device=args.device) if args.store else \
        build_vector_store(knowledge_dir=args.knowledge_dir, device=args.device)
    assistant = RagAssistant(store=store)
    report_text = Path(args.report).read_text(encoding="utf-8") if args.report else ""
    if args.question:
        print(assistant.answer_query(args.question, report_text))
        return 0
    if args.test:
        sample_questions = [
            "What is midline shift?",
            "What does peritumoral edema mean?",
            "Why does a tumor enhance with contrast?",
            "What is the whole tumor volume?",
            "What MRI sequences were used?",
            "What is a glioma?",
        ]
        for q in sample_questions:
            best = store.retrieve(q, 2)[0]
            print(f"Q: {q}\n   → {best[0].title} (score {best[1]:.3f})")
        return 0
    assistant.interactive(report_text)
    return 0


def cmd_build_kb(args) -> int:
    from .rag import build_vector_store

    store = build_vector_store(knowledge_dir=args.knowledge_dir, device=args.device)
    store.save(args.output)
    print(f"embedded {len(store.docs)} documents → {args.output} "
          f"(top-k route when queried: {store.route})")
    return 0


def cmd_serve(args) -> int:
    import threading

    from .serve import make_server

    engine = load_engine(args)
    server = make_server(engine, Path(args.root), host=args.host, port=args.port)
    failed = []
    if not args.no_warmup:
        # build the kernels and run one dummy case off the request path, on
        # a thread so that the port binds at once.  A failure here (nvcc, a
        # library that does not load, a kernel that does not launch) means
        # no job can succeed: stop the server and exit non-zero.
        def _warm():
            try:
                print(f"engine warmup done in {engine.warmup():.1f}s", flush=True)
            except Exception as e:
                failed.append(e)
                print(f"engine warmup failed, shutting down: {type(e).__name__}: {e}", flush=True)
                server.shutdown()

        threading.Thread(target=_warm, daemon=True, name="engine-warmup").start()
    print(f"serving on http://{args.host}:{server.server_address[1]}  (root: {args.root})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 1 if failed else 0


def cmd_check_env(args) -> int:
    from .utils import format_env_report, run_env_checks

    checks = run_env_checks(Path(args.checkpoints) if args.checkpoints else None)
    print(format_env_report(checks))
    return 0 if all(c["ok"] for c in checks) else 1


def cmd_convert_checkpoint(args) -> int:
    from .ckpt.convert import convert_torch_checkpoint
    from .ckpt.discover import convert_nnunet_tree
    from .ckpt.npz import save_pytree_npz
    from .models.unet3d import MODEL1_BN, MODEL2_GN_LARGE

    if Path(args.input).is_dir():
        # a whole nnU-Net results tree -> <output>/<model>/fold_<n>.npz
        written = convert_nnunet_tree(
            args.input, args.output, configs={"model1": MODEL1_BN, "model2": MODEL2_GN_LARGE},
            folds=[int(f) for f in args.tree_folds.split(",")] if args.tree_folds else None)
        for p in written:
            print(f"  {p}")
        print(f"converted {len(written)} fold checkpoint(s) from {args.input} → {args.output}")
        return 0
    cfg = MODEL1_BN if args.config == "model1" else MODEL2_GN_LARGE
    save_pytree_npz(convert_torch_checkpoint(args.input, cfg), args.output)
    print(f"converted {args.input} → {args.output} ({args.config})")
    return 0


def cmd_train(args) -> int:
    """``train``: the reference's ``cmd_train`` on the port's trainer (the
    card unless ``--device cpu``).  Resumable: rerun with more ``--steps``.
    ``--dp-devices N`` trains data-parallel over N ranks (the batch split
    over them, the gradient averaged; rank 0 prints and writes the
    checkpoints)."""
    import dataclasses

    from .io.brats import find_cases

    cfg = _model_configs()[args.model]
    if args.patch:
        cfg = dataclasses.replace(cfg, patch_size=tuple(int(v) for v in args.patch.split(",")))
    if not [c for c in find_cases(args.data) if c.seg_path is not None]:
        raise SystemExit(f"no cases with _seg ground truth under {args.data}")
    n = args.dp_devices
    if n <= 1:
        return _train(args, cfg)
    devices = _dp_devices(n, args.device, what="device(s)")
    if args.batch_size % n:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be a multiple of "
            f"--dp-devices {n} (per-device batch sharding)")
    if cfg.dropout_rate > 0:
        raise SystemExit("--dp-devices training does not support dropout_rate > 0")
    from .parallel.launch import spawn

    return max(spawn(_train_rank, n, devices=devices, args=(args, cfg)))


def _train_rank(args, cfg) -> int:
    """One rank of ``train --dp-devices N``: rank 0 prints and writes."""
    mesh, quiet = _rank_mesh(args.dp_devices)
    with quiet:
        return _train(args, cfg, mesh)


def _train(args, cfg, mesh=None) -> int:
    import torch

    from .io.brats import find_cases
    from .models.unet3d import init_params
    from .train.augment import AugmentConfig
    from .train.data import PatchSampler
    from .train.trainer import TrainConfig, create_train_state, fit
    from .utils.device import resolve_device

    cases = [c for c in find_cases(args.data) if c.seg_path is not None]
    device = resolve_device(args.device) if mesh is None else mesh.device
    print(f"training {args.model} on {len(cases)} cases, patch {cfg.patch_size}, device {device}")
    # under --dp-devices every rank draws the same global batches
    sampler = PatchSampler(cases, patch_size=cfg.patch_size, batch_size=args.batch_size,
                           seed=args.seed, augment=AugmentConfig() if args.augment else None)
    tc = TrainConfig(base_lr=args.lr, max_steps=args.steps)
    state = create_train_state(init_params(cfg, args.seed), tc, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)  # dropout draws
    step_fn = None
    if mesh is not None:
        from .parallel import make_sharded_train_step, shard_train_state

        state, layout = shard_train_state(state, cfg, mesh)
        step_fn = make_sharded_train_step(mesh, cfg, tc, layout)
        print(f"data-parallel training over mesh {dict(mesh.shape)}")

    def log(m):
        step = int(m["step"])
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:>7}  loss {m['loss']:.4f}  |g| {m['grad_norm']:.3f}", flush=True)

    state = fit(state, iter(sampler), cfg, tc, num_steps=args.steps,
                checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                generator=generator, on_metrics=log, step_fn=step_fn)
    print(f"done at step {int(state.step)}; checkpoints in {args.checkpoint_dir}")
    return 0


def _add_engine_args(p, convention_default=None) -> None:
    """The flags that build an engine (see :func:`load_engine`)."""
    p.add_argument("--checkpoints", help="checkpoint root: model{1,2}/fold_N.npz, "
                   "model{1,2}/fold_N/model_final_checkpoint.model, or an nnU-Net results tree")
    p.add_argument("--models", default="model1,model2",
                   help="comma list of model1, model2, axial, axial-full")
    p.add_argument("--folds", type=int, default=5)
    if convention_default:
        p.add_argument("--convention", choices=["internal", "brats2025", "brats2021"],
                       default=convention_default, help="label convention of saved segmentations")
    p.add_argument("--no-tta", action="store_true")
    p.add_argument("--ensemble", choices=["softmax", "label"], default="softmax",
                   help="softmax: mean of the models' region probabilities, then the ET rule; "
                        "label: round(mean of the models' label maps), no ET rule")
    p.add_argument("--mode", choices=["sliding", "fullconv"], default=None,
                   help="fullconv (default for non-axial models): one whole-volume forward per "
                        "fold and mirror; sliding (default for axial models): 128^3 patches at "
                        "50%% overlap, Gaussian-blended")
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
    p.add_argument("--config", help="FrameworkConfig JSON (overrides flag defaults)")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("init-config", help="write the default FrameworkConfig JSON")
    p.add_argument("output", nargs="?", default="braintpu_torch.config.json")
    p.set_defaults(fn=cmd_init_config)

    p = sub.add_parser("segment", help="ensemble segmentation only")
    p.add_argument("--input", required=True, help="case folder (or a root of case folders)")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-cases", type=int, default=0,
                   help="batch N cases of one bucket through whole-volume inference "
                        "together (fullconv mode only)")
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy case of the standard bucket (at the batch shape with "
                        "--batch-cases) before the first case")
    p.add_argument("--dp-devices", type=int, default=0,
                   help="shard each --batch-cases batch case-wise across this many ranks "
                        "(one card each; with --device cpu, CPU ranks); fullconv mode only")
    p.add_argument("--spatial-shard", action="store_true",
                   help="with --dp-devices N and --mode fullconv: shard each single case's X "
                        "axis across the ranks (halo exchange; per-rank memory and single-case "
                        "latency instead of throughput)")
    p.add_argument("--trace-dir",
                   help="capture a torch.profiler trace of the run (host ops and the card's "
                        "kernels) into this directory (analyze with 'profile-report')")
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

    store_device = "device of a large store's top-k; default: the card (cuda)"
    p = sub.add_parser("rag", help="educational Q&A assistant")
    p.add_argument("--report")
    p.add_argument("--question")
    p.add_argument("--store")
    p.add_argument("--knowledge-dir")
    p.add_argument("--test", action="store_true", help="run canned retrieval checks")
    p.add_argument("--device", default=None, help=store_device)
    p.set_defaults(fn=cmd_rag)

    p = sub.add_parser("build-kb", help="embed a knowledge base into a vector store")
    p.add_argument("--knowledge-dir")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default=None, help=store_device)
    p.set_defaults(fn=cmd_build_kb)

    p = sub.add_parser("serve", help="REST API + web UI")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--root", default="serve_data")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the background kernel build and dummy case at startup")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("check-env", help="environment preflight checks")
    p.add_argument("--checkpoints")
    p.set_defaults(fn=cmd_check_env)

    p = sub.add_parser("train", help="train a U-Net on BraTS cases (checkpointed, resumable)")
    p.add_argument("--data", required=True, help="folder of BraTS cases with _seg ground truth")
    p.add_argument("--model", choices=["model1", "model2", "axial"], default="model1")
    p.add_argument("--steps", type=int, default=250000)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--patch", help="override patch size, e.g. 128,128,128")
    p.add_argument("--augment", action="store_true", help="nnU-Net-style data augmentation")
    p.add_argument("--checkpoint-dir", default="train_ckpts")
    p.add_argument("--checkpoint-every", type=int, default=250)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp-devices", type=int, default=0,
                   help="data-parallel training: shard the batch over this many ranks (one "
                        "card each; with --device cpu, CPU ranks); batch-size must divide evenly")
    p.add_argument("--device", default=None, help="torch device; default: the card (cuda)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("convert-checkpoint",
                       help="torch nnU-Net .model → .npz (file, or a whole nnUNet_results tree "
                            "when --input is a directory)")
    p.add_argument("--input", required=True, help=".model file OR nnU-Net results-tree root")
    p.add_argument("--output", required=True,
                   help=".npz path (file mode) OR checkpoint root dir (tree mode)")
    p.add_argument("--config", choices=["model1", "model2"], default="model1",
                   help="architecture of a single .model file (ignored in tree mode)")
    p.add_argument("--tree-folds", help="tree mode: comma-separated fold subset, e.g. 0,1,2,3,4")
    p.set_defaults(fn=cmd_convert_checkpoint)

    p = sub.add_parser("rename", help="BraTS-2025 → 2021 filename conversion")
    p.add_argument("folder")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_rename)

    p = sub.add_parser("visualize", help="segmentation overlay PNGs per modality")
    p.add_argument("--input", required=True)
    p.add_argument("--segmentation", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num-slices", type=int, default=9)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("compare", help="GT vs prediction comparison grid")
    p.add_argument("--gt", required=True)
    p.add_argument("--pred", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--background", help="optional MRI for the underlay")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("data", help="BraTS dataset access instructions / local audit")
    p.add_argument("--root", help="audit an existing local dataset folder")
    p.set_defaults(fn=cmd_data)

    p = sub.add_parser("profile-report",
                       help="per-op time table from a torch.profiler trace (segment --trace-dir)")
    p.add_argument("trace", help="trace dir (newest capture) or a .pt.trace.json[.gz] file")
    p.add_argument("--line", default="XLA Ops",
                   help='"XLA Ops" (the card\'s kernels) or "XLA Modules" (top-level host ops)')
    p.add_argument("--top", type=int, default=30)
    p.set_defaults(fn=cmd_profile_report)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
