"""The X-sharded two-model forward of one case on ranks with a card each.

    python -m braintpu_torch.tools.sharded_case [--ranks N] [--seed 200]
        [--shape 240,240,155] [--device cpu] [--log PATH]

Writes a synthetic BraTS case (``train.synthetic.write_synth_case``, the
seed-200 case of the chip smoke by default) to a temporary directory and
starts ``N`` ranks (``parallel.launch.spawn``): one card each with ``nccl``
(``cuda:0`` .. ``cuda:N-1``), or ``N`` ``gloo`` ranks with ``--device cpu``.
Each rank runs, for model 1 and for model 2 at full width in bf16 (random
``init_params`` folds, one fold, no mirrors), the unsharded forward and
:func:`braintpu_torch.infer.fullconv.fullconv_predict_spatial` twice each
and the unsharded forward in f32 (``parallel.scenarios.two_model_case``),
then times one halo exchange and one statistics all-reduce
(``parallel.scenarios.collective_times``).

It prints one JSON line per model with each rank's seconds (the second run
of each path), peak memory, collective traffic and kernel launches, the
labels' agreement with the unsharded forward, the largest probability
difference from it and from the f32 forward; then one line with the
collectives' times and the card's name and power limit.  It exits
non-zero when a check of the chip smoke's phase 14c fails: labels on at
least 0.99 of the voxels (the smoke's floor for random weights), and
against the f32 forward an error at most twice the unsharded bf16
forward's.  On one machine
with several cards this is the X-sharded path on ``nccl`` at full width;
the chip smoke runs the same scenario on two ``gloo`` ranks sharing one
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["main"]

#: both models' folds are random here (the smoke's model 1 is trained: 0.999)
LABEL_FLOOR = {"model1": 0.99, "model2": 0.99}


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="braintpu_torch.tools.sharded_case", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=200)
    ap.add_argument("--shape", default="240,240,155")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--log", metavar="PATH", help="append the JSON lines to PATH")
    args = ap.parse_args(argv)

    import torch

    from ..parallel.launch import spawn
    from ..parallel.scenarios import run
    from ..train.synthetic import write_synth_case

    n = args.ranks
    if args.device == "cpu":
        devices = ["cpu"] * n
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise SystemExit(f"--ranks {n} but only {count} card(s) visible")
        devices = [f"cuda:{i}" for i in range(n)]
    shape = tuple(int(s) for s in args.shape.split(","))
    lines = []
    with tempfile.TemporaryDirectory(prefix="braintpu_torch_sharded_") as tmp:
        case = Path(tmp) / "in"
        write_synth_case(case, f"BraTS-SYN-{args.seed:05d}-000", seed=args.seed, shape=shape)
        base = ["--input", str(case), "--output", str(Path(tmp) / "out"), "--folds", "1",
                "--no-tta", "--random-weights"]
        if args.device == "cpu":
            base += ["--device", "cpu"]
        specs = [(m, "two_model_case", dict(argv=base + ["--models", m], case_dir=str(case),
                                            paths=("plain", "spatial", "plain#2", "spatial#2",
                                                   "f32"),
                                            return_probs=False,
                                            diffs=(("spatial#2", "plain#2"),
                                                   ("spatial#2", "f32"), ("plain#2", "f32"))))
                 for m in ("model1", "model2")]
        specs.append(("t", "collective_times", dict(plane=(1, 1, 256, 256, 64), stats=(1, 64))))
        ranks = spawn(run, n, devices=devices, args=(specs,), timeout_s=1800)
    ok = True
    for m in ("model1", "model2"):
        per_rank = []
        for rk in ranks:
            sp, pl = rk[m]["spatial#2"], rk[m]["plain#2"]
            ma = {k: v[0] for k, v in rk[m]["max_abs"].items()}
            agree = float((sp["labels"] == pl["labels"]).mean())
            bound = 2 * ma["plain#2 vs f32"]
            ok &= agree >= LABEL_FLOOR[m] and ma["spatial#2 vs f32"] <= bound
            per_rank.append({"spatial_s": sp["seconds"], "unsharded_s": pl["seconds"],
                             "peak_bytes": sp["max_memory_allocated_bytes"],
                             "unsharded_peak_bytes": pl["max_memory_allocated_bytes"],
                             "traffic": sp["traffic"], "launches": sp["launches"],
                             "label_agreement": agree,
                             "probs_max_abs": ma["spatial#2 vs plain#2"],
                             "f32_max_abs": ma["spatial#2 vs f32"],
                             "unsharded_f32_max_abs": ma["plain#2 vs f32"],
                             "f32_error_bound": bound})
        lines.append({"model": m, "ranks": n, "route": ranks[0][m]["route"],
                      "bucket": list(ranks[0][m]["bucket"]), "per_rank": per_rank,
                      "label_floor": LABEL_FLOOR[m]})
    lines.append({"collective_times": ranks[0]["t"], "card": _card(), "ok": ok})
    for rec in lines:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.log:
            with open(args.log, "a") as f:
                f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
