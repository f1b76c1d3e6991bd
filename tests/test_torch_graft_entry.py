"""The port's entry points (``braintpu_torch/graft_entry.py``): the
single-device forward check and the multi-rank dry run, beside the
reference's ``__graft_entry__.py``.

``entry()`` is held to the reference's contract (full-width MODEL1_BN,
BatchNorm folded, a 1 x 128^3 x 4 bf16 input) and its forward is run on a
32^3 crop of that input here (the whole 128^3 forward is about 1 TFLOP:
card work).  ``dryrun_multichip(n)`` runs every parallel path on ``n`` gloo
ranks on the CPU and prints the reference's summary line.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as jax_graft  # noqa: E402

from braintpu_torch import graft_entry  # noqa: E402
from braintpu_torch.models import unet3d  # noqa: E402

LINE = re.compile(r"dryrun_multichip OK: mesh=\{'data': (\d), 'model': (\d)\} loss=\S+ step=1 "
                  r"fold_psum_probs=\((\d), 16, 16, 16, 3\) fullconv_mirror_shards=(\d) "
                  r"spatial_shards=(\d) dp_patch_runner_cases=2 batched_engine_cases=2$")


def test_entry_returns_the_reference_forward_and_input():
    fn, (params, x) = graft_entry.entry(device="cpu")
    jfn, (jparams, jx) = jax_graft.entry()
    assert tuple(x.shape) == tuple(jx.shape) == (1, 128, 128, 128, 4)
    assert x.dtype == torch.bfloat16 and str(jx.dtype) == "bfloat16"
    assert set(params) == set(jparams) and "mean" not in params["encoder"][0][0]
    # folded as the reference folds (the reference in f16, the port in f32)
    np.testing.assert_allclose(params["encoder"][0][0]["b"].numpy(),
                               np.asarray(jparams["encoder"][0][0]["b"], np.float32), atol=1e-3)
    logits = fn(params, x[:, :32, :32, :32])
    assert tuple(logits.shape) == (1, 32, 32, 32, 3) and torch.isfinite(logits).all()
    if not torch.cuda.is_available():  # the card by default, as every entry point
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_runs_every_path(n, capsys):
    report = graft_entry.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = LINE.match(line)
    assert m, line
    model = 2 if n >= 4 else 1
    assert tuple(int(v) for v in m.groups()) == (n // model, model, n // model, n, n // model)
    assert report["line"] == line and report["route"] == "gloo-cpu-allreduce"
    assert report["spatial_traffic"]["halo"]["calls"] > 0
    assert report["spatial_traffic"]["stats"]["calls"] > 0  # instance norm over the slabs
