"""The walk of the up-conv kernel's launch plan (``tests/test_torch_upconv_plan.py``)
held against the JAX package's Pallas kernel in interpret mode.

The walk repeats the Hopper kernel's tiling in f32 (tiles of whole W rows,
column slices of each phase pair's run, each run written into the lanes
view); the Pallas kernel (``braintpu/ops/upconv_pallas.py::upconv2x``,
lanes strategy) runs as the JAX package's own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ops.upconv_pallas import upconv2x as jax_upconv2x
from braintpu.ops.upconv_pallas import upconv2x_supported

from braintpu_torch.ops.upconv_plan import upconv_plan
from test_torch_upconv_plan import walk


@pytest.mark.parametrize("N,D,H,W,ci,co", [(1, 2, 8, 9, 24, 24), (2, 2, 8, 8, 72, 40)])
def test_walk_of_the_plan_matches_pallas_interpret(N, D, H, W, ci, co):
    assert upconv2x_supported((N, D, H, W, ci), co)
    rng = np.random.default_rng(N + D + H + W + ci + co)
    x = torch.from_numpy(rng.standard_normal((N, D, H, W, ci)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((ci, 2, 2, 2, co)) / np.sqrt(ci))
                         .astype(np.float32)).bfloat16()
    ref = np.asarray(jax_upconv2x(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(w.float().numpy(), jnp.bfloat16), interpret=True),
                     np.float32)
    plan = upconv_plan(N, D, H, W, ci, co)
    y, writes = walk(plan, x, w)
    assert (writes == 1).all()
    got = y.bfloat16().float().numpy()
    # both round one f32 sum per element to bf16; summed in another order, a
    # rare value may land on the neighbouring bf16 (one ulp of 8 bits)
    mag = np.maximum(np.abs(ref), np.float32(2.0**-126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)
    tol = np.maximum(ulp, 1e-6 * np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= tol)
