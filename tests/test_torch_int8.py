"""The port's int8 matrix product (``ops/int8_probe.py``) and its probe entry
point, held against the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode, as the JAX package's own test runs
it; the port's CPU path is its plain version.  The card-only checks of the
kernel are in ``test_torch_port.py``, which imports no JAX (the machine with
the card has none).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.ops.int8_probe import int8_matmul as jax_int8_matmul
from braintpu.ops.int8_probe import xla_int8_matmul

from braintpu_torch.ops.int8_probe import int8_matmul, int8_matmul_ref
from braintpu_torch.tools import probe

REPO = Path(__file__).resolve().parent.parent


def _operands(seed, M, K, N):
    """Seeded int8 operands over the whole range, -128 included."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    y = rng.integers(-128, 128, (K, N)).astype(np.int8)
    x[0, :] = -128  # the corner values the kernel must take
    y[:, 0] = -128
    return x, y


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 512, 384, 128, 128, 128),
    (512, 128, 256, 128, 256, 128),
    (384, 256, 128, 128, 128, 256),
    # blocks that leave K and N off the card kernel's 16-byte chunks
    (32, 24, 32, 8, 8, 8),
    (40, 84, 50, 8, 10, 12),
])
def test_plain_version_is_bit_equal_to_pallas_interpret_and_xla(M, K, N, bm, bn, bk):
    x, y = _operands(M + K + N, M, K, N)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(y), bm=bm, bn=bn, bk=bk,
                                     interpret=True))
    xla = np.asarray(xla_int8_matmul(jnp.asarray(x), jnp.asarray(y)))
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(y), bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), xla)
    # -128 x -128 summed over a row and a column reaches the int32 result
    assert got[0, 0].item() == int(np.dot(x[0].astype(np.int64), y[:, 0].astype(np.int64)))


@pytest.mark.parametrize("M,K,N", [(200, 128, 128), (128, 200, 128), (128, 128, 200)])
def test_ragged_shape_raises_in_both_packages(M, K, N):
    x, y = _operands(0, M, K, N)
    with pytest.raises(AssertionError):
        jax_int8_matmul(jnp.asarray(x), jnp.asarray(y), bm=128, bn=128, bk=128, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        int8_matmul(torch.from_numpy(x), torch.from_numpy(y), bm=128, bn=128, bk=128)


def test_wrapper_checks_types_and_counts_no_launch_on_the_cpu():
    x, y = _operands(1, 64, 32, 48)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = int8_matmul.launches
    got = int8_matmul(tx, ty, bm=16, bn=16, bk=16)
    assert torch.equal(got, int8_matmul_ref(tx, ty))
    assert int8_matmul.launches == before  # the plain version is no launch
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(tx.to(torch.int16), ty, bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="expected x"):
        int8_matmul(tx, ty[:16], bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        int8_matmul(tx.to("meta"), ty.to("meta"), bm=16, bn=16, bk=16)


def test_probe_runs_the_reference_shapes_and_blocks():
    text = (REPO / "tools" / "tpu_probe.py").read_text()
    calls = re.findall(r'^bench\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), "([^"]+)"\)', text, re.M)
    want = [(label, *map(int, nums)) for *nums, label in calls]
    assert len(want) == 4
    assert [tuple(s) for s in probe.INT8_SHAPES] == want


def test_probe_bound_is_operations_for_the_cube_and_bytes_for_stage_shapes():
    ms, by = probe.int8_bound_ms(4096, 4096, 4096)
    assert by == "operations" and ms == pytest.approx(2 * 4096**3 / 1979e12 * 1e3)
    for _, M, K, N, *_ in probe.INT8_SHAPES[1:]:
        ms, by = probe.int8_bound_ms(M, K, N)
        assert by == "bytes" and ms == pytest.approx((M * K + K * N + 4 * M * N) / 3.35e12 * 1e3)


def test_probe_without_a_card_exits_nonzero_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = tmp_path / "probe.jsonl"
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main(["int8", "--log", str(log)])
    assert not log.exists()


def test_probe_and_pipeline_import_without_a_card():
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import braintpu_torch.tools.probe, braintpu_torch.pipeline, braintpu_torch.cli\n"
        "print(torch.cuda.is_initialized())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
