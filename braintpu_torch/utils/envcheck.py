"""Environment preflight checks of the port (``cli check-env``).

Counterpart of ``braintpu/utils/envcheck.py`` (upstream
scripts/check_compatibility.py:16-70: interpreter, framework, accelerator,
packages, model files, data), re-targeted at this stack.

Required (a failure makes ``check-env`` exit 1): Python >= 3.10; torch built
with CUDA; a CUDA device of compute capability 9.0 (the kernels are built for
``sm_90a``); ``nvcc``, found the way the kernel build finds it; numpy; scipy;
with ``--checkpoints``, at least one ``.npz`` or ``.model`` file under it
(as the reference); the built-in knowledge base with its 7 documents or more
(as the reference).

Information only: ``g++`` (the native host library); whether each
``csrc/*.cu`` already has a library built under its current hash (else it
builds at first use, or at the server's warm-up); optional packages.
"""

from __future__ import annotations

import importlib
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["run_env_checks", "format_env_report"]

REQUIRED_PACKAGES = ["torch", "numpy", "scipy"]
OPTIONAL_PACKAGES = ["httpx", "matplotlib"]


def _check(name, ok, detail="", required=True):
    return {"check": name, "ok": bool(ok), "detail": str(detail), "required": required}


def _info(name, detail):
    return _check(name, True, detail, required=False)


def _torch_checks() -> List[Dict]:
    try:
        import torch
    except ImportError as e:
        return [_check("torch with CUDA", False, repr(e))]
    cuda = torch.version.cuda
    checks = [_check("torch with CUDA", cuda is not None,
                     f"{torch.__version__}, CUDA {cuda or 'none (a CPU-only build)'}")]
    if not torch.cuda.is_available():
        checks.append(_check("CUDA device (sm_90)", False, "no CUDA device visible"))
        return checks
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    checks.append(_check("CUDA device (sm_90)", cc == (9, 0),
                         f"{n} x {name}, compute capability {cc[0]}.{cc[1]} (9.0 expected)"))
    return checks


def run_env_checks(checkpoint_dir: Optional[Path] = None) -> List[Dict]:
    from ..ops import _build

    checks: List[Dict] = [_check(
        "python>=3.10", sys.version_info >= (3, 10),
        f"{sys.version_info.major}.{sys.version_info.minor}.{sys.version_info.micro}")]
    checks += _torch_checks()
    try:
        checks.append(_check("nvcc", True, _build._nvcc()))
    except RuntimeError as e:
        checks.append(_check("nvcc", False, e))
    for pkg in REQUIRED_PACKAGES[1:]:  # torch: its own checks above
        try:
            mod = importlib.import_module(pkg)
            checks.append(_check(f"package {pkg}", True, getattr(mod, "__version__", "?")))
        except ImportError as e:
            checks.append(_check(f"package {pkg}", False, repr(e)))

    gxx = shutil.which("g++")
    checks.append(_info("g++ (native host lib)", gxx or "absent: the host takes its Python routes"))
    for cu in sorted(_build.CSRC.glob("*.cu")):
        lib = _build._lib_path(cu.stem)
        checks.append(_info(f"kernel {cu.stem}", f"built: {lib.name}" if lib.exists()
                            else "not built yet (builds at first use or warm-up)"))
    for pkg in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(pkg)
            checks.append(_info(f"optional {pkg}", "available"))
        except ImportError:
            checks.append(_info(f"optional {pkg}", "absent (feature degrades gracefully)"))
    if checkpoint_dir is not None:
        ckpt = Path(checkpoint_dir)
        files = sorted(ckpt.glob("**/*.npz")) + sorted(ckpt.glob("**/*.model"))
        checks.append(_check("model checkpoints", bool(files),
                             f"{len(files)} file(s) under {ckpt}" if files else f"none under {ckpt}"))

    from ..rag import builtin_knowledge_base

    kb = builtin_knowledge_base()
    checks.append(_check("knowledge base", len(kb) >= 7, f"{len(kb)} built-in documents"))
    return checks


def format_env_report(checks: List[Dict]) -> str:
    lines = ["Environment preflight:"]
    for c in checks:
        mark = "INFO" if not c.get("required", True) else ("OK " if c["ok"] else "FAIL")
        lines.append(f"  [{mark}] {c['check']:<26} {c['detail']}")
    n_bad = sum(not c["ok"] for c in checks)
    lines.append("all checks passed" if n_bad == 0 else f"{n_bad} check(s) FAILED")
    return "\n".join(lines)
