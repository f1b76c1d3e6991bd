"""Tracing & profiling of the port.

* :class:`StageTimer` — nested named spans with a structured summary
  (host clock only),
* :func:`device_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace into a directory (``profile-report`` reads it),
* :func:`timed_device` — wall-clock a device computation honestly (the
  device it ran on is synchronised around each call).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Span", "StageTimer", "device_trace", "timed_device"]


@dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    children: List["Span"] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seconds": round(self.seconds, 4),
            "children": [c.as_dict() for c in self.children],
        }


class StageTimer:
    """Nested span timer: ``with timer.span("segmenting"): ...``"""

    def __init__(self):
        self.root: List[Span] = []
        self._stack: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str):
        s = Span(name, time.perf_counter())
        (self._stack[-1].children if self._stack else self.root).append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self._stack.pop()

    def summary(self) -> List[Dict[str, Any]]:
        return [s.as_dict() for s in self.root]

    def report(self) -> str:
        def fmt(span: Dict[str, Any], depth=0) -> List[str]:
            out = [f"{'  ' * depth}{span['name']:<28} {span['seconds']:8.3f}s"]
            for c in span["children"]:
                out.extend(fmt(c, depth + 1))
            return out

        lines: List[str] = []
        for s in self.summary():
            lines.extend(fmt(s))
        return "\n".join(lines)

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/braintpu_trace"):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write its Chrome trace to
    ``log_dir/<pid>.<ms>.pt.trace.json`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the capture
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"))


def _sync(result) -> None:
    """Wait for every CUDA tensor in ``result`` (a tensor or a nested
    list/tuple/dict of them) on its own device; CPU tensors need nothing."""
    import torch

    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


def timed_device(fn, *args, repeats: int = 1, **kwargs):
    """(result, seconds) with a proper device sync; min over ``repeats``
    after one untimed call."""
    result = fn(*args, **kwargs)
    _sync(result)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync(result)
        best = min(best, time.perf_counter() - t0)
    return result, best
