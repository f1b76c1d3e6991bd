"""Device-trace analysis: per-op time attribution without a trace viewer.

The port's counterpart of the reference's ``utils/xprof.py`` (which reads an
XLA ``*.xplane.pb``).  :func:`braintpu_torch.utils.profiling.device_trace`
writes a ``torch.profiler`` Chrome trace (``*.pt.trace.json``, optionally
gzipped); this module turns it into an aggregated per-op table.  The two
lines the reference aggregates map onto the trace's events:

* ``"XLA Ops"`` → the device kernels (events of category ``kernel``),
* ``"XLA Modules"`` → the top-level host ops (``cpu_op`` events that no
  other ``cpu_op`` of their thread encloses).

A capture with no device kernel is refused whichever line is asked for: a
CPU capture records host threads only.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["LINES", "OpTime", "aggregate_trace", "format_table", "latest_trace"]

#: the reference's trace lines → this trace's events
LINES = {"XLA Ops": "device kernels", "XLA Modules": "top-level host ops"}


@dataclass
class OpTime:
    name: str
    total_ms: float
    count: int

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


def latest_trace(logdir: str) -> Optional[str]:
    """Newest ``*.pt.trace.json[.gz]`` under ``logdir`` (searched
    recursively; the counterpart of the reference's ``latest_xplane``)."""
    paths = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pat), recursive=True)]
    return max(paths, key=lambda p: (os.path.getmtime(p), p)) if paths else None


def _load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _top_level(events: List[dict]) -> List[dict]:
    """The ``cpu_op`` events not enclosed by another of their thread."""
    by_thread: Dict[tuple, List[dict]] = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        end = float("-inf")
        for e in evs:
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0)
    return out


def aggregate_trace(logdir_or_trace: str, line: str = "XLA Ops") -> List[OpTime]:
    """Aggregate op durations from a profiler capture.

    Args:
      logdir_or_trace: a trace directory (the newest capture is used) or a
        direct path to a ``.pt.trace.json[.gz]`` file.
      line: "XLA Ops" for per-kernel device times, "XLA Modules" for the
        top-level host ops (see :data:`LINES`).

    Returns:
      OpTime entries sorted by total time, descending.
    """
    if line not in LINES:
        raise ValueError(f"line must be one of {sorted(LINES)}, got {line!r}")
    path = logdir_or_trace
    if os.path.isdir(path):
        found = latest_trace(path)
        if found is None:
            raise FileNotFoundError(f"no .pt.trace.json under {logdir_or_trace}")
        path = found
    elif not os.path.exists(path):
        raise FileNotFoundError(path)
    events = [e for e in _load_events(path) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        cats: Dict[str, int] = defaultdict(int)
        for e in events:
            cats[str(e.get("cat"))] += 1
        seen = [f"{c}: {n} events" for c, n in sorted(cats.items())] or ["(no timed events)"]
        raise ValueError(
            f"no device kernels for a {line!r} table in this capture — per-op "
            "attribution needs a GPU trace (CPU captures only record host "
            "threads).  Event categories found:\n  " + "\n  ".join(seen)
        )
    chosen = kernels if line == "XLA Ops" else _top_level(
        [e for e in events if e.get("cat") == "cpu_op"])
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for e in chosen:
        totals[e["name"]] += e.get("dur", 0) / 1e3  # µs → ms
        counts[e["name"]] += 1
    return sorted((OpTime(n, t, counts[n]) for n, t in totals.items()),
                  key=lambda o: -o.total_ms)


def format_table(ops: List[OpTime], top: int = 30, width: int = 100) -> str:
    """Human-readable top-N table."""
    total = sum(o.total_ms for o in ops)
    lines = [f"{'total ms':>10}  {'count':>6}  {'%':>5}  op", "-" * width]
    for o in ops[:top]:
        pct = 100.0 * o.total_ms / total if total else 0.0
        lines.append(
            f"{o.total_ms:10.2f}  {o.count:6d}  {pct:5.1f}  {o.name[: width - 28]}"
        )
    lines.append(f"{total:10.2f}  (all {len(ops)} ops)")
    return "\n".join(lines)
