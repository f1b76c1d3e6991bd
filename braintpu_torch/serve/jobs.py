"""Job store: session lifecycle for analysis jobs (restart-safe).

The port's copy of ``braintpu/serve/jobs.py``.  Parity with the upstream job
management (upstream api.py:27-273):
mutex-guarded in-memory store, per-job ``sessions/<job>/input`` staging,
background pipeline execution, and **restart resilience** — job status and
artifacts are re-derived from the ``sessions/`` and ``results/`` directories
on disk, so a restarted server keeps serving old jobs (ref api.py:195-213).

Progress comes from the orchestrator's structured JSONL event journal
instead of regex-scraping stdout for STAGE markers; the
``{status, stage, progress_pct}`` response shape (and percentages) match the
reference's ``STAGE_MAP`` (ref api.py:74-146).
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

__all__ = ["STAGE_PROGRESS", "JobStore", "validate_case_id"]

#: case_id is interpolated into filesystem paths; restrict it to a safe
#: charset (no separators, no leading dot) to block path traversal from the
#: upload endpoint.
_CASE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")


def validate_case_id(case_id: str) -> str:
    if not _CASE_ID_RE.fullmatch(case_id or "") or ".." in case_id:
        raise ValueError(
            "invalid case_id: use letters, digits, '.', '_' or '-' "
            "(max 128 chars, no leading '.')"
        )
    return case_id

#: stage → (status, progress_pct), matching the reference's STAGE_MAP.
STAGE_PROGRESS = {
    "renaming": ("running", 5),
    "segmenting": ("running", 10),
    "converting": ("running", 35),
    "evaluating": ("running", 38),
    "extracting": ("running", 40),
    "generating": ("running", 70),
    "exporting": ("running", 90),
    "done": ("done", 100),
    "error": ("error", None),
}


class JobStore:
    """Thread-safe job registry with on-disk state re-derivation."""

    def __init__(self, sessions_dir: Path, results_dir: Path):
        self.sessions_dir = Path(sessions_dir)
        self.results_dir = Path(results_dir)
        self.sessions_dir.mkdir(parents=True, exist_ok=True)
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict[str, Any]] = {}

    # -- creation -----------------------------------------------------------

    def create_job(self, case_id: str) -> Dict[str, Any]:
        case_id = validate_case_id(case_id)
        job_id = uuid.uuid4().hex[:12]
        input_dir = self.sessions_dir / job_id / "input" / case_id
        input_dir.mkdir(parents=True, exist_ok=True)
        record = {
            "job_id": job_id,
            "case_id": case_id,
            "created_at": time.time(),
            "input_dir": str(input_dir),
        }
        with self._lock:
            self._jobs[job_id] = record
        with open(self.sessions_dir / job_id / "job.json", "w") as f:
            json.dump(record, f)
        return record

    def launch(self, job_id: str, target: Callable[[Dict[str, Any]], Any]) -> None:
        """Run the pipeline for a job in a daemon thread.

        The worker is wrapped so a job can never be left in "running /
        segmenting / 0%" forever: if the pipeline dies before it knows its
        output folder (e.g. the renaming stage raised before the event
        journal was opened — no events.jsonl, no pipeline_summary.json),
        or the worker thread itself raises, a fallback error summary is
        written where :meth:`status` will find it."""
        record = self.get(job_id)
        if record is None:
            raise KeyError(job_id)

        def runner():
            try:
                result = target(record)
            except BaseException as exc:  # worker must not die silently
                self._write_fallback_summary(record, f"{type(exc).__name__}: {exc}")
                return
            summary = getattr(result, "summary", None)
            if isinstance(summary, dict) and summary.get("status") != "completed":
                # run_case persisted the summary itself only if it got far
                # enough to know its output folder; make sure one exists
                self._write_fallback_summary(
                    record, str(summary.get("error") or "pipeline failed")
                )

        thread = threading.Thread(target=runner, daemon=True)
        thread.start()
        with self._lock:
            record["thread"] = thread

    def _write_fallback_summary(self, record: Dict[str, Any], error: str) -> None:
        out = self.results_dir / record["job_id"] / record["case_id"]
        try:
            out.mkdir(parents=True, exist_ok=True)
            path = out / "pipeline_summary.json"
            if path.exists():  # the pipeline wrote its own — keep it
                return
            with open(path, "w") as f:
                json.dump(
                    {
                        "case_id": record["case_id"],
                        "status": "error",
                        "error": error,
                    },
                    f,
                    indent=2,
                )
        except OSError:
            pass  # disk-level failure: nothing more we can do from here

    # -- lookup (restart-safe) ----------------------------------------------

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            if job_id in self._jobs:
                return self._jobs[job_id]
        meta = self.sessions_dir / job_id / "job.json"
        if meta.exists():
            with open(meta) as f:
                record = json.load(f)
            with self._lock:
                self._jobs[job_id] = record
            return record
        return None

    def exists(self, job_id: str) -> bool:
        return self.get(job_id) is not None

    def list_jobs(self) -> List[Dict[str, Any]]:
        known = {p.name for p in self.sessions_dir.iterdir() if p.is_dir()}
        return [r for j in sorted(known) if (r := self.get(j)) is not None]

    def list_public(self) -> List[Dict[str, Any]]:
        """JSON-safe snapshot of all job records.

        Copies are taken under the store lock: ``launch`` inserts the
        'thread' key into live record dicts, and iterating them unlocked
        from another handler thread can raise "dictionary changed size
        during iteration"."""
        records = self.list_jobs()
        with self._lock:
            return [
                {k: v for k, v in r.items() if k != "thread"} for r in records
            ]

    # -- derived state ------------------------------------------------------

    def case_results_dir(self, job_id: str) -> Optional[Path]:
        record = self.get(job_id)
        if record is None:
            return None
        # results are scoped PER JOB (results/<job>/<case>): keying off the
        # bare case_id would let a re-submitted case read the previous job's
        # status/artifacts and append to its event journal.
        return self.results_dir / record["job_id"] / record["case_id"]

    def status(self, job_id: str) -> Optional[Dict[str, Any]]:
        """{status, stage, progress_pct, error_message} from the event journal."""
        out_dir = self.case_results_dir(job_id)
        if out_dir is None:
            return None
        events_path = out_dir / "events.jsonl"
        summary_path = out_dir / "pipeline_summary.json"
        summary = None
        if summary_path.exists():
            try:
                with open(summary_path) as f:
                    summary = json.load(f)
            except json.JSONDecodeError:
                pass  # the pipeline is writing it: read the journal below meanwhile
        if summary is not None:
            if summary.get("status") == "completed":
                return {
                    "status": "done",
                    "stage": "done",
                    "progress_pct": 100,
                    "error_message": None,
                }
            return {
                "status": "error",
                "stage": "error",
                "progress_pct": None,
                "error_message": summary.get("error"),
            }
        if not events_path.exists():
            return {
                "status": "running",
                "stage": "segmenting",
                "progress_pct": 0,
                "error_message": None,
            }
        stage, error_message = "segmenting", None
        with open(events_path) as f:
            for line in f:
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if event.get("stage") in STAGE_PROGRESS:
                    stage = event["stage"]
                if event.get("status") == "error":
                    error_message = event.get("detail", {}).get("error")
        status, pct = STAGE_PROGRESS.get(stage, ("running", 0))
        return {
            "status": status,
            "stage": stage,
            "progress_pct": pct,
            "error_message": error_message,
        }

    def artifact(self, job_id: str, *relpath: str) -> Optional[Path]:
        out_dir = self.case_results_dir(job_id)
        if out_dir is None:
            return None
        path = out_dir.joinpath(*relpath)
        return path if path.exists() else None
