"""REST API server (stdlib http.server, no FastAPI dependency).

The port's copy of ``braintpu/serve/api.py``: the same endpoints, status
codes, gates and upload checks, around the port's engine and pipeline.
Endpoint parity with upstream api.py:275-470:

* ``POST /api/analyze``            — upload 4 modalities (+optional seg) → job
* ``GET  /api/status/{job}``       — {status, stage, progress_pct}
* ``GET  /api/report/{job}``       — report text
* ``GET  /api/report/{job}/pdf``   — rendered PDF
* ``GET  /api/metrics/{job}``      — Dice/IoU evaluation
* ``POST /api/chat/{job}``         — RAG Q&A with its own keyword gate
  (ref api.py:59-71 blocklist; refusal returned with HTTP 400)
* ``GET  /api/jobs``               — job listing (extra)
* ``GET  /``                       — built-in single-page UI
  (:mod:`.webui`, replacing the upstream Streamlit app)

Uploads accept multipart/form-data (fields ``case_id`` + files named
``t1, t1ce, t2, flair[, seg]``) or JSON with base64 file bodies.  The
pipeline runs in a background thread per job via :class:`JobStore`
(ref api.py:220-240 semantics, in-process instead of subprocess).  Jobs on
several threads share the engine: its kernels launch on each thread's
current stream, which is the device's default stream, so their device work
runs in turn while their host stages overlap.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import gzip
import json
import re
import threading
from email.parser import BytesParser
from email.policy import default as _email_default
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from ..infer.engine import InferenceEngine
from ..pipeline import Pipeline, PipelineConfig
from ..rag import RagAssistant
from .jobs import JobStore
from .webui import INDEX_HTML

__all__ = ["BLOCKED_KEYWORDS", "CLINICAL_REFUSAL", "AnalysisServer", "make_server"]

#: The API-level chat gate (stricter than the RAG assistant's own gate;
#: ref api.py:59-67).
BLOCKED_KEYWORDS = [
    "treatment", "prognosis", "diagnose", "diagnosis",
    "should i", "will the patient", "survival",
    "chemotherapy", "radiation", "surgery",
    "grade", "malignant", "benign", "cancer",
]

CLINICAL_REFUSAL = (
    "This question requires clinical judgment. "
    "Please consult a qualified radiologist."
)

_MODALITIES = ("t1", "t1ce", "t2", "flair")
#: accepted upload field names (the optional seg is ground truth)
_UPLOAD_FIELDS = _MODALITIES + ("seg",)


class AnalysisServer:
    """Application state shared by all request handlers."""

    def __init__(
        self,
        engine: InferenceEngine,
        root: Path,
        pipeline_config: Optional[PipelineConfig] = None,
        assistant: Optional[RagAssistant] = None,
    ):
        root = Path(root)
        self.jobs = JobStore(root / "sessions", root / "results")
        self.engine = engine
        self.pipeline_config = pipeline_config or PipelineConfig()
        self.results_root = root / "results"
        self.assistant = assistant or RagAssistant()
        self._rag_lock = threading.Lock()

    # -- job execution -------------------------------------------------------

    def start_job(self, case_id: str, files: Dict[str, bytes]) -> str:
        # field names become filesystem paths — allowlist them (defense in
        # depth; _analyze rejects unknown fields with a 400 first).  A raw
        # client-supplied name like "x/../../../../tmp/pwn.nii.gz" would
        # otherwise write outside the session input directory.
        bad = [m for m in files if m not in _UPLOAD_FIELDS]
        if bad:
            raise ValueError(f"unexpected upload field(s): {', '.join(sorted(bad))}")
        record = self.jobs.create_job(case_id)
        input_dir = Path(record["input_dir"])
        for mod, data in files.items():
            if data[:2] != b"\x1f\x8b":  # bare .nii upload → gzip it
                data = gzip.compress(data)
            (input_dir / f"{case_id}_{mod}.nii.gz").write_bytes(data)
        # one Pipeline per job: run_case state stays private to the thread,
        # and outputs land under the job-scoped results dir
        cfg = dataclasses.replace(
            self.pipeline_config, output_root=self.results_root / record["job_id"]
        )
        pipeline = Pipeline(self.engine, cfg)
        self.jobs.launch(
            record["job_id"],
            lambda rec: pipeline.run_case(Path(rec["input_dir"])),
        )
        return record["job_id"]

    def chat(self, job_id: str, question: str) -> Tuple[int, Dict[str, Any]]:
        if not self.jobs.exists(job_id):
            return 404, {"detail": "Job not found."}
        low = question.lower()
        if any(k in low for k in BLOCKED_KEYWORDS):
            return 400, {"detail": CLINICAL_REFUSAL}
        report_path = self.jobs.artifact(job_id, "feature_extraction", "radiology_report.txt")
        if report_path is None:
            return 404, {"detail": "Report not available yet."}
        with self._rag_lock:
            # the orchestrator writes the report as UTF-8; read it the same
            # way (locale-default decoding breaks on '×' etc. under C locale)
            answer = self.assistant.answer_query(
                question, report_path.read_text(encoding="utf-8")
            )
        return 200, {"answer": answer}


def _parse_multipart(content_type: str, body: bytes) -> Tuple[Dict[str, str], Dict[str, bytes]]:
    msg = BytesParser(policy=_email_default).parsebytes(
        f"Content-Type: {content_type}\r\n\r\n".encode() + body
    )
    fields: Dict[str, str] = {}
    files: Dict[str, bytes] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        if part.get_filename():
            files[name] = payload
        else:
            fields[name] = payload.decode("utf-8", "replace").strip()
    return fields, files


class _Handler(BaseHTTPRequestHandler):
    server_version = "braintpu_torch-serve/0.1"
    app: AnalysisServer  # injected by make_server

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload, content_type="application/json"):
        if isinstance(payload, (dict, list)):
            body = json.dumps(payload).encode()
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = payload
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    # -- routing -------------------------------------------------------------

    def do_GET(self):
        app = self.app
        if self.path in ("/", "/index.html"):
            return self._send(200, INDEX_HTML, "text/html; charset=utf-8")
        if self.path == "/api/jobs":
            return self._send(200, {"jobs": app.jobs.list_public()})

        m = re.match(r"^/api/status/([A-Za-z0-9_-]+)$", self.path)
        if m:
            status = app.jobs.status(m.group(1)) if app.jobs.exists(m.group(1)) else None
            if status is None:
                return self._send(404, {"detail": "Job not found."})
            return self._send(200, status)

        m = re.match(r"^/api/report/([A-Za-z0-9_-]+)(/pdf)?$", self.path)
        if m:
            job_id, want_pdf = m.group(1), bool(m.group(2))
            if not app.jobs.exists(job_id):
                return self._send(404, {"detail": "Job not found."})
            if want_pdf:
                path = app.jobs.artifact(job_id, "feature_extraction", "radiology_report.pdf")
                if path is None:
                    return self._send(404, {"detail": "PDF report not generated yet."})
                return self._send(200, path.read_bytes(), "application/pdf")
            path = app.jobs.artifact(job_id, "feature_extraction", "radiology_report.txt")
            if path is None:
                return self._send(404, {"detail": "Report not generated yet."})
            return self._send(
                200, path.read_text(encoding="utf-8"), "text/plain; charset=utf-8"
            )

        m = re.match(r"^/api/metrics/([A-Za-z0-9_-]+)$", self.path)
        if m:
            if not app.jobs.exists(m.group(1)):
                return self._send(404, {"detail": "Job not found."})
            path = app.jobs.artifact(m.group(1), "evaluation.json")
            if path is None:
                return self._send(404, {"detail": "Metrics not available yet."})
            return self._send(200, json.loads(path.read_text()))

        return self._send(404, {"detail": "Not found."})

    def do_POST(self):
        app = self.app
        if self.path == "/api/analyze":
            return self._analyze()
        m = re.match(r"^/api/chat/([A-Za-z0-9_-]+)$", self.path)
        if m:
            try:
                data = json.loads(self._body() or b"{}")
            except json.JSONDecodeError:
                return self._send(400, {"detail": "Invalid JSON body."})
            if not isinstance(data, dict):
                return self._send(400, {"detail": "JSON body must be an object."})
            question = str(data.get("question") or "").strip()
            if not question:
                return self._send(400, {"detail": "question must not be empty."})
            code, payload = app.chat(m.group(1), question)
            return self._send(code, payload)
        return self._send(404, {"detail": "Not found."})

    # -- handlers ------------------------------------------------------------

    def _analyze(self):
        app = self.app
        ctype = self.headers.get("Content-Type", "")
        body = self._body()
        if ctype.startswith("multipart/form-data"):
            fields, files = _parse_multipart(ctype, body)
            case_id = fields.get("case_id", "").strip()
        elif ctype.startswith("application/json"):
            try:
                data = json.loads(body or b"{}")
            except json.JSONDecodeError:
                return self._send(400, {"detail": "Invalid JSON body."})
            if not isinstance(data, dict):  # e.g. a bare JSON list
                return self._send(400, {"detail": "JSON body must be an object."})
            case_id = str(data.get("case_id") or "").strip()
            try:
                # strip whitespace first: RFC-2045 wrappers (Python's
                # encodebytes, the base64 CLI) insert newlines every 76
                # chars, which validate=True would reject
                files = {
                    k: base64.b64decode("".join(v.split()), validate=True)
                    for k, v in (data.get("files") or {}).items()
                }
            except (binascii.Error, TypeError, ValueError, AttributeError):
                # invalid base64 / non-string value: a 400, not a dropped
                # connection from an exception escaping do_POST
                return self._send(
                    400, {"detail": "files values must be base64-encoded strings."}
                )
        else:
            return self._send(415, {"detail": "Use multipart/form-data or JSON."})

        if not case_id:
            return self._send(400, {"detail": "case_id must not be empty."})
        missing = [m for m in _MODALITIES if m not in files]
        if missing:
            return self._send(
                400, {"detail": f"Missing required modality files: {', '.join(missing)}"}
            )
        unknown = [k for k in files if k not in _UPLOAD_FIELDS]
        if unknown:
            # field names become file paths in start_job — never accept
            # arbitrary ones (path traversal)
            return self._send(
                400,
                {"detail": f"Unexpected upload field(s): {', '.join(sorted(unknown))}. "
                           f"Allowed: {', '.join(_UPLOAD_FIELDS)}."},
            )
        try:
            job_id = app.start_job(case_id, files)
        except ValueError as exc:  # unsafe case_id
            return self._send(400, {"detail": str(exc)})
        return self._send(200, {"job_id": job_id})


def make_server(
    engine: InferenceEngine,
    root: Path,
    host: str = "0.0.0.0",
    port: int = 8000,
    **kwargs,
) -> ThreadingHTTPServer:
    """Build a ready-to-serve ThreadingHTTPServer bound to ``host:port``."""
    app = AnalysisServer(engine, Path(root), **kwargs)
    handler = type("BoundHandler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.app = app  # type: ignore[attr-defined]
    return server
