"""The port's serving layer (``braintpu_torch/serve``, ``cli serve``) on the CPU.

Copies of the JAX package's ``tests/test_serve.py`` on the port's server,
with the JAX package's own small test model carried across (f32, the same
weights through ``ckpt/npz.py::params_from_jax``), and parity with the JAX
server: the same labels for the same upload, the same stage journal and
response shapes, the same page apart from its title, the same gates.  Also:
``cli serve`` as a process, its exit on a failed warm-up, and the launch
counters under threads.
"""

import base64
import gzip
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from braintpu.infer import InferenceEngine as JaxEngine
from braintpu.infer import ModelBundle as JaxBundle
from braintpu.io import nifti as jax_nifti
from braintpu.models import UNetConfig as JaxUNetConfig
from braintpu.models import init_params as jax_init_params
from braintpu.serve import api as jax_api
from braintpu.serve import jobs as jax_jobs
from braintpu.serve import make_server as jax_make_server
from braintpu.serve.webui import INDEX_HTML as JAX_INDEX_HTML

from braintpu_torch import cli
from braintpu_torch.ckpt.npz import params_from_jax
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.models import unet3d
from braintpu_torch.ops import _build
from braintpu_torch.serve import CLINICAL_REFUSAL, api, make_server
from braintpu_torch.serve.jobs import STAGE_PROGRESS, JobStore, validate_case_id
from braintpu_torch.serve.webui import INDEX_HTML

from test_serve import _case_files, _multipart, _req

REPO = Path(__file__).resolve().parent.parent
_TINY = dict(in_channels=4, num_classes=3, base_features=4, max_features=16, num_pool=2,
             conv_per_stage=2, norm="batch", patch_size=(16, 16, 16))


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No LLM key: chat takes the grounded-refusal path."""
    monkeypatch.setenv("GEMINI_API_KEY", "")


def _engines():
    """The JAX test server's engine and the port's with the same weights."""
    jcfg = JaxUNetConfig(compute_dtype=jnp.float32, **_TINY)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jax_engine = JaxEngine(models=[JaxBundle.from_folds(jcfg, [params])], tta=False,
                           output_convention="internal")
    tcfg = unet3d.UNetConfig(compute_dtype=torch.float32, **_TINY)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port_engine = InferenceEngine(
        models=[ModelBundle.from_folds(tcfg, [params_from_jax(tree, tcfg)])], tta=False,
        output_convention="internal", device="cpu")
    return jax_engine, port_engine


def _serve(make, engine, root):
    srv = make(engine, root, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jax_engine, port_engine = _engines()
    jsrv, jurl = _serve(jax_make_server, jax_engine, tmp_path_factory.mktemp("jax_root"))
    psrv, purl = _serve(make_server, port_engine, tmp_path_factory.mktemp("port_root"))
    yield {"jax": jurl, "torch": purl, "apps": {"jax": jsrv.app, "torch": psrv.app}}
    jsrv.shutdown()
    psrv.shutdown()


@pytest.fixture
def server(both):
    return both["torch"]


def _submit(url, case_id, files):
    body, ctype = _multipart({"case_id": case_id}, files)
    code, resp, _ = _req(url + "/api/analyze", data=body, headers={"Content-Type": ctype},
                         method="POST")
    assert code == 200, resp
    return json.loads(resp)["job_id"]


def _wait(url, job_id, deadline_s=120):
    """Poll until done or error; returns the last status and the distinct
    statuses seen, in order."""
    seen, status = [], None
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        code, resp, _ = _req(url + f"/api/status/{job_id}")
        assert code == 200
        status = json.loads(resp)
        if not seen or seen[-1] != status:
            seen.append(status)
        if status["status"] in ("done", "error"):
            break
        time.sleep(0.2)
    return status, seen


def _chat(url, job_id, question):
    return _req(url + f"/api/chat/{job_id}", data=json.dumps({"question": question}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")


# ---------------------------------------------------------------------------
# Copies of tests/test_serve.py
# ---------------------------------------------------------------------------


def test_index_page(server):
    code, body, headers = _req(server + "/")
    assert code == 200
    assert b"Brain MRI Analysis" in body
    assert headers.get("Content-Type") == "text/html; charset=utf-8"


def test_analyze_missing_modalities(server):
    body, ctype = _multipart({"case_id": "X"}, {})
    code, resp, _ = _req(server + "/api/analyze", data=body, headers={"Content-Type": ctype},
                         method="POST")
    assert code == 400
    assert b"Missing required modality" in resp


def test_unknown_job_404(server):
    for path in ("/api/status/nope", "/api/report/nope", "/api/metrics/nope",
                 "/api/report/nope/pdf", "/api/nothing"):
        code, _, _ = _req(server + path)
        assert code == 404, path
    code, resp, _ = _chat(server, "nope", "What is midline shift?")
    assert code == 404 and b"Job not found" in resp


def test_full_job_cycle(server, synth_case):
    job_id = _submit(server, "BraTS-GLI-99999-000", _case_files(synth_case))
    status, _ = _wait(server, job_id)
    assert status and status["status"] == "done", status
    assert status["progress_pct"] == 100

    code, resp, _ = _req(server + f"/api/report/{job_id}")
    assert code == 200
    assert b"MRI BRAIN WITH CONTRAST" in resp

    code, resp, headers = _req(server + f"/api/report/{job_id}/pdf")
    assert code == 200
    assert resp.startswith(b"%PDF")
    assert headers.get("Content-Type") == "application/pdf"

    code, resp, _ = _req(server + f"/api/metrics/{job_id}")
    assert code == 200
    assert "mean_dice" in json.loads(resp)

    code, resp, _ = _chat(server, job_id, "What treatment should I get?")
    assert code == 400
    assert CLINICAL_REFUSAL.encode() in resp

    code, resp, _ = _chat(server, job_id, "What is midline shift?")
    assert code == 200
    answer = json.loads(resp)["answer"]
    assert answer == "This information is not present in the generated report or " \
                     "verified definitions."  # offline: the grounded refusal

    code, resp, _ = _req(server + "/api/jobs")
    assert code == 200
    assert any(j["job_id"] == job_id for j in json.loads(resp)["jobs"])


def test_analyze_rejects_traversal_case_id(server, synth_case):
    files = _case_files(synth_case)
    for evil in ("../../tmp/evil", "a/b", "..", ".hidden"):
        body, ctype = _multipart({"case_id": evil}, files)
        code, resp, _ = _req(server + "/api/analyze", data=body,
                             headers={"Content-Type": ctype}, method="POST")
        assert code == 400, (evil, resp)
        assert b"invalid case_id" in resp


def test_analyze_rejects_traversal_field_names(server, synth_case, tmp_path):
    files = _case_files(synth_case)
    marker = tmp_path / "pwn.nii.gz"
    files[f"x/../../../../../../../{marker}"] = b"\x1f\x8bpwned"
    body, ctype = _multipart({"case_id": "TRAV-0001"}, files)
    code, resp, _ = _req(server + "/api/analyze", data=body, headers={"Content-Type": ctype},
                         method="POST")
    assert code == 400, resp
    assert b"Unexpected upload field" in resp
    assert not marker.exists()


def test_start_job_refuses_unknown_fields_itself(both, synth_case):
    """Defense in depth: AnalysisServer.start_job refuses a field name that
    is not a modality, even when called without the handler's check."""
    app = both["apps"]["torch"]
    with pytest.raises(ValueError, match="unexpected upload field"):
        app.start_job("TRAV-0002", {"../x": b"data"})


def test_analyze_json_rejects_invalid_base64(server):
    payload = {"case_id": "B64-0001",
               "files": {m: "%%%not-base64%%%" for m in ("t1", "t1ce", "t2", "flair")}}
    code, resp, _ = _req(server + "/api/analyze", data=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"}, method="POST")
    assert code == 400, resp
    assert b"base64" in resp
    payload["files"] = {m: 7 for m in ("t1", "t1ce", "t2", "flair")}
    code, resp, _ = _req(server + "/api/analyze", data=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"}, method="POST")
    assert code == 400, resp


def test_analyze_json_accepts_wrapped_base64(server, synth_case):
    files = _case_files(synth_case)
    payload = {"case_id": "WRAP-0001",
               "files": {m: base64.encodebytes(files[m]).decode()
                         for m in ("t1", "t1ce", "t2", "flair")}}
    assert "\n" in payload["files"]["t1"]
    code, resp, _ = _req(server + "/api/analyze", data=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"}, method="POST")
    assert code == 200, resp
    status, _ = _wait(server, json.loads(resp)["job_id"])
    assert status["status"] == "done", status


def test_status_reads_the_journal_while_the_summary_is_being_written(tmp_path):
    """A summary the pipeline has opened but not finished is no status yet:
    the journal answers (a poll used to raise and drop its connection)."""
    store = JobStore(tmp_path / "sessions", tmp_path / "results")
    job_id = store.create_job("PART-0001")["job_id"]
    out = store.case_results_dir(job_id)
    out.mkdir(parents=True)
    (out / "events.jsonl").write_text(json.dumps({"stage": "extracting", "status": "start"})
                                      + "\n")
    summary = json.dumps({"status": "completed"}, indent=2)
    for partial in ("", summary[:5]):
        (out / "pipeline_summary.json").write_text(partial)
        assert store.status(job_id)["stage"] == "extracting"
    (out / "pipeline_summary.json").write_text(summary)
    assert store.status(job_id)["status"] == "done"


def test_job_that_dies_early_reports_error(tmp_path):
    store = JobStore(tmp_path / "sessions", tmp_path / "results")
    record = store.create_job("DEAD-0001")

    class _Failed:  # looks like PipelineResult after an early failure
        summary = {"status": "error", "error": "no complete BraTS case in input"}

    store.launch(record["job_id"], lambda rec: _Failed())
    deadline, status = time.time() + 10, None
    while time.time() < deadline:
        status = store.status(record["job_id"])
        if status and status["status"] == "error":
            break
        time.sleep(0.05)
    assert status is not None and status["status"] == "error"
    assert "no complete BraTS case" in (status["error_message"] or "")

    record2 = store.create_job("DEAD-0002")

    def _boom(rec):
        raise RuntimeError("worker exploded")

    store.launch(record2["job_id"], _boom)
    deadline = time.time() + 10
    while time.time() < deadline:
        status = store.status(record2["job_id"])
        if status and status["status"] == "error":
            break
        time.sleep(0.05)
    assert status["status"] == "error"
    assert "worker exploded" in (status["error_message"] or "")
    # restart-safe: a new store over the same directories reads both jobs back
    again = JobStore(tmp_path / "sessions", tmp_path / "results")
    assert {r["job_id"] for r in again.list_public()} == {record["job_id"], record2["job_id"]}
    assert again.status(record2["job_id"])["status"] == "error"


def test_resubmitted_case_id_gets_fresh_job_state(server, synth_case):
    files = _case_files(synth_case)
    job1 = _submit(server, "BraTS-GLI-99999-000", files)
    assert _wait(server, job1)[0]["status"] == "done"
    job2 = _submit(server, "BraTS-GLI-99999-000", files)
    assert job2 != job1
    code, resp, _ = _req(server + f"/api/status/{job2}")
    assert json.loads(resp)["status"] != "done"  # not job 1's state
    assert _wait(server, job2)[0]["status"] == "done"


def test_bare_nii_upload_is_gzipped(server, synth_case):
    files = {mod: gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data
             for mod, data in _case_files(synth_case).items()}
    assert all(d[:2] != b"\x1f\x8b" for d in files.values())
    job_id = _submit(server, "BARE-NII-0001", files)
    status, _ = _wait(server, job_id)
    assert status and status["status"] == "done", status


def test_api_never_drops_connection_on_garbage(server):
    cases = [
        ("/api/analyze", b"\x00\xff\x13garbage", "multipart/form-data; boundary=x"),
        ("/api/analyze", b"{not json", "application/json"),
        ("/api/analyze", b"[]", "application/json"),
        ("/api/analyze", json.dumps({"case_id": "A-1", "files": "notadict"}).encode(),
         "application/json"),
        ("/api/analyze", b"", "multipart/form-data"),
        ("/api/analyze", b"x", "text/plain"),
        ("/api/chat/doesnotexist", b"{\"question\": 5}", "application/json"),
        ("/api/chat/doesnotexist", b"{bad", "application/json"),
        ("/api/chat/doesnotexist", b"[1]", "application/json"),
    ]
    for path, body, ctype in cases:
        try:
            code, resp, _ = _req(server + path, data=body, headers={"Content-Type": ctype},
                                 method="POST")
        except urllib.error.URLError as e:
            raise AssertionError(f"{path} with {ctype!r} dropped the connection: {e}")
        assert 400 <= code < 500, (path, ctype, code, resp[:200])


# ---------------------------------------------------------------------------
# Parity with the JAX server
# ---------------------------------------------------------------------------


def _journal(app, job_id):
    out = app.jobs.case_results_dir(job_id)
    return [(e["stage"], e["status"]) for e in
            map(json.loads, (out / "events.jsonl").read_text().splitlines())]


def _shape(value):
    """The keys and value types of a JSON response, recursively."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value[:1]]
    return type(value).__name__


def test_served_job_matches_the_reference_server(both, synth_case):
    files = _case_files(synth_case)
    jobs = {pkg: _submit(both[pkg], "BraTS-GLI-99999-000", files) for pkg in ("jax", "torch")}
    seen = {}
    for pkg, job_id in jobs.items():
        status, seen[pkg] = _wait(both[pkg], job_id)
        assert status["status"] == "done", (pkg, status)
    # every status seen is one of the reference's (status, stage, pct) triples
    for pkg in seen:
        for s in seen[pkg]:
            assert STAGE_PROGRESS[s["stage"]] == (s["status"], s["progress_pct"]), s
        assert seen[pkg][-1] == {"status": "done", "stage": "done", "progress_pct": 100,
                                 "error_message": None}
    assert _journal(both["apps"]["torch"], jobs["torch"]) == \
        _journal(both["apps"]["jax"], jobs["jax"])
    # the same labels, internal and BraTS-convention
    case = "BraTS-GLI-99999-000"
    for name in (f"{case}.nii.gz", f"{case}_brats.nii.gz"):
        port = np.asarray(jax_nifti.load(
            both["apps"]["torch"].jobs.artifact(jobs["torch"], name)).dataobj)
        ref = np.asarray(jax_nifti.load(both["apps"]["jax"].jobs.artifact(jobs["jax"], name)).dataobj)
        np.testing.assert_array_equal(port, ref)
    # the same response shapes, and the same report and metrics
    replies = {}
    for pkg, job_id in jobs.items():
        url = both[pkg]
        replies[pkg] = {
            "status": _req(url + f"/api/status/{job_id}"),
            "report": _req(url + f"/api/report/{job_id}"),
            "pdf": _req(url + f"/api/report/{job_id}/pdf"),
            "metrics": _req(url + f"/api/metrics/{job_id}"),
            "chat_clinical": _chat(url, job_id, "Is it malignant?"),
            "chat": _chat(url, job_id, "What is peritumoral edema?"),
            "jobs": _req(url + "/api/jobs"),
        }
    for key in replies["jax"]:
        (pc, pb, ph), (jc, jb, jh) = replies["torch"][key], replies["jax"][key]
        assert pc == jc and ph.get("Content-Type") == jh.get("Content-Type"), key
        if key == "pdf":
            assert pb[:5] == jb[:5] == b"%PDF-"
        elif key == "report":
            strip = lambda b: [ln for ln in b.decode().splitlines() if not ln.startswith("DATE:")]
            assert strip(pb) == strip(jb)
        else:
            p, j = json.loads(pb), json.loads(jb)
            assert _shape(p) == _shape(j), key
            if key in ("status", "chat", "chat_clinical"):
                assert p == j, key
    pm, jm = (json.loads(replies[k]["metrics"][1]) for k in ("torch", "jax"))
    assert pm["mean_dice"] == pytest.approx(jm["mean_dice"], rel=1e-12)


def test_page_gates_and_stage_map_equal_the_reference():
    assert INDEX_HTML.replace("braintpu_torch", "braintpu") == JAX_INDEX_HTML
    assert "<title>Brain MRI Analysis — braintpu_torch</title>" in INDEX_HTML
    assert api.BLOCKED_KEYWORDS == jax_api.BLOCKED_KEYWORDS
    assert api.CLINICAL_REFUSAL == jax_api.CLINICAL_REFUSAL
    assert (api._MODALITIES, api._UPLOAD_FIELDS) == (jax_api._MODALITIES, jax_api._UPLOAD_FIELDS)
    assert STAGE_PROGRESS == jax_jobs.STAGE_PROGRESS
    for case_id in ("BraTS-GLI-00001-000", "a.b_c-d", "../x", ".x", "", "x" * 129, "a..b"):
        try:
            jax_jobs.validate_case_id(case_id)
            want = True
        except ValueError:
            want = False
        try:
            validate_case_id(case_id)
            got = True
        except ValueError:
            got = False
        assert got == want, case_id


def test_multipart_parser_matches_the_reference(synth_case):
    files = _case_files(synth_case)
    body, ctype = _multipart({"case_id": " CASE-1 "}, files)
    assert api._parse_multipart(ctype, body) == jax_api._parse_multipart(ctype, body)
    fields, got = api._parse_multipart(ctype, body)
    assert fields == {"case_id": "CASE-1"} and got == files


# ---------------------------------------------------------------------------
# cli serve
# ---------------------------------------------------------------------------


def test_cli_serve_exits_nonzero_when_warmup_fails(monkeypatch, tmp_path, capsys):
    class Broken:
        def warmup(self):
            raise RuntimeError("nvcc failed to build csrc/conv_stage.cu")

    monkeypatch.setattr(cli, "load_engine", lambda args: Broken())
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", cli.main(
        ["serve", "--host", "127.0.0.1", "--port", "0", "--root", str(tmp_path),
         "--device", "cpu"])), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert rc["rc"] == 1
    out = capsys.readouterr().out
    assert "serving on http://127.0.0.1:" in out
    assert "engine warmup failed, shutting down: RuntimeError: nvcc failed" in out


def test_cli_serve_as_a_process(tmp_path):
    """``python -m braintpu_torch.cli serve`` binds, answers, and exits 0 on
    an interrupt (CPU, full-width model 1 with one random fold, no warm-up)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "braintpu_torch.cli", "serve", "--host", "127.0.0.1",
         "--port", "0", "--root", str(tmp_path / "root"), "--models", "model1", "--folds", "1",
         "--random-weights", "--no-tta", "--no-warmup", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "GEMINI_API_KEY": ""})
    try:
        url = None
        deadline = time.time() + 120
        while time.time() < deadline and url is None:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving on "):
                port = int(line.split()[2].rsplit(":", 1)[1])
                url = f"http://127.0.0.1:{port}"
        assert url, "the server printed no 'serving on' line"
        code, body, _ = _req(url + "/")
        assert code == 200 and b"braintpu_torch" in body
        code, body, _ = _req(url + "/api/jobs")
        assert code == 200 and json.loads(body) == {"jobs": []}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


# ---------------------------------------------------------------------------
# Launch counters and bindings under threads
# ---------------------------------------------------------------------------


def test_launch_counter_loses_no_update_under_threads():
    kernel = types.SimpleNamespace(launches=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count_launch(kernel)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == 16 * 2000


def test_bind_publishes_one_launcher_with_its_signature(monkeypatch):
    made = []

    class FakeLib:
        def __getitem__(self, symbol):
            fn = types.SimpleNamespace(symbol=symbol, restype=None, argtypes=None)
            made.append(fn)
            return fn

    monkeypatch.setattr(_build, "load_library", lambda name: FakeLib())
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(_build.bind("fake_kernel", [int])))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        _build._launchers.pop("fake_kernel", None)
    assert len(got) == 16 and all(g is got[0] for g in got)
    assert got[0].symbol == "fake_kernel_launch"
    assert got[0].argtypes == [int] and got[0].restype is not None
