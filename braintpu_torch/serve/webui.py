"""Built-in single-page web UI (replaces the upstream Streamlit frontend).

The port's copy of ``braintpu/serve/webui.py``: the same page, with the
title and heading naming the port.  The upstream ``app.py`` offers: modality
upload, analysis progress, report viewing with download, and a RAG Q&A box
(upstream app.py:49-166).  This self-contained page provides the same
workflow against the REST API with zero frontend dependencies.
"""

INDEX_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Brain MRI Analysis — braintpu_torch</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 880px; color: #222; }
 h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 2rem; }
 fieldset { border: 1px solid #ccc; border-radius: 8px; margin-bottom: 1rem; }
 label { display:inline-block; width: 5rem; font-weight: 600; }
 .row { margin: .4rem 0; }
 button { padding: .45rem 1rem; border-radius: 6px; border: 1px solid #888; background:#f4f4f4; cursor:pointer; }
 button:hover { background:#e8e8e8; }
 #status, #answer { white-space: pre-wrap; background: #f8f8f8; border-radius: 6px; padding: .8rem; }
 #report { white-space: pre-wrap; background: #f8f8f8; border-radius: 6px; padding: .8rem;
           max-height: 420px; overflow-y: auto; font-family: ui-monospace, monospace; font-size: .85rem; }
 progress { width: 100%; height: 14px; }
 .muted { color:#777; font-size:.85rem; }
</style>
</head>
<body>
<h1>Automated Brain MRI Analysis <span class="muted">(braintpu_torch)</span></h1>

<h2>1. Upload case</h2>
<fieldset><legend>BraTS modalities (.nii.gz)</legend>
 <div class="row"><label>Case ID</label><input id="case_id" value="CASE-0001"></div>
 <div class="row"><label>T1</label><input type="file" id="t1"></div>
 <div class="row"><label>T1ce</label><input type="file" id="t1ce"></div>
 <div class="row"><label>T2</label><input type="file" id="t2"></div>
 <div class="row"><label>FLAIR</label><input type="file" id="flair"></div>
 <div class="row"><label>Seg (GT)</label><input type="file" id="seg"> <span class="muted">optional, enables Dice</span></div>
 <div class="row"><button onclick="analyze()">Start analysis</button></div>
</fieldset>

<h2>2. Progress</h2>
<progress id="bar" max="100" value="0"></progress>
<div id="status">no job yet</div>

<h2>3. Report</h2>
<div class="row">
 <button onclick="loadReport()">Load report</button>
 <button onclick="window.open('/api/report/'+jobId+'/pdf')">Download PDF</button>
</div>
<div id="report">—</div>

<h2>4. Ask the educational assistant</h2>
<div class="row"><input id="question" size="70" placeholder="e.g. What is midline shift?">
 <button onclick="ask()">Ask</button></div>
<div id="answer">—</div>
<p class="muted">Educational use only. Not a diagnostic device. Clinical questions are refused by design.</p>

<script>
let jobId = null, timer = null;
async function analyze() {
  const fd = new FormData();
  fd.append('case_id', document.getElementById('case_id').value);
  for (const m of ['t1','t1ce','t2','flair','seg']) {
    const f = document.getElementById(m).files[0];
    if (f) fd.append(m, f, f.name);
  }
  const res = await fetch('/api/analyze', {method:'POST', body: fd});
  const data = await res.json();
  if (!res.ok) { document.getElementById('status').textContent = data.detail; return; }
  jobId = data.job_id;
  document.getElementById('status').textContent = 'job ' + jobId + ' started';
  if (timer) clearInterval(timer);
  timer = setInterval(poll, 2000);
}
async function poll() {
  if (!jobId) return;
  const res = await fetch('/api/status/' + jobId);
  const s = await res.json();
  document.getElementById('bar').value = s.progress_pct || 0;
  document.getElementById('status').textContent =
    `status: ${s.status}   stage: ${s.stage}` + (s.error_message ? `\\nerror: ${s.error_message}` : '');
  if (s.status === 'done' || s.status === 'error') { clearInterval(timer); if (s.status==='done') loadReport(); }
}
async function loadReport() {
  if (!jobId) return;
  const res = await fetch('/api/report/' + jobId);
  document.getElementById('report').textContent = res.ok ? await res.text() : (await res.json()).detail;
}
async function ask() {
  if (!jobId) { document.getElementById('answer').textContent = 'start an analysis first'; return; }
  const q = document.getElementById('question').value;
  const res = await fetch('/api/chat/' + jobId, {
    method:'POST', headers: {'Content-Type':'application/json'},
    body: JSON.stringify({question: q})});
  const data = await res.json();
  document.getElementById('answer').textContent = data.answer || data.detail;
}
</script>
</body>
</html>
"""
