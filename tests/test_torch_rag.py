"""The port's RAG layer (``braintpu_torch/rag``): copies of the JAX package's
``tests/test_rag.py`` and ``tests/test_rag_eval.py`` on the port, and
parity with the JAX package on the CPU: the hashed embedder's matrices
bit-equal, the same titles and scores for the 33 labelled queries (also on
the device route, with ``device="cpu"``), stores that load across packages,
the same prompt, gates and refusals.

Two of the JAX package's RAG tests have no copy here: the MiniLM embedder is
not ported (it needs ``sentence_transformers`` and the all-MiniLM-L6-v2
weights, in neither the repository nor its machines).
"""

import numpy as np
import pytest
import torch

from braintpu import rag as jax_rag
from braintpu.rag import store as jax_store_mod

from braintpu_torch import cli
from braintpu_torch.rag import (
    BLOCKED_KEYWORDS,
    PROMPT_TEMPLATE,
    REFUSAL_CLINICAL,
    REFUSAL_DATA,
    HashedNgramEmbedder,
    KBDocument,
    RagAssistant,
    VectorStore,
    build_prompt,
    build_vector_store,
    builtin_knowledge_base,
    is_clinical_query,
    load_vector_store,
    parse_md_text,
)
from braintpu_torch.rag import assistant as assistant_mod
from braintpu_torch.rag import store as store_mod
from braintpu_torch.report.llm import GeminiClient

from test_rag import REFERENCE_SAMPLE_QUESTIONS
from test_rag_eval import LABELED_QUERIES, run_eval


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No LLM key: the assistant takes the grounded-refusal path."""
    monkeypatch.setenv("GEMINI_API_KEY", "")


@pytest.fixture(scope="module")
def store():
    return build_vector_store()


@pytest.fixture(scope="module")
def jax_store():
    return jax_rag.build_vector_store()


# ---------------------------------------------------------------------------
# Copies of tests/test_rag.py
# ---------------------------------------------------------------------------


def test_clinical_gate_blocks_all_keywords():
    for kw in BLOCKED_KEYWORDS:
        assert is_clinical_query(f"What about the {kw} options?"), kw
    assert is_clinical_query("What is the PROGNOSIS here?")  # case-insensitive
    assert not is_clinical_query("What is midline shift?")
    assert not is_clinical_query("How large is the tumor?")


def test_gate_refuses_before_llm():
    calls = []

    class Recorder(GeminiClient):
        def generate(self, prompt, **kw):
            calls.append(prompt)
            return super().generate(prompt, **kw)

    assistant = RagAssistant(client=Recorder(api_key=None))
    assert assistant.answer_query("What surgery do I need?", "report text") == REFUSAL_CLINICAL
    assert calls == []  # the gate answers before the LLM is asked
    # offline (no API key): grounded refusal
    assert assistant.answer_query("What is midline shift?", "report text") == REFUSAL_DATA
    assert len(calls) == 1
    assert assistant.answer_query("   ", "report text") == REFUSAL_DATA


def test_builtin_kb_topics():
    docs = builtin_knowledge_base()
    assert {d.title for d in docs} == {
        "Midline Shift", "Peritumoral Edema", "Enhancing Tumor", "Non-enhancing Tumor",
        "Tumor Volumes", "MRI Sequences", "Glioma Overview",
    }
    for d in docs:
        assert "What This Does NOT Mean" in d.body
        assert d.keywords


def test_md_parsing():
    doc = parse_md_text("TITLE: X\nKEYWORDS: a, b\nVERSION: 2.0\n---\nBody text.")
    assert doc.title == "X" and doc.keywords == "a, b" and doc.version == "2.0"
    assert doc.body == "Body text."
    assert "Title: X" in doc.embed_text


@pytest.mark.parametrize(
    "query,expected_title",
    [
        ("what is midline shift?", "Midline Shift"),
        ("explain peritumoral edema around the tumor", "Peritumoral Edema"),
        ("why does the tumor enhance with contrast gadolinium?", "Enhancing Tumor"),
        ("what do the volume measurements WT TC ET mean?", "Tumor Volumes"),
        ("what are T1 T2 FLAIR sequences?", "MRI Sequences"),
        ("tell me about glioma", "Glioma Overview"),
    ],
)
def test_retrieval_quality(store, query, expected_title):
    hits = store.retrieve(query, k=2)
    assert hits[0][0].title == expected_title, [h[0].title for h in hits]


def test_chromadb_shaped_query(store):
    res = store.query("midline shift", n_results=2)
    assert len(res["documents"][0]) == 2
    assert res["metadatas"][0][0]["title"] == "Midline Shift"
    assert res["distances"][0][0] <= res["distances"][0][1]


def test_prompt_grounding_structure(store):
    hits = store.retrieve("midline shift", 2)
    prompt = build_prompt("What is midline shift?", "PATIENT REPORT BODY", hits)
    assert "### CONTEXT 1: PATIENT REPORT" in prompt
    assert "PATIENT REPORT BODY" in prompt
    assert "### CONTEXT 2: KNOWLEDGE BASE" in prompt
    assert "Midline Shift" in prompt
    assert "Anchor & Explain" in prompt
    assert prompt.rstrip().endswith("What is midline shift?")


def test_store_roundtrip(tmp_path, store):
    path = tmp_path / "store.npz"
    store.save(path)
    loaded = load_vector_store(path)
    assert len(loaded.docs) == len(store.docs)
    np.testing.assert_allclose(loaded.matrix, store.matrix)
    assert loaded.retrieve("midline shift", 1)[0][0].title == "Midline Shift"
    # an extensionless path round-trips with the same string
    store.save(tmp_path / "bare")
    assert load_vector_store(tmp_path / "bare").retrieve("glioma", 1)[0][0].title == \
        "Glioma Overview"


def test_reference_canned_questions_hashed_embedder(store):
    results = [(q, want, store.retrieve(q, k=1)[0][0].title)
               for q, want in REFERENCE_SAMPLE_QUESTIONS]
    misses = [(q, want, got) for q, want, got in results if got != want]
    assert len(results) - len(misses) >= 8, misses
    assert not misses, misses


def test_embedder_determinism():
    e = HashedNgramEmbedder()
    a = e.embed(["midline shift measurement"])
    b = e.embed(["midline shift measurement"])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a[0]), 1.0, rtol=1e-5)


def test_md_horizontal_rule_without_header_keeps_full_body():
    doc = parse_md_text("Intro paragraph about gliomas.\n\n---\n\nMore text after the rule.")
    assert doc.title == ""
    assert "Intro paragraph" in doc.body and "More text" in doc.body


def _small_docs(n=6):
    return [KBDocument(f"d{i}", "", "1", "t", f"text {i}") for i in range(n)]


def test_large_store_device_matrix_cached(monkeypatch):
    emb = HashedNgramEmbedder(dim=64)
    docs = _small_docs()
    matrix = emb.embed([d.embed_text for d in docs])
    s = VectorStore(docs, matrix, emb, device="cpu")
    s.retrieve("text 3")  # small store: numpy route, no upload
    assert s.route == "host" and s._device_matrix is None
    monkeypatch.setattr(store_mod, "DEVICE_TOPK_MIN_ROWS", 1)
    s2 = VectorStore(docs, matrix, emb, device="cpu")
    first = s2.retrieve("text 3")
    dev = s2._device_matrix
    assert s2.route == "device" and isinstance(dev, torch.Tensor)
    s2.retrieve("text 4")
    assert s2._device_matrix is dev  # cached, not re-uploaded
    assert first[0][0].title == "d3"


# ---------------------------------------------------------------------------
# Copies of tests/test_rag_eval.py
# ---------------------------------------------------------------------------


def test_labels_are_valid(store):
    titles = {d.title for d in store.docs}
    for _, expected, _ in LABELED_QUERIES:
        assert expected in titles


def test_topk_accuracy_floor(store):
    top1, top2, n, misses = run_eval(store)
    assert n >= 30
    assert top1 / n >= 0.75, f"top-1 {top1}/{n}; misses: {misses}"
    assert top2 / n >= 0.90, f"top-2 {top2}/{n}; misses: {misses}"


def test_adversarial_subset_top2(store):
    adversarial = [q for q in LABELED_QUERIES if q[2] == "adversarial"]
    _, top2, n, misses = run_eval(store, adversarial)
    assert top2 / n >= 0.75, f"adversarial top-2 {top2}/{n}; misses: {misses}"


def test_v2_embedder_beats_v1_dim(store):
    top1_v2, top2_v2, _, _ = run_eval(store)
    texts = [d.embed_text for d in store.docs]
    store_v1 = build_vector_store(store.docs, embedder=HashedNgramEmbedder(dim=2048).fit_idf(texts))
    top1_v1, top2_v1, _, _ = run_eval(store_v1)
    assert top1_v2 >= top1_v1 and top2_v2 >= top2_v1


def test_out_of_scope_scores_are_low(store):
    on_topic = [store.retrieve(q, k=1)[0][1] for q, _, _ in LABELED_QUERIES]
    off_topic = [store.retrieve(q, k=1)[0][1] for q in (
        "best lasagna recipe with bechamel sauce", "how do I file my federal tax return",
        "current exchange rate euro to yen", "champions league semifinal schedule")]
    assert max(off_topic) < sum(on_topic) / len(on_topic)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def test_knowledge_base_equals_the_reference():
    port = [vars(d) for d in builtin_knowledge_base()]
    ref = [vars(d) for d in jax_rag.builtin_knowledge_base()]
    assert port == ref
    assert [d.embed_text for d in builtin_knowledge_base()] == \
        [d.embed_text for d in jax_rag.builtin_knowledge_base()]


@pytest.mark.parametrize("dim", [8192, 2048, 64])
def test_hashed_embedder_is_bit_equal_to_the_reference(dim):
    texts = [d.embed_text for d in builtin_knowledge_base()]
    port = HashedNgramEmbedder(dim=dim).fit_idf(texts)
    ref = jax_rag.HashedNgramEmbedder(dim=dim).fit_idf(texts)
    assert port.idf.dtype == ref.idf.dtype == np.float32
    assert np.array_equal(port.idf.view(np.uint32), ref.idf.view(np.uint32))
    queries = [q for q, _, _ in LABELED_QUERIES]
    for batch in (texts, queries):
        got, want = port.embed(batch), ref.embed(batch)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert port.name == ref.name


def test_labelled_queries_match_the_reference(store, jax_store):
    assert np.array_equal(store.matrix.view(np.uint32), jax_store.matrix.view(np.uint32))
    for query, _, _ in LABELED_QUERIES:
        got = store.retrieve(query, k=3)
        want = jax_store.retrieve(query, k=3)
        assert [d.title for d, _ in got] == [d.title for d, _ in want], query
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6,
                                   atol=1e-7)
    assert run_eval(store)[:3] == run_eval(jax_store)[:3]


def _big_matrix(texts, rows, dim=512, seed=0):
    """The KB's rows plus seeded unit rows: a store on the device route."""
    emb = HashedNgramEmbedder(dim=dim).fit_idf(texts)
    kb = emb.embed(texts)
    rnd = np.random.default_rng(seed).standard_normal((rows - len(texts), dim)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    return emb, np.concatenate([kb, rnd])


def test_device_route_matches_the_reference_and_numpy():
    """A store of DEVICE_TOPK_MIN_ROWS rows takes the device route (here on
    the CPU, as asked): the same top-k as numpy's argsort on the same
    matrix, and as the JAX package's store."""
    docs = builtin_knowledge_base()
    texts = [d.embed_text for d in docs]
    rows = store_mod.DEVICE_TOPK_MIN_ROWS
    assert rows == jax_store_mod.DEVICE_TOPK_MIN_ROWS == 4096
    emb, matrix = _big_matrix(texts, rows)
    pad = [KBDocument(f"row {i}", "", "", "random", "") for i in range(len(docs), rows)]
    port = VectorStore(docs + pad, matrix, emb, device="cpu")
    ref = jax_rag.VectorStore([jax_rag.KBDocument(**vars(d)) for d in docs + pad], matrix,
                              jax_rag.HashedNgramEmbedder(dim=emb.dim, idf=emb.idf))
    assert port.route == "device"
    for query, _, _ in LABELED_QUERIES:
        q = emb.embed([query])[0]
        vals, idx = port.topk(q, 5)
        scores = matrix @ q
        want_idx = np.argsort(-scores)[:5]
        np.testing.assert_allclose(vals, scores[want_idx], rtol=1e-5, atol=1e-6)
        # ties may come back in another order: sets where scores tie
        assert set(idx.tolist()) == set(want_idx.tolist()) or \
            np.allclose(np.sort(scores[idx]), np.sort(scores[want_idx]), rtol=1e-6)
        got = port.retrieve(query, k=2)
        want = ref.retrieve(query, k=2)
        assert [d.title for d, _ in got] == [d.title for d, _ in want], query
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6,
                                   atol=1e-7)
    assert isinstance(port._device_matrix, torch.Tensor)


def test_device_route_resolves_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(store_mod, "DEVICE_TOPK_MIN_ROWS", 1)
    emb = HashedNgramEmbedder(dim=64)
    docs = _small_docs()
    s = VectorStore(docs, emb.embed([d.embed_text for d in docs]), emb)  # device None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.retrieve("text 1")
    # below the threshold the host route never resolves a device
    monkeypatch.setattr(store_mod, "DEVICE_TOPK_MIN_ROWS", 4096)
    assert s.retrieve("text 1")[0][0].title == "d1"


def test_device_route_failure_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(store_mod, "DEVICE_TOPK_MIN_ROWS", 1)
    emb = HashedNgramEmbedder(dim=64)
    docs = _small_docs()
    s = VectorStore(docs, emb.embed([d.embed_text for d in docs]), emb, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("topk failed on the device")

    monkeypatch.setattr(store_mod.torch, "topk", broken)
    with pytest.raises(RuntimeError, match="topk failed"):
        s.retrieve("text 2")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_store_saved_by_one_package_loads_in_the_other(tmp_path, store, jax_store, writer):
    path = tmp_path / "kb.npz"
    (store if writer == "port" else jax_store).save(path)
    port, ref = load_vector_store(path), jax_rag.load_vector_store(path)
    assert np.array_equal(port.matrix, ref.matrix)
    assert np.array_equal(port.embedder.idf, ref.embedder.idf)
    assert [vars(d) for d in port.docs] == [vars(d) for d in ref.docs]
    for query, _, _ in LABELED_QUERIES[:8]:
        assert [d.title for d, _ in port.retrieve(query)] == \
            [d.title for d, _ in ref.retrieve(query)]


def test_a_minilm_store_is_refused_without_the_network(tmp_path, store):
    path = tmp_path / "minilm.npz"
    store.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["embedder"] = np.frombuffer(b"all-MiniLM-L6-v2", np.uint8)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="all-MiniLM-L6-v2.*MiniLM is not ported"):
        load_vector_store(path)
    # an embedder passed by the caller is used as given
    assert load_vector_store(path, embedder=store.embedder).retrieve("glioma", 1)


def test_prompt_gates_and_refusals_equal_the_reference(store, jax_store):
    assert PROMPT_TEMPLATE == jax_rag.PROMPT_TEMPLATE
    assert BLOCKED_KEYWORDS == jax_rag.BLOCKED_KEYWORDS
    assert (REFUSAL_CLINICAL, REFUSAL_DATA) == (jax_rag.REFUSAL_CLINICAL, jax_rag.REFUSAL_DATA)
    for query, _, _ in LABELED_QUERIES + [("What about the prognosis?", "", "")]:
        assert is_clinical_query(query) == jax_rag.is_clinical_query(query)
        got = build_prompt(query, " REPORT\n", store.retrieve(query, 2))
        want = jax_rag.build_prompt(query, " REPORT\n", jax_store.retrieve(query, 2))
        assert got == want
    assert build_prompt("q", "r", []) == jax_rag.build_prompt("q", "r", [])
    assert sorted(assistant_mod.__all__) == sorted(jax_rag.assistant.__all__)


def test_exports_are_the_reference_ones_but_minilm():
    import braintpu_torch.rag as port_rag

    assert sorted(port_rag.__all__) == sorted(set(jax_rag.__all__) - {"SentenceTransformerEmbedder"})


# ---------------------------------------------------------------------------
# cli rag and build-kb
# ---------------------------------------------------------------------------


def test_cli_build_kb_and_rag(tmp_path, capsys):
    kb = tmp_path / "kb"
    kb.mkdir()
    (kb / "a.md").write_text("TITLE: Alpha Topic\nKEYWORDS: alpha\nVERSION: 1\n---\nAlpha body.")
    (kb / "b.md").write_text("TITLE: Beta Topic\nKEYWORDS: beta\nVERSION: 1\n---\nBeta body.")
    out = tmp_path / "store.npz"
    assert cli.main(["build-kb", "--knowledge-dir", str(kb), "--output", str(out)]) == 0
    assert "embedded 2 documents" in capsys.readouterr().out
    assert jax_rag.load_vector_store(out).retrieve("beta", 1)[0][0].title == "Beta Topic"
    report = tmp_path / "report.txt"
    report.write_text("Midline shift 3 mm.", encoding="utf-8")
    assert cli.main(["rag", "--store", str(out), "--question", "What is beta?",
                     "--report", str(report), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == REFUSAL_DATA  # offline
    assert cli.main(["rag", "--question", "Which therapy is best?"]) == 0
    assert capsys.readouterr().out.strip() == REFUSAL_CLINICAL
    assert cli.main(["rag", "--test", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].strip().startswith("→ Midline Shift")
