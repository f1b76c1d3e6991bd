"""Vector store: embeddings-as-matmul retrieval.

The port's copy of ``braintpu/rag/store.py``.  Documents are embedded once
into a dense matrix; a query is one embed, one matrix-vector product and a
top-k.  The upstream project used ChromaDB + sentence-transformers
(upstream RAG_Assistant/vector_store_builder.py:145-368,
rag_assistant.py:131-211).

* :class:`HashedNgramEmbedder`: deterministic hashed word + character
  trigram TF embedding with IDF weighting, pure numpy, no model weights,
  offline.  Its matrices are bit-equal to the reference package's.
* The MiniLM embedder of the reference package is not ported: it needs the
  ``sentence_transformers`` package and the all-MiniLM-L6-v2 weights.  A
  saved store that names another embedder raises on load.

Two routes for the top-k, chosen by the store's size:

* below :data:`DEVICE_TOPK_MIN_ROWS` rows, a numpy matvec and ``np.argsort``
  (a host product beats a device round trip on a few dozen rows);
* at that size or more, the matrix is uploaded to the device once and a
  query is one ``torch.matmul`` with the query vector and one
  ``torch.topk``.  The device is ``device`` (``None``: the card, resolved
  only when this route is taken; ``"cpu"`` only when asked for).  A failed
  upload or top-k raises: there is no silent numpy fallback.

Persistence is one ``.npz`` (matrix, documents as JSON, embedder name, IDF)
in the reference package's format: a store either package writes loads in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import asdict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .knowledge import KBDocument, builtin_knowledge_base

__all__ = [
    "DEVICE_TOPK_MIN_ROWS",
    "HashedNgramEmbedder",
    "VectorStore",
    "build_vector_store",
    "load_vector_store",
]

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _stable_hash(token: str, dim: int, salt: str = "") -> int:
    h = hashlib.blake2b(f"{salt}:{token}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % dim


class HashedNgramEmbedder:
    """Deterministic hashed TF-IDF embedding over words + char trigrams.

    ``fit_idf`` learns inverse-document-frequency weights from the corpus so
    boilerplate shared across documents (guard sections, common radiology
    vocabulary) stops dominating cosine similarity.
    """

    name = "hashed-ngram-v2"  # v2: 8192-d hash space (4x fewer collisions)

    #: char-trigram features get a fraction of a whole word's weight: they
    #: give typo/morphology robustness without drowning exact matches (the
    #: reference's choice, evaluated on tests/test_rag_eval.py's 33 queries).
    TRIGRAM_WEIGHT = 0.3

    def __init__(self, dim: int = 8192, idf: Optional[np.ndarray] = None):
        self.dim = dim
        self.idf = idf  # (dim,) or None = unweighted

    def fit_idf(self, texts: Sequence[str]) -> "HashedNgramEmbedder":
        tf = self._tf_matrix(texts)
        df = (tf > 0).sum(axis=0)
        self.idf = np.log(1.0 + len(texts) / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def _features(self, text: str) -> List[tuple]:
        words = _TOKEN_RE.findall(text.lower())
        feats = [(w, 1.0) for w in words]
        for w in words:
            padded = f"#{w}#"
            feats.extend(
                (padded[i : i + 3], self.TRIGRAM_WEIGHT) for i in range(len(padded) - 2)
            )
        return feats

    def _tf_matrix(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            for f, weight in self._features(text):
                out[i, _stable_hash(f, self.dim)] += weight
            np.sqrt(out[i], out=out[i])  # sub-linear TF
        return out

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self._tf_matrix(texts)
        if self.idf is not None:
            out *= self.idf
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        return out


#: Below this many rows a host matvec beats a device round trip; from it on
#: the store keeps its matrix on the device and a query is one matmul + topk.
DEVICE_TOPK_MIN_ROWS = 4096


class VectorStore:
    """Dense-retrieval store over knowledge documents."""

    def __init__(self, docs: List[KBDocument], matrix: np.ndarray, embedder,
                 device: Union[None, str, torch.device] = None):
        self.docs = docs
        self.matrix = matrix.astype(np.float32)
        self.embedder = embedder
        self.device = device  # resolved only when the device route is taken
        self._device_matrix: Optional[torch.Tensor] = None  # one upload, then reused

    # -- queries -----------------------------------------------------------

    @property
    def route(self) -> str:
        """``"device"`` (matmul + topk on the device) or ``"host"`` (numpy)."""
        return "device" if self.matrix.shape[0] >= DEVICE_TOPK_MIN_ROWS else "host"

    def _device_copy(self) -> torch.Tensor:
        """Upload the matrix once; queries then only ship the query vector."""
        if self._device_matrix is None:
            self._device_matrix = torch.from_numpy(self.matrix).to(resolve_device(self.device))
        return self._device_matrix

    def topk(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Cosine scores and row indices of the ``k`` best rows for one
        embedded query, best first."""
        k = min(k, self.matrix.shape[0])
        if self.route == "device":
            mat = self._device_copy()
            scores = torch.matmul(mat, torch.from_numpy(np.asarray(query, np.float32)).to(mat.device))
            vals, idx = torch.topk(scores, k)
            return vals.cpu().numpy(), idx.cpu().numpy()
        scores = self.matrix @ query
        idx = np.argsort(-scores)[:k]
        return scores[idx], idx

    def retrieve(self, query: str, k: int = 2) -> List[Tuple[KBDocument, float]]:
        vals, idx = self.topk(self.embedder.embed([query])[0], k)
        return [(self.docs[int(i)], float(v)) for v, i in zip(vals, idx)]

    def query(self, query_text: str, n_results: int = 2) -> dict:
        """ChromaDB-shaped result dict for drop-in compatibility."""
        hits = self.retrieve(query_text, n_results)
        return {
            "documents": [[d.embed_text for d, _ in hits]],
            "metadatas": [
                [{"title": d.title, "keywords": d.keywords, "source": d.source} for d, _ in hits]
            ],
            "distances": [[1.0 - s for _, s in hits]],
        }

    # -- persistence --------------------------------------------------------

    def save(self, path) -> None:
        # np.savez appends ".npz" to extensionless paths; normalize here so
        # save(p) / load_vector_store(p) round-trip with the same string
        path = _npz_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        docs_json = json.dumps([asdict(d) for d in self.docs])
        extra = {}
        if getattr(self.embedder, "idf", None) is not None:
            extra["idf"] = self.embedder.idf
        np.savez_compressed(
            path,
            matrix=self.matrix,
            docs=np.frombuffer(docs_json.encode(), np.uint8),
            embedder=np.frombuffer(self.embedder.name.encode(), np.uint8),
            **extra,
        )


def build_vector_store(
    docs: Optional[List[KBDocument]] = None,
    embedder=None,
    knowledge_dir=None,
    device: Union[None, str, torch.device] = None,
) -> VectorStore:
    """Embed a knowledge base into a store (the built-in KB by default)."""
    if docs is None:
        if knowledge_dir is not None:
            from .knowledge import load_knowledge_dir

            docs = load_knowledge_dir(knowledge_dir)
        else:
            docs = builtin_knowledge_base()
    texts = [d.embed_text for d in docs]
    if embedder is None:
        embedder = HashedNgramEmbedder().fit_idf(texts)
    matrix = embedder.embed(texts)
    return VectorStore(docs, matrix, embedder, device=device)


def _npz_path(path) -> str:
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def load_vector_store(path, embedder=None,
                      device: Union[None, str, torch.device] = None) -> VectorStore:
    """A store saved by :meth:`VectorStore.save` (of either package).

    Raises ``ValueError`` for a store whose embedder is not the hashed n-gram
    one and no ``embedder`` is passed: the MiniLM embedder is not ported.
    """
    with np.load(_npz_path(path)) as z:
        docs_json = bytes(z["docs"]).decode()
        matrix = z["matrix"]
        saved_embedder = bytes(z["embedder"]).decode()
        idf = z["idf"] if "idf" in z.files else None
    docs = [KBDocument(**d) for d in json.loads(docs_json)]
    if embedder is None:
        if not saved_embedder.startswith("hashed-ngram"):
            raise ValueError(
                f"store {Path(path)} was embedded with {saved_embedder!r}; braintpu_torch has "
                "the hashed n-gram embedder only (MiniLM is not ported): pass embedder= or "
                "rebuild the store with build-kb")
        if saved_embedder != HashedNgramEmbedder.name:
            # feature space changed since the store was written; the doc
            # texts are persisted, so re-embedding reproduces it exactly
            return build_vector_store(docs, device=device)
        embedder = HashedNgramEmbedder(dim=matrix.shape[1], idf=idf)
    return VectorStore(docs, matrix, embedder, device=device)
