"""Retrieval-augmented educational assistant: KB, dense store, gated Q&A.

The port's copy of ``braintpu/rag`` with the reference's exports, apart from
``SentenceTransformerEmbedder`` (MiniLM needs a package and weights that are
not in the repository).
"""

from .assistant import (
    BLOCKED_KEYWORDS,
    PROMPT_TEMPLATE,
    REFUSAL_CLINICAL,
    REFUSAL_DATA,
    RagAssistant,
    answer_query,
    build_prompt,
    is_clinical_query,
)
from .knowledge import (
    KBDocument,
    builtin_knowledge_base,
    load_knowledge_dir,
    parse_md_file,
    parse_md_text,
)
from .store import (
    HashedNgramEmbedder,
    VectorStore,
    build_vector_store,
    load_vector_store,
)

__all__ = [
    "BLOCKED_KEYWORDS",
    "PROMPT_TEMPLATE",
    "REFUSAL_CLINICAL",
    "REFUSAL_DATA",
    "RagAssistant",
    "answer_query",
    "build_prompt",
    "is_clinical_query",
    "KBDocument",
    "builtin_knowledge_base",
    "load_knowledge_dir",
    "parse_md_file",
    "parse_md_text",
    "HashedNgramEmbedder",
    "VectorStore",
    "build_vector_store",
    "load_vector_store",
]
