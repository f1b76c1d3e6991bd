"""Minimal `.env` file loader (reference parity: the reference loads
``GEMINI_API_KEY`` from a repo-root ``.env`` file via python-dotenv —
upstream generate_report_gemini.py:31-42 and
upstream RAG_Assistant/rag_assistant.py:35-39).

No python-dotenv dependency: this parses the common subset (``KEY=VALUE``
lines, ``#`` comments, optional ``export `` prefix, single/double quotes)
and never overrides variables already present in the process environment —
matching ``dotenv.load_dotenv(override=False)`` semantics.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

__all__ = ["parse_dotenv", "load_dotenv"]


def parse_dotenv(text: str) -> Dict[str, str]:
    """Parse `.env` text into a dict; malformed lines are skipped."""
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export "):].lstrip()
        key, sep, value = line.partition("=")
        key = key.strip()
        if not sep or not key or any(c.isspace() for c in key):
            continue
        value = value.strip()
        if value[:1] in "\"'":
            # quoted value: take through the matching close quote, so an
            # inline comment after it ('KEY="abc" # prod') can't leak the
            # quote characters into the value (python-dotenv semantics)
            closing = value.find(value[0], 1)
            if closing != -1:
                value = value[1:closing]
            elif len(value) >= 2 and value[0] == value[-1]:
                value = value[1:-1]
        else:
            # strip trailing inline comment on unquoted values
            hash_pos = value.find(" #")
            if hash_pos != -1:
                value = value[:hash_pos].rstrip()
        out[key] = value
    return out


def load_dotenv(path: Optional[os.PathLike] = None) -> Dict[str, str]:
    """Load a `.env` file into ``os.environ`` without overriding existing vars.

    With no explicit *path*, searches the current directory then its parents
    (nearest wins), like python-dotenv's ``find_dotenv``. Returns the mapping
    of variables actually set (empty if no file found or nothing new).
    """
    candidates = [Path(path)] if path is not None else [
        d / ".env" for d in [Path.cwd(), *Path.cwd().parents]
    ]
    for candidate in candidates:
        if not candidate.is_file():
            continue
        try:
            parsed = parse_dotenv(candidate.read_text())
        except OSError:
            continue  # unreadable candidate: keep searching parents
        applied = {k: v for k, v in parsed.items() if k not in os.environ}
        os.environ.update(applied)
        return applied
    return {}
