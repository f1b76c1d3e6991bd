"""Slot validation: the enforcement layer for clinical governance.

Implements the reference's 7-point validation
(upstream report_templates.py:395-641): global banned words with
allowed-compound exceptions, section forbidden terms, slot forbidden terms,
length caps with truncation, concept-ownership tracking, sentence-integrity
heuristics, and fallback substitution on violation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .governance import (
    ALLOWED_COMPOUND_WORDS,
    CONCEPT_OWNERSHIP,
    GLOBAL_BANNED_WORDS,
    SECTION_FORBIDDEN_TERMS,
    SLOT_SPECIFICATIONS,
)

__all__ = ["ValidationResult", "SlotValidator"]

_SENTINELS = ("[BANNED]", "[SECTION_VIOLATION]", "[SLOT_VIOLATION]")

_FRAGMENT_PATTERNS = [
    r"^[a-z]",
    r",\s*$",
    r"^\s*and\s",
    r"^\s*with\s",
    r",\s*,",
    r"\s{2,}",
]


@dataclass
class ValidationResult:
    is_valid: bool
    content: str
    violations: List[str] = field(default_factory=list)


def _occurrences_all_in_allowed_compounds(text: str, banned: str) -> bool:
    """True when every occurrence of ``banned`` sits inside an allowed compound."""
    low = text.lower()
    b = banned.lower()
    spans = []
    for compound in ALLOWED_COMPOUND_WORDS:
        start = 0
        c = compound.lower()
        while True:
            i = low.find(c, start)
            if i == -1:
                break
            spans.append((i, i + len(c)))
            start = i + 1
    pos = 0
    while True:
        i = low.find(b, pos)
        if i == -1:
            return True
        if not any(s <= i < e for s, e in spans):
            return False
        pos = i + 1


class SlotValidator:
    """Validates and sanitizes slot content against the governance data."""

    GLOBAL_BANNED_WORDS = GLOBAL_BANNED_WORDS
    ALLOWED_COMPOUND_WORDS = ALLOWED_COMPOUND_WORDS

    def __init__(self, specifications: Optional[Dict] = None):
        self.specs = specifications or SLOT_SPECIFICATIONS
        self.reported_concepts: Set[str] = set()

    def reset_concept_tracking(self) -> None:
        self.reported_concepts = set()

    # -- individual checks --------------------------------------------------

    def _section_violations(self, slot_name: str, content: str) -> List[str]:
        spec = self.specs.get(slot_name)
        if not spec:
            return []
        section = spec.get("section", "")
        terms = SECTION_FORBIDDEN_TERMS.get(section, [])
        low = content.lower()
        return [
            f"Section '{section}' forbidden term: '{t}'" for t in terms if t.lower() in low
        ]

    def _concept_violations(self, slot_name: str, content: str) -> List[str]:
        violations = []
        low = content.lower()
        for concept, owner in CONCEPT_OWNERSHIP.items():
            mentioned = concept.replace("_", " ") in low or concept in low
            if slot_name == owner:
                if mentioned:
                    self.reported_concepts.add(concept)
            elif concept in self.reported_concepts and mentioned:
                violations.append(f"Concept '{concept}' already reported by '{owner}'")
        return violations

    def check_sentence_integrity(self, content: str) -> List[str]:
        violations = [
            f"Possible sentence fragment: pattern '{p}'"
            for p in _FRAGMENT_PATTERNS
            if re.search(p, content)
        ]
        stripped = content.strip()
        if stripped and not stripped.endswith((".", "?", "!")):
            if not stripped.startswith(("1.", "2.", "-", "*")):
                violations.append("Sentence does not end with proper punctuation")
        return violations

    # -- main entry ---------------------------------------------------------

    def validate(
        self, slot_name: str, content: str, check_section: bool = True
    ) -> Tuple[bool, str, List[str]]:
        """Run the validation cascade; returns (is_valid, sanitized, violations)."""
        violations: List[str] = []
        sanitized = content
        low = content.lower()

        for banned in self.GLOBAL_BANNED_WORDS:
            if banned.lower() in low and not _occurrences_all_in_allowed_compounds(
                content, banned
            ):
                violations.append(f"Global banned: '{banned}'")
                sanitized = "[BANNED]"
                break

        if sanitized != "[BANNED]" and check_section:
            sect = self._section_violations(slot_name, content)
            if sect:
                violations.extend(sect)
                sanitized = "[SECTION_VIOLATION]"

        if sanitized not in _SENTINELS and slot_name in self.specs:
            for term in self.specs[slot_name].get("forbidden_terms", []):
                if term.lower() in low:
                    violations.append(f"Slot forbidden: '{term}'")
                    sanitized = "[SLOT_VIOLATION]"
                    break

        if sanitized not in _SENTINELS and slot_name in self.specs:
            max_len = self.specs[slot_name].get("max_length", float("inf"))
            if len(sanitized) > max_len:
                violations.append(f"Exceeds max length ({len(sanitized)} > {max_len})")
                sanitized = sanitized[: int(max_len) - 3] + "..."

        if sanitized not in _SENTINELS:
            violations.extend(self._concept_violations(slot_name, content))
            violations.extend(self.check_sentence_integrity(sanitized))

        if sanitized in _SENTINELS:
            fallback = self.get_fallback(slot_name)
            if fallback:
                sanitized = fallback
                violations.append("Used fallback due to validation failure")

        return len(violations) == 0, sanitized, violations

    def report_violations(self, report: str) -> List[str]:
        """The governance rules that hold for a whole final report: no global
        banned word outside its allowed compounds, and no section-forbidden
        term in its section (whole words, as the engine's final pass redacts
        them).  Empty for a report that passes.  (An addition of the port:
        the reference applies these rules only while it writes the report.)
        """
        from .engine import _split_sections

        found = [
            f"global banned: {w!r}" for w in self.GLOBAL_BANNED_WORDS
            if re.search(r"\b" + re.escape(w) + r"\b", report, re.IGNORECASE)
            and not _occurrences_all_in_allowed_compounds(report, w)
        ]
        for name, body in _split_sections(report).items():
            for term in SECTION_FORBIDDEN_TERMS.get(name, []):
                if re.search(r"\b" + re.escape(term) + r"\b", body, re.IGNORECASE):
                    found.append(f"section {name}: {term!r}")
        return found

    # -- helpers ------------------------------------------------------------

    def get_fallback(self, slot_name: str) -> str:
        return self.specs.get(slot_name, {}).get("fallback", "")

    def get_allowed_values(self, slot_name: str, fld: str) -> List[str]:
        return self.specs.get(slot_name, {}).get("allowed_values", {}).get(fld, [])

    def validate_value(self, slot_name: str, fld: str, value: str) -> bool:
        allowed = self.get_allowed_values(slot_name, fld)
        return True if not allowed else value.lower() in [v.lower() for v in allowed]
