"""Report assembly engine: the deterministic 6-step pipeline + gatekeeper.

Mirrors the reference's ``ReportTemplateFiller``
(upstream report_templates.py:1727-2084):

1. rigid human-written template (:mod:`braintpu_torch.report.governance`),
2. slot specifications with constraints,
3. fact extraction (:mod:`braintpu_torch.report.facts`),
4. deterministic slot mapping (:mod:`braintpu_torch.report.slots`),
5. mandatory per-slot validation with fallbacks
   (:mod:`braintpu_torch.report.validator`),
6. zero-creativity ``format()`` assembly + the final gatekeeper pass —
   section re-scan, duplicate-concept logging, fragment cleanup, banned-word
   redaction (ref :1869-1988).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .facts import extract_facts
from .governance import (
    CONCEPT_OWNERSHIP,
    MRI_BRAIN_TEMPLATE,
    SECTION_FORBIDDEN_TERMS,
)
from .slots import map_facts_to_slots
from .validator import SlotValidator, _occurrences_all_in_allowed_compounds

__all__ = ["ReportEngine", "generate_report_from_summary", "generate_report_simple"]

_SECTION_MARKERS = ["FINDINGS:", "IMPRESSION:", "TECHNIQUE:", "COMPARISON:"]

_FRAGMENT_CLEANUPS = [
    (r",\s*\.", "Comma before period"),
    (r",\s*,", "Double comma"),
    (r"\.\s*\.", "Double period"),
    (r"\s{3,}", "Excessive whitespace"),
]


def _section_span(report: str, marker: str):
    """(start, end) character span of a section's content, or None."""
    if marker not in report:
        return None
    start = report.find(marker) + len(marker)
    end = len(report)
    for other in _SECTION_MARKERS:
        if other != marker:
            i = report.find(other, start)
            if i != -1 and i < end:
                end = i
    return start, end


def _split_sections(report: str) -> Dict[str, str]:
    sections = {}
    for marker in _SECTION_MARKERS:
        span = _section_span(report, marker)
        if span is None:
            continue
        sections[marker[:-1]] = report[span[0] : span[1]].strip()
    return sections


class ReportEngine:
    """Deterministic slot/template report generator."""

    def __init__(
        self,
        summary: Dict,
        validate: bool = True,
        llm_filler=None,
        exam_date: Optional[str] = None,
    ):
        self.summary = summary
        self.validate = validate
        self.validator = SlotValidator()
        self.validation_log: List[Dict] = []
        self.facts = extract_facts(summary)
        self.llm_filler = llm_filler
        self.exam_date = exam_date

    # ------------------------------------------------------------------

    def _log(self, slot: str, original: str, sanitized: str, violations: List[str]) -> None:
        self.validation_log.append(
            {
                "slot": slot,
                "original": original,
                "sanitized": sanitized,
                "violations": violations,
            }
        )

    def slot_values(self) -> Dict[str, str]:
        """Raw slot sentences before validation (step 4)."""
        return map_facts_to_slots(self.facts, exam_date=self.exam_date)

    def fill_template(self, template: Optional[str] = None) -> str:
        template = template or MRI_BRAIN_TEMPLATE
        self.validation_log = []
        self.validator.reset_concept_tracking()

        raw = self.slot_values()
        values: Dict[str, str] = {}
        for slot_name, content in raw.items():
            if not self.validate:
                values[slot_name] = content
                continue
            ok, sanitized, violations = self.validator.validate(slot_name, content)
            if violations:
                self._log(slot_name, content, sanitized, violations)
            values[slot_name] = sanitized

        report = template.format(**values)
        while "\n\n\n" in report:
            report = report.replace("\n\n\n", "\n\n")
        return self._gatekeeper(report)

    # -- step 7: final deterministic validation pass ---------------------

    def _gatekeeper(self, report: str) -> str:
        # 1. section forbidden terms → redact WITHIN the offending section
        # only (spans are recomputed per redaction as text shrinks): the
        # same word can be required hedged language elsewhere — e.g.
        # "suspicious" is FINDINGS-forbidden but part of IMPRESSION's
        # "suspicious for high-grade neoplastic process"
        for marker in _SECTION_MARKERS:
            name = marker[:-1]
            for term in SECTION_FORBIDDEN_TERMS.get(name, []):
                span = _section_span(report, marker)
                if span is None:
                    break
                content = report[span[0] : span[1]]
                if term.lower() in content.lower():
                    self._log(
                        f"FINAL_{name}",
                        f"[Contains: {term}]",
                        "[REDACTED]",
                        [f"Section '{name}' contains forbidden term: '{term}'"],
                    )
                    content = re.compile(
                        r"\b" + re.escape(term) + r"\b", re.IGNORECASE
                    ).sub("", content)
                    report = report[: span[0]] + content + report[span[1] :]

        # 2. duplicated concepts → log
        for concept in CONCEPT_OWNERSHIP:
            phrase = concept.replace("_", " ")
            count = report.lower().count(phrase)
            if count > 1:
                self._log(
                    "FINAL_CONCEPTS",
                    f"[Duplicate: {concept}]",
                    "[LOGGED]",
                    [f"Concept '{concept}' appears {count} times"],
                )

        # 3. fragments → clean
        for pattern, description in _FRAGMENT_CLEANUPS:
            if re.search(pattern, report):
                self._log(
                    "FINAL_GRAMMAR",
                    f"[Fragment: {description}]",
                    "[CLEANED]",
                    [f"Grammar issue: {description}"],
                )
                report = re.sub(pattern, " ", report)

        # 4. empty sentences / dangling commas
        report = re.sub(r"\n\s*\.\s*\n", "\n", report)
        report = re.sub(r"\s+,\s+", " ", report)

        # 5. whitespace normalization
        report = re.sub(r" {2,}", " ", report)
        while "\n\n\n" in report:
            report = report.replace("\n\n\n", "\n\n")

        # 6. global banned words final net
        for banned in SlotValidator.GLOBAL_BANNED_WORDS:
            if banned.lower() in report.lower() and not _occurrences_all_in_allowed_compounds(
                report, banned
            ):
                self._log(
                    "FINAL_BANNED",
                    f"[Contains: {banned}]",
                    "[REDACTED]",
                    [f"Final check caught banned term: '{banned}'"],
                )
                report = re.compile(r"\b" + re.escape(banned) + r"\b", re.IGNORECASE).sub(
                    "", report
                )
        return report


def generate_report_from_summary(
    summary: Dict, validate: bool = True
) -> Tuple[str, List[Dict], Dict]:
    """Main entry: llm_ready_summary dict → (report, validation_log, facts).

    Same contract as the reference's ``generate_report_from_summary``
    (ref :2056-2072).
    """
    engine = ReportEngine(summary, validate=validate)
    report = engine.fill_template()
    return report, engine.validation_log, engine.facts


def generate_report_simple(summary: Dict) -> str:
    return generate_report_from_summary(summary)[0]
