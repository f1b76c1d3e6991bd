"""Hallucination-guarded report generation: governance, facts, slots, engine, PDF, LLM.

The port's copy of ``braintpu/report`` (host Python).  The LLM refinement
stays off unless asked for; its HTTP client is imported only when called.
"""

from .engine import ReportEngine, generate_report_from_summary, generate_report_simple
from .facts import extract_facts
from .governance import (
    CONCEPT_OWNERSHIP,
    FINDINGS_PARAGRAPH_STRUCTURE,
    GLOBAL_BANNED_WORDS,
    HEDGED_DIAGNOSTIC_PHRASES,
    MRI_BRAIN_TEMPLATE,
    SECTION_FORBIDDEN_TERMS,
    SLOT_SPECIFICATIONS,
)
from .llm import ConstrainedSlotFiller, GeminiClient, refine_report
from .pdf import PDFWriter, generate_pdf_report, parse_report_sections
from .slots import map_facts_to_slots
from .validator import SlotValidator

__all__ = [
    "ReportEngine",
    "generate_report_from_summary",
    "generate_report_simple",
    "extract_facts",
    "map_facts_to_slots",
    "SlotValidator",
    "ConstrainedSlotFiller",
    "GeminiClient",
    "refine_report",
    "PDFWriter",
    "generate_pdf_report",
    "parse_report_sections",
    "CONCEPT_OWNERSHIP",
    "FINDINGS_PARAGRAPH_STRUCTURE",
    "GLOBAL_BANNED_WORDS",
    "HEDGED_DIAGNOSTIC_PHRASES",
    "MRI_BRAIN_TEMPLATE",
    "SECTION_FORBIDDEN_TERMS",
    "SLOT_SPECIFICATIONS",
]
