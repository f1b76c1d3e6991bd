"""Safety-gated RAG assistant for patient-report Q&A.

The port's copy of ``braintpu/rag/assistant.py``: the same gate, blocklist,
prompt template (character for character), refusals and flow.  Pipeline
parity with upstream RAG_Assistant/rag_assistant.py:494-570: keyword
blocklist gate (the LLM is never invoked for clinical queries, ref :62-71,
:231-252) → top-2 dense retrieval → strict Anchor-&-Explain prompt
(ref :259-359) → Gemini 2.5-flash at temperature 0.1 (ref :421-459) →
hard-coded refusal strings on any failure (ref :46-53).

LLM access goes through the port's :class:`..report.llm.GeminiClient`;
offline the assistant takes the grounded-refusal path, as upstream does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..report.llm import GeminiClient
from .knowledge import KBDocument
from .store import VectorStore, build_vector_store

__all__ = [
    "REFUSAL_CLINICAL",
    "REFUSAL_DATA",
    "BLOCKED_KEYWORDS",
    "PROMPT_TEMPLATE",
    "is_clinical_query",
    "build_prompt",
    "RagAssistant",
    "answer_query",
]

REFUSAL_CLINICAL = (
    "I cannot answer clinical questions regarding diagnosis, prognosis, "
    "or treatment. Please consult a doctor."
)

REFUSAL_DATA = (
    "This information is not present in the generated report "
    "or verified definitions."
)

#: Queries containing any of these are refused before the LLM is invoked.
BLOCKED_KEYWORDS: List[str] = [
    "treatment", "therapy", "surgery", "medication", "drug",
    "prognosis", "survival", "outcome", "chemotherapy", "radiation",
]

PROMPT_TEMPLATE = """\
You are an Educational MRI Assistant with expertise in neuroradiology.

You support probabilistic clinical reasoning — explaining typical radiologic
associations — while strictly refusing to diagnose the patient.

### CONTEXT 1: PATIENT REPORT
{patient_report}

### CONTEXT 2: KNOWLEDGE BASE
{definitions}

### KNOWLEDGE SOURCE RULES
- Patient-specific findings must come ONLY from Context 1 (Patient Report).
  Do NOT invent, assume, or extrapolate findings beyond what is described.
- Medical associations and definitions must come ONLY from Context 2
  (Knowledge Base). If no relevant association was retrieved, state:
  "This association is not described in the available verified knowledge."
- Do NOT draw on unrestricted internal medical knowledge.

### PROBABILISTIC REASONING (Allowed)
When discussing imaging findings you MAY use language such as:
  "is commonly associated with", "raises suspicion for",
  "is frequently seen in", "is characteristic of",
  "suggests but does not confirm".
The tone must remain objective and educational.

### CLINICAL LIMITATION RULE
When an explanation touches on aggressiveness, tumor grade, or tumor type:
  Naturally clarify that imaging findings alone do not establish a
  definitive diagnosis and that histopathologic confirmation is required.
  Integrate this clarification contextually — do NOT append it mechanically.

### FORBIDDEN — Hard Safety Boundary
You must NEVER:
  - Diagnose the patient ("This patient has…", "This confirms…",
    "This is definitively…", "The tumor is Grade…").
  - State a prognosis ("The prognosis is…", "Survival is…").
  - Recommend any treatment, therapy, medication, or surgery.
If the user asks for any of the above, respond ONLY with:
  "I cannot answer clinical questions regarding diagnosis, prognosis,
   or treatment. Please consult a doctor."

### RESPONSE RULES

1. Directness
   - Begin with a HEADLINE: one clear, direct sentence answering the user's question.
   - Do not use filler phrases (e.g., "Based on the context", "The report indicates").

2. Structure
   - After the HEADLINE, provide SUPPORTING DETAILS as a bulleted list.
   - Each bullet must contain exactly one idea.
   - **Bold** all measurements, volumes, and anatomical locations (e.g., **12.4 cm³**, **Right Temporal Lobe**).
   - Do not write paragraph-style prose inside bullets.

3. Content Logic (The "Anchor & Explain" Pattern)
   - First bullet(s): Extract specific findings from the PATIENT REPORT (Context 1).
   - Next bullet(s): Explain the mechanism or association using the KNOWLEDGE BASE (Context 2).
   - Explicitly connect the patient's specific value to the general concept.

4. Imaging Sign Questions
   - First, confirm if the sign is PRESENT or ABSENT in the report.
   - If the user asks about significance or mechanism, then explain the radiologic basis and associations.

5. Safety & Grounding
   - If the answer is not in the context, output ONLY: "This information is not present in the generated report or verified definitions."
   - If the user asks for diagnosis/prognosis, output ONLY: "I cannot answer clinical questions regarding diagnosis, prognosis, or treatment. Please consult a doctor."

6. Brevity Control
   - Use 2–4 bullets maximum for factual questions.
   - Use 4–6 bullets maximum for reasoning questions.
   - Never repeat the same finding or concept across multiple bullets.

7. Question-Type Adaptation
   - If the user asks a simple factual retrieval question
     (e.g., presence, size, location, yes/no),
     provide ONLY:
        • A direct HEADLINE answer.
        • Supporting bullets strictly from Context 1.
     Do NOT include pathophysiology or associations unless explicitly asked.

   - If the user asks a reasoning or mechanism question
     (e.g., "what does this suggest?", "why?", "what is the significance?"),
     then apply the full Anchor & Explain pattern.

8. Clinical Boundary Enforcement
     - A. Treatment & Prognosis (HARD REFUSAL)
         - If the user asks about Treatment (surgery, radiation, medication) or
             Prognosis (survival, life expectancy, recovery):
                 - Output ONLY: "I cannot answer clinical questions regarding prognosis or treatment. Please consult a specialist."

     - B. Diagnosis & Tumor Grading (CONDITIONAL RESPONSE)
         - If the user asks about tumor type, tumor grade, or definitive diagnosis:
                 - First check whether the report contains probabilistic diagnostic language
                     (e.g., "suspicious for," "suggestive of," "consistent with").
                 - If such language is present:
                         - State exactly what the report describes using the same probabilistic wording.
                         - Clarify that imaging findings alone do not establish a definitive diagnosis or WHO grade.
                         - Do NOT assign a tumor type or numerical grade.
                 - If no diagnostic language is present:
                         - Output ONLY: "The generated report describes imaging findings but does not specify a tumor type or grade. Please consult a radiologist."

### USER QUESTION
{user_query}
"""


def is_clinical_query(user_query: str) -> bool:
    """True when the query hits the clinical blocklist (gate runs pre-LLM)."""
    low = user_query.lower()
    return any(k in low for k in BLOCKED_KEYWORDS)


def build_prompt(
    user_query: str,
    patient_report: str,
    retrieved: List[Tuple[KBDocument, float]],
) -> str:
    defs = [f"- {doc.title}:\n{doc.body}" for doc, _ in retrieved]
    definitions_block = "\n\n".join(defs) if defs else "No definitions retrieved."
    return PROMPT_TEMPLATE.format(
        patient_report=patient_report.strip(),
        definitions=definitions_block,
        user_query=user_query.strip(),
    )


class RagAssistant:
    """Reusable assistant holding the store + LLM client (cached singletons)."""

    def __init__(
        self,
        store: Optional[VectorStore] = None,
        client: Optional[GeminiClient] = None,
        top_k: int = 2,
    ):
        self.store = store or build_vector_store()
        self.client = client or GeminiClient()
        self.top_k = top_k

    def answer_query(self, user_query: str, patient_report_text: str) -> str:
        """Gate → retrieve → prompt → LLM → refusal fallbacks."""
        if not user_query or not user_query.strip():
            return REFUSAL_DATA
        if is_clinical_query(user_query):
            return REFUSAL_CLINICAL

        retrieved = self.store.retrieve(user_query, self.top_k)
        prompt = build_prompt(user_query, patient_report_text, retrieved)

        text = self.client.generate(prompt, temperature=0.1, max_output_tokens=2048)
        if not text or not text.strip():
            return REFUSAL_DATA
        return text.strip()

    def interactive(self, patient_report_text: str) -> None:  # pragma: no cover
        """Terminal Q&A loop (the reference's interactive CLI, ref :578-670)."""
        print("Educational MRI Assistant — type 'quit' to exit.")
        while True:
            try:
                query = input("\nYour question: ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if query.lower() in {"quit", "exit", "q"}:
                break
            print("\n" + self.answer_query(query, patient_report_text))


_default_assistant: Optional[RagAssistant] = None


def answer_query(user_query: str, patient_report_text: str) -> str:
    """Module-level convenience matching the reference's public API."""
    global _default_assistant
    if _default_assistant is None:
        _default_assistant = RagAssistant()
    return _default_assistant.answer_query(user_query, patient_report_text)
