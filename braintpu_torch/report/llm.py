"""Optional LLM integration: constrained slot filling + report refinement.

Two LLM touchpoints, both strictly bounded and both optional — the pipeline
is fully deterministic and offline without them (the reference degrades the
same way: upstream generate_report_gemini.py:294-310):

* :class:`ConstrainedSlotFiller` — the LLM may only pick ONE value from an
  allowed list, with validation + retries and a deterministic fallback
  (ref report_templates.py:904-1076).
* :func:`refine_report` — structure-preserving readability pass with the
  fixed editor system prompt (ref generate_report_gemini.py:87-183;
  gemini-2.5-flash, temperature 0.2).

The Gemini client is a minimal httpx wrapper (no google-generativeai
dependency); any network/credential failure returns the deterministic input.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

__all__ = ["GeminiClient", "ConstrainedSlotFiller", "refine_report", "REFINEMENT_SYSTEM_PROMPT"]

REFINEMENT_SYSTEM_PROMPT = """You are a medical editor reviewing an automatically generated radiology report.

Your task is to REFINE the report for better readability while following these STRICT RULES:

WHAT YOU CAN DO:
- Improve sentence flow and readability
- Fix grammatical issues
- Make phrasing more natural and clinical

WHAT YOU CANNOT DO:
- Add new information not present in the original
- Remove any information from the original
- Change the report structure or section order
- Add new sections or headings
- Change any measurements or values
- Add diagnostic conclusions not present in the original
- Modify the disclaimer

The template structure is FIXED. Your refinements must preserve:
1. All section headings exactly as they appear
2. All measurements and values
3. All clinical findings
4. The exact disclaimer text
5. The overall report structure

Return ONLY the refined report text, nothing else."""


class GeminiClient:
    """Minimal Gemini REST client (httpx); silently unavailable offline."""

    BASE = "https://generativelanguage.googleapis.com/v1beta/models"

    def __init__(self, api_key: Optional[str] = None, model: str = "gemini-2.5-flash"):
        if api_key is None and "GEMINI_API_KEY" not in os.environ:
            # Reference parity: the key may live in a repo-root `.env` file
            # (upstream generate_report_gemini.py:31-42).
            from ..utils.env import load_dotenv

            load_dotenv()
        self.api_key = api_key or os.environ.get("GEMINI_API_KEY")
        self.model = model

    @property
    def available(self) -> bool:
        return bool(self.api_key)

    def generate(
        self,
        prompt: str,
        system: Optional[str] = None,
        temperature: float = 0.2,
        max_output_tokens: int = 4096,
        timeout: float = 60.0,
    ) -> Optional[str]:
        """Returns generated text, or None on any failure."""
        if not self.available:
            return None
        try:
            import httpx

            body: Dict = {
                "contents": [{"parts": [{"text": prompt}]}],
                "generationConfig": {
                    "temperature": temperature,
                    "maxOutputTokens": max_output_tokens,
                },
            }
            if system:
                body["systemInstruction"] = {"parts": [{"text": system}]}
            resp = httpx.post(
                f"{self.BASE}/{self.model}:generateContent",
                params={"key": self.api_key},
                json=body,
                timeout=timeout,
            )
            resp.raise_for_status()
            data = resp.json()
            return data["candidates"][0]["content"]["parts"][0]["text"]
        except Exception:
            return None


class ConstrainedSlotFiller:
    """LLM value selection restricted to an allowed list, with retries."""

    MAX_RETRIES = 3

    def __init__(self, client: Optional[GeminiClient] = None):
        self.client = client or GeminiClient()

    def fill_slot_value(
        self, slot_name: str, field_name: str, context: Dict, allowed_values: List[str]
    ) -> str:
        if not allowed_values:
            return ""
        if not self.client.available:
            return self._deterministic_fallback(field_name, context, allowed_values)

        prompt = self._prompt(field_name, context, allowed_values)
        for _ in range(self.MAX_RETRIES):
            text = self.client.generate(prompt, temperature=0.0, max_output_tokens=50)
            if text is None:
                break
            selected = text.strip().lower()
            for allowed in allowed_values:
                if allowed.lower() == selected or allowed.lower() in selected:
                    return allowed
            prompt = self._retry_prompt(allowed_values, selected)
        return self._deterministic_fallback(field_name, context, allowed_values)

    @staticmethod
    def _prompt(field_name: str, context: Dict, allowed_values: List[str]) -> str:
        ctx = "\n".join(f"  {k}: {v}" for k, v in context.items())
        return (
            "STRICT INSTRUCTION: Select exactly ONE value from the allowed list.\n\n"
            f'TASK: Choose the best value for "{field_name}"\n\n'
            f"ALLOWED VALUES (choose ONLY from these):\n{', '.join(allowed_values)}\n\n"
            f"CONTEXT:\n{ctx}\n\n"
            "RULES:\n- Output ONLY the selected value, nothing else\n"
            "- Do NOT add explanation\n- Do NOT add punctuation\n"
            "- The output must EXACTLY match one of the allowed values\n\nYOUR SELECTION:"
        )

    @staticmethod
    def _retry_prompt(allowed_values: List[str], invalid: str) -> str:
        return (
            f'ERROR: Your previous response "{invalid}" is not valid.\n\n'
            f"You MUST select EXACTLY ONE of these values:\n{', '.join(allowed_values)}\n\n"
            "Output ONLY the value. No other text.\n\nYOUR SELECTION:"
        )

    @staticmethod
    def _deterministic_fallback(field_name: str, context: Dict, allowed_values: List[str]) -> str:
        if field_name == "edema_degree":
            vol = context.get("edema_volume_cm3", 0)
            if vol < 5:
                return "Minimal"
            if vol < 15:
                return "Moderate"
            if vol < 30:
                return "Significant"
            return "Extensive"
        if field_name == "hemisphere":
            return context.get("hemisphere", allowed_values[0])
        if field_name == "distribution":
            return "multifocal" if context.get("lesion_count", 1) > 1 else "focal"
        return allowed_values[0]


def refine_report(report: str, client: Optional[GeminiClient] = None) -> str:
    """Structure-preserving LLM readability pass; identity when offline."""
    client = client or GeminiClient()
    prompt = (
        "Please refine the following radiology report for better readability.\n"
        "Remember: DO NOT change the structure, add information, or modify any values.\n\n"
        f"REPORT TO REFINE:\n{report}\n\nReturn only the refined report:"
    )
    refined = client.generate(prompt, system=REFINEMENT_SYSTEM_PROMPT, temperature=0.2)
    return refined if refined else report
