"""Facts → slot sentences (deterministic mapping rules).

Reproduces the reference's ``FactsToSlotMapper``
(upstream report_templates.py:1083-1358): atomic sentences, concept
ownership (necrosis/edema/shift each appear in exactly one slot), hedged
IMPRESSION phrasing.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List

__all__ = ["map_facts_to_slots"]

_SEQ_NAMES = {
    "T1": "T1-weighted",
    "T1CE": "post-contrast T1-weighted",
    "T2": "T2-weighted",
    "FLAIR": "FLAIR",
}


def _oxford_join(items: List[str]) -> str:
    if not items:
        return ""
    if len(items) == 1:
        return items[0]
    if len(items) == 2:
        return f"{items[0]} and {items[1]}"
    return ", ".join(items[:-1]) + f", and {items[-1]}"


def _sequences(facts: Dict) -> str:
    seqs = facts["sequences"]
    if not seqs:
        return "standard sequences"
    return _oxford_join([_SEQ_NAMES.get(s.upper(), s) for s in seqs])


def _lesion_count(facts: Dict) -> str:
    count = facts["lesion_count"]
    hemisphere = facts["hemisphere"]
    if count == 1:
        return f"A single enhancing lesion is identified within the {hemisphere} cerebral hemisphere."
    if count == 2:
        return (
            f"Two spatially separate enhancing lesions are identified within the "
            f"{hemisphere} cerebral hemisphere."
        )
    return (
        f"Multiple enhancing lesions ({count}) are identified with a "
        f"{facts['distribution']} distribution."
    )


def _dominant_lesion(facts: Dict) -> str:
    depth_prefix = facts["depth_prefix"]
    shape = facts["shape"]
    shape_str = f"{shape} " if shape and shape != "mass" else ""
    first_word = depth_prefix if depth_prefix else shape_str
    article = "an" if first_word and first_word.strip()[0].lower() in "aeiou" else "a"
    return (
        f"The dominant lesion is {article} {depth_prefix}{shape_str}mass located in the "
        f"{facts['lobes_formatted']}, measuring approximately {facts['size_cm']} cm in "
        f"maximum diameter."
    )


def _enhancement(facts: Dict) -> str:
    if not facts["enhancement_present"]:
        return "No abnormal enhancement is identified."
    het = "heterogeneous" in facts["enhancement_heterogeneity"]
    if facts["is_ring_enhancing"]:
        if het:
            return "The lesion demonstrates heterogeneous ring enhancement."
        return "The lesion demonstrates ring enhancement with a non-enhancing central component."
    if het:
        return "The lesion demonstrates heterogeneous enhancement following contrast administration."
    return "The lesion demonstrates homogeneous enhancement following contrast administration."


def _necrosis(facts: Dict) -> str:
    if not facts["necrosis_present"]:
        return "No central necrosis is identified."
    degree = facts["necrosis_degree"]
    if degree == "minimal":
        return "A small central necrotic component is identified."
    if degree == "extensive":
        return "A large area of central necrosis is present."
    return "Central necrosis is present within the lesion."


def _edema(facts: Dict) -> str:
    degree = facts["edema_degree"]
    if degree == "Minimal":
        return "Minimal surrounding T2/FLAIR hyperintensity is present."
    if degree == "Moderate":
        return "Moderate surrounding T2/FLAIR hyperintensity is present."
    if degree == "Extensive":
        return (
            "Extensive surrounding T2/FLAIR hyperintensity is present, "
            "representing vasogenic edema."
        )
    return (
        "Significant surrounding T2/FLAIR hyperintensity is present, "
        "representing vasogenic edema."
    )


#: step2 emits "Left to right"/"Right to left"; the report sentence (and the
#: slot's allowed_values) want the DESTINATION side only.  Plain
#: "left"/"right" pass through; anything else ("Unknown", "Not applicable")
#: drops the direction clause rather than garbling the sentence.
_SHIFT_DIRECTION_WORD = {
    "left to right": "right",
    "right to left": "left",
    "left": "left",
    "right": "right",
}


def _mass_effect(facts: Dict) -> str:
    if facts["shift_significant"]:
        shift = round(facts["midline_shift_mm"], 1)
        direction = _SHIFT_DIRECTION_WORD.get(
            facts.get("shift_direction", "").strip().lower(), ""
        )
        if direction:
            return (
                f"There is approximately {shift} mm of midline shift to the "
                f"{direction}. No evidence of herniation."
            )
        return f"There is approximately {shift} mm of midline shift. No evidence of herniation."
    return "No significant midline shift is identified. No evidence of herniation."


def _ventricles(facts: Dict) -> str:
    if facts["hydrocephalus"]:
        return "The ventricular system demonstrates ventriculomegaly."
    if not facts["ventricles_symmetric"]:
        return (
            "The ventricular system is normal in size with mild asymmetry of the "
            "lateral ventricles."
        )
    return "The ventricular system is normal in size and configuration."


def _parenchyma(facts: Dict) -> str:
    if facts["white_matter_disease"]:
        return (
            "Background white matter changes are noted. Gray-white matter "
            "differentiation is otherwise preserved."
        )
    if facts["parenchyma_normal"]:
        return "The remaining brain parenchyma demonstrates preserved gray-white matter differentiation."
    return "The remaining brain parenchyma appears unremarkable."


def _impression_summary(facts: Dict) -> str:
    hemisphere = facts["hemisphere"]
    size_cm = facts["size_cm"]
    if facts["is_multifocal"]:
        if facts["is_ring_enhancing"]:
            return (
                f"Multifocal ring-enhancing masses in the {hemisphere} cerebral "
                f"hemisphere, largest measuring approximately {size_cm} cm, suspicious "
                "for high-grade neoplastic process."
            )
        return (
            f"Multifocal enhancing masses in the {hemisphere} cerebral hemisphere, "
            "imaging features suspicious for neoplastic process."
        )
    lobe = facts["primary_lobe"]
    if facts["is_ring_enhancing"]:
        return (
            f"Ring-enhancing mass in the {hemisphere} {lobe} lobe, measuring "
            f"approximately {size_cm} cm, suspicious for high-grade neoplastic process."
        )
    return (
        f"Enhancing mass in the {hemisphere} {lobe} lobe, measuring approximately "
        f"{size_cm} cm, with imaging features concerning for neoplastic process."
    )


def _impression_differential(facts: Dict) -> str:
    formatted = []
    for d in facts["differentials"][:3]:
        low = d.lower()
        if "glioma" in low or "glioblastoma" in low:
            formatted.append("high-grade glioma")
        elif "metast" in low:
            formatted.append("metastatic disease")
        elif "lymphoma" in low:
            formatted.append("primary CNS lymphoma")
        else:
            formatted.append(low)
    unique = list(dict.fromkeys(formatted))
    diff_str = _oxford_join(unique) if unique else "high-grade neoplasm"
    return (
        f"Differential diagnosis includes {diff_str}. Clinical and histopathologic "
        "correlation recommended."
    )


def map_facts_to_slots(facts: Dict, exam_date: str = None) -> Dict[str, str]:
    """All 16 slots as filled sentences (ref map_to_slot_values :1102-1126)."""
    return {
        "patient_id": facts["case_id"],
        "exam_date": exam_date or _dt.datetime.now().strftime("%B %d, %Y"),
        "clinical_indication": (
            facts.get("clinical_history", "Clinical indication not provided.")
            if facts["clinical_history_provided"]
            else "Clinical indication not provided."
        ),
        "sequences_list": _sequences(facts),
        "contrast_sentence": (
            "Post-contrast T1-weighted imaging was obtained following intravenous "
            "gadolinium administration."
            if facts["contrast_given"]
            else "No intravenous contrast was administered."
        ),
        "comparison": (
            "Compared to prior examination."
            if facts["prior_imaging_available"]
            else "No prior imaging available for comparison."
        ),
        "lesion_count_sentence": _lesion_count(facts),
        "dominant_lesion_sentence": _dominant_lesion(facts),
        "enhancement_sentence": _enhancement(facts),
        "necrosis_sentence": _necrosis(facts),
        "edema_sentence": _edema(facts),
        "mass_effect_sentence": _mass_effect(facts),
        "ventricles_sentence": _ventricles(facts),
        "parenchyma_sentence": _parenchyma(facts),
        "impression_summary": _impression_summary(facts),
        "impression_differential": _impression_differential(facts),
    }
