"""Clinical-governance data: the constraint system for report generation.

This is configuration-as-code parity with the reference's slot constraint
system (upstream report_templates.py:39-388 and :414-439): the exact
section-forbidden terms, hedged-phrase registry, concept-ownership map,
paragraph grouping, per-slot specifications, and the global banned-word list.
The string constants ARE the clinical behavior being reproduced; the
enforcement machinery lives in :mod:`braintpu_torch.report.validator`.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = [
    "SECTION_FORBIDDEN_TERMS",
    "HEDGED_DIAGNOSTIC_PHRASES",
    "FORBIDDEN_IMPRESSION_UNHEDGED",
    "CONCEPT_OWNERSHIP",
    "FINDINGS_PARAGRAPH_STRUCTURE",
    "SLOT_SPECIFICATIONS",
    "GLOBAL_BANNED_WORDS",
    "ALLOWED_COMPOUND_WORDS",
    "MRI_BRAIN_TEMPLATE",
]

#: Section-level semantic rules: FINDINGS may not contain diagnostic
#: language; IMPRESSION may not contain unhedged certainty (ref :39-52).
SECTION_FORBIDDEN_TERMS: Dict[str, List[str]] = {
    "FINDINGS": [
        "concern", "concerning", "suspicious", "suspicious for",
        "suggestive", "suggestive of", "raises concern", "raising concern",
        "neoplasm", "glioblastoma", "tumor", "cancer", "disease",
        "differential", "likely", "probable", "favor", "favoring",
        "consistent with", "diagnostic of", "compatible with",
    ],
    "IMPRESSION": [
        "diagnostic of", "definitive for", "definitely",
        "certainly", "100%", "always", "never",
    ],
}

#: Reviewer-safe hedged alternatives for diagnostic claims (ref :55-69).
HEDGED_DIAGNOSTIC_PHRASES: Dict[str, List[str]] = {
    "high_grade": [
        "suspicious for a high-grade neoplastic process",
        "raises concern for high-grade neoplasm",
        "imaging features are concerning for high-grade neoplasm",
    ],
    "metastasis": [
        "suspicious for metastatic disease",
        "raises concern for metastases",
    ],
    "glioblastoma": [
        "suspicious for high-grade glioma",
        "concerning for high-grade glial neoplasm",
    ],
}

FORBIDDEN_IMPRESSION_UNHEDGED: List[str] = [
    "diagnostic of", "consistent with", "definitive for",
    "confirms", "represents", "is a", "definitely",
]

#: Single-source reporting: each clinical concept belongs to exactly one
#: slot (ref :82-91).
CONCEPT_OWNERSHIP: Dict[str, str] = {
    "necrosis": "necrosis_sentence",
    "edema": "edema_sentence",
    "mass_effect": "mass_effect_sentence",
    "enhancement_center": "enhancement_sentence",
    "ring_enhancement": "enhancement_sentence",
    "midline_shift": "mass_effect_sentence",
    "herniation": "mass_effect_sentence",
    "hydrocephalus": "ventricles_sentence",
}

#: Conceptual paragraph blocks in FINDINGS (ref :98-115).
FINDINGS_PARAGRAPH_STRUCTURE: Dict[str, List[str]] = {
    "lesion_description": ["lesion_count_sentence", "dominant_lesion_sentence"],
    "signal_characteristics": [
        "enhancement_sentence",
        "necrosis_sentence",
        "edema_sentence",
    ],
    "secondary_effects": ["mass_effect_sentence"],
    "normal_structures": ["ventricles_sentence", "parenchyma_sentence"],
}

_FINDINGS_DIAGNOSTIC = [
    "tumor", "cancer", "neoplasm", "malignant", "glioblastoma",
    "concern", "suspicious", "suggestive", "disease",
]

#: Per-slot constraint records: allowed templates, forbidden terms,
#: constrained vocabularies, length caps, fallbacks, owning section
#: (ref :129-388).
SLOT_SPECIFICATIONS: Dict[str, dict] = {
    "clinical_indication": {
        "allowed_templates": [
            "Clinical indication not provided.",
            "{clinical_history}",
            "{clinical_history}. Presenting symptoms: {symptoms}.",
            "Presenting symptoms: {symptoms}.",
            "Evaluation for {indication}.",
        ],
        "forbidden_terms": [],
        "max_length": 500,
        "fallback": "Clinical indication not provided.",
        "section": "CLINICAL_INDICATION",
    },
    "sequences_list": {
        "allowed_templates": [
            "T1-weighted, post-contrast T1-weighted, T2-weighted, and FLAIR",
            "T1-weighted, T2-weighted, and FLAIR",
            "T1-weighted and T2-weighted",
            "{custom_sequences}",
        ],
        "forbidden_terms": [],
        "max_length": 200,
        "fallback": "standard sequences",
        "section": "TECHNIQUE",
    },
    "contrast_sentence": {
        "allowed_templates": [
            "Post-contrast T1-weighted imaging was obtained following intravenous gadolinium administration.",
            "No intravenous contrast was administered.",
        ],
        "forbidden_terms": [],
        "max_length": 150,
        "fallback": "Post-contrast T1-weighted imaging was obtained following intravenous gadolinium administration.",
        "section": "TECHNIQUE",
    },
    "comparison": {
        "allowed_templates": [
            "No prior imaging available for comparison.",
            "Compared to prior MRI dated {prior_date}.",
            "Compared to prior examination.",
            "{custom_comparison}",
        ],
        "forbidden_terms": [],
        "max_length": 200,
        "fallback": "No prior imaging available for comparison.",
        "section": "COMPARISON",
    },
    "lesion_count_sentence": {
        "allowed_templates": [
            "A single enhancing lesion is identified within the {hemisphere} cerebral hemisphere.",
            "Two spatially separate enhancing lesions are identified within the {hemisphere} cerebral hemisphere.",
            "Multiple enhancing lesions ({count}) are identified with a {distribution} distribution.",
        ],
        "forbidden_terms": list(_FINDINGS_DIAGNOSTIC),
        "allowed_values": {
            "hemisphere": ["right", "left", "bilateral"],
            "distribution": ["multifocal", "multicentric", "scattered", "clustered"],
        },
        "max_length": 200,
        "fallback": "An enhancing lesion is identified within the cerebral hemisphere.",
        "section": "FINDINGS",
    },
    "dominant_lesion_sentence": {
        "allowed_templates": [
            "The dominant lesion is a {depth}{shape} mass located in the {lobes}, measuring approximately {size_cm} cm in maximum diameter.",
            "A {depth}{shape} mass is identified in the {lobes}, measuring approximately {size_cm} cm in maximum diameter.",
            "The primary lesion is a {depth}mass located in the {lobes}, measuring approximately {size_cm} cm.",
        ],
        "forbidden_terms": ["microscopic", "invasive", "definitive", "metastasis"]
        + _FINDINGS_DIAGNOSTIC,
        "allowed_values": {
            "depth": ["", "subcortical ", "deep ", "cortical and subcortical ", "periventricular "],
            "shape": ["", "ovoid ", "irregular ", "round ", "lobulated "],
            "hemisphere": ["right", "left", "bilateral", "midline"],
        },
        "max_length": 250,
        "fallback": "A mass is identified within the cerebral hemisphere.",
        "section": "FINDINGS",
    },
    "enhancement_sentence": {
        "allowed_templates": [
            "The lesion demonstrates ring enhancement with a non-enhancing central component.",
            "The lesion demonstrates heterogeneous ring enhancement.",
            "The lesion demonstrates homogeneous enhancement following contrast administration.",
            "The lesion demonstrates heterogeneous enhancement following contrast administration.",
            "No abnormal enhancement is identified.",
        ],
        "forbidden_terms": ["aggressive", "definitive", "necrosis", "necrotic"]
        + _FINDINGS_DIAGNOSTIC,
        "allowed_values": {
            "pattern": [
                "ring enhancement",
                "homogeneous enhancement",
                "heterogeneous enhancement",
                "nodular enhancement",
            ],
        },
        "max_length": 200,
        "fallback": "Enhancement is noted following contrast administration.",
        "section": "FINDINGS",
    },
    "necrosis_sentence": {
        "allowed_templates": [
            "Central necrosis is present within the lesion.",
            "A small central necrotic component is identified.",
            "A large area of central necrosis is present.",
            "No central necrosis is identified.",
        ],
        "forbidden_terms": [
            "tumor", "cancer", "glioblastoma", "malignant",
            "percentage", "%", "microscopic",
            "concern", "suspicious", "suggestive", "disease",
        ],
        "allowed_values": {},
        "max_length": 150,
        "fallback": "Central signal abnormality is noted within the lesion.",
        "section": "FINDINGS",
    },
    "edema_sentence": {
        "allowed_templates": [
            "Surrounding T2/FLAIR hyperintensity is present, representing vasogenic edema.",
            "Extensive surrounding T2/FLAIR hyperintensity is present, representing vasogenic edema.",
            "Significant surrounding T2/FLAIR hyperintensity is present, representing vasogenic edema.",
            "Moderate surrounding T2/FLAIR hyperintensity is present.",
            "Minimal surrounding T2/FLAIR hyperintensity is present.",
            "No significant surrounding edema is identified.",
        ],
        "forbidden_terms": [
            "cm³", "cm3", "cubic", "volume", "ml", "mL",
            "tumor", "cancer", "neoplasm",
            "concern", "suspicious", "suggestive", "disease",
            "consistent with",
        ],
        "allowed_values": {
            "edema_degree": ["Minimal", "Moderate", "Significant", "Extensive"],
        },
        "max_length": 150,
        "fallback": "Surrounding T2/FLAIR hyperintensity is present.",
        "section": "FINDINGS",
    },
    "mass_effect_sentence": {
        "allowed_templates": [
            "No significant midline shift is identified. No evidence of herniation.",
            "There is approximately {shift_mm} mm of midline shift to the {direction}. No evidence of herniation.",
            "Mild mass effect is noted without significant midline shift.",
        ],
        "forbidden_terms": [
            "risk", "probability", "likely", "percent", "%",
            "tumor", "cancer", "dangerous",
            "concern", "suspicious", "suggestive", "disease",
        ],
        "allowed_values": {"direction": ["left", "right"]},
        "max_length": 200,
        "fallback": "No significant midline shift is identified. No evidence of herniation.",
        "section": "FINDINGS",
    },
    "ventricles_sentence": {
        "allowed_templates": [
            "The ventricular system is normal in size and configuration.",
            "The ventricular system is normal in size with mild asymmetry of the lateral ventricles.",
            "The ventricular system demonstrates ventriculomegaly.",
            "Mild ventriculomegaly is noted.",
        ],
        "forbidden_terms": [
            "tumor", "cancer", "mass",
            "concern", "suspicious", "suggestive", "disease",
        ],
        "max_length": 150,
        "fallback": "The ventricular system is normal in size and configuration.",
        "section": "FINDINGS",
    },
    "parenchyma_sentence": {
        "allowed_templates": [
            "The remaining brain parenchyma demonstrates preserved gray-white matter differentiation.",
            "Background white matter changes are noted. Gray-white matter differentiation is otherwise preserved.",
            "The remaining brain parenchyma appears unremarkable.",
        ],
        "forbidden_terms": [
            "tumor", "cancer", "neoplasm", "metastasis",
            "concern", "suspicious", "suggestive", "disease",
        ],
        "max_length": 200,
        "fallback": "The remaining brain parenchyma appears unremarkable.",
        "section": "FINDINGS",
    },
    "impression_summary": {
        "allowed_templates": [
            "Ring-enhancing mass in the {hemisphere} {lobe} lobe, measuring approximately {size_cm} cm, suspicious for high-grade neoplastic process.",
            "Multifocal ring-enhancing masses in the {hemisphere} cerebral hemisphere, largest measuring approximately {size_cm} cm, suspicious for high-grade neoplastic process.",
            "Enhancing mass in the {hemisphere} {lobe} lobe, measuring approximately {size_cm} cm, with imaging features concerning for neoplastic process.",
            "Multifocal enhancing masses in the {hemisphere} cerebral hemisphere, imaging features concerning for neoplastic process.",
        ],
        "forbidden_terms": [
            "definitive", "definitely", "certainly", "proven",
            "microscopic", "invasive", "diagnostic of", "consistent with",
            "confirms", "represents", "is a",
        ],
        "allowed_values": {"hemisphere": ["right", "left", "bilateral"]},
        "max_length": 300,
        "fallback": "Enhancing mass identified, suspicious for neoplastic process. Clinical correlation recommended.",
        "section": "IMPRESSION",
    },
    "impression_differential": {
        "allowed_templates": [
            "Differential diagnosis includes {differentials}. Histopathologic correlation recommended.",
            "Differential considerations include {differentials}. Tissue sampling is recommended.",
            "Given the imaging features, differential diagnosis includes {differentials}. Clinical correlation advised.",
        ],
        "forbidden_terms": [
            "definitely", "certainly", "proven", "confirmed",
            "100%", "always", "never", "diagnostic of", "consistent with",
        ],
        "max_length": 250,
        "fallback": "Differential diagnosis includes high-grade glioma, metastasis, and lymphoma. Histopathologic correlation recommended.",
        "section": "IMPRESSION",
    },
}

#: Words banned from every slot regardless of specification (ref :414-432).
GLOBAL_BANNED_WORDS: List[str] = [
    "microscopic", "definitive", "histologic", "histological", "pathologic",
    "pathological", "biopsy-proven", "confirmed", "definite", "certainly",
    "definitely", "proven",
    "diagnostic of",
    "benign", "malignant", "cancer", "carcinoma", "sarcoma",
    "malpractice", "error", "mistake", "missed", "overlooked",
    "looks like", "seems to be", "probably", "maybe", "I think",
    "in my opinion", "appears to possibly",
]

#: Compounds whose substrings would otherwise trip the banned list (ref :435-439).
ALLOWED_COMPOUND_WORDS: List[str] = [
    "histopathologic",
    "histopathological",
    "histopathology",
]

#: The rigid human-written master template (ref :1373-1403).
MRI_BRAIN_TEMPLATE = """
MRI BRAIN WITH CONTRAST

PATIENT ID: {patient_id}
DATE: {exam_date}

CLINICAL INDICATION:
{clinical_indication}

TECHNIQUE:
Multiplanar, multisequence MRI of the brain was performed including {sequences_list}. {contrast_sentence}

COMPARISON:
{comparison}

FINDINGS:
{lesion_count_sentence} {dominant_lesion_sentence}

{enhancement_sentence} {necrosis_sentence} {edema_sentence}

{mass_effect_sentence}

{ventricles_sentence} {parenchyma_sentence}

IMPRESSION:
1. {impression_summary}
2. {impression_differential}

DISCLAIMER:
This report was generated with automated assistance and should be reviewed by a qualified radiologist.
""".strip()
