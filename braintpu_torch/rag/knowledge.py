"""Knowledge base: curated neuroradiology definitions + .md parsing.

The port's copy of ``braintpu/rag/knowledge.py``: the same parser and the
same seven built-in documents, character for character.

Parity with the upstream knowledge layer
(upstream RAG_Assistant/knowledge_base/*.md and
vector_store_builder.py:71-142): each entry has a ``TITLE:/KEYWORDS:/
VERSION: --- body`` header, a "What This Does NOT Mean" guard section, and is
embedded as one chunk of ``Title + Keywords + body`` so short queries match
on topic identity.

The built-in knowledge base covers the same seven topics as the reference
(midline shift, peritumoral edema, enhancing/non-enhancing tumor, tumor
volumes, MRI sequences, glioma overview) with independently written
educational text.  External ``.md`` files in the same format can be loaded
alongside or instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["KBDocument", "parse_md_text", "parse_md_file", "load_knowledge_dir", "builtin_knowledge_base"]


@dataclass
class KBDocument:
    title: str
    keywords: str
    version: str
    source: str
    body: str

    @property
    def embed_text(self) -> str:
        """Text used for embedding: topic identity + content."""
        parts = []
        if self.title:
            parts.append(f"Title: {self.title}")
        if self.keywords:
            parts.append(f"Keywords: {self.keywords}")
        parts.append(self.body)
        return "\n\n".join(parts)


def parse_md_text(raw: str, source: str = "<memory>") -> KBDocument:
    """Parse the TITLE/KEYWORDS/VERSION --- body format."""
    title = keywords = version = ""
    body = raw
    if "---" in raw:
        header, _, rest = raw.partition("---")
        # Only treat the '---' as the header separator when the prefix is
        # actually a TITLE/KEYWORDS/VERSION header — otherwise a plain
        # markdown horizontal rule in a headerless document would silently
        # drop all text before it from embedding/retrieval.
        if any(
            line.startswith(("TITLE:", "KEYWORDS:", "VERSION:"))
            for line in header.strip().splitlines()
        ):
            body = rest.strip()
            for line in header.strip().splitlines():
                if line.startswith("TITLE:"):
                    title = line[len("TITLE:"):].strip()
                elif line.startswith("KEYWORDS:"):
                    keywords = line[len("KEYWORDS:"):].strip()
                elif line.startswith("VERSION:"):
                    version = line[len("VERSION:"):].strip()
    return KBDocument(title, keywords, version, source, body)


def parse_md_file(path) -> KBDocument:
    raw = Path(path).read_text(encoding="utf-8")
    return parse_md_text(raw, source=os.path.basename(os.fspath(path)))


def load_knowledge_dir(directory) -> List[KBDocument]:
    docs = []
    for p in sorted(Path(directory).glob("*.md")):
        docs.append(parse_md_file(p))
    return docs


def _doc(title: str, keywords: str, body: str) -> KBDocument:
    return KBDocument(title, keywords, "1.0", f"builtin:{title.lower().replace(' ', '_')}", body.strip())


_NOT_MEAN = (
    "What This Does NOT Mean:\n"
    "This finding by itself does not establish tumor type, WHO grade, "
    "prognosis, or any treatment decision. Histopathologic confirmation and "
    "specialist review are required for diagnosis."
)


def builtin_knowledge_base() -> List[KBDocument]:
    """The seven curated definition documents."""
    return [
        _doc(
            "Midline Shift",
            "midline, shift, displacement, mass effect, septum pellucidum, falx cerebri, subfalcine, herniation",
            f"""Definition:
Midline shift describes lateral displacement of normally central brain
structures — the septum pellucidum, third ventricle, or pineal gland — away
from the anatomical midline. It is quantified in millimeters on axial images
and reflects asymmetric pressure (mass effect) inside the skull, most often
from a space-occupying lesion together with its surrounding edema. A large
shift can push the cingulate gyrus beneath the falx cerebri, which is termed
subfalcine herniation.

Why It Appears in the Report:
The measurement summarizes how much a lesion and its edema are displacing
the brain's central structures sideways.

Typical Reporting Units:
Millimeters (mm) of deviation of midline reference structures on axial images.

{_NOT_MEAN}""",
        ),
        _doc(
            "Peritumoral Edema",
            "edema, vasogenic, swelling, FLAIR, T2, hyperintensity, peritumoral, fluid",
            f"""Definition:
Peritumoral edema is excess fluid that accumulates in brain tissue around a
lesion, most commonly because leaky abnormal vessels let plasma fluid into
the white matter (vasogenic edema). On T2-weighted and FLAIR sequences it
appears as bright (hyperintense) signal surrounding the lesion margin and can
contribute substantially to overall mass effect.

Why It Appears in the Report:
The extent of surrounding T2/FLAIR signal change is described because it adds
to the space-occupying effect of the lesion and helps characterize it.

Typical Reporting Units:
Qualitative descriptors (minimal/moderate/significant/extensive) or volume in
cubic centimeters (cm³).

{_NOT_MEAN}""",
        ),
        _doc(
            "Enhancing Tumor",
            "enhancement, contrast, gadolinium, T1ce, blood-brain barrier, ring enhancement",
            f"""Definition:
An enhancing component is lesion tissue that becomes brighter on T1-weighted
images acquired after intravenous gadolinium contrast. Enhancement marks
regions where the blood-brain barrier is disrupted, so contrast agent leaks
into the tissue. Patterns include homogeneous, heterogeneous, nodular, and
ring enhancement; a ring pattern is a rim of enhancement around a
non-enhancing center.

Why It Appears in the Report:
Comparing pre- and post-contrast T1 images identifies where the blood-brain
barrier is broken, which is an important descriptive feature of a lesion.

Typical Reporting Units:
Pattern descriptors and enhancing-component volume in cm³.

{_NOT_MEAN}""",
        ),
        _doc(
            "Non-enhancing Tumor",
            "non-enhancing, tumor core, NCET, necrosis, infiltrative, T2, FLAIR, "
            "low grade, signal abnormality",
            f"""Definition:
A non-enhancing component is abnormal tissue that does not brighten after
gadolinium, implying a relatively intact blood-brain barrier in that region.
Such tissue is usually identified as T2/FLAIR signal abnormality beyond the
enhancing margin. The non-enhancing tumor core (sometimes abbreviated NCET)
is the part of the tumor core lacking contrast uptake — necrotic, cystic, or
intact-barrier tumor tissue — and is delineated as its own sub-region in the
BraTS segmentation convention. Entirely non-enhancing lesions can be seen
with lower-grade glioma, treatment effect, and several non-neoplastic
processes.

Why It Appears in the Report:
It documents lesion tissue visible on T2/FLAIR that lacks contrast uptake,
which is relevant to describing the full extent of the abnormality.

Typical Reporting Units:
Qualitative description; volume in cm³ where measured.

{_NOT_MEAN}""",
        ),
        _doc(
            "Tumor Volumes",
            "volume, measurement, volumetric, whole tumor, tumor core, "
            "enhancing tumor, necrotic core, WT, TC, ET, NCR, ED, cm3, "
            "segmentation, BraTS, sub-regions, voxel",
            f"""Definition:
Automated segmentation reports volumes for the standard BraTS sub-regions:
whole tumor (WT — all abnormal tissue including edema in some conventions),
tumor core (TC — enhancing plus necrotic components), enhancing tumor (ET),
necrotic core (NCR), and peritumoral edema (ED). Volume is measured by
counting the voxels assigned to each sub-region and multiplying by the
volume of one voxel (set by the scan's spatial resolution), giving a
quantitative, reproducible volumetric measurement for every compartment.

Why It Appears in the Report:
Compartment volumes quantify lesion burden objectively and allow comparison
across time points.

Typical Reporting Units:
Cubic centimeters (cm³); 1 cm³ equals 1000 cubic millimeters.

{_NOT_MEAN}""",
        ),
        _doc(
            "MRI Sequences",
            "T1, T2, FLAIR, T1ce, post-contrast, sequences, weighted, gadolinium, acquisition",
            f"""Definition:
A brain-tumor MRI protocol typically includes: T1-weighted images (anatomy;
fluid dark), post-contrast T1-weighted images (T1ce — acquired after
gadolinium to show enhancement), T2-weighted images (fluid bright; edema and
many lesions conspicuous), and FLAIR (a T2 image with cerebrospinal-fluid
signal suppressed, making periventricular and cortical signal changes easier
to see). Each sequence highlights different tissue properties, so findings
are interpreted across all of them together.

Why It Appears in the Report:
The technique section records which sequences were acquired so readers know
what information the study could and could not capture.

Typical Reporting Units:
Sequence names, slice thickness in mm, in-plane resolution in mm.

{_NOT_MEAN}""",
        ),
        _doc(
            "Glioma Overview",
            "glioma, glial, astrocytoma, brain tumor, infiltrative, WHO grade, educational",
            f"""Definition:
Gliomas are primary brain tumors arising from glial cells. On MRI they
commonly show T2/FLAIR signal abnormality, variable contrast enhancement,
possible central necrosis, and surrounding vasogenic edema. Imaging features
such as ring enhancement and necrosis are statistically associated with
higher histologic grade, but grade is defined by tissue examination, not by
imaging.

Why It Appears in the Report:
Educational context for the category of lesion the segmentation model was
trained on (glioma cases from the BraTS challenge).

Typical Reporting Units:
Not applicable — descriptive overview.

{_NOT_MEAN}""",
        ),
    ]
