"""Professional PDF rendering of radiology reports — zero dependencies.

Capability parity with the reference's fpdf-based renderer
(upstream generate_pdf_report.py:16-356): parses the text report into
sections, renders a titled PDF with header rule, section headings, body
wrapping, a boxed disclaimer, and page-numbered footers.  Implemented as a
minimal from-scratch PDF-1.4 writer (base-14 Helvetica fonts, literal text
streams) since fpdf is not a dependency of this framework.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

__all__ = ["PDFWriter", "parse_report_sections", "generate_pdf_report"]

# Average per-character width factors for base-14 Helvetica (1000-unit em).
_HELV_WIDTH = 0.513
_HELV_BOLD_WIDTH = 0.556

PAGE_W, PAGE_H = 595.28, 841.89  # A4 points
MARGIN = 56.0


def _esc(text: str) -> str:
    return (
        text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
    )


#: common non-Latin-1 characters in clinical text → readable ASCII — the
#: base fonts are Latin-1 only, and errors='replace' alone renders every
#: em dash/quote as '?' in the PDF (the title contains '—')
_TRANSLIT = str.maketrans({
    "—": "-", "–": "-", "−": "-",   # em/en dash, minus
    "‘": "'", "’": "'",                   # curly single quotes
    "“": '"', "”": '"',                   # curly double quotes
    "…": "...", "•": "-",                 # ellipsis, bullet
})


def _latin1(text: str) -> str:
    return text.translate(_TRANSLIT).encode("latin-1", "replace").decode("latin-1")


class PDFWriter:
    """Tiny multi-page PDF document builder (text only, Helvetica family)."""

    def __init__(self, title: str = "Report"):
        self.title = title
        self.pages: List[List[str]] = []
        self._y = 0.0
        self._new_page()

    # -- layout ------------------------------------------------------------

    def _new_page(self) -> None:
        self.pages.append([])
        self._y = PAGE_H - MARGIN

    def _ensure_space(self, needed: float) -> None:
        if self._y - needed < MARGIN + 24:  # keep room for footer
            self._new_page()

    def _emit_text(self, x: float, y: float, text: str, size: float, bold: bool) -> None:
        font = "/F2" if bold else "/F1"
        self.pages[-1].append(
            f"BT {font} {size:.1f} Tf {x:.2f} {y:.2f} Td ({_esc(_latin1(text))}) Tj ET"
        )

    def _emit_line(self, x0, y0, x1, y1, width=0.7) -> None:
        self.pages[-1].append(f"{width} w {x0:.2f} {y0:.2f} m {x1:.2f} {y1:.2f} l S")

    @staticmethod
    def text_width(text: str, size: float, bold: bool = False) -> float:
        return len(text) * size * (_HELV_BOLD_WIDTH if bold else _HELV_WIDTH)

    def wrap(self, text: str, size: float, bold: bool = False, width: Optional[float] = None) -> List[str]:
        width = width or (PAGE_W - 2 * MARGIN)
        out: List[str] = []
        for raw_line in text.split("\n"):
            words = raw_line.split(" ")
            line = ""
            for word in words:
                candidate = f"{line} {word}".strip()
                if self.text_width(candidate, size, bold) <= width or not line:
                    line = candidate
                else:
                    out.append(line)
                    line = word
            out.append(line)
        return out

    # -- public API ---------------------------------------------------------

    def add_title(self, text: str, size: float = 15) -> None:
        self._ensure_space(size * 2.2)
        w = self.text_width(text, size, bold=True)
        self._emit_text((PAGE_W - w) / 2, self._y, text, size, bold=True)
        self._y -= size * 0.8
        self._emit_line(MARGIN, self._y, PAGE_W - MARGIN, self._y, 1.2)
        self._y -= size * 1.4

    def add_heading(self, text: str, size: float = 11) -> None:
        self._ensure_space(size * 3)
        self._y -= size * 0.6
        self._emit_text(MARGIN, self._y, text, size, bold=True)
        self._y -= size * 0.4
        self._emit_line(MARGIN, self._y, PAGE_W - MARGIN, self._y, 0.5)
        self._y -= size * 1.1

    def add_paragraph(self, text: str, size: float = 9.5, leading: float = 1.45) -> None:
        for line in self.wrap(text, size):
            self._ensure_space(size * leading)
            self._emit_text(MARGIN, self._y, line, size, bold=False)
            self._y -= size * leading

    def add_key_values(self, pairs: List[Tuple[str, str]], size: float = 9.5) -> None:
        """Two-column label/value rows (demographics block)."""
        label_w = max((self.text_width(k + ":", size, True) for k, _ in pairs), default=80)
        for key, value in pairs:
            self._ensure_space(size * 1.6)
            self._emit_text(MARGIN, self._y, f"{key}:", size, bold=True)
            self._emit_text(MARGIN + label_w + 10, self._y, value, size, bold=False)
            self._y -= size * 1.6

    def add_disclaimer(self, text: str, size: float = 8.5) -> None:
        lines = self.wrap(text, size, width=PAGE_W - 2 * MARGIN - 16)
        box_h = len(lines) * size * 1.5 + 14
        self._ensure_space(box_h + 10)
        top = self._y
        self.pages[-1].append(
            f"0.5 w {MARGIN:.2f} {top - box_h:.2f} {PAGE_W - 2 * MARGIN:.2f} {box_h:.2f} re S"
        )
        y = top - 12
        for line in lines:
            self._emit_text(MARGIN + 8, y, line, size, bold=False)
            y -= size * 1.5
        self._y = top - box_h - 12

    def add_spacer(self, pts: float = 8) -> None:
        self._y -= pts

    # -- serialization -------------------------------------------------------

    def render(self) -> bytes:
        n_pages = len(self.pages)
        for i, page in enumerate(self.pages):  # footers
            footer = f"Page {i + 1} of {n_pages}"
            w = self.text_width(footer, 8)
            page.append(
                f"BT /F1 8 Tf {(PAGE_W - w) / 2:.2f} {MARGIN - 20:.2f} Td ({_esc(footer)}) Tj ET"
            )

        objects: List[bytes] = []

        def add(obj: str | bytes) -> int:
            objects.append(obj if isinstance(obj, bytes) else obj.encode("latin-1"))
            return len(objects)  # 1-indexed object number

        font1 = add("<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
        font2 = add("<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold >>")

        content_ids = []
        for page in self.pages:
            stream = zlib.compress("\n".join(page).encode("latin-1"))
            content_ids.append(
                add(
                    b"<< /Length "
                    + str(len(stream)).encode()
                    + b" /Filter /FlateDecode >>\nstream\n"
                    + stream
                    + b"\nendstream"
                )
            )

        pages_id = len(objects) + n_pages + 1
        page_ids = []
        for cid in content_ids:
            page_ids.append(
                add(
                    f"<< /Type /Page /Parent {pages_id} 0 R "
                    f"/MediaBox [0 0 {PAGE_W} {PAGE_H}] "
                    f"/Resources << /Font << /F1 {font1} 0 R /F2 {font2} 0 R >> >> "
                    f"/Contents {cid} 0 R >>"
                )
            )
        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        assert add(f"<< /Type /Pages /Kids [{kids}] /Count {n_pages} >>") == pages_id
        catalog = add(f"<< /Type /Catalog /Pages {pages_id} 0 R >>")
        info = add(f"<< /Title ({_esc(_latin1(self.title))}) /Producer (braintpu) >>")

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, obj in enumerate(objects, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
        xref_pos = len(out)
        out += f"xref\n0 {len(objects) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (
            f"trailer\n<< /Size {len(objects) + 1} /Root {catalog} 0 R /Info {info} 0 R >>\n"
            f"startxref\n{xref_pos}\n%%EOF\n"
        ).encode()
        return bytes(out)


def parse_report_sections(report_text: str) -> Dict[str, str]:
    """Split a report into ordered {section: body} (ref :122-205 semantics)."""
    sections: Dict[str, List[str]] = {}
    current = "HEADER"
    sections[current] = []
    for line in report_text.splitlines():
        stripped = line.strip()
        m = re.match(r"^([A-Z][A-Z /&'-]{2,}):\s*(.*)$", stripped)
        if m and not stripped.startswith(("PATIENT ID", "DATE")):
            current = m.group(1)
            sections[current] = []
            if m.group(2):
                sections[current].append(m.group(2))
        else:
            sections.setdefault(current, []).append(line)
    return {k: "\n".join(v).strip() for k, v in sections.items()}


def generate_pdf_report(
    report_text: str,
    output_path: os.PathLike,
    case_id: str = "",
    exam_date: str = "",
) -> str:
    """Render the text report to a professional PDF file; returns the path."""
    pdf = PDFWriter(title=f"MRI Brain Report {case_id}".strip())
    pdf.add_title("MRI BRAIN WITH CONTRAST — RADIOLOGY REPORT")

    sections = parse_report_sections(report_text)

    demo: List[Tuple[str, str]] = []
    header = sections.pop("HEADER", "")
    for line in header.splitlines():
        m = re.match(r"^\s*(PATIENT ID|DATE)\s*:\s*(.+)$", line)
        if m:
            demo.append((m.group(1).title(), m.group(2).strip()))
    if case_id and not any(k == "Patient Id" for k, _ in demo):
        demo.insert(0, ("Patient Id", case_id))
    if exam_date and not any(k == "Date" for k, _ in demo):
        demo.append(("Date", exam_date))
    if demo:
        pdf.add_key_values(demo)
        pdf.add_spacer(6)

    disclaimer = None
    for name, body in sections.items():
        if not body:
            continue
        if name == "DISCLAIMER":
            disclaimer = body
            continue
        pdf.add_heading(name)
        pdf.add_paragraph(body)
    if disclaimer:
        pdf.add_spacer(10)
        pdf.add_disclaimer("DISCLAIMER: " + disclaimer)

    data = pdf.render()
    path = os.fspath(output_path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path
