"""Excel interchange for the reference L0 label contract — no deps.

The port's own copy of ``av1tpu.ingest.xlsx``: the same workbooks, member
by member, and the same records.

The reference ETL round-trips encoder dumps through per-frame Excel
workbooks: ``pesquisa_v5/004_prepare_partition_data_v2.py:145-172`` writes
``{video}-{word}-{frame}.xlsx`` with one headerless sheet per block size
("64"/"32"/"16"/"8", columns A..F = row, col, partition_mode, qp,
frame_type, order_hint, sorted by row then col); ``005_...py:737-738``
consumes column B (4-px-unit col positions) and ``007_generate_label_qp_v2
.py:59-99`` column C (modes). A user holding only xlsx archives (dumps
discarded) must be able to ingest — this module reads and writes that
exact format with ``zipfile`` + ``xml.etree`` (openpyxl is not available
in this environment), and adapts workbooks into the same
:class:`~av1tpu_torch.ingest.partition_dump.DumpParseResult` records the dump
parser produces, so the rest of the one-pass ETL is format-agnostic.
"""
from __future__ import annotations

import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional
from xml.etree import ElementTree

import numpy as np

from av1tpu_torch.ingest.partition_dump import (
    DumpParseResult,
    FrameBlocks,
    parse_dump_directory,
)

SHEET_NAMES = ("64", "32", "16", "8")
# reference filename contract: {video}-{middle_word}-{frame}.xlsx
# (middle word is "intra" for the intra-only archives the docs describe)
_XLSX_RE = re.compile(r"^(?P<video>.+)-(?P<word>[^-]+)-(?P<frame>\d+)\.xlsx$")

_CT = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheet_overrides}
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""


def _col_letter(index: int) -> str:
    letters = ""
    index += 1
    while index:
        index, rem = divmod(index - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return letters


def _col_index(ref: str) -> int:
    """'BC12' -> zero-based column index 54."""
    letters = "".join(c for c in ref if c.isalpha())
    value = 0
    for c in letters:
        value = value * 26 + (ord(c.upper()) - ord("A") + 1)
    return value - 1


def _sheet_xml(rows: np.ndarray) -> str:
    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>',
    ]
    for ri, row in enumerate(np.atleast_2d(rows), start=1):
        cells = "".join(
            f'<c r="{_col_letter(ci)}{ri}"><v>{int(v)}</v></c>'
            for ci, v in enumerate(row)
        )
        parts.append(f'<row r="{ri}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def write_frame_xlsx(path: Path, result: DumpParseResult) -> Path:
    """Write one frame's blocks as a reference-format workbook.

    Rows per sheet: [row, col, mode, qp, frame_type=0, order_hint], sorted
    by (row, col) exactly like 004:158-170; block sizes with no data get an
    empty sheet (004:175-177).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    sheets: Dict[str, np.ndarray] = {}
    for name in SHEET_NAMES:
        blocks = result.per_block_size.get(int(name))
        if blocks is None or len(blocks.modes) == 0:
            sheets[name] = np.zeros((0, 6), np.int64)
            continue
        rows = np.stack(
            [
                blocks.row_units.astype(np.int64),
                blocks.col_units.astype(np.int64),
                blocks.modes.astype(np.int64),
                blocks.qps.astype(np.int64),
                np.zeros(len(blocks.modes), np.int64),  # frame_type intra
                np.full(len(blocks.modes), result.frame_index, np.int64),
            ],
            axis=1,
        )
        order = np.lexsort((rows[:, 1], rows[:, 0]))
        sheets[name] = rows[order]

    sheet_entries = []
    rel_entries = []
    overrides = []
    for i, name in enumerate(SHEET_NAMES, start=1):
        sheet_entries.append(f'<sheet name="{name}" sheetId="{i}" r:id="rId{i}"/>')
        rel_entries.append(
            f'<Relationship Id="rId{i}" Type="http://schemas.openxmlformats.org/'
            f'officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i}.xml"/>'
        )
        overrides.append(
            f'<Override PartName="/xl/worksheets/sheet{i}.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
            'worksheet+xml"/>'
        )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
        '2006/main" xmlns:r="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships"><sheets>'
        + "".join(sheet_entries)
        + "</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">' + "".join(rel_entries) + "</Relationships>"
    )

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(
            "[Content_Types].xml", _CT.format(sheet_overrides="".join(overrides))
        )
        zf.writestr("_rels/.rels", _ROOT_RELS)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, name in enumerate(SHEET_NAMES, start=1):
            zf.writestr(f"xl/worksheets/sheet{i}.xml", _sheet_xml(sheets[name]))
    return path


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def read_frame_xlsx(path: Path) -> Dict[str, np.ndarray]:
    """Read a reference-format workbook -> {sheet name: (N, 6) int array}.

    Handles numeric cells (the only type the contract produces) from any
    writer (openpyxl or this module); missing cells read as 0.
    """
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        wb = ElementTree.fromstring(zf.read("xl/workbook.xml"))
        rels = ElementTree.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rel_targets = {}
        for rel in rels:
            target = rel.get("Target", "")
            if not target.startswith("/"):
                target = "xl/" + target
            rel_targets[rel.get("Id")] = target.lstrip("/")

        sheets: Dict[str, np.ndarray] = {}
        for node in wb.iter():
            if _strip_ns(node.tag) != "sheet":
                continue
            name = node.get("name")
            rid = next(
                (v for k, v in node.attrib.items() if _strip_ns(k) == "id"), None
            )
            target = rel_targets.get(rid)
            if target is None:
                continue
            ws = ElementTree.fromstring(zf.read(target))
            rows: List[List[int]] = []
            for row in ws.iter():
                if _strip_ns(row.tag) != "row":
                    continue
                values: Dict[int, int] = {}
                for ci, cell in enumerate(
                    [c for c in row if _strip_ns(c.tag) == "c"]
                ):
                    ref = cell.get("r")
                    col = _col_index(ref) if ref else ci
                    v = next(
                        (c for c in cell if _strip_ns(c.tag) == "v"), None
                    )
                    if v is not None and v.text is not None:
                        values[col] = int(float(v.text))
                if values:
                    width = max(values) + 1
                    rows.append([values.get(c, 0) for c in range(width)])
            if rows:
                width = max(len(r) for r in rows)
                arr = np.zeros((len(rows), width), np.int64)
                for ri, r in enumerate(rows):
                    arr[ri, : len(r)] = r
            else:
                arr = np.zeros((0, 6), np.int64)
            sheets[name] = arr
    return sheets


def frame_index_from_xlsx_name(path: Path) -> int:
    m = _XLSX_RE.match(Path(path).name)
    if m is None:
        raise ValueError(
            f"invalid workbook name {Path(path).name!r} "
            "(expected <video>-<word>-<frame>.xlsx)"
        )
    return int(m.group("frame"))


def parse_xlsx_file(path: Path) -> DumpParseResult:
    """Adapt one workbook into the dump parser's record type.

    Applies the same intra filter (frame_type == 0) and order-hint
    cross-check as :func:`av1tpu_torch.ingest.partition_dump.parse_dump_file`.
    """
    path = Path(path)
    frame_index = frame_index_from_xlsx_name(path)
    result = DumpParseResult(frame_index=frame_index)
    for name, rows in read_frame_xlsx(path).items():
        if name not in SHEET_NAMES or rows.shape[0] == 0:
            continue
        if rows.shape[1] < 6:
            # 004-era archives always carry 6 columns; tolerate truncation
            padded = np.zeros((rows.shape[0], 6), np.int64)
            padded[:, : rows.shape[1]] = rows
            rows = padded
        result.total_lines += int(rows.shape[0])
        intra = rows[:, 4] == 0
        mismatched = rows[:, 5] != frame_index
        if mismatched.any():
            result.warnings.append(
                f"{path.name}: {int(mismatched.sum())} rows with order_hint != "
                f"{frame_index}"
            )
        rows = rows[intra]
        result.intra_blocks += int(rows.shape[0])
        if rows.shape[0] == 0:
            continue
        px = int(name)
        result.per_block_size[px] = FrameBlocks(
            frame_index=frame_index,
            block_px=px,
            row_units=rows[:, 0].astype(np.int32),
            col_units=rows[:, 1].astype(np.int32),
            modes=rows[:, 2].astype(np.int32),
            qps=rows[:, 3].astype(np.int32),
        )
    return result


def discover_xlsx_files(directory: Path) -> List[Path]:
    files = [p for p in Path(directory).iterdir() if _XLSX_RE.match(p.name)]
    return sorted(files, key=frame_index_from_xlsx_name)


def parse_xlsx_directory(directory: Path) -> List[DumpParseResult]:
    return [parse_xlsx_file(p) for p in discover_xlsx_files(directory)]


def export_dump_dir_to_xlsx(
    dump_dir: Path, out_dir: Path, video_name: str, middle_word: str = "intra"
) -> List[Path]:
    """Reference 004 equivalent: dumps -> per-frame workbooks."""
    out_dir = Path(out_dir)
    written = []
    for result in parse_dump_directory(dump_dir):
        name = f"{video_name}-{middle_word}-{result.frame_index}.xlsx"
        written.append(write_frame_xlsx(out_dir / name, result))
    return written


__all__ = [
    "discover_xlsx_files",
    "export_dump_dir_to_xlsx",
    "frame_index_from_xlsx_name",
    "parse_xlsx_directory",
    "parse_xlsx_file",
    "read_frame_xlsx",
    "write_frame_xlsx",
]
