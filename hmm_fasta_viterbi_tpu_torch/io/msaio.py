"""Multiple-sequence-alignment input (the hmmbuild-side of the format
family). Reads the two MSA shapes this engine itself emits — Stockholm
1.0 (ops.traceback.stockholm_msa, incl. multi-block files with a
``#=GC RF`` match-column annotation) — plus aligned FASTA (gap chars
``-``/``.``). Returns raw aligned strings; interpretation (match
columns, residues vs gaps) belongs to models.build."""

from __future__ import annotations

import os


class MSAParseError(ValueError):
    pass


def read_msa(path: str | os.PathLike) -> tuple[list[str], list[str], str | None]:
    """(names, aligned_rows, rf_annotation_or_None) from a Stockholm or
    aligned-FASTA file (auto-detected by the Stockholm header)."""
    with open(path, "r") as f:
        text = f.read()
    if text.startswith("# STOCKHOLM"):
        return _read_stockholm(text, str(path))
    return _read_aligned_fasta(text, str(path))


def _read_stockholm(text: str, source: str):
    rows: dict[str, str] = {}
    order: list[str] = []
    rf = ""
    for line in text.splitlines():
        if not line.strip() or line.startswith("//"):
            continue
        if line.startswith("#=GC RF"):
            parts = line.split(None, 2)
            if len(parts) < 3:
                raise MSAParseError(f"{source}: empty #=GC RF line")
            rf += parts[2].strip()
            continue
        if line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise MSAParseError(f"{source}: malformed row {line!r}")
        name, chunk = parts[0], parts[1].strip()
        if name not in rows:
            rows[name] = ""
            order.append(name)
        rows[name] += chunk  # blocks concatenate per name
    if not order:
        raise MSAParseError(f"{source}: no alignment rows")
    lengths = {len(rows[n]) for n in order}
    if len(lengths) != 1:
        raise MSAParseError(f"{source}: ragged alignment rows {lengths}")
    if rf and len(rf) != lengths.pop():
        raise MSAParseError(f"{source}: RF length != alignment width")
    return order, [rows[n] for n in order], (rf or None)


def _read_aligned_fasta(text: str, source: str):
    names: list[str] = []
    chunks: list[list[str]] = []
    for line in text.splitlines():
        if line.startswith(">"):
            names.append(line[1:].strip())
            chunks.append([])
        elif line.strip():
            if not chunks:
                raise MSAParseError(f"{source}: data before first '>'")
            chunks[-1].append(line.strip())
    if not names:
        raise MSAParseError(f"{source}: no alignment rows")
    rows = ["".join(c) for c in chunks]
    if len({len(r) for r in rows}) != 1:
        raise MSAParseError(f"{source}: ragged alignment rows")
    return names, rows, None
