"""Text file-list stores: ``train_files.txt`` and ``target_files.txt``.

The port's copy of ``streamz_tpu/io/filelists.py``.

Formats are byte-compatible with the reference:

- ``train_files.txt``: one ``path`` or ``path,label`` per line, labels optional
  (parse: ``streamz-rs/src/main.rs:41-64``; write-back: ``:66-79``).
- ``target_files.txt``: only labeled ``path,label`` lines are kept
  (parse: ``src/main.rs:91-111``; write: ``:81-89``).
- ``count_speakers`` counts *distinct* labels (``src/main.rs:129-135``).
- Label normalization for eval maps the sorted set of raw labels onto
  ``0..n-1`` (``build_label_map``/``normalize_with_map``,
  ``src/main.rs:281-304``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

TrainEntry = Tuple[str, Optional[int]]


def _parse_usize(raw: str) -> Optional[int]:
    """Rust ``usize`` parse semantics: ASCII digits only.  Python's int()
    is laxer (underscores, unicode digits, sign) — '1_0' must be
    unparseable like the reference, not label 10."""
    raw = raw.strip()
    if raw.isascii() and raw.isdigit():
        return int(raw)
    return None


def load_train_files(path: str) -> List[TrainEntry]:
    """Parse ``train_files.txt`` into (path, optional-label) pairs."""
    if not os.path.exists(path):
        return []
    entries: List[TrainEntry] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split(",")
            if not parts:
                continue
            p = parts[0].strip()
            if not p:
                continue
            # usize semantics (src/main.rs:52): a negative or otherwise
            # unparseable label leaves the entry unlabeled.  (Negative ints
            # would also collide with the device loop's -1 sentinel.)
            label = _parse_usize(parts[1]) if len(parts) > 1 else None
            entries.append((p, label))
    return entries


def _atomic_write_text(path: str, text: str) -> None:
    """temp file + rename in the target directory: a crash (or a second
    process writing the same list — e.g. an unguarded multi-host run)
    can never leave a half-truncated file that the next run loads as a
    silently smaller corpus."""
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".filelist-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_train_files(path: str, files: Sequence[TrainEntry]) -> None:
    """Write back (path, optional-label) pairs (src/main.rs:66-79)."""
    lines = []
    for p, c in files:
        lines.append(f"{p}\n" if c is None else f"{p},{c}\n")
    _atomic_write_text(path, "".join(lines))


def load_target_files(path: str) -> List[Tuple[str, int]]:
    """Parse ``target_files.txt``; only labeled lines survive."""
    if not os.path.exists(path):
        return []
    entries: List[Tuple[str, int]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split(",")
            if len(parts) < 2:
                continue
            p = parts[0].strip()
            c = parts[1].strip()
            if not p:
                continue
            cls = _parse_usize(c)
            if cls is None:  # usize parse failure in the reference: dropped
                continue
            entries.append((p, cls))
    return entries


def write_target_files(path: str, files: Sequence[TrainEntry]) -> None:
    """Write only the labeled entries (src/main.rs:81-89)."""
    _atomic_write_text(
        path, "".join(f"{p},{c}\n" for p, c in files if c is not None)
    )


def count_speakers(files: Sequence[TrainEntry]) -> int:
    """Number of distinct labels present (src/main.rs:129-135)."""
    return len({c for _, c in files if c is not None})


def build_label_map(
    train: Sequence[TrainEntry], eval_files: Sequence[TrainEntry]
) -> Dict[int, int]:
    """Map the sorted union of raw labels onto contiguous ids (src/main.rs:281-294)."""
    labels = sorted({c for _, c in list(train) + list(eval_files) if c is not None})
    return {v: i for i, v in enumerate(labels)}


def normalize_with_map(
    files: Sequence[TrainEntry], label_map: Dict[int, int]
) -> List[Tuple[str, int]]:
    """Apply a label map, dropping unlabeled/unknown entries (src/main.rs:296-304)."""
    out: List[Tuple[str, int]] = []
    for p, c in files:
        if c is not None and c in label_map:
            out.append((p, label_map[c]))
    return out
