"""Progress reporting (tqdm-backed), replacing the reference's indicatif bars
(``streamz-rs/src/main.rs:491-509``, ``:703-708``).  The port's copy of
``streamz_tpu/runtime/progress.py``."""

from __future__ import annotations

from typing import Iterable, Optional, TypeVar

T = TypeVar("T")

try:
    from tqdm import tqdm as _tqdm
except Exception:  # pragma: no cover
    _tqdm = None


def progress(
    it: Iterable[T], desc: str = "", total: Optional[int] = None, enabled: bool = True
) -> Iterable[T]:
    if not enabled or _tqdm is None:
        return it
    return _tqdm(it, desc=desc, total=total, leave=False)
