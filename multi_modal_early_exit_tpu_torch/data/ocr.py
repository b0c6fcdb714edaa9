"""Host-side OCR ingestion: pytesseract words + normalized boxes.

Behavioral parity with the reference ingestion (EE/data/RVL_CDIP.py:20-89):
``image_to_data`` output is rounded to ints, empty / NaN rows dropped,
(left, top, width, height) converted to (x0, y0, x1, y1) and normalized onto
the 0-1000 layout grid with clipping (the reference's "nasty fixes for wrong
easyOCR bboxes").

pytesseract is optional; ``have_tesseract()`` gates it and the
precomputed-OCR path (words+boxes columns, RVL_CDIP_IO) needs no OCR at
all. The port's copy of the JAX package's ``data/ocr.py`` imports
pytesseract only inside ``apply_tesseract``, so importing the
module needs neither.
"""

from __future__ import annotations

import importlib.util
from typing import List, Sequence, Tuple


def have_tesseract() -> bool:
    """Whether pytesseract can be imported."""
    return importlib.util.find_spec("pytesseract") is not None


def normalize_box(
    box: Sequence[float], width: float, height: float, grid: int = 1000
) -> List[int]:
    """(x0, y0, x1, y1) pixel box -> clipped 0..grid layout box
    (parity: EE/data/RVL_CDIP.py:20-30)."""
    return [
        min(max(0, int(grid * (box[0] / width))), grid),
        min(max(0, int(grid * (box[1] / height))), grid),
        min(max(0, int(grid * (box[2] / width))), grid),
        min(max(0, int(grid * (box[3] / height))), grid),
    ]


def apply_tesseract(image) -> Tuple[List[str], List[List[int]]]:
    """OCR one PIL image -> (words, normalized boxes).

    Parity: EE/data/RVL_CDIP.py:48-84 (process_single's OCR block) — rounds
    float columns, drops blank rows, converts (l,t,w,h) to corner boxes and
    normalizes to the 0-1000 grid.
    """
    if not have_tesseract():
        raise RuntimeError(
            "pytesseract is not installed; use a precomputed-OCR dataset "
            "(words+boxes columns) or install pytesseract"
        )
    import numpy as np
    import pytesseract  # type: ignore

    width, height = image.size
    ocr_df = pytesseract.image_to_data(image, output_type="data.frame")
    float_cols = ocr_df.select_dtypes("float").columns
    ocr_df[float_cols] = ocr_df[float_cols].round(0).astype(int, errors="ignore")
    ocr_df = ocr_df.replace(r"^\s*$", np.nan, regex=True)
    ocr_df = ocr_df.dropna().reset_index(drop=True)

    words = [str(w) for w in ocr_df.text]
    boxes = []
    for _, row in ocr_df[["left", "top", "width", "height"]].iterrows():
        x, y, w, h = tuple(row)
        boxes.append(normalize_box([x, y, x + w, y + h], width, height))
    return words, boxes
