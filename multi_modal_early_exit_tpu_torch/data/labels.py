"""Label vocabularies for the supported document-classification datasets.

The PyTorch port's own copy of the JAX package's ``data/labels.py``.

Parity: RVL-CDIP 16-class map (reference: EE/data/RVL_CDIP.py:175-195),
Tobacco-3482 10-class map (EE/data/RVL_CDIP.py:414-427), and the
RVL-CDIP-N out-of-distribution remapping onto the RVL-CDIP labelset
(EE/configs.py:257-292).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

RVL_CDIP_ID2LABEL: "OrderedDict[int, str]" = OrderedDict(
    {
        0: "letter",
        1: "form",
        2: "email",
        3: "handwritten",
        4: "advertisement",
        5: "scientific_report",
        6: "scientific_publication",
        7: "specification",
        8: "file_folder",
        9: "news_article",
        10: "budget",
        11: "invoice",
        12: "presentation",
        13: "questionnaire",
        14: "resume",
        15: "memo",
    }
)
RVL_CDIP_LABEL2ID: Dict[str, int] = {v: k for k, v in RVL_CDIP_ID2LABEL.items()}

TOBACCO_ID2LABEL: "OrderedDict[int, str]" = OrderedDict(
    {
        0: "ADVE",
        1: "Email",
        2: "Form",
        3: "Letter",
        4: "Memo",
        5: "News",
        6: "Note",
        7: "Report",
        8: "Resume",
        9: "Scientific",
    }
)
TOBACCO_LABEL2ID: Dict[str, int] = {v: k for k, v in TOBACCO_ID2LABEL.items()}

# RVL-CDIP-N ships lowercase space-separated names; remap to RVL-CDIP ids
# (reference: EE/configs.py:257-292 builds this correspondence dynamically).
RVL_CDIP_N_NAME_FIX: Dict[str, str] = {
    "scientific report": "scientific_report",
    "scientific publication": "scientific_publication",
    "file folder": "file_folder",
    "news article": "news_article",
}


def labelset_for(dataset_name: str) -> "OrderedDict[int, str]":
    name = dataset_name.lower()
    if "tobacco" in name:
        return TOBACCO_ID2LABEL
    return RVL_CDIP_ID2LABEL
