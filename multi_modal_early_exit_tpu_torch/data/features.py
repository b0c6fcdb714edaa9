"""Token-level feature conversion: words + layout boxes -> fixed-shape arrays.

The PyTorch port's own copy of the JAX package's ``data/features.py``
(host-side numpy; nothing here touches a framework). Parity target:
``convert_example_to_features`` of the reference data stack and the HF
LayoutLMv3 processor's tokenizer path:

- each word is tokenized to subwords; its normalized box is replicated per
  subword token;
- sequence truncated to ``max_seq_length - 2``;
- [CLS] box = [0,0,0,0], [SEP] box = [1000,1000,1000,1000], pad box =
  [0,0,0,0]; pad token id fills input_ids; attention_mask is 1 on real
  tokens.

``load_tokenizer`` uses a locally-cached HuggingFace tokenizer when
``transformers`` is installed and has one, and otherwise falls back to
``HashWordTokenizer``, a deterministic hash-bucket subword scheme that keeps
the pipeline runnable with no network and no extra packages.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

CLS_BOX = (0, 0, 0, 0)
SEP_BOX = (1000, 1000, 1000, 1000)
PAD_BOX = (0, 0, 0, 0)
MAX_SEQ_LENGTH = 512  # reference compute budget


class HashWordTokenizer:
    """Deterministic offline tokenizer with RoBERTa-style special ids.

    Words are lowercased, chunked to <= 8 chars, and each chunk is hashed
    into [num_special, vocab_size). Not a linguistic tokenizer — a hermetic
    stand-in so pipelines and tests run with zero network.
    """

    cls_token = "<s>"
    sep_token = "</s>"
    pad_token = "<pad>"
    cls_token_id = 0
    pad_token_id = 1
    sep_token_id = 2
    _num_special = 4  # 0..3 reserved (mirrors RoBERTa <s>/<pad>/</s>/<unk>)

    def __init__(self, vocab_size: int = 50265, chunk: int = 8):
        self.vocab_size = vocab_size
        self.chunk = chunk

    def tokenize(self, word: str) -> List[str]:
        w = str(word).lower()
        return [w[i : i + self.chunk] for i in range(0, len(w), self.chunk)] or [w]

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        ids = []
        span = self.vocab_size - self._num_special
        for t in tokens:
            if t == self.cls_token:
                ids.append(self.cls_token_id)
            elif t == self.sep_token:
                ids.append(self.sep_token_id)
            elif t == self.pad_token:
                ids.append(self.pad_token_id)
            else:
                h = int.from_bytes(
                    hashlib.md5(t.encode("utf-8")).digest()[:8], "little"
                )
                ids.append(self._num_special + h % span)
        return ids


def load_tokenizer(name: str = "microsoft/layoutlmv3-base", vocab_size: int = 50265):
    """Locally-cached HF tokenizer if present, else the hermetic fallback."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception:  # no transformers, or no cached tokenizer: hermetic path
        return HashWordTokenizer(vocab_size=vocab_size)


def convert_words_to_features(
    words: Sequence[str],
    boxes: Sequence[Sequence[int]],
    tokenizer,
    max_seq_length: int = MAX_SEQ_LENGTH,
) -> Dict[str, np.ndarray]:
    """words + 0-1000 boxes -> {input_ids, bbox, attention_mask} fixed shape.

    Subword expansion with per-token box replication, -2 truncation, [CLS]
    prepended and [SEP] appended, zero-padding to max_seq_length.
    """
    if len(words) != len(boxes):
        raise ValueError(f"{len(words)} words but {len(boxes)} boxes")
    tokens: List[str] = []
    token_boxes: List[Sequence[int]] = []
    for word, box in zip(words, boxes):
        if isinstance(word, float):
            word = str(int(word))
        word_tokens = tokenizer.tokenize(str(word))
        tokens.extend(word_tokens)
        token_boxes.extend([box] * len(word_tokens))

    limit = max_seq_length - 2
    if len(tokens) > limit:
        tokens = tokens[:limit]
        token_boxes = token_boxes[:limit]

    tokens = [tokenizer.cls_token] + tokens + [tokenizer.sep_token]
    token_boxes = [CLS_BOX] + token_boxes + [SEP_BOX]

    input_ids = list(tokenizer.convert_tokens_to_ids(tokens))
    attention_mask = [1] * len(input_ids)

    pad = max_seq_length - len(input_ids)
    input_ids += [tokenizer.pad_token_id] * pad
    attention_mask += [0] * pad
    token_boxes += [PAD_BOX] * pad

    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "bbox": np.asarray(token_boxes, np.int32),
        "attention_mask": np.asarray(attention_mask, np.int32),
    }


def batch_features(
    examples: Sequence[Dict[str, np.ndarray]],
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """List of per-example dicts -> dict of stacked arrays, ``extra``'s
    arrays added as they are (parity: collate_fn, EE/data/__init__.py:23-27)."""
    out = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    if extra:
        out.update(extra)
    return out
