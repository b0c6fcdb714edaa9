"""The one generator of documents, read from a traffic file's parameters.

A document is what the port's feature conversion would hand the model for
one scanned page: token ids (the configuration's [CLS], [SEP] and pad ids,
word pieces drawn from its ``word_pieces`` range), each token's word box on
the 0-1000 grid (words on lines, [CLS] and pad boxes 0, [SEP] 1000), the
attention mask, a label, and the 224^2 page with text-like dark bands on
white, normalised to [-1, 1] or, with ``pixels`` "0-255", as raw values. Word counts are drawn per page from ``words`` (1 to 3
pieces a word), so pages range from short to truncated at the text length.
Everything comes from the seed: the host arrays from numpy, the pages from
a generator on the device.
"""

from __future__ import annotations

import numpy as np
import torch

def text_features(n: int, rng: np.random.Generator, cfg: dict, words) -> dict:
    """(n, text_len) int32 ids and mask, (n, text_len, 4) int32 boxes, (n,)
    int64 labels, on the host."""
    t = cfg["text_len"]
    ids = np.full((n, t), cfg["pad_token_id"], np.int32)
    boxes = np.zeros((n, t, 4), np.int32)
    mask = np.zeros((n, t), np.int32)
    lo, hi = words
    for i in range(n):
        n_words = int(rng.integers(lo, hi))
        pieces = rng.integers(1, 4, n_words)
        x0 = rng.integers(0, 900, n_words)
        y0 = np.sort(rng.integers(0, 980, n_words))
        wbox = np.stack([x0, y0, x0 + rng.integers(10, 100, n_words), y0 + 15], -1)
        tok_box = np.repeat(wbox, pieces, axis=0)[:t - 2]
        m = len(tok_box)
        ids[i, 0] = cfg["cls_token_id"]
        ids[i, 1:m + 1] = rng.integers(*cfg["word_pieces"], m)
        ids[i, m + 1] = cfg["sep_token_id"]
        boxes[i, 1:m + 1] = tok_box
        boxes[i, m + 1] = 1000
        mask[i, :m + 2] = 1
    labels = rng.integers(0, cfg["num_labels"], n).astype(np.int64)
    return {"input_ids": ids, "bbox": boxes, "attention_mask": mask, "labels": labels}


def pages(n: int, gen: torch.Generator, cfg: dict, bands: int, device) -> torch.Tensor:
    """(n, C, size, size) f32 pages normalised to [-1, 1]: white, with
    ``bands`` dark horizontal strokes of random length and shade a page."""
    size, c = cfg["input_size"], cfg["num_channels"]
    img = torch.ones((n, size, size), device=device)
    rows = torch.arange(size, device=device)
    ys = torch.randint(0, size - 2, (n, bands), generator=gen, device=device)
    x0 = torch.randint(0, size * 3 // 8, (n, bands), generator=gen, device=device)
    x1 = torch.randint(size // 2, size, (n, bands), generator=gen, device=device)
    shade = torch.rand((n, bands), generator=gen, device=device) * (120 / 255) * 2 - 1
    for k in range(bands):
        in_rows = (rows[None, :] >= ys[:, k, None]) & (rows[None, :] < ys[:, k, None] + 2)
        in_cols = (rows[None, :] >= x0[:, k, None]) & (rows[None, :] < x1[:, k, None])
        stroke = in_rows[:, :, None] & in_cols[:, None, :]
        img = torch.where(stroke, shade[:, k, None, None], img)
    return img[:, None].expand(n, c, size, size).contiguous()


def make_pool(seed: int, cfg: dict, mix: dict, device) -> dict:
    """The cell's pool of ``mix['pool']`` documents: host arrays and the
    pages on ``device``."""
    rng = np.random.default_rng([seed, 1])
    pool = text_features(mix["pool"], rng, cfg, mix["words"])
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    px = pages(mix["pool"], gen, cfg, mix["bands"], device)
    pool["pixel_values"] = (px + 1) * 127.5 if mix.get("pixels") == "0-255" else px
    return pool


class Batches:
    """Batches of ``batch`` rows that cycle the pool: each pass over it is
    a new permutation drawn from the seed, so every batch differs while the
    set of documents, and so the work, stays the same from seed to seed."""

    def __init__(self, seed: int, pool_size: int, batch: int):
        if pool_size % batch:
            raise ValueError(f"the pool ({pool_size}) must be a multiple of the batch ({batch})")
        self.rng = np.random.default_rng([seed, 2])
        self.pool_size, self.batch = pool_size, batch
        self.order = np.empty(0, np.int64)

    def next(self) -> np.ndarray:
        if len(self.order) < self.batch:
            self.order = np.concatenate([self.order, self.rng.permutation(self.pool_size)])
        rows, self.order = self.order[:self.batch], self.order[self.batch:]
        return rows


def gather(pool: dict, rows: np.ndarray, keys, device=None) -> dict:
    """A batch of ``rows``: host arrays stay numpy (as a request carries
    them), the pages are gathered on their device."""
    out = {}
    for k in keys:
        v = pool[k]
        if torch.is_tensor(v):
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        else:
            out[k] = v[rows]
    return out
