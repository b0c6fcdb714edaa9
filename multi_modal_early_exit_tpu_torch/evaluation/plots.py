"""Qualitative exit visualizations (parity: EE/plots.py:6-125).

``plot_exits`` renders, for each exit, a grid of the top-k most-confident
test samples that exited there, annotated with predicted class + confidence,
framed green when correct and red when wrong. Works directly on the
framework's pixel_values (denormalized) so it needs no raw image access.
The port's copy of the JAX package's module; PIL is imported only to draw.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.special


def _denormalize(pixel_values: np.ndarray) -> "np.ndarray":
    """(3, H, W) normalized -> (H, W, 3) uint8 (inverse of images.py)."""
    x = np.asarray(pixel_values)
    x = (x * 0.5 + 0.5) * 255.0
    return np.clip(x.transpose(1, 2, 0), 0, 255).astype(np.uint8)


def annotate(image, text: str, correct: bool, border: int = 4):
    """Frame an image green/red and caption it (EE/plots.py:33-81)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image) if isinstance(image, np.ndarray) else image
    img = img.convert("RGB")
    color = (0, 170, 0) if correct else (200, 0, 0)
    w, h = img.size
    framed = Image.new("RGB", (w + 2 * border, h + 2 * border + 14), color)
    framed.paste(img, (border, border))
    draw = ImageDraw.Draw(framed)
    draw.rectangle([0, h + 2 * border, w + 2 * border, h + 2 * border + 14],
                   fill=(255, 255, 255))
    draw.text((border, h + 2 * border + 1), text, fill=(0, 0, 0))
    return framed


def image_grid(images: Sequence, cols: int):
    from PIL import Image

    if not images:
        return Image.new("RGB", (64, 64), (255, 255, 255))
    w, h = images[0].size
    rows = (len(images) + cols - 1) // cols
    grid = Image.new("RGB", (cols * w, rows * h), (255, 255, 255))
    for i, img in enumerate(images):
        grid.paste(img, ((i % cols) * w, (i // cols) * h))
    return grid


def plot_exits(
    logits_store: np.ndarray,       # (E+1, N, K)
    references: np.ndarray,         # (N,)
    exits_store: np.ndarray,        # (N,) chosen exit per sample
    pixel_values: np.ndarray,       # (N, 3, H, W)
    id2label: Optional[Dict[int, str]] = None,
    top_k: int = 9,
    out_dir: str = "results/plots",
) -> Dict[int, str]:
    """One grid image per exit of its top-k most-confident samples
    (EE/plots.py:84-125). Returns {exit_id: saved path}."""
    os.makedirs(out_dir, exist_ok=True)
    num_exits = logits_store.shape[0]
    saved = {}
    for e in range(num_exits):
        idx = np.where(exits_store == e)[0]
        if len(idx) == 0:
            continue
        probs = scipy.special.softmax(logits_store[e, idx], axis=-1)
        conf = probs.max(-1)
        order = idx[np.argsort(-conf)][:top_k]
        tiles = []
        for i in order:
            p = scipy.special.softmax(logits_store[e, i])
            pred = int(p.argmax())
            name = id2label.get(pred, str(pred)) if id2label else str(pred)
            tiles.append(
                annotate(
                    _denormalize(pixel_values[i]),
                    f"{name} {p.max():.2f}",
                    correct=pred == int(references[i]),
                )
            )
        grid = image_grid(tiles, cols=int(np.ceil(np.sqrt(len(tiles)))))
        path = os.path.join(out_dir, f"exit_{e}.png")
        grid.save(path)
        saved[e] = path
    return saved
