"""Batched image preprocessing for document pages, on the device.

Parity target: the HF ``LayoutLMv3ImageProcessor`` pipeline (resize to
224x224 bilinear, rescale 1/255, normalize with mean=std=0.5 per channel,
channels-first output), as the JAX package's ``data/images.py`` runs it.
The whole pipeline is a few tensor ops over a batch of uint8 pages on the
device; PIL decoding (JPEG/TIFF) stays on the host.

The resize antialiases when it downscales, as ``jax.image.resize(...,
"bilinear")`` does; ``F.interpolate`` does so only with ``antialias=True``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.device import resolve_device

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


def preprocess_images(images_u8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, size, size) float32, normalized, on the
    device ``images_u8`` lies on."""
    x = images_u8.permute(0, 3, 1, 2).to(torch.float32)
    if x.shape[-2:] != (size, size):
        x = F.interpolate(
            x, size=(size, size), mode="bilinear", align_corners=False,
            antialias=True,
        )
    x = x / 255.0
    return (x - IMAGE_MEAN) / IMAGE_STD


def decode_to_array(image, target: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """PIL image -> RGB uint8 (H, W, 3) host array (optionally pre-resized on
    host when source pages are huge, to bound the host->device transfer)."""
    image = image.convert("RGB")
    if target is not None and image.size != target:
        image = image.resize(target)
    return np.asarray(image, dtype=np.uint8)


def preprocess_pil_batch(
    images: Iterable, size: int = 224, device=None
) -> torch.Tensor:
    """List of PIL images -> normalized (B, 3, size, size) on ``device``.

    Decodes on the host, resizes each page to a common shape (the batched
    resize needs uniform input), then normalizes on the device.
    """
    arrs = [decode_to_array(im, target=(size, size)) for im in images]
    batch = torch.from_numpy(np.stack(arrs)).to(resolve_device(device))
    return preprocess_images(batch, size=size)
