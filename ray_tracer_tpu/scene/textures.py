"""Texture loading: image files -> one padded float32 stack in HBM.

Replacement for the reference's stb_image -> VkImage path
(``src/vk_textures.cpp:8-293``).  All textures are decoded to linear-light
RGB float32 (the reference binds views with ``VK_FORMAT_R8G8B8A8_SRGB``,
``vk_engine.cpp:1158``, so its shader reads are linearized by hardware) and
stacked into a single ``(K, Hmax, Wmax, 3)`` array so texture fetches are a
single dynamic gather instead of 64 separate bindings.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to (H,W,3) uint8 sRGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def stack_textures(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Load + zero-pad to a common (K,Hmax,Wmax,3) uint8 sRGB stack.

    Stored as uint8 (the reference's VK_FORMAT_R8G8B8A8_SRGB images are 8-bit
    too); linearization happens per sample in the shader, exactly like the
    reference's SRGB-view hardware decode.  A float32 stack would cost 4x
    the HBM and Sponza-class texture sets run to hundreds of MB.
    """
    if not paths:
        return (
            np.zeros((1, 1, 1, 3), np.uint8),
            np.ones((1, 2), np.int32),
        )
    images: List[np.ndarray] = []
    for p in paths:
        try:
            images.append(load_image_rgb(p))
        except Exception:
            # Missing texture: magenta 1x1, mirroring the reference's loud
            # failure (vk_textures.cpp:114) without aborting the build.
            images.append(np.array([[[255, 0, 255]]], np.uint8))
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    stack = np.zeros((len(images), hmax, wmax, 3), np.uint8)
    sizes = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        stack[i, : im.shape[0], : im.shape[1]] = im
        sizes[i] = (im.shape[0], im.shape[1])
    return stack, sizes
