"""Scene texture storage (a copy of svgf_tpu/core/textures.py, which is
NumPy; the port imports nothing of svgf_tpu).

The reference packs every scene texture into one 8192x8192 CUDA pitched
array of 256x256 slots (reference src/TextureArrayCu.cu:24-84; slot size
TEX_WIDTH, src/Scene.h:17) and every environment map into a float atlas of
2048x1024 slots (ENV_TEX_WIDTH, src/Scene.h:16). Here the layout is a
stacked (K, S, S, 4) array indexed by texture id, which a plain index
gather reads by layer, so that is what `build_texture_stack` produces.
Images are resized to the common slot size on the host exactly like the
reference resizes every texture into its atlas slot
(src/GLTFLoader.cpp:16-71, src/ImageLoader.cpp:96-119).

Device-side sampling lives in svgf_tpu_torch.ops.texture.
"""

from __future__ import annotations

import numpy as np

# Reference slot sizes (src/Scene.h:16-17, Scene.cpp:641-644).
TEX_SIZE = 256
ENV_TEX_WIDTH = 2048


def to_rgba_u8(img: np.ndarray) -> np.ndarray:
    """Normalize any (H, W[, C]) image to (H, W, 4) uint8."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    c = a.shape[-1]
    if c == 1:
        a = np.repeat(a, 3, axis=-1)
        c = 3
    if c == 3:
        a = np.concatenate([a, np.full(a.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return a[..., :4]


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host resize to the atlas slot size (reference stb resize,
    src/ImageLoader.cpp:96-119; nearest keeps this dependency-free and
    exactly reproducible)."""
    a = np.asarray(img)
    ys = (np.arange(h) * (a.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (a.shape[1] / w)).astype(np.int64)
    return a[ys[:, None], xs[None, :]]


def build_texture_stack(images, size: int = TEX_SIZE) -> np.ndarray:
    """Stack scene textures into one (K, size, size, 4) uint8 array.

    `images`: list of (H, W[, C]) uint8 or float [0,1] arrays. Returns a
    (1, 1, 2, 4) placeholder when empty (never indexed; keeps shapes static).
    """
    if not images:
        return np.zeros((1, 1, 2, 4), np.uint8)
    slots = [resize_nearest(to_rgba_u8(im), size, size) for im in images]
    return np.stack(slots, axis=0)


def build_env_stack(images, width: int = ENV_TEX_WIDTH) -> np.ndarray:
    """Stack float HDR equirect maps into one (K, width/2, width, 3) array
    (reference env atlas slot 2048x1024, src/Scene.cpp:643-644)."""
    if not images:
        return np.zeros((1, 1, 2, 3), np.float32)
    h = width // 2
    slots = []
    for im in images:
        a = np.asarray(im, np.float32)[..., :3]
        a = np.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)  # NaN scrub, ImageLoader.cpp:121-127
        if a.shape[:2] != (h, width):
            a = resize_nearest(a, h, width)
        slots.append(a)
    return np.stack(slots, axis=0)


def texture_alpha_min(images) -> list:
    """Per-texture minimum alpha (0..1). Used to extend has_opacity to
    alpha-textured materials (reference folds ColourTexture.w into
    Point.Opacity, src/Common.cuh:1458)."""
    mins = []
    for im in images:
        a = to_rgba_u8(im)
        mins.append(float(a[..., 3].min()) / 255.0)
    return mins
