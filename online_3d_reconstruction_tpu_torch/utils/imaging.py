"""Small host-side imaging helpers shared by tests and data tooling."""

from __future__ import annotations

import numpy as np


def bilinear_sample_np(image: np.ndarray, x: np.ndarray, y: np.ndarray,
                       fill: float = 0.0) -> np.ndarray:
    """Bilinearly sample ``image`` (H, W[, C]) at float coords (x, y).

    Out-of-bounds samples return ``fill``. Numpy mirror of the remap gather
    in ``stereo/rectify.py``: its oracle, also used by the synthetic-scene
    self-consistency tests.
    """
    h, w = image.shape[:2]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    tx = (x - x0).astype(np.float64)
    ty = (y - y0).astype(np.float64)

    valid = (x0 >= 0) & (x0 + 1 <= w - 1) & (y0 >= 0) & (y0 + 1 <= h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)

    def at(yy, xx):
        return image[yy, xx]

    v00 = at(y0c, x0c)
    v10 = at(y0c, x0c + 1)
    v01 = at(y0c + 1, x0c)
    v11 = at(y0c + 1, x0c + 1)
    if image.ndim == 3:
        tx = tx[..., None]
        ty = ty[..., None]
        valid_b = valid[..., None]
    else:
        valid_b = valid
    out = (
        v00 * (1 - tx) * (1 - ty)
        + v10 * tx * (1 - ty)
        + v01 * (1 - tx) * ty
        + v11 * tx * ty
    )
    return np.where(valid_b, out, fill).astype(image.dtype)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8 (for cv2 oracles that want 8-bit)."""
    return np.clip(image * 255.0, 0, 255).astype(np.uint8)
