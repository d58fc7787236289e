"""Image files for the data-prep tools, through cv2 where it is importable
and PIL otherwise (the JAX tools write through imageio, which a machine
may lack). Arrays are RGB (or gray), uint8 or uint16."""

from __future__ import annotations

import numpy as np


def write_image(path: str, img: np.ndarray) -> None:
    """Write ``img`` ((H, W) gray or (H, W, 3) RGB, uint8 or uint16) to
    ``path``; the suffix picks the format. A 16-bit RGB image needs cv2
    (PIL cannot encode one)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img):
            raise OSError(f"cv2 could not write {path}")
        return
    from PIL import Image
    if img.ndim == 3 and img.dtype != np.uint8:
        raise ImportError(f"{path}: a 16-bit RGB image needs cv2")
    Image.fromarray(img).save(path)


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as stored: gray (H, W) or RGB (H, W, 3)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"Could not read {path}")
        return img[..., ::-1] if img.ndim == 3 else img
    from PIL import Image
    return np.asarray(Image.open(path))
