"""Host-side image <-> model-tensor conversion (numpy, cv2 conventions) —
``rerevst_tpu/data/transforms.py``.

cv2 images are BGR uint8 HWC; the model consumes ImageNet-normalized RGB
NHWC.
"""

from __future__ import annotations

import numpy as np

from rerevst_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD


def bgr_to_model(img_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8/float HWC -> normalized RGB float32 [1,H,W,C]."""
    rgb = img_bgr[..., ::-1].astype(np.float32) / 255.0
    out = (rgb - IMAGENET_MEAN) / IMAGENET_STD
    return out[None]


def model_to_bgr(x: np.ndarray) -> np.ndarray:
    """Normalized RGB [N,H,W,C] -> BGR uint8 HWC (first sample), rounded
    with rint like cv2's CV_8U conversion, not truncated."""
    img = x[0] * IMAGENET_STD + IMAGENET_MEAN
    img = np.clip(img, 0.0, 1.0) * 255.0
    return np.rint(img[..., ::-1]).astype(np.uint8)
