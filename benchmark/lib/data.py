"""Seeded inputs, made in bulk on the device: moving-pattern clips, style
textures and training batches.

The clip pattern is ``chip_smoke.synth_clip``'s (copied, not imported): per
colour channel a sine grating of seeded frequencies and phase that moves 3
px right and 2 px down a frame, times a slowly drifting cosine.  Its
parameters come from numpy's generator seeded with ``(seed, clip)``; the
pixels are computed on the device in fp32 and truncated to uint8 after
clipping, as ``astype(np.uint8)`` does.  The same seed gives the same bytes
on the same device type.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _params(seed: int, index: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng([seed, index])
    return rng.uniform(0.01, 0.05, (3, 2)), rng.uniform(0, 6.3, 3)


def clip(seed: int, index: int, frames: int, h: int, w: int, device,
         chunk: int = 16) -> np.ndarray:
    """One clip, BGR uint8 [frames, h, w, 3] in host memory."""
    f, ph = _params(seed, index)
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    ph = torch.as_tensor(ph, dtype=torch.float32, device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    out = torch.empty((frames, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, frames, chunk):
        i = torch.arange(s, min(s + chunk, frames), dtype=torch.float32,
                         device=device)[:, None, None, None]
        v = 128 + 100 * torch.sin((xx + 3 * i) * f[:, 0] + (yy + 2 * i)
                                  * f[:, 1] + ph) \
            * torch.cos(yy * f[:, 0] * 0.7 - i * 0.05)
        out[s:s + i.shape[0]] = v.clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()


def style(seed: int, h: int, w: int, device) -> np.ndarray:
    """A seeded texture, BGR uint8 [h, w, 3]: ``chip_smoke.synth_style``'s
    gratings plus normal noise of std 12 drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    chans = [128 + 90 * torch.sin(xx / (9 + 4 * c) + c)
             * torch.cos(yy / (13 - 3 * c) - c) for c in range(3)]
    img = torch.stack(chans, -1)
    img = img + 12 * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def clips(seed: int, count: int, frames: int, h: int, w: int,
          device) -> List[np.ndarray]:
    return [clip(seed, k, frames, h, w, device) for k in range(count)]
