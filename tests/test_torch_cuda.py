"""rerevst_torch on a CUDA card: each kernel against its plain version, the
wrappers' refusals, and a stylized clip against the port's CPU path.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports no JAX, so it runs on a machine that
has only PyTorch; there, skip the JAX-only ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: a kernel and its plain version both compute in fp32 and round
once, so they agree to 1e-5 of the output's scale in fp32 and within one ulp
of the storage dtype in f16/bf16 (plus 1e-5 of the scale, for the other
order of the filter pair's sums).  The card's fp32 frames stay within 1
uint8 count of the CPU path's (cuDNN and the CPU sum in other orders).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rerevst_torch import kernels
from rerevst_torch.api import Stylization
from rerevst_torch.kernels import (
    dynamic_filter_pair,
    dynamic_filter_pair_plain,
    norm_affine_clamp,
    norm_affine_clamp_plain,
)
from rerevst_torch.models.transformer import NormStats

CKPT = Path(__file__).resolve().parent.parent / "models" / "demo_plum_4000.msgpack"
DTYPES = [torch.float32, torch.float16, torch.bfloat16]
VARIANTS = ["identity", "affine", "leaky"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulp_ok(got, want):
    """Within one ulp of the storage dtype (fp32: 1e-5 of the scale)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return bool((g - w).abs().max()
                    <= 1e-5 * w.abs().max().clamp_min(1e-30))
    mant = {torch.float16: 10, torch.bfloat16: 7}[got.dtype]
    tiny = {torch.float16: 2.0 ** -24, torch.bfloat16: 2.0 ** -133}[got.dtype]
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                     - mant).clamp_min(tiny)
    return bool(((g - w).abs() <= ulp + 1e-5 * w.abs().max()).all())


def _norm_inputs(rng, shape, variant, dev, dtype):
    """Inputs with one degenerate channel: rstd 1e6 and a non-zero mean."""
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2
    x[..., 0] = 0.3 + rng.standard_normal(shape[:-1]) * 1e-6
    mean = rng.standard_normal(c).astype(np.float32)
    rstd = (0.5 + rng.random(c)).astype(np.float32)
    mean[0], rstd[0] = 0.3, 1e6
    xmin = (-2 - rng.random(c)).astype(np.float32)
    xmax = (2 + rng.random(c)).astype(np.float32)
    st = NormStats(*(torch.from_numpy(v).reshape(1, 1, 1, c).to(dev)
                     for v in (mean, rstd, xmin, xmax)))
    s = m = None
    if variant == "affine":
        s = torch.from_numpy(1 + rng.random((1, 1, 1, c))).to(dev, dtype)
        m = torch.from_numpy(rng.standard_normal((1, 1, 1, c))).to(dev, dtype)
    return torch.from_numpy(x).to(dev, dtype), st, s, m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_norm_affine_kernel_on_card(rng, cuda, dtype, variant):
    x, st, s, m = _norm_inputs(rng, (3, 17, 19, 128), variant, cuda, dtype)
    leaky = variant == "leaky"
    before = norm_affine_clamp.launches
    got = norm_affine_clamp(x, st, s, m, leaky=leaky)
    torch.cuda.synchronize()
    assert norm_affine_clamp.launches == before + 1
    assert _ulp_ok(got, norm_affine_clamp_plain(x, st, s, m, leaky=leaky))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_pair_kernel_on_card(rng, cuda, dtype):
    """Filters of magnitude 1e3 under every storage dtype: the kernel keeps
    them and the intermediate in fp32."""
    x = torch.from_numpy(rng.standard_normal((2, 13, 11, 32))).to(cuda, dtype)
    f1 = torch.from_numpy(rng.standard_normal((1, 32, 32)) * 1e3) \
        .float().to(cuda)
    f2 = torch.from_numpy(rng.standard_normal((1, 32, 32)) * 1e-3) \
        .float().to(cuda)
    before = dynamic_filter_pair.launches
    got = dynamic_filter_pair(x, f1, f2)
    torch.cuda.synchronize()
    assert dynamic_filter_pair.launches == before + 1
    assert torch.isfinite(got).all()
    assert _ulp_ok(got, dynamic_filter_pair_plain(x, f1, f2))


@pytest.mark.cuda
def test_wrappers_refuse_on_card(rng, cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: inputs the
    kernel does not take never fall back to the plain version."""
    x, st, _, _ = _norm_inputs(rng, (2, 3, 4, 64), "identity", cuda,
                               torch.float16)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="fp32"):
        norm_affine_clamp(x, NormStats(*(v.cpu() for v in st)))
    x36 = torch.zeros(2, 3, 4, 36, device=cuda, dtype=torch.float16)
    f36 = torch.zeros(1, 36, 36, device=cuda)
    with pytest.raises(ValueError, match="C=32"):
        dynamic_filter_pair(x36, f36, f36)
    f32 = torch.zeros(1, 32, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32"):
        dynamic_filter_pair(x36[..., :32].contiguous(), f32, f32)
    assert kernels.launch_counts() == before


def _clip(n=9, h=64, w=112, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


@pytest.mark.cuda
def test_stylize_video_on_card_matches_cpu(cuda):
    """The main path on the card goes through both kernels (11 and 3
    launches per Pass-2 batch) and renders the CPU path's frames within
    1 count."""
    rng = np.random.default_rng(1)
    style = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    clip = _clip()
    outs = {}
    for dev in ("cuda", "cpu"):
        s = Stylization(str(CKPT), device=dev)
        s.prepare_style(style)
        kernels.reset_launches()
        outs[dev] = list(s.stylize_video(clip, batch_size=4))
        if dev == "cuda":
            assert kernels.launch_counts() == {"norm_affine_clamp": 33,
                                               "dynamic_filter_pair": 9}
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == (64, 112, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
