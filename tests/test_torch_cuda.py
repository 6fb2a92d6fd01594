"""rerevst_torch on a CUDA card: each kernel against its plain version, the
wrappers' refusals, stylized clips of both inference modes against the
port's CPU path, and the per-frame graph's ops and the evaluation on the
card against the CPU path.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports no JAX, so it runs on a machine that
has only PyTorch; there, skip the JAX-only ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: a kernel and its plain version both compute in fp32 and round
once, so they agree to 1e-5 of the output's scale in fp32 and within one ulp
of the storage dtype in f16/bf16 (plus 1e-5 of the scale, for the other
order of the filter pair's sums).  The 3x3 convs sum K = 9 C products in
other orders on the two sides: each side's fp32 sum is within K 2^-23 of
the sum of |products| (the standard bound, doubled for the tensor cores'
accumulation), so they agree to K 2^-22 sum|x||w| (+ |b|), plus one ulp
of the storage dtype in f16/bf16.  The card's fp32 frames stay within 1
uint8 count of the CPU path's (cuDNN and the CPU sum in other orders).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rerevst_torch import kernels
from rerevst_torch.api import Stylization
from rerevst_torch.config import ModelConfig
from rerevst_torch.kernels import (
    conv3x3_implicit_gemm,
    conv3x3_implicit_gemm_plain,
    conv3x3_pairlane,
    conv3x3_pairlane_plain,
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
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


def _filters(rng, cuda):
    """f1 at magnitude 1e3 and f2 at 1e-3, far outside f16's range."""
    return tuple(torch.from_numpy(rng.standard_normal((1, 32, 32)) * s)
                 .float().to(cuda) for s in (1e3, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_pair_kernel_on_card(rng, cuda, dtype):
    """Filters of magnitude 1e3 under every storage dtype: the kernel keeps
    them and the intermediate in fp32."""
    x = torch.from_numpy(rng.standard_normal((2, 13, 11, 32))).to(cuda, dtype)
    f1, f2 = _filters(rng, cuda)
    before = dynamic_filter_pair.launches
    got = dynamic_filter_pair(x, f1, f2)
    torch.cuda.synchronize()
    assert dynamic_filter_pair.launches == before + 1
    assert torch.isfinite(got).all()
    assert _ulp_ok(got, dynamic_filter_pair_plain(x, f1, f2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1, 32), (1, 1, 13, 32),
                                   (2, 53, 97, 32), (1, 1, 10007, 32)])
def test_filter_pair_ragged_rows_on_card(rng, cuda, dtype, shape):
    """Row counts off the kernel's 16-row tile (1, 13, 10,282 and the prime
    10,007): the last tile is masked, every row is written."""
    x = torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    f1, f2 = _filters(rng, cuda)
    got = dynamic_filter_pair(x, f1, f2)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _ulp_ok(got, dynamic_filter_pair_plain(x, f1, f2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_pair_nonfinite_inputs_on_card(rng, cuda, dtype):
    """inf and NaN inputs, one in the ragged last tile: the kernel's
    non-finite outputs are the plain version's (inf splits into inf and
    NaN), and every other row agrees as usual."""
    x = torch.from_numpy(rng.standard_normal((3, 7, 11, 32))).to(cuda, dtype)
    x[0, 0, 3, 5] = float("inf")
    x[1, 4, 2, 0] = float("-inf")
    x[2, 6, 10, 31] = float("nan")
    f1, f2 = _filters(rng, cuda)
    got = dynamic_filter_pair(x, f1, f2)
    torch.cuda.synchronize()
    want = dynamic_filter_pair_plain(x, f1, f2)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    rows = fin.all(dim=-1)
    assert int((~rows).sum()) == 3
    assert _ulp_ok(got[rows], want[rows])


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


def _conv_ok(got, want, x, w, b, passes=3):
    """Within K 2^-22 sum|x||w| (+|b|), plus one ulp of the storage dtype;
    one TF32 pass (fp32, ``passes=1``) adds (2^-10 + 2^-22) sum|x||w|: x
    and w each rounded to nearest TF32 (<= 2^-11 of it)."""
    k = 9 * x.shape[-1]
    absb = None if b is None else b.abs()
    scale = conv3x3_implicit_gemm_plain(x.abs().float(), w.abs().float(),
                                        None if absb is None else absb.float())
    tol = (k * 2.0 ** -22 + (2.0 ** -10 + 2.0 ** -22 if passes == 1 else 0.0)) * scale
    g, v = got.float(), want.float()
    if got.dtype != torch.float32:
        mant = {torch.float16: 10, torch.bfloat16: 7}[got.dtype]
        tiny = {torch.float16: 2.0 ** -24,
                torch.bfloat16: 2.0 ** -133}[got.dtype]
        tol = tol + torch.exp2(torch.floor(torch.log2(
            v.abs().clamp_min(1e-30))) - mant).clamp_min(tiny)
    return bool(((g - v).abs() <= tol).all())


def _conv_on_card(rng, cuda, dtype, shape, o, bias):
    x = torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((3, 3, shape[-1], o)) * 0.1) \
        .to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(o)).to(cuda, dtype) \
        if bias else None
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,bias", [
    ((2, 13, 7, 128), 5, True), ((3, 37, 53, 64), 64, True),
    ((1, 9, 11, 3), 64, True), ((1, 6, 10, 64), 128, False),
    ((2, 8, 16, 64), 3, True), ((1, 5, 9, 256), 40, True),
    # C = 64, O = 128: two 64-wide channel tiles of the streamed kernel.
    ((1, 75, 300, 64), 128, True), ((1, 75, 300, 64), 128, False),
])
def test_conv3x3_implicit_gemm_kernel_on_card(rng, cuda, dtype, shape, o,
                                              bias):
    x, w, b = _conv_on_card(rng, cuda, dtype, shape, o, bias)
    before = conv3x3_implicit_gemm.launches
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_implicit_gemm.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)


#: Shapes of the wide kernel (16-bit, C % 64 = 0, C >= 128, O > 64): every
#: tile width the plan picks (W = 640, 320, 160, 80 and ragged widths),
#: ragged bands and strips, B = 1, O not a multiple of the tile (192) and
#: two 256-wide tiles.  Its O <= 64 shapes moved to SLICED.
WIDE = [
    ((2, 11, 9, 128), 192), ((1, 5, 640, 128), 128), ((2, 6, 320, 256), 256),
    ((1, 19, 150, 256), 256), ((1, 23, 45, 512), 128),
    ((2, 12, 80, 256), 512), ((1, 3, 161, 512), 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,o", WIDE)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_wide_kernel_on_card(rng, cuda, dtype, shape, o, bias):
    x, w, b = _conv_on_card(rng, cuda, dtype, shape, o, bias)
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert after["wide"] == before["wide"] + 1
    assert got.dtype == dtype and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("o", [128, 192])
def test_conv3x3_wide_nonfinite_inputs_on_card(rng, cuda, dtype, o):
    """The wide kernel (C = 128) under inf and NaN inputs, in the interior,
    on a tile's edge and at the image's edges (O = 5, now on the sliced
    kernel, is in the sliced kernel's test)."""
    x, w, b = _conv_on_card(rng, cuda, dtype, (2, 19, 150, 128), o, True)
    x[0, 3, 5, 7] = float("inf")
    x[0, 10, 63, 1] = float("-inf")
    x[0, 10, 64, 100] = float("nan")
    x[1, 0, 149, 0] = float("nan")
    x[1, 18, 0, 127] = float("inf")
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    want = conv3x3_implicit_gemm_plain(x, w, b)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b)


#: Shapes of the narrow kernel (16-bit, 1 <= C <= 7): ragged last bands and
#: strips of its 8 x 32 tiles, W narrower than one tile, B = 1, O below 8
#: and not a multiple of 8 (scalar stores), 16, 64, 72 and 128 (two channel
#: tiles, the second ragged at 72).
NARROW = [
    ((2, 13, 45, 3), 64), ((1, 9, 7, 1), 5), ((1, 37, 70, 4), 128),
    ((3, 5, 33, 7), 16), ((1, 40, 33, 3), 3), ((2, 11, 96, 2), 72),
    ((1, 8, 32, 6), 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,o", NARROW)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_narrow_kernel_on_card(rng, cuda, dtype, shape, o, bias):
    x, w, b = _conv_on_card(rng, cuda, dtype, shape, o, bias)
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert after["narrow"] == before["narrow"] + 1
    assert got.dtype == dtype and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("o", [64, 5])
def test_conv3x3_narrow_nonfinite_inputs_on_card(rng, cuda, dtype, o):
    """The narrow kernel (C = 3) under inf and NaN inputs on a tile's edge
    columns (31 | 32) and rows (7 | 8), at the image's edges and in a
    halo's corner: the padded K columns must read true zeros."""
    x, w, b = _conv_on_card(rng, cuda, dtype, (2, 19, 70, 3), o, True)
    for idx, v in [((0, 3, 31, 2), "inf"), ((0, 3, 32, 0), "-inf"),
                   ((0, 7, 10, 1), "nan"), ((0, 8, 40, 2), "inf"),
                   ((1, 0, 69, 2), "inf"), ((1, 18, 0, 0), "-inf"),
                   ((1, 15, 63, 1), "inf"), ((1, 16, 64, 2), "nan")]:
        x[idx] = float(v)
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    want = conv3x3_implicit_gemm_plain(x, w, b)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b)


#: Shapes of the sliced kernel (16-bit, C >= 8 neither 64 nor a multiple of
#: 64 >= 128): C = 8 and 16 (16-channel slices), 24, 32, 40, 96, 100 (a
#: zero-padded copy of x), 160 and 200 (32-channel slices; 24, 40 and 200
#: end in a zero-filled tail); every tile width its plan picks, ragged bands
#: and strips, W narrower than a tile, B = 1; O = 3 and 5 (scalar stores, a
#: padded weight copy), 8, 24, 32, 64, 192 (a half-empty channel tile) and
#: 512 (four).
SLICED = [
    ((2, 13, 7, 8), 5), ((1, 37, 53, 16), 64), ((2, 9, 33, 24), 24),
    ((1, 21, 100, 32), 3), ((1, 5, 300, 32), 64), ((2, 19, 150, 40), 32),
    ((1, 23, 45, 96), 192), ((2, 11, 9, 100), 8), ((1, 12, 80, 32), 512),
    ((1, 3, 161, 160), 64), ((1, 17, 20, 200), 24),
    # C % 64 = 0 with O <= 64 (formerly the wide kernel's).
    ((2, 13, 7, 128), 5), ((1, 37, 53, 128), 64), ((1, 9, 33, 128), 16),
    ((2, 5, 80, 512), 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,o", SLICED)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_sliced_kernel_on_card(rng, cuda, dtype, shape, o, bias):
    x, w, b = _conv_on_card(rng, cuda, dtype, shape, o, bias)
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert after["sliced"] == before["sliced"] + 1
    assert got.dtype == dtype and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(32, 64), (100, 5), (200, 192), (128, 5),
                                 (512, 32)])
def test_conv3x3_sliced_nonfinite_inputs_on_card(rng, cuda, dtype, c, o):
    """The sliced kernel under inf and NaN inputs in the interior, on both
    sides of a tile's edge columns (15 | 16) and rows, at the image's edges
    and in the last channel (a slice's zero-filled tail follows it): the
    padded K columns must read true zeros on both sides."""
    x, w, b = _conv_on_card(rng, cuda, dtype, (2, 19, 70, c), o, True)
    x[0, 3, 5, 7] = float("inf")
    x[0, 10, 15, 1] = float("-inf")
    x[0, 10, 16, c - 1] = float("nan")
    x[1, 0, 69, 0] = float("nan")
    x[1, 18, 0, c - 1] = float("inf")
    x[1, 15, 33, 2] = float("inf")
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    want = conv3x3_implicit_gemm_plain(x, w, b)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b)


#: Shapes of the split-TF32 kernel (fp32, every C and O): C = 1, 3, 7 and 13
#: (a copy of x zero-padded to a multiple of 4), 8 (one 8-channel slice),
#: 32, 64, 100 and 128 (16-channel slices; 100 ends in a zero-filled tail);
#: ragged bands and strips, W narrower than a tile, B = 1; O = 3, 5 and 6
#: (scalar stores), 16, 64, 192 and 512 (three and eight 64-wide tiles).
TF32X3 = [
    ((1, 9, 11, 3), 64), ((2, 13, 45, 3), 5), ((1, 21, 100, 7), 3),
    ((2, 19, 21, 13), 6), ((1, 8, 20, 1), 3), ((1, 5, 300, 8), 16),
    ((3, 37, 53, 64), 64), ((1, 23, 45, 100), 192), ((1, 12, 80, 32), 512),
    ((2, 13, 7, 128), 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o", TF32X3)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_tf32x3_kernel_on_card(rng, cuda, shape, o, bias):
    """Three passes at every C and O: one launch of the design ``design``
    names (the split-TF32 kernel where O > 32, the rows kernel below),
    within the fp32 bar of the plain conv."""
    from rerevst_torch.kernels.conv3x3 import design

    x, w, b = _conv_on_card(rng, cuda, torch.float32, shape, o, bias)
    kind = design(shape[-1], torch.float32, o, 3)
    assert kind == ("tf32x3" if o > 32 else "tf32_rows")
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kind) for k in after}
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("name,c,o", [
    ("conv3x3_implicit_gemm", 64, 64), ("conv3x3_implicit_gemm", 13, 6),
    ("conv3x3_implicit_gemm", 3, 64), ("conv3x3_implicit_gemm", 200, 192),
    ("conv3x3_pairlane", 64, 64), ("conv3x3_pairlane", 64, 3)])
def test_conv3x3_tf32x3_nonfinite_inputs_on_card(rng, cuda, name, c, o,
                                                 splits):
    """The split-TF32 kernel through both entry points under inf, -inf,
    NaN and +-FLT_MAX inputs, in the interior, on both sides of a tile's
    edge columns (15 | 16), at the image's edges and in the last channel:
    NaN and inf outputs exactly the plain version's (inf stays inf, of the
    same sign; FLT_MAX's split does not overflow), finite ones as usual;
    at the plan's K split and at 4 splits a tile (one a slice at C = 64;
    C = 3 and 13 have one slice, so one split)."""
    kern = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    x, w, b = _conv_on_card(rng, cuda, torch.float32, (2, 19, 70, c), o, True)
    fmax = torch.finfo(torch.float32).max
    for idx, v in [((0, 3, 5, 2 % c), float("inf")),
                   ((0, 10, 15, 1 % c), float("-inf")),
                   ((0, 10, 16, c - 1), float("nan")),
                   ((1, 0, 69, 0), float("nan")),
                   ((1, 18, 0, c - 1), float("inf")),
                   ((0, 14, 40, c - 1), fmax), ((1, 6, 33, 0), -fmax)]:
        x[idx] = v
    with _splits(splits):
        got = kern(x, w, b)
    torch.cuda.synchronize()
    want = plain(x, w, b)
    fin = torch.isfinite(want)
    assert not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.sign(got[torch.isinf(want)]),
                       torch.sign(want[torch.isinf(want)]))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o", TF32X3)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_tf32x1_kernel_on_card(rng, cuda, shape, o, bias):
    """The one-pass conv (``passes=1``, the 'default' precision) at the
    three-pass shapes: one launch of the design ``design`` names (the
    one-pass design ``tf32x1`` where O > 32, the rows kernel ``tf32_rows``
    below), within the one-pass bar of the plain fp32 conv."""
    from rerevst_torch.kernels.conv3x3 import design

    x, w, b = _conv_on_card(rng, cuda, torch.float32, shape, o, bias)
    kind = design(shape[-1], torch.float32, o, 1)
    assert kind == ("tf32x1" if o > 32 else "tf32_rows")
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b, passes=1)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kind) for k in after}
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3] + (o,)
    want = conv3x3_implicit_gemm_plain(x, w, b)
    assert _conv_ok(got, want, x, w, b, passes=1)
    # One pass is not three: its error is TF32's, far above fp32's.
    assert not torch.equal(got, conv3x3_implicit_gemm(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("c,o", [(64, 64), (13, 6), (3, 64), (200, 192),
                                 (64, 32)])
def test_conv3x3_tf32x1_nonfinite_inputs_on_card(rng, cuda, c, o, splits):
    """One pass under inf, -inf, NaN and +-FLT_MAX inputs: NaN and inf
    outputs exactly the plain version's, of the same sign; at the plan's
    K split and at 4 splits a tile (both one-pass routes: O = 6 and 32 take
    the rows kernel)."""
    x, w, b = _conv_on_card(rng, cuda, torch.float32, (2, 19, 70, c), o, True)
    fmax = torch.finfo(torch.float32).max
    for idx, v in [((0, 3, 5, 2 % c), float("inf")),
                   ((0, 10, 15, 1 % c), float("-inf")),
                   ((0, 10, 16, c - 1), float("nan")),
                   ((1, 0, 69, 0), float("nan")),
                   ((1, 18, 0, c - 1), float("inf")),
                   ((0, 14, 40, c - 1), fmax), ((1, 6, 33, 0), -fmax)]:
        x[idx] = v
    with _splits(splits):
        got = conv3x3_implicit_gemm(x, w, b, passes=1)
    torch.cuda.synchronize()
    want = conv3x3_implicit_gemm_plain(x, w, b)
    fin = torch.isfinite(want)
    assert not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.sign(got[torch.isinf(want)]),
                       torch.sign(want[torch.isinf(want)]))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b, passes=1)


#: Shapes of the rows kernel (fp32, O <= 32, both pass counts): C = 1, 3
#: and 13 (a copy of x zero-padded to a multiple of 4, one 8- or 16-channel
#: slice), 8, 24 (a zero-filled slice tail), 64 and 512; every tile width
#: its plan picks, ragged tiles, W and H under a tile, B = 1 and 4; O = 1,
#: 3, 5 (scalar stores), 8, 9, 16, 17, 24 and 32 (N = 8, 16, 32); the
#: Pass-2 batch's `down` conv at a small batch and a train step's
#: [4,32,32,512] -> 32 and [4,256,256,64] -> 3 at their own shapes.
ROWS = [((1, 8, 20, 1), 3), ((2, 13, 45, 3), 5), ((2, 19, 21, 13), 6),
        ((1, 5, 300, 8), 16), ((2, 19, 70, 24), 17), ((3, 37, 53, 64), 32),
        ((1, 9, 11, 64), 1), ((2, 33, 130, 64), 8), ((1, 21, 100, 64), 9),
        ((2, 11, 9, 512), 24), ((2, 80, 80, 512), 32),
        ((4, 32, 32, 512), 32), ((4, 256, 256, 64), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("shape,o", ROWS)
def test_conv3x3_rows_kernel_on_card(rng, cuda, shape, o, passes):
    """The rows kernel at three and one pass: one launch of design
    ``tf32_rows`` at its plan, then with each tile's K split 2 and 4 ways
    and one way a slice (forced, where there are that many slices): within
    the pass count's bar of the plain fp32 conv, and two runs give the same
    bits (split partials are summed in split order)."""
    from rerevst_torch.kernels.conv3x3 import design, forced_splits, plan_for

    x, w, b = _conv_on_card(rng, cuda, torch.float32, shape, o, True)
    assert design(shape[-1], torch.float32, o, passes) == "tf32_rows"
    want = conv3x3_implicit_gemm_plain(x, w, b)
    before = dict(conv3x3_implicit_gemm.launches_by_design)
    got = conv3x3_implicit_gemm(x, w, b, passes=passes)
    torch.cuda.synchronize()
    after = conv3x3_implicit_gemm.launches_by_design
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "tf32_rows") for k in after}
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, want, x, w, b, passes=passes)
    assert torch.equal(got, conv3x3_implicit_gemm(x, w, b, passes=passes))
    slices = plan_for(x, o, passes).slices
    for splits in sorted({2, 4, slices} - {1}):
        if splits > slices:
            continue
        with forced_splits(splits):
            assert plan_for(x, o, passes).splits == splits
            got = conv3x3_implicit_gemm(x, w, b, passes=passes)
            again = conv3x3_implicit_gemm(x, w, b, passes=passes)
        torch.cuda.synchronize()
        assert _conv_ok(got, want, x, w, b, passes=passes), splits
        assert torch.equal(got, again), splits


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("c,o", [(13, 6), (64, 3), (64, 32), (512, 17)])
def test_conv3x3_rows_nonfinite_inputs_on_card(rng, cuda, c, o, splits,
                                               passes):
    """The rows kernel under inf, -inf, NaN and +-FLT_MAX inputs, inside,
    on both sides of a tile's and a warpgroup column's edges, at the
    image's edges and in the last channel: NaN and inf outputs exactly the
    plain version's, of the same sign, finite ones within the pass count's
    bar; at the plan's K split and at 2 (where C has two slices)."""
    x, w, b = _conv_on_card(rng, cuda, torch.float32, (2, 19, 70, c), o, True)
    fmax = torch.finfo(torch.float32).max
    for idx, v in [((0, 3, 5, 2 % c), float("inf")),
                   ((0, 10, 15, 1 % c), float("-inf")),
                   ((0, 10, 16, c - 1), float("nan")),
                   ((0, 15, 31, 3 % c), float("inf")),
                   ((0, 16, 32, 4 % c), float("-inf")),
                   ((1, 0, 69, 0), float("nan")),
                   ((1, 18, 0, c - 1), float("inf")),
                   ((0, 14, 40, c - 1), fmax), ((1, 6, 33, 0), -fmax)]:
        x[idx] = v
    with _splits(splits if splits is None or c > 16 else None):
        got = conv3x3_implicit_gemm(x, w, b, passes=passes)
    torch.cuda.synchronize()
    want = conv3x3_implicit_gemm_plain(x, w, b)
    fin = torch.isfinite(want)
    assert not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.sign(got[torch.isinf(want)]),
                       torch.sign(want[torch.isinf(want)]))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b, passes=passes)


def _splits(splits):
    """`splits` K splits a tile for the fp32 launches inside (None: each
    plan's own)."""
    import contextlib

    from rerevst_torch.kernels.conv3x3 import forced_splits

    return contextlib.nullcontext() if splits is None \
        else forced_splits(splits)


#: Shapes of the fp32 kernels' K split (x shape, O): one slice a split at
#: C = 64 (4 slices), ragged runs at C = 200 (13 slices of 16, the last
#: half zero-filled), a train step's [4,32,32,512] -> 32 (the plan's 8
#: splits) and -> 96 (the one-pass design at one pass), and a ragged band
#: and strip; O = 8, 32, 96 and 192 (three channel tiles of 64 at three
#: passes).
SPLIT_K = [((1, 8, 8, 64), 8), ((1, 8, 8, 64), 96), ((2, 19, 21, 200), 192),
           ((4, 32, 32, 512), 32), ((1, 32, 32, 512), 96),
           ((2, 19, 70, 64), 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape,o", SPLIT_K)
def test_conv3x3_split_k_on_card(rng, cuda, shape, o, bias, passes):
    """Both fp32 kernels with each tile's K split 2, 3 and 4 ways and one
    way a slice (forced), at three and one pass: within the pass count's
    bar of the plain fp32 conv, and two runs give the same bits (the
    partials are summed in split order, whichever unit finishes last)."""
    from rerevst_torch.kernels.conv3x3 import forced_splits, plan_for

    x, w, b = _conv_on_card(rng, cuda, torch.float32, shape, o, bias)
    want = conv3x3_implicit_gemm_plain(x, w, b)
    slices = plan_for(x, o, passes).slices
    for splits in sorted({2, 3, 4, slices}):
        with forced_splits(splits):
            plan = plan_for(x, o, passes)
            assert plan.splits == min(splits, slices)
            got = conv3x3_implicit_gemm(x, w, b, passes=passes)
            again = conv3x3_implicit_gemm(x, w, b, passes=passes)
        torch.cuda.synchronize()
        assert _conv_ok(got, want, x, w, b, passes=passes), splits
        assert torch.equal(got, again), splits


#: Shapes that stress the streamed C = 64 kernel's work split (its plan on
#: an H100's 132 SMs): a last band shorter than the others (H % R != 0), a
#: last strip narrower than 128 columns, W < 128, B = 1.
STREAMED = [
    ((1, 131, 200, 64), 64),   # R = 2: a 1-row last band; strips 128 + 72
    ((1, 130, 257, 64), 5),    # R = 3: a 1-row last band; a 1-column strip
    ((2, 97, 129, 64), 32),    # R = 2; a 1-column strip
    ((1, 37, 100, 64), 8),     # W < 128
    ((3, 5, 7, 64), 3),        # W < 128, H < 8
    ((1, 200, 64, 64), 3),     # W = 64: warpgroup 1 has no pixel
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,bias", [
    # W = 150: two column strips, the second ragged.
    *(((2, 19, 150, 64), o, True) for o in (64, 32, 3, 8)),
    *((s, o, bias) for s, o in STREAMED for bias in (True, False)),
])
def test_conv3x3_pairlane_kernel_on_card(rng, cuda, dtype, shape, o, bias):
    x, w, b = _conv_on_card(rng, cuda, dtype, shape, o, bias)
    before = conv3x3_pairlane.launches
    got = conv3x3_pairlane(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_pairlane.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == shape[:3] + (o,)
    assert _conv_ok(got, conv3x3_pairlane_plain(x, w, b), x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("o", [64, 3])
def test_conv3x3_nonfinite_inputs_on_card(rng, cuda, dtype, o):
    """inf and NaN inputs, in the interior, on a strip's halo and at the
    image's edges: the kernel's non-finite outputs are the plain version's,
    and the finite ones agree as usual."""
    x, w, b = _conv_on_card(rng, cuda, dtype, (2, 19, 150, 64), o, True)
    x[0, 3, 5, 7] = float("inf")
    x[0, 10, 127, 1] = float("-inf")
    x[0, 10, 128, 2] = float("nan")
    x[1, 0, 149, 0] = float("nan")
    x[1, 18, 0, 63] = float("inf")
    got = conv3x3_pairlane(x, w, b)
    torch.cuda.synchronize()
    want = conv3x3_pairlane_plain(x, w, b)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    # A finite output saw no non-finite input: bound it with those zeroed.
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert _conv_ok(torch.where(fin, got, 0), torch.where(fin, want, 0),
                    xz, w, b)


@pytest.mark.cuda
def test_conv_wrappers_refuse_on_card(rng, cuda):
    x, w, b = _conv_on_card(rng, cuda, torch.float16, (1, 4, 6, 64), 64, True)
    before = kernels.launch_counts()
    flat = torch.zeros(x.numel() + 1, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3_pairlane(flat[1:].view(x.shape), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_implicit_gemm(x, w.cpu(), b)
    with pytest.raises(ValueError, match="C=64"):
        conv3x3_pairlane(x[..., :32].contiguous(), w[:, :, :32].contiguous())
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
                                               "dynamic_filter_pair": 9,
                                               "conv3x3_implicit_gemm": 0,
                                               "conv3x3_pairlane": 0,

                                               "conv3x3_wgrad": 0}
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == (64, 112, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.cuda
def test_stylize_video_pairlane_on_card(cuda):
    """The pair-lane path on the card: conv1_2 once in Pass 1 and conv1_2,
    res2.conv2 and the out conv in each of the 3 Pass-2 batches go through
    the kernel (10 launches); the f16 frames stay within the repository's
    1e-3 mean |delta| of the fp32 default path."""
    rng = np.random.default_rng(1)
    style = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    clip = _clip()
    outs = {}
    for dtype, pairlane in ((torch.float32, False), (torch.float16, True)):
        s = Stylization(str(CKPT), cfg=ModelConfig(dtype=dtype,
                                                   pairlane=pairlane))
        s.prepare_style(style)
        kernels.reset_launches()
        outs[dtype] = list(s.stylize_video(clip, batch_size=4))
        if pairlane:
            assert kernels.launch_counts() == {"norm_affine_clamp": 33,
                                               "dynamic_filter_pair": 9,
                                               "conv3x3_implicit_gemm": 0,
                                               "conv3x3_pairlane": 10,

                                               "conv3x3_wgrad": 0}
    d = np.mean([np.abs(a.astype(np.int16) - b.astype(np.int16)).mean()
                 for a, b in zip(outs[torch.float16], outs[torch.float32])])
    assert d / 255.0 <= 1e-3


# ---------------------------------------------------------------------------
# Per-frame graph and evaluation on the card
# ---------------------------------------------------------------------------

def _decode_inputs():
    """Content features [2,8,14,512] and style features from the trained
    encoders, on the CPU in fp32."""
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.io.checkpoint import load_params
    from rerevst_torch.models import transformer as T

    params = load_params(str(CKPT), dtype=torch.float32, device="cpu")
    cfg = ModelConfig()
    clip = _clip(n=2)
    x = torch.from_numpy(np.concatenate([bgr_to_model(f) for f in clip]))
    style = T.encode_style(params, torch.from_numpy(bgr_to_model(clip[0][:, :64])),
                           cfg)
    return params, T.encode_content(params, x, cfg), style


def _to(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev, dtype) for v in tree)
    return tree.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_on_card_matches_cpu(cuda, dtype):
    """Per-frame decode on the card in each storage dtype against the CPU's
    fp32 decode: 1e-4 of the output's scale in fp32 (other summation
    orders), and the 16-bit dtypes within the storage error the global
    graph's f16 test allows (mean |delta| below 2% of mean |out|)."""
    from rerevst_torch.models import transformer as T

    params, x, style = _decode_inputs()
    want = T.decode(params["decoder"], x, style, ModelConfig())
    kernels.reset_launches()
    got = T.decode(_to(params["decoder"], cuda, dtype), x.to(cuda, dtype),
                   T.StyleFeatures(*_to(tuple(style), cuda, dtype)),
                   ModelConfig(dtype=dtype)).cpu()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert set(kernels.launch_counts().values()) == {0}
    scale = want.abs().max()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-4 * scale
    else:
        assert (got.float() - want).abs().mean() < 2e-2 * want.abs().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fbatch,xbatch", [(1, 1), (1, 3), (3, 3)])
def test_per_sample_filters_on_card(rng, cuda, dtype, fbatch, xbatch):
    """apply_dynamic_filter_3x3 and per-sample apply_dynamic_filter on the
    card against the CPU's fp32 version of the same (rounded) inputs: fp32
    products on both sides in fp32 and f16 (1e-5 of the scale, plus one f16
    ulp), 16-bit products in bf16 (2e-2 of the scale)."""
    from rerevst_torch.models.layers import (
        apply_dynamic_filter,
        apply_dynamic_filter_3x3,
    )

    x = torch.from_numpy(rng.standard_normal((xbatch, 9, 11, 32))
                         .astype(np.float32)).to(dtype)
    f3 = torch.from_numpy(rng.standard_normal((fbatch, 32, 32, 3, 3))
                          .astype(np.float32) * 0.1).to(dtype)
    f1 = torch.from_numpy(rng.standard_normal((xbatch, 32, 32))
                          .astype(np.float32) * 0.1).to(dtype)
    for fn, f in ((apply_dynamic_filter_3x3, f3), (apply_dynamic_filter, f1)):
        want = fn(x.float(), f.float())
        got = fn(x.to(cuda), f.to(cuda)).cpu()
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()
        else:
            assert _ulp_ok(got, want.to(dtype))


@pytest.mark.cuda
def test_eval_on_card_matches_cpu(rng, cuda):
    """Warps, masks, E_warp and SSIM on the card against the CPU path:
    warps equal at an integer flow and within 1e-4 of a pixel at sub-pixel
    ones, the metrics within 1e-5 relative (fp64 sums on both sides)."""
    from rerevst_torch.eval import ewarp as E
    from rerevst_torch.eval import ssim as S

    frames = _clip(n=4)
    styled = [np.ascontiguousarray(f[:, ::-1]) for f in frames]
    h, w = frames[0].shape[:2]
    integer = np.zeros((h, w, 2), np.float32)
    integer[..., 0], integer[..., 1] = 3, -2
    sub = rng.uniform(-3, 3, (h, w, 2)).astype(np.float32)
    for flow, atol in ((integer, 0.0), (sub, 1e-4)):
        a = E.backward_warp(frames[0], flow, cuda).cpu()
        b = E.backward_warp(frames[0], flow, "cpu")
        assert (a - b).abs().max() <= atol
        assert torch.equal(E.occlusion_mask(frames[0], frames[1], flow,
                                            device=cuda).cpu(),
                           E.occlusion_mask(frames[0], frames[1], flow,
                                            device="cpu"))
    flows = [integer, sub, integer]
    for fn in (E.ewarp, S.temporal_ssim):
        got = fn(styled, frames, flows=flows, device=cuda)
        want = fn(styled, frames, flows=flows, device="cpu")
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    assert S.ssim(frames[0], styled[1], device=cuda) == pytest.approx(
        S.ssim(frames[0], styled[1], device="cpu"), rel=1e-5)


@pytest.mark.cuda
def test_stylize_video_per_frame_on_card(cuda):
    """Per-frame mode on the card: fp32 frames within 1 count of the CPU
    path's and no kernel launched; on the pair-lane route (f16) conv1_2 goes
    through conv3x3_pairlane once per Pass-2 batch (3 on 9 frames at batch
    4) and nothing else does."""
    rng = np.random.default_rng(1)
    style = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    clip = _clip()
    outs = {}
    for dev in ("cuda", "cpu"):
        s = Stylization(str(CKPT), use_global=False, device=dev)
        s.prepare_style(style)
        kernels.reset_launches()
        outs[dev] = list(s.stylize_video(clip, batch_size=4))
        assert set(kernels.launch_counts().values()) == {0}
        assert s.pass2_mode == "per-frame"
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
    s = Stylization(str(CKPT), use_global=False,
                    cfg=ModelConfig(dtype=torch.float16, pairlane=True))
    s.prepare_style(style)
    kernels.reset_launches()
    out = list(s.stylize_video(clip, batch_size=4))
    assert kernels.launch_counts() == {"norm_affine_clamp": 0,
                                       "dynamic_filter_pair": 0,
                                       "conv3x3_implicit_gemm": 0,
                                       "conv3x3_pairlane": 3,

                                       "conv3x3_wgrad": 0}
    d = np.mean([np.abs(a.astype(np.int16) - b.astype(np.int16)).mean()
                 for a, b in zip(out, outs["cpu"])])
    assert d / 255.0 <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_norm_affine_per_sample_on_card(rng, cuda, dtype, variant):
    """Per-sample [B,1,1,C] statistics and style affine: one launch per
    sample, each against the plain version's broadcast."""
    x, st, s, m = _norm_inputs(rng, (3, 17, 19, 128), variant, cuda, dtype)
    st = NormStats(*(v * torch.from_numpy(1 + 0.1 * rng.random(
        (3, 1, 1, 128))).float().to(cuda) for v in st))
    if s is not None:
        s = torch.from_numpy(1 + rng.random((3, 1, 1, 128))).float().to(cuda)
        m = torch.from_numpy(rng.standard_normal((3, 1, 1, 128))).float() \
            .to(cuda)
    leaky = variant == "leaky"
    before = norm_affine_clamp.launches
    got = norm_affine_clamp(x, st, s, m, leaky=leaky)
    torch.cuda.synchronize()
    assert norm_affine_clamp.launches == before + 3
    assert _ulp_ok(got, norm_affine_clamp_plain(x, st, s, m, leaky=leaky))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_pair_per_sample_on_card(rng, cuda, dtype):
    x = torch.from_numpy(rng.standard_normal((3, 13, 11, 32))).to(cuda, dtype)
    f1 = torch.from_numpy(rng.standard_normal((3, 32, 32)) * 1e3).float() \
        .to(cuda)
    f2 = torch.from_numpy(rng.standard_normal((3, 32, 32)) * 1e-3).float() \
        .to(cuda)
    before = dynamic_filter_pair.launches
    got = dynamic_filter_pair(x, f1, f2)
    torch.cuda.synchronize()
    assert dynamic_filter_pair.launches == before + 3
    assert _ulp_ok(got, dynamic_filter_pair_plain(x, f1, f2))


@pytest.mark.cuda
def test_long_clip_and_multistyle_on_card(cuda):
    """A spilled Pass 1 (threshold lowered to 1, below the clip's 2
    samples) and a two-style interpolation on the card, each within 1 count
    of the CPU path."""
    from rerevst_torch.multistyle import MultiStylization

    rng = np.random.default_rng(1)
    style = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    clip = _clip()
    outs = {}
    for dev in ("cuda", "cpu"):
        s = Stylization(str(CKPT), device=dev)
        s.STREAMING_THRESHOLD = 1
        s.prepare_style(style)
        outs[dev] = list(s.stylize_video(clip, batch_size=4))
        assert s.pass1_mode == "streaming-spill"
        ms = MultiStylization(str(CKPT), device=dev)
        ms.prepare_styles([style, style[::-1].copy()])
        outs[dev + "_ms"] = list(ms.interpolate_video(clip, batch_size=4))
    for key in ("", "_ms"):
        for a, b in zip(outs["cuda" + key], outs["cpu" + key]):
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.cuda
def test_microbatched_service_on_card_matches_transfer_batch(cuda):
    """Eight concurrent /stylize calls through the micro-batcher on the
    card coalesce (some call runs more than one frame) and give the
    session's transfer_batch frames within 1 count (cuDNN may choose
    another algorithm for another batch size)."""
    import threading

    from rerevst_torch.serve import StylizeService

    rng = np.random.default_rng(1)
    style = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    clip = _clip()[:8]
    svc = StylizeService(str(CKPT), dtype="f16", batch_window_ms=50.0,
                         batch_max=8)
    svc.set_style(style)
    for i, f in enumerate(clip):
        svc.pass1(f, last=i == len(clip) - 1)
    outs = [None] * len(clip)
    barrier = threading.Barrier(len(clip), timeout=60)

    def call(i):
        barrier.wait()
        outs[i] = svc.stylize(clip[i])

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(clip))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
        assert not t.is_alive()
    assert max(svc.batcher.calls) > 1, svc.batcher.calls
    want = svc.session.transfer_batch(clip)
    for a, b in zip(outs, want):
        assert a.shape == (64, 112, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.cuda
def test_warmup_on_card_leaves_healthz_clean(cuda):
    """warmup on the card (each batch bucket with micro-batching on) leaves
    no style and no statistics, and healthz names the card."""
    from rerevst_torch.serve import StylizeService

    svc = StylizeService(str(CKPT), dtype="f16", batch_window_ms=5.0,
                         batch_max=4)
    assert svc.warmup((64, 112)) > 0
    hz = svc.healthz()
    assert hz["ok"] and not hz["has_style"] and not hz["has_stats"]
    assert hz["device"] == f"cuda:0 ({torch.cuda.get_device_name(0)})"


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One train step (64x64, flow_iter 2, an injected fake pair) on the card
    against the CPU from the same state: losses to 1e-4 relative, the
    selected gradients to 1e-3 of their max-abs, no hand-written kernel
    launched, the loss network untouched."""
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.io.torch_compat import load_pretrained
    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_torch.ops.warp import flow_warp

    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False))
    host, _ = load_pretrained(str(CKPT), init_transformer_params(
        torch.Generator().manual_seed(0), cfg.model, vgg_scheme="he_relu"))
    # Smooth synthetic images, as chip_smoke.py's phase train uses: on
    # white noise the relaxed loop's two chained flow steps (lr 16) carry
    # the two devices' rounding to 1.5e-4 in the relaxed loss.
    content, style = (torch.from_numpy(np.concatenate(
        [bgr_to_model(f) for f in _clip(2, 64, 64, seed)])) for seed in (3, 4))
    gen = torch.Generator().manual_seed(1)
    # Whole-pixel flows: no nearest-warp coordinate sits at a .5 tie, where
    # the card's and the CPU's last bits could pick other neighbours.
    flow = torch.randint(-3, 4, (2, 64, 64, 2), generator=gen).float()
    extra = {"Second": flow_warp(content, flow, "nearest"), "FakeFlow": flow}
    sites = [("decoder", "out", "w"), ("decoder", "filter1", "p1", "fc", "w"),
             ("encoder", "conv4_1", "w"), ("encoder_style", "conv1_1", "w")]
    # Deterministic algorithms: cuDNN may otherwise pick ones that sum a
    # gradient in another order on each run (chip_smoke.py phase train
    # reports that spread beside the same comparison).
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {dev.type: _train_step_on(cfg, host, content, style, extra,
                                        sites, dev)
               for dev in (cuda, torch.device("cpu"))}
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)
    (mc, gc), (mh, gh) = out["cuda"], out["cpu"]
    for k in mh:
        assert abs(mc[k] - mh[k]) <= 1e-4 * max(abs(mh[k]), 1e-12), \
            (k, mc[k], mh[k])
    for site in sites:
        err = (gc[site] - gh[site]).abs().max() / gh[site].abs().max()
        assert err <= 1e-3, (site, float(err))


def _train_step_on(cfg, host, content, style, extra, sites, dev):
    """One train step on `dev` from `host`: (metrics, the sites' grads);
    no hand-written kernel launched, the loss network untouched."""
    from rerevst_torch.train.state import init_train_state, tree_leaves
    from rerevst_torch.train.step import make_train_step

    state = init_train_state(_copy_to(host, dev), cfg)
    vgg = [t.clone() for _, t in tree_leaves(state.params["vgg_loss"])]
    kernels.reset_launches()
    state, m = make_train_step(cfg)(
        state, content.to(dev), style.to(dev), None,
        {k: v.to(dev) for k, v in extra.items()})
    assert not any(kernels.launch_counts().values())
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(vgg, tree_leaves(state.params["vgg_loss"])))
    grads = {}
    for site in sites:
        t = state.params
        for k in site:
            t = t[k]
        grads[site] = t.grad.cpu()
    return {k: float(v) for k, v in m.items()}, grads


def _copy_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def _deterministic_on(fn):
    """fn() under cuDNN's and PyTorch's deterministic algorithms."""
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)


def _host_generator(cfg):
    from rerevst_torch.io.torch_compat import load_pretrained
    from rerevst_torch.models.transformer import init_transformer_params

    host, _ = load_pretrained(str(CKPT), init_transformer_params(
        torch.Generator().manual_seed(0), cfg.model, vgg_scheme="he_relu"))
    return host


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_adversarial_step_on_card_matches_cpu(cuda, mode):
    """The adversarial step's parts (64x64, flow_iter 2, an injected
    whole-pixel fake pair, a seeded ndf-64 discriminator) on the card
    against the CPU, each part fed the CPU's inputs
    (``chip_smoke.adversarial_parts_card_vs_cpu``): losses to 1e-4
    relative; D's gradients, G's GAN cotangent and the selected G
    gradients to 1e-3 of their max-abs, or to twice the largest change of
    the CPU's own result over draws of ``chip_smoke.conv_noise`` where the
    step's conditioning makes that larger (D's batch norms over 2 x 16 x
    16 values behind leaky ReLUs; ReLU kinks ahead of the filter
    predictor)."""
    import chip_smoke
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.models.discriminator import init_discriminator_params
    from rerevst_torch.ops.warp import flow_warp

    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False,
                                      adversarial_loss=True, gan_mode=mode))
    host = _host_generator(cfg)
    d_host = init_discriminator_params(torch.Generator().manual_seed(99))
    batch = {k: np.concatenate([bgr_to_model(f)
                                for f in _clip(2, 64, 64, seed)])
             for k, seed in (("Content", 3), ("Style", 4))}
    content = torch.from_numpy(batch["Content"])
    flow = torch.randint(-3, 4, (2, 64, 64, 2),
                         generator=torch.Generator().manual_seed(1)).float()
    extra = {"Second": flow_warp(content, flow, "nearest"), "FakeFlow": flow}
    kernels.reset_launches()
    res = chip_smoke.adversarial_parts_card_vs_cpu(torch, cfg, host, d_host,
                                                   batch, extra)
    assert not any(kernels.launch_counts().values())
    assert not res["over_bar"], res


@pytest.mark.cuda
@pytest.mark.parametrize("flow_key,mask_key", [
    ("BackwardFlow", "BackwardMask"), ("ForwardFlow", "ForwardMask")],
    ids=["mpi", "video"])
def test_ablation_step_on_card_matches_cpu(cuda, flow_key, mask_key):
    """One train step on an ablation pair (64x64, a whole-pixel flow, a
    3-D mask) on the card against the CPU: losses to 1e-4 relative, the
    selected gradients to 1e-3 of their max-abs."""
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.ops.warp import flow_warp

    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False))
    host = _host_generator(cfg)
    content, style = (torch.from_numpy(np.concatenate(
        [bgr_to_model(f) for f in _clip(2, 64, 64, seed)])) for seed in (5, 6))
    gen = torch.Generator().manual_seed(2)
    flow = torch.randint(-3, 4, (2, 64, 64, 2), generator=gen).float()
    extra = {"NextContent": flow_warp(content, flow, "nearest")
             + 0.05 * torch.randn(content.shape, generator=gen),
             flow_key: flow,
             mask_key: (torch.rand((2, 64, 64), generator=gen) > 0.2).float()}
    sites = [("decoder", "out", "w"), ("decoder", "filter1", "p1", "fc", "w"),
             ("encoder", "conv4_1", "w")]
    out = _deterministic_on(lambda: {
        dev.type: _train_step_on(cfg, host, content, style, extra, sites,
                                 dev)
        for dev in (cuda, torch.device("cpu"))})
    (mc, gc), (mh, gh) = out["cuda"], out["cpu"]
    assert mh["temporal_gt"] > 0
    for k in mh:
        assert abs(mc[k] - mh[k]) <= 1e-4 * max(abs(mh[k]), 1e-12), \
            (k, mc[k], mh[k])
    for site in sites:
        err = (gc[site] - gh[site]).abs().max() / gh[site].abs().max()
        assert err <= 1e-3, (site, float(err))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# The fp32 conv's backward: the weight-gradient kernel and Conv3x3Fn
# ---------------------------------------------------------------------------

#: ([B, H, W, C], O): both routes (wgmma: C, O >= 8 and multiples of 4;
#: mma.sync: the rest) and the mma.sync route's two block tiles (O <= 8,
#: the rest), C and O off every multiple, W off the 32-pixel K tile, one
#: split and many.
WGRAD = [((1, 9, 11, 3), 64), ((2, 13, 45, 64), 3), ((2, 19, 70, 13), 6),
         ((3, 37, 53, 64), 64), ((1, 12, 80, 32), 512),
         ((2, 5, 300, 200), 192), ((1, 1, 1, 1), 1), ((4, 64, 64, 64), 64),
         ((2, 7, 33, 8), 8), ((1, 3, 5, 36), 12)]


def _wgrad_f64(x, g):
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1))
    _, h, w, c = x.shape
    gm = g.double().reshape(-1, g.shape[-1])
    return torch.stack([torch.stack([
        xp[:, ky:ky + h, kx:kx + w].reshape(-1, c).T @ gm for kx in range(3)])
        for ky in range(3)])


def _wgrad_bar(x, g, passes):
    """(2^-19 at three passes, 2^-10 + 2^-22 at one, + (K_split + splits)
    2^-22) sum |x||g|: the split's loss a product, then the fp32 sums of a
    block's pixels and of the partials (``chip_smoke.check_wgrad``)."""
    from rerevst_torch.kernels.conv3x3 import wgrad_plan_for

    plan = wgrad_plan_for(x, g)
    per = 2.0 ** -19 if passes == 3 else 2.0 ** -10 + 2.0 ** -22
    return (per + (plan.k_split + plan.splits) * 2.0 ** -22) \
        * _wgrad_f64(x.abs(), g.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("shape,o", WGRAD)
def test_conv3x3_wgrad_kernel_on_card(rng, cuda, shape, o, passes):
    """One launch; within its bar of the float64 weight gradient; bit-equal
    on a second run (no atomics)."""
    x = torch.from_numpy(rng.standard_normal(shape)).to(cuda, torch.float32)
    g = torch.from_numpy(rng.standard_normal(shape[:3] + (o,))).to(
        cuda, torch.float32)
    before = conv3x3_wgrad.launches
    got = conv3x3_wgrad(x, g, passes)
    again = conv3x3_wgrad(x, g, passes)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (
        3, 3, shape[-1], o)
    assert torch.equal(got, again)
    err = (got.double() - _wgrad_f64(x, g)).abs()
    assert (err <= _wgrad_bar(x, g, passes)).all()
    plain = conv3x3_wgrad_plain(x, g)
    assert plain.dtype == torch.float32 and plain.shape == got.shape


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("c,o", [(13, 6), (12, 8)], ids=["mma", "wgmma"])
def test_conv3x3_wgrad_nonfinite_inputs_on_card(rng, cuda, passes, c, o):
    """inf, -inf and NaN in x, in the interior, in the last column of a
    ragged K tile (W = 70) and in the first column, on both routes: NaN and
    inf outputs exactly the plain version's, of the same sign; the finite
    ones within the bar."""
    x = torch.from_numpy(rng.standard_normal((2, 19, 70, c))).to(
        cuda, torch.float32)
    g = torch.from_numpy(rng.standard_normal((2, 19, 70, o))).to(
        cuda, torch.float32)
    for idx, v in [((0, 3, 5, 2), float("inf")),
                   ((1, 10, 69, c - 1), float("-inf")),
                   ((0, 7, 33, 0), float("nan")),
                   ((1, 15, 0, 4), float("inf"))]:
        x[idx] = v
    got = conv3x3_wgrad(x, g, passes)
    torch.cuda.synchronize()
    want = conv3x3_wgrad_plain(x, g)
    fin = torch.isfinite(want)
    assert not fin.all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.sign(got[torch.isinf(want)]),
                       torch.sign(want[torch.isinf(want)]))
    xz = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    err = (got.double() - _wgrad_f64(xz, g)).abs()
    assert (err[fin] <= _wgrad_bar(xz, g, passes)[fin]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("width", [70, 64])
@pytest.mark.parametrize("c,o", [(13, 6), (12, 8)], ids=["mma", "wgmma"])
def test_conv3x3_wgrad_nonfinite_g_on_card(rng, cuda, passes, width, c, o):
    """inf, -inf and NaN in g, in the interior and at the image's first and
    last columns (which meet the padding column of x: 0 inf = NaN in taps
    kx = 0 and 2), W ragged and a multiple of 32, on both routes: NaN and
    inf outputs exactly float64's of the zero-padded definition, of its
    sign; the finite ones within the bar.  (cuDNN's weight gradient is no
    oracle here: an algorithm may form no products with the padding.)"""
    x = torch.from_numpy(rng.standard_normal((2, 19, width, c))).to(
        cuda, torch.float32)
    g = torch.from_numpy(rng.standard_normal((2, 19, width, o))).to(
        cuda, torch.float32)
    for idx, v in [((0, 3, 0, 2), float("inf")),
                   ((1, 10, width - 1, o - 1), float("-inf")),
                   ((0, 7, 33, 0), float("nan")),
                   ((1, 18, width - 1, 4), float("nan"))]:
        g[idx] = v
    got = conv3x3_wgrad(x, g, passes)
    torch.cuda.synchronize()
    want = _wgrad_f64(x, g)
    fin = torch.isfinite(want)
    assert torch.isnan(want[:, 0, :, 2]).all()
    assert torch.isnan(want[:, 2, :, o - 1]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.sign(got[torch.isinf(want)]),
                       torch.sign(want[torch.isinf(want)]).float())
    gz = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    err = (got.double() - _wgrad_f64(x, gz)).abs()
    assert (err[fin] <= _wgrad_bar(x, gz, passes)[fin]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision,passes", [("high", 3), ("default", 1)])
@pytest.mark.parametrize("shape,o", [((2, 13, 45, 3), 64),
                                     ((1, 19, 70, 64), 3),
                                     ((2, 16, 32, 64), 64)])
def test_conv3x3_fn_on_card(rng, cuda, shape, o, precision, passes):
    """``layers.conv2d`` at 'high' / 'default' under autograd on the card:
    the conv kernel twice (forward, input gradient) and the wgrad kernel
    once at `passes`; dx within the forward's bar of
    ``torch.nn.grad.conv2d_input``, dw within the wgrad bar of float64, db
    the pixel sum."""
    from rerevst_torch.models.layers import conv2d
    from rerevst_torch.ops.precision import exact_products

    x, w, b = _conv_on_card(rng, cuda, torch.float32, shape, o, True)
    g = torch.from_numpy(rng.standard_normal(shape[:3] + (o,))).to(
        cuda, torch.float32)
    for t in (x, w, b):
        t.requires_grad_(True)
    kernels.reset_launches()
    y = conv2d({"w": w, "b": b}, x, padding=1, precision=precision)
    dx, dw, db = torch.autograd.grad(y, (x, w, b), g)
    torch.cuda.synchronize()
    by_design = conv3x3_implicit_gemm.launches_by_design
    assert sum(v for k, v in by_design.items()
               if k in (f"tf32x{passes}", "tf32_rows")) == 2 == sum(
                   by_design.values())
    assert {key[-1] for key in conv3x3_implicit_gemm.launches_by_shape} \
        == {passes}
    assert conv3x3_wgrad.launches == 1
    x, w = x.detach(), w.detach()
    with torch.no_grad(), exact_products():
        want_dx = torch.nn.grad.conv2d_input(
            x.permute(0, 3, 1, 2).shape, w.permute(3, 2, 0, 1).contiguous(),
            g.permute(0, 3, 1, 2), padding=1).permute(0, 2, 3, 1)
    assert _conv_ok(dx, want_dx, g, w.flip(0, 1).transpose(2, 3).contiguous(),
                    None, passes)
    assert ((dw.double() - _wgrad_f64(x, g)).abs()
            <= _wgrad_bar(x, g, passes)).all()
    torch.testing.assert_close(db, g.sum((0, 1, 2)))

