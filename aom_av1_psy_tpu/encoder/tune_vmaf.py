"""VMAF-style perceptual tuning — the JAX analogue of
``av1/encoder/tune_vmaf.c``.

The reference's tune=vmaf pipeline is (a) unsharp-mask the SOURCE frame
with an amount that maximizes a libvmaf score of (source, sharpened)
(av1_vmaf_frame_preprocessing, tune_vmaf.c:356), (b) adjust frame q from
a motion score (av1_get_vmaf_base_qindex, :896). This module reproduces
(a) with the reference's exact Gaussian kernel and unsharp arithmetic.

The amount selection differs deliberately: scoring sharpened-vs-its-own
-source through an information-fidelity metric is near-degenerate (the
unsharp map is locally linear in the source, so any regression-based
VIF sits at ~1.0 regardless of amount — the libvmaf search only works
because of that model's specific trained enhancement response). Instead
the amount is a high-frequency-energy servo: content whose
Gaussian-residual energy ratio is below a target gets proportionally
more sharpening, which reproduces the reference's observable behavior
(blurry/smooth sources sharpened, textured sources left alone) without
pretending to evaluate VMAF.

``vif_lite`` (multi-scale VIF, the dominant VMAF elementary metric) is
exposed for fidelity REPORTING — identity scores 1.0, blur degrades
toward 0 — and the motion-score q model (b) exposes the reference's
fitted dvmaf = 26.11*(1-exp(-0.06*motion)) on a blurred-frame-diff
motion proxy.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

# tune_vmaf.c:248 — the frame preprocessing blur (sum 128, applied with
# the standard convolve rounding)
GAUSS_KERNEL = (0, 8, 30, 52, 30, 8, 0, 0)


def _pad_for_conv(y):
    """Edge-pad so the 8-tap kernel (phase center at tap 3) sees
    replicated borders, matching av1_convolve_2d_sr's edge use inside
    gaussian_blur (the reference blurs 128x128 tiles of a buffer with
    real border pixels; frame edges replicate)."""
    return jnp.pad(y, ((3, 4), (3, 4)), mode="edge")


@jax.jit
def gaussian_blur(y):
    """(H, W) uint8/int32 -> blurred int32, av1 convolve rounding
    (FILTER_BITS=7, round0=3, round1=11 as in convolve_2d_sr at bd=8)."""
    from ..ops import convolve as CONV
    x = _pad_for_conv(jnp.asarray(y, jnp.int32))
    k = jnp.asarray(GAUSS_KERNEL, jnp.int32)
    round0 = CONV.ROUND0_BITS
    round1 = 2 * CONV.FILTER_BITS - round0
    off = 1 << (8 + CONV.FILTER_BITS - 1)
    H, W = y.shape
    im = jnp.zeros((H + 7, W), jnp.int32)
    for t in range(8):
        im = im + k[t] * x[:, t : t + W]
    im = (im + off + (1 << (round0 - 1))) >> round0
    offset_bits = 8 + 2 * CONV.FILTER_BITS - round0
    out = jnp.zeros((H, W), jnp.int32)
    for t in range(8):
        out = out + k[t] * im[t : t + H, :]
    out = (out + (1 << offset_bits) + (1 << (round1 - 1))) >> round1
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return jnp.clip(out, 0, 255)


def _unsharp(src, blurred, amount):
    """unsharp_rect (tune_vmaf.c:209): clamp(round(src + a*(src-blur)))."""
    val = src.astype(jnp.float64) + amount * (src - blurred) \
        .astype(jnp.float64)
    return jnp.clip(jnp.floor(val + 0.5), 0, 255).astype(jnp.int32)


def _moments(x, win: int = 9):
    """Box-window mean/variance maps (VIF uses Gaussian windows; a box
    window keeps the metric monotone in the same distortions and stays a
    single reduce_window-style conv)."""
    k = jnp.ones((win, win), jnp.float32) / (win * win)
    mu = _box_conv(x, k)
    musq = _box_conv(x * x, k)
    return mu, jnp.maximum(musq - mu * mu, 0.0)


def _box_conv(a, k, padding="VALID"):
    """2-D f32 conv at full f32 precision: the operands are squares and
    products of pixels (16 significant bits), which a reduced-precision
    tensor-core pass would round."""
    return jax.lax.conv_general_dilated(
        a[None, None], k[None, None], (1, 1), padding,
        precision=jax.lax.Precision.HIGHEST)[0, 0]


def _vif_scale(ref, dist):
    """One VIF scale: sum log(1 + g^2 s_x / (sv + s_n)) /
    sum log(1 + s_x / s_n), sigma_n^2 = 2 (libvmaf convention)."""
    sigma_n = 2.0
    mu_r, var_r = _moments(ref)
    mu_d, var_d = _moments(dist)
    k = jnp.ones((9, 9), jnp.float32) / 81.0
    rd = _box_conv(ref * dist, k)
    cov = rd - mu_r * mu_d
    g = cov / (var_r + 1e-10)
    sv = jnp.maximum(var_d - g * cov, 0.0)
    num = jnp.log2(1.0 + g * g * var_r / (sv + sigma_n)).sum()
    den = jnp.log2(1.0 + var_r / sigma_n).sum()
    return num / jnp.maximum(den, 1e-10)


def _down2(x):
    """Blur-and-decimate for the next VIF scale."""
    k = jnp.asarray([[1, 2, 1], [2, 4, 2], [1, 2, 1]], jnp.float32) / 16.0
    b = _box_conv(x, k, "SAME")
    return b[::2, ::2]


def vif_lite(ref, dist, scales: int = 4):
    """Multi-scale VIF: 1.0 at identity, decreasing toward 0 with
    information loss (blur, quantization). A fidelity REPORTING metric —
    see the module docstring for why it cannot drive the unsharp
    search."""
    r = jnp.asarray(ref, jnp.float32)
    d = jnp.asarray(dist, jnp.float32)
    total = 0.0
    for s in range(scales):
        total = total + _vif_scale(r, d)
        if s != scales - 1:
            r = _down2(r)
            d = _down2(d)
    return total / scales


HF_TARGET = 0.03       # Gaussian-residual energy ratio of "sharp enough"
MAX_AMOUNT = 0.3       # the reference search's practical ceiling


def frame_preprocessing(y_plane, max_amount: float = MAX_AMOUNT,
                        hf_target: float = HF_TARGET):
    """av1_vmaf_frame_preprocessing analogue: unsharp the source luma.

    amount = max_amount * clip(1 - hf_ratio / hf_target, 0, 1) where
    hf_ratio = var(src - gaussian_blur(src)) / var(src) — a servo toward
    a target high-frequency energy (see module docstring for why the
    libvmaf amount search is not reproducible without that model).
    Returns (amount, sharpened uint8)."""
    src = jnp.asarray(y_plane, jnp.int32)
    blurred = gaussian_blur(src)
    srcf = src.astype(jnp.float32)
    hf = float(jnp.var(srcf - blurred.astype(jnp.float32))
               / jnp.maximum(jnp.var(srcf), 1.0))
    amount = max_amount * min(max(1.0 - hf / hf_target, 0.0), 1.0)
    if amount <= 0.0:
        return 0.0, np.asarray(y_plane, np.uint8)
    sharp = _unsharp(src, blurred, amount)
    return float(amount), np.asarray(sharp).astype(np.uint8)


def motion_score(cur_y, last_y):
    """Blurred-frame mean absolute difference — the role of
    calc_vmaf_motion_score's blurred motion-search error (tune_vmaf.c:
    motion search over 16x16 blurred blocks; a dense diff is its
    upper-bound proxy and shares the zero-motion fixed point)."""
    b0 = gaussian_blur(jnp.asarray(cur_y, jnp.int32))
    b1 = gaussian_blur(jnp.asarray(last_y, jnp.int32))
    return float(jnp.abs(b0 - b1).mean())


def vmaf_motion_dq(motion: float, qindex: int, last_ysse: float,
                   last_dvmaf: float, num_pels: int) -> int:
    """av1_get_vmaf_base_qindex's fitted model (tune_vmaf.c:896): when
    motion is high the same SSE hurts VMAF less, so q can rise.
    Returns the adjusted qindex."""
    sse_threshold = 0.01 * num_pels
    if last_ysse < sse_threshold or last_dvmaf < 0.01:
        return qindex
    dvmaf = 26.11 * (1.0 - np.exp(-0.06 * motion))
    dsse = dvmaf * last_ysse / last_dvmaf
    beta = last_ysse / (dsse + last_ysse)
    # av1_get_deltaq_offset: scale qstep by 1/cbrt? -- the reference maps
    # beta to a delta-q via the qstep ratio; mirror via the quant table
    from ..normative import tables
    qstep = tables.ac_quant(max(qindex, 1))
    want = qstep / max(beta, 1e-6) ** 0.5
    lo, hi = 1, 255
    while lo < hi:
        mid = (lo + hi) // 2
        if tables.ac_quant(mid) < want:
            lo = mid + 1
        else:
            hi = mid
    return int(np.clip(lo, 1, 255))
