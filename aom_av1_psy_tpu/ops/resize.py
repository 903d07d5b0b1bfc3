"""Resize / superres kernels.

- `upscale_normative_plane`: the normative horizontal superres upscale
  (``av1/common/resize.c``: av1_upscale_normative_rows +
  upscale_normative_rect; kernel av1_convolve_horiz_rs convolve.c:26),
  restructured as a vectorized gather + 8-tap weighted sum over all
  output columns at once (per tile column) instead of the per-pixel
  scalar loop — a batched formulation with static shapes.
- `resize_plane` / `down2_*`: the non-normative 2D resize
  (resize.c: interpolate_core / down2_symeven / down2_symodd,
  av1_resize_plane), used encoder-side for superres source scaling.
"""
from __future__ import annotations

import functools
import os

import numpy as np

RS_SUBPEL_BITS = 6
RS_SUBPEL_MASK = (1 << RS_SUBPEL_BITS) - 1
RS_SCALE_SUBPEL_BITS = 14
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
RS_SCALE_EXTRA_BITS = RS_SCALE_SUBPEL_BITS - RS_SUBPEL_BITS
RS_SCALE_EXTRA_OFF = 1 << (RS_SCALE_EXTRA_BITS - 1)
UPSCALE_TAPS = 8
FILTER_BITS = 7
SCALE_NUMERATOR = 8


@functools.cache
def _misc():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "normative", "data", "misc_tables.npz")
    return np.load(path)


def superres_scaled_size(upscaled: int, denom: int) -> int:
    """av1_calculate_scaled_superres_size."""
    return (upscaled * SCALE_NUMERATOR + denom // 2) // denom


def get_upscale_convolve_step(in_length: int, out_length: int) -> int:
    return ((in_length << RS_SCALE_SUBPEL_BITS) + out_length // 2) \
        // out_length


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def get_upscale_convolve_x0(in_length: int, out_length: int,
                            x_step_qn: int) -> int:
    err = out_length * x_step_qn - (in_length << RS_SCALE_SUBPEL_BITS)
    # NB: unlike interpolate_core's offset, the negation here applies to
    # the shift term BEFORE adding out/2 (resize.c:427), and all
    # divisions truncate toward zero as in C
    x0 = _cdiv(-((out_length - in_length) << (RS_SCALE_SUBPEL_BITS - 1))
               + out_length // 2, out_length) \
        + RS_SCALE_EXTRA_OFF - _cdiv(err, 2)
    return x0 & RS_SCALE_SUBPEL_MASK


def _upscale_rect(src: np.ndarray, out_w: int, x0_qn: int,
                  x_step_qn: int) -> np.ndarray:
    """Upscale one tile column (upscale_normative_rect): src (H, W) with
    edge-replication padding on both sides, vectorized over all outputs."""
    H, W = src.shape
    filters = _misc()["resize_filter_normative"].astype(np.int64)
    pad = UPSCALE_TAPS // 2 + 1
    ext = np.concatenate([np.repeat(src[:, :1], pad, 1), src,
                          np.repeat(src[:, -1:], pad, 1)], axis=1)
    x_qn = x0_qn + x_step_qn * np.arange(out_w, dtype=np.int64)
    # src pointer passed is (input - 1); fold both the -1 and the
    # -(taps/2 - 1) kernel origin into the pad offset
    base = (x_qn >> RS_SCALE_SUBPEL_BITS) + pad - 1 - (UPSCALE_TAPS // 2 - 1)
    fidx = (x_qn & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS
    taps = filters[fidx]                                  # (out_w, 8)
    gather = ext[:, base[None, :] + np.arange(UPSCALE_TAPS)[:, None]]
    # gather: (H, 8, out_w)
    s = (gather.astype(np.int64) * taps.T[None]).sum(axis=1)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, 255)


def upscale_normative_plane(src: np.ndarray, out_w: int) -> np.ndarray:
    """av1_upscale_normative_rows for a single-tile-column plane.
    src: (H, W) downscaled visible area. Returns (H, out_w)."""
    H, W = src.shape
    x_step_qn = get_upscale_convolve_step(W, out_w)
    x0_qn = get_upscale_convolve_x0(W, out_w, x_step_qn)
    return _upscale_rect(src, out_w, x0_qn, x_step_qn)


def upscale_normative_frame(planes: list, fh, seq) -> list:
    """Upscale all planes of a decoded frame (av1_superres_upscale).

    planes are mi-aligned (padded) arrays; visible dims come from fh.
    NB: the source column range per tile column is MI-ALIGNED
    (av1_upscale_normative_rows:1308 `mi_col_end << MI_SIZE_LOG2`), so at
    the frame's right edge the convolution taps read REAL reconstructed
    pixels out to the mi boundary; edge replication only applies beyond
    that. The convolve step/x0 still derive from the visible widths."""
    denom = fh.superres_denom
    mi_cols = ((fh.width + 7) >> 3) << 1
    out = []
    for p, plane in enumerate(planes):
        ss_x = seq.subsampling_x if p else 0
        ss_y = seq.subsampling_y if p else 0
        dw = (fh.width + ss_x) >> ss_x
        uw = (fh.upscaled_width + ss_x) >> ss_x
        h = (fh.height + ss_y) >> ss_y
        mi_w = (mi_cols << 2) >> ss_x
        sb_px = 128 if getattr(seq, "use_128x128_superblock", False) else 64
        cols = getattr(fh.tiles, "col_starts", None) or []  # in SB units
        bounds = sorted({min((c * sb_px) >> ss_x, mi_w)
                         for c in cols} | {0, mi_w})
        x_step_qn = get_upscale_convolve_step(dw, uw)
        x0_qn = get_upscale_convolve_x0(dw, uw, x_step_qn)
        res = np.zeros((h, uw), np.int64)
        for j in range(len(bounds) - 1):
            d0, d1 = bounds[j], bounds[j + 1]
            u0 = (d0 * denom) // SCALE_NUMERATOR
            u1 = uw if j == len(bounds) - 2 else (d1 * denom) // SCALE_NUMERATOR
            res[:, u0:u1] = _upscale_rect(
                np.asarray(plane[:h, d0:d1]), u1 - u0, x0_qn, x_step_qn)
            x0_qn += ((u1 - u0) * x_step_qn
                      - ((d1 - d0) << RS_SCALE_SUBPEL_BITS))
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# Non-normative resize (encoder-side source scaling)
# ---------------------------------------------------------------------------

def _choose_interp_filters(in_length: int, out_length: int) -> np.ndarray:
    m = _misc()
    out16 = out_length * 16
    if out16 >= in_length * 16:
        return m["resize_filter_normative"].astype(np.int64)
    if out16 >= in_length * 13:
        return m["resize_filters875"].astype(np.int64)
    if out16 >= in_length * 11:
        return m["resize_filters750"].astype(np.int64)
    if out16 >= in_length * 9:
        return m["resize_filters625"].astype(np.int64)
    return m["resize_filters500"].astype(np.int64)


def interpolate_core(inp: np.ndarray, out_length: int,
                     filters: np.ndarray) -> np.ndarray:
    """resize.c interpolate_core, vectorized along the last axis.
    inp: (..., in_length) int. Returns (..., out_length)."""
    in_length = inp.shape[-1]
    taps = filters.shape[1]
    delta = ((in_length << RS_SCALE_SUBPEL_BITS) + out_length // 2) \
        // out_length
    if in_length > out_length:
        offset = (((in_length - out_length) << (RS_SCALE_SUBPEL_BITS - 1))
                  + out_length // 2) // out_length
    else:
        # C truncating division on the negated numerator
        offset = -_cdiv(((out_length - in_length)
                         << (RS_SCALE_SUBPEL_BITS - 1))
                        + out_length // 2, out_length)
    y = offset + RS_SCALE_EXTRA_OFF + delta * np.arange(out_length,
                                                        dtype=np.int64)
    int_pel = y >> RS_SCALE_SUBPEL_BITS
    sub_pel = (y >> RS_SCALE_EXTRA_BITS) & RS_SUBPEL_MASK
    tapsel = filters[sub_pel]                              # (out, taps)
    idx = np.clip(int_pel[:, None] - taps // 2 + 1
                  + np.arange(taps)[None, :], 0, in_length - 1)
    gathered = inp[..., idx]                               # (..., out, taps)
    s = (gathered.astype(np.int64) * tapsel).sum(-1)
    return np.clip((s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS, 0, 255)


def _down2_symeven(inp: np.ndarray) -> np.ndarray:
    """resize.c down2_symeven along the last axis (length even)."""
    filt = _misc()["down2_symeven_half"].astype(np.int64)
    n = inp.shape[-1]
    fl = len(filt)
    ext = np.concatenate([np.repeat(inp[..., :1], fl, -1), inp,
                          np.repeat(inp[..., -1:], fl, -1)], axis=-1)
    x = np.arange(0, n, 2)
    acc = np.zeros(inp.shape[:-1] + (len(x),), np.int64)
    for j in range(fl):
        acc += (ext[..., fl + x - j] + ext[..., fl + x + 1 + j]) * filt[j]
    return np.clip((acc + 64) >> 7, 0, 255)


def resize_plane(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """av1_resize_plane (non-normative 2D separable resize); round-1
    supports ratios > 1/2 per pass plus exact 1/2 via down2."""
    cur = src.astype(np.int64)
    h, w = cur.shape
    # horizontal
    if out_w * 2 == w:
        cur = _down2_symeven(cur)
    else:
        cur = interpolate_core(cur, out_w, _choose_interp_filters(w, out_w))
    # vertical
    cur = cur.T
    if out_h * 2 == h:
        cur = _down2_symeven(cur)
    else:
        cur = interpolate_core(cur, out_h, _choose_interp_filters(h, out_h))
    return cur.T