"""Fused inter-frame plan — the batched replacement for the host
IPPP encoder's per-block loop (VERDICT r3 task 4).

Unlike intra, inter prediction reads only the REFERENCE frame, so there
is no wavefront dependency at all: motion search, motion compensation,
transform/quantize/recon and the 32-vs-16 partition choice for EVERY
block of the frame run as single batched device programs
(av1/encoder/mcomp.c + rdopt.c + encodeframe.c hot loop, re-expressed).

Pipeline per frame (all jit, shapes static per resolution):
  1. full-pel motion search per 16x16 block: coarse step-2 grid over
     +/-16 px then +/-1 refine (SAD), av1_full_pixel_search analogue;
  2. subpel refine at half then quarter pel using the bit-exact
     batched convolve (av1_find_best_sub_pixel_tree analogue);
  3. the 32-path takes the best of its four sub-MVs (and zero) at 32x32;
  4. both granularities are motion-compensated (bit-exact mirror of
     decoder/inter.py:_predict_one), transformed, quantized,
     reconstructed, skip-RD'd; the split choice is made on device from
     reconstructed RD (alpha*eob coeff-rate model + an MV-rate proxy);
  5. chroma follows the luma structure with the same MVs (4:2:0).

The host then derives the normative ref-MV stacks with the proven
normative/mvref.py, picks NEAREST/NEAR/GLOBAL/NEWMV per block, and
builds a symbol script executed by native ec_enc_run_script
(encoder/tpu_interframe.py).
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..normative import tables
from ..ops import convolve as CONV
from .tpu_intra import _tq_recon, _skip_rd, BS_TO_TX

SEARCH_RAD = 16          # full-pel +/- range, px
AOM_INTERP_EXTEND = 4


# ----------------------------------------------------------------------
# batched bit-exact MC (decoder/inter.py:_predict_one mirror)
# ----------------------------------------------------------------------
def _conv2d_batched(region, kx, ky, bw, bd=8):
    """av1_convolve_2d_sr with per-block kernels.

    region: (B, bw+7, bw+7) int32; kx/ky: (B, 8) int32. The 2-D path with
    the zero-phase kernel reproduces the x/y/copy facade paths bit-exactly
    (verified against decoder/inter.py in tests), so one code path covers
    every subpel phase.
    """
    x = region.astype(jnp.int32)
    round0 = CONV.ROUND0_BITS
    round1 = 2 * CONV.FILTER_BITS - round0
    off = 1 << (bd + CONV.FILTER_BITS - 1)
    im = jnp.zeros(x.shape[:-2] + (bw + 7, bw), jnp.int32)
    for k in range(8):
        im = im + kx[:, k, None, None] * x[:, :, k : k + bw]
    im = (im + off + (1 << (round0 - 1))) >> round0
    offset_bits = bd + 2 * CONV.FILTER_BITS - round0
    out = jnp.zeros(x.shape[:-2] + (bw, bw), jnp.int32)
    for k in range(8):
        out = out + ky[:, k, None, None] * im[:, k : k + bw, :]
    out = (out + (1 << offset_bits) + (1 << (round1 - 1))) >> round1
    out = out - ((1 << (offset_bits - round1))
                 + (1 << (offset_bits - round1 - 1)))
    return jnp.clip(out, 0, (1 << bd) - 1)


def _gather_region(ref, ys, xs):
    """ref (H, W); ys (B, h), xs (B, w) pre-clamped -> (B, h, w)."""
    return ref[ys[:, :, None], xs[:, None, :]]


def _mc_blocks(ref, base_y, base_x, mvq4_r, mvq4_c, bw, crop_h, crop_w,
               kernels):
    """Batched single-ref MC. base_* (B,) plane px; mvq4 (B,) CLAMPED
    1/16-pel; kernels (16, 8). Returns (B, bw, bw) int32 pixels."""
    pos_y = (base_y << 4) + mvq4_r
    pos_x = (base_x << 4) + mvq4_c
    y0 = (pos_y >> 4) - 3
    x0 = (pos_x >> 4) - 3
    spy = pos_y & 15
    spx = pos_x & 15
    ys = jnp.clip(y0[:, None] + jnp.arange(bw + 7)[None, :], 0, crop_h - 1)
    xs = jnp.clip(x0[:, None] + jnp.arange(bw + 7)[None, :], 0, crop_w - 1)
    region = _gather_region(ref, ys, xs)
    kx = kernels[spx]
    ky = kernels[spy]
    return _conv2d_batched(region, kx, ky, bw)


def _clamp_mv_q4(mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c, ss):
    """clamp_mv_to_umv_border_sb: 1/8-pel -> clamped q4 (1/16 plane)."""
    row = mv8_r * (1 << (1 - ss))
    col = mv8_c * (1 << (1 - ss))
    return (jnp.clip(row, lo_r, hi_r), jnp.clip(col, lo_c, hi_c))


# ----------------------------------------------------------------------
# motion search
# ----------------------------------------------------------------------
def _fullpel_search(src16, ref, by, bx, crop_h, crop_w, bw: int = 16,
                    cy=None, cx=None):
    """src16 (B,bw,bw); block origins by/bx (B,); optional per-block
    window centers cy/cx (full-pel offsets added to the block origin —
    the two-stage search centers the fine stage on the coarse stage's
    half-resolution winner, extending the effective range to
    +/-(2+1)*SEARCH_RAD). EXACT exhaustive step-1 SSD over
    +/-SEARCH_RAD, av1_full_pixel_search's exhaustive mode:

      SSD(d) = sum(win(d)^2) - 2*corr(win(d), src) + const

    The correlation for the whole (2r+1)^2 offset grid of every block is
    ONE grouped ``lax.conv`` pinned to full f32 precision (no reduced-
    precision tensor-core passes): its 8-bit products and sums stay below
    2^24, so the f32 result is an exact integer. The windowed sum of
    squares is an int32 box sum. The score is formed in int32, so the
    argmin (first index on ties) equals an int64 brute-force SSD's.
    A coarse step-2 SAD grid (the previous design) undersamples noisy
    content, whose SSD basin at the true MV is one pixel wide.
    Returns full-pel (dy, dx) (B,) each."""
    B = src16.shape[0]
    r = SEARCH_RAD
    oy = by if cy is None else by + cy
    ox = bx if cx is None else bx + cx
    span = jnp.arange(bw + 2 * r)[None, :] - r
    ys = jnp.clip(oy[:, None] + span, 0, crop_h - 1)
    xs = jnp.clip(ox[:, None] + span, 0, crop_w - 1)
    win = _gather_region(ref, ys, xs).astype(jnp.int32)
    corr = jax.lax.conv_general_dilated(
        win.astype(jnp.float32)[None], src16.astype(jnp.float32)[:, None],
        window_strides=(1, 1), padding="VALID", feature_group_count=B,
        precision=jax.lax.Precision.HIGHEST)[0]            # (B, n, n)
    sumsq = jax.lax.reduce_window(win * win, 0, jax.lax.add, (1, bw, bw),
                                  (1, 1, 1), "VALID")
    score = sumsq - 2 * corr.astype(jnp.int32)
    n = 2 * r + 1
    best = jnp.argmin(score.reshape(B, -1), axis=1)
    dy = (best // n).astype(jnp.int32) - r
    dx = (best % n).astype(jnp.int32) - r
    if cy is not None:
        dy = dy + cy
        dx = dx + cx
    return dy, dx


def _subpel_refine(src16, ref, by, bx, mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c,
                   crop_h, crop_w, kernels):
    """Half- then quarter-pel refine with exact-MC SAD (decision only)."""
    for step in (4, 2):
        sads, drs, dcs = [], [], []
        for dr in (-step, 0, step):
            for dc in (-step, 0, step):
                r8 = mv8_r + dr
                c8 = mv8_c + dc
                qr, qc = _clamp_mv_q4(r8, c8, lo_r, hi_r, lo_c, hi_c, 0)
                pred = _mc_blocks(ref, by, bx, qr, qc, 16, crop_h, crop_w,
                                  kernels)
                sads.append(jnp.abs(pred - src16).sum((-1, -2)))
                drs.append(dr)
                dcs.append(dc)
        s = jnp.stack(sads)
        k = jnp.argmin(s, axis=0)
        mv8_r = mv8_r + jnp.asarray(drs, jnp.int32)[k]
        mv8_c = mv8_c + jnp.asarray(dcs, jnp.int32)[k]
    return mv8_r, mv8_c


RATE_ZEROMV = 1024.0     # ~2 bits: the GLOBALMV-class mode cost


def _mv_rate_proxy(mv8_r, mv8_c):
    """Rough NEWMV rate in 1/512-bit units (decision only): ~10 bits base
    plus ~2*bit-length of each 1/4-pel component."""
    mag = (jnp.abs(mv8_r) + jnp.abs(mv8_c)).astype(jnp.float32) / 2.0
    return 512.0 * (10.0 + 2.0 * jnp.log2(1.0 + mag))


# ----------------------------------------------------------------------
# the fused luma plan
# ----------------------------------------------------------------------
@functools.partial(jax.jit,
                   static_argnames=("R", "C", "crop_h", "crop_w"))
def _luma_inter(src, ref, dc_q, ac_q, rd16, rd32, forced, no_split,
                all_kernels, c16, c32, rt32, rt16,
                *, R, C, crop_h, crop_w):
    """src/ref: (R*32, C*32) int32 padded planes. Returns
    (split (R,C), mv8 (2R,2C,2), lv32, e32, lv16, e16, recon)."""
    tx32, tx16 = BS_TO_TX[32], BS_TO_TX[16]
    scan32 = jnp.asarray(tables.scan_table(tx32, 0))
    scan16 = jnp.asarray(tables.scan_table(tx16, 0))
    R2, C2 = 2 * R, 2 * C
    B = R2 * C2

    # ---- 16-level motion field ----
    # block origins are STATIC grids: keep them numpy so every derived
    # source/window gather has compile-time constant indices
    gy = 16 * (np.arange(B, dtype=np.int32) // C2)
    gx = 16 * (np.arange(B, dtype=np.int32) % C2)
    rows16 = gy[:, None] + np.arange(16)[None, :]
    cols16 = gx[:, None] + np.arange(16)[None, :]
    s16 = src[rows16[:, :, None], cols16[:, None, :]]
    kernels = all_kernels[0]      # REGULAR during the search stages
    # two-stage full-pel search: a half-resolution exact-SSD pass first
    # (effective +/-2*SEARCH_RAD), then the full-res pass centered on its
    # winner -- combined range +/-48 px (av1_full_pixel_search's
    # multi-step role without its sequential steps)
    half = (src[0::2, 0::2] + src[1::2, 0::2] + src[0::2, 1::2]
            + src[1::2, 1::2] + 2) >> 2
    rhalf = (ref[0::2, 0::2] + ref[1::2, 0::2] + ref[0::2, 1::2]
             + ref[1::2, 1::2] + 2) >> 2
    gy_h = gy >> 1
    gx_h = gx >> 1
    rows8 = gy_h[:, None] + np.arange(8)[None, :]
    cols8 = gx_h[:, None] + np.arange(8)[None, :]
    s8 = half[rows8[:, :, None], cols8[:, None, :]]
    cdy, cdx = _fullpel_search(s8, rhalf, gy_h, gx_h, crop_h // 2,
                               crop_w // 2, bw=8)
    fdy, fdx = _fullpel_search(s16, ref, gy, gx, crop_h, crop_w,
                               cy=2 * cdy, cx=2 * cdx)
    mv8_r, mv8_c = 8 * fdy, 8 * fdx
    lo_r, hi_r, lo_c, hi_c = [x.reshape(-1) for x in c16]
    mv8_r, mv8_c = _subpel_refine(s16, ref, gy, gx, mv8_r, mv8_c,
                                  lo_r, hi_r, lo_c, hi_c, crop_h, crop_w,
                                  kernels)
    # ---- dominant-MV candidate (crude global motion) ----
    # The reference's search is anchored by neighbour MV prediction, which
    # propagates a pan through low-texture regions; an independent
    # per-block search instead locks onto noise there. The batched
    # analogue: texture-confident blocks vote their full-pel MV into a
    # histogram, and the winning MV becomes a per-block candidate
    # (av1_compute_global_motion's role, flat-fast).
    rdf16 = rd16.reshape(-1)
    qr, qc = _clamp_mv_q4(mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c, 0)
    pred16 = _mc_blocks(ref, gy, gx, qr, qc, 16, crop_h, crop_w, kernels)
    sse_srch = ((pred16 - s16) ** 2).sum((-1, -2)).astype(jnp.float32)
    z = jnp.zeros_like(mv8_r)
    zqr, zqc = _clamp_mv_q4(z, z, lo_r, hi_r, lo_c, hi_c, 0)
    pred0 = _mc_blocks(ref, gy, gx, zqr, zqc, 16, crop_h, crop_w, kernels)
    sad0 = jnp.abs(pred0 - s16).sum((-1, -2))
    sad_srch = jnp.abs(pred16 - s16).sum((-1, -2))
    conf = jnp.maximum(sad0 - sad_srch, 0)
    fr = jnp.clip((mv8_r + 4 * jnp.sign(mv8_r)) // 8, -SEARCH_RAD,
                  SEARCH_RAD)
    fc_ = jnp.clip((mv8_c + 4 * jnp.sign(mv8_c)) // 8, -SEARCH_RAD,
                   SEARCH_RAD)
    nbin = 2 * SEARCH_RAD + 1
    bins = (fr + SEARCH_RAD) * nbin + (fc_ + SEARCH_RAD)
    votes = jnp.zeros((nbin * nbin,), jnp.int32).at[bins].add(conf)
    gbin = jnp.argmax(votes)
    g_r = 8 * (gbin // nbin - SEARCH_RAD).astype(jnp.int32)
    g_c = 8 * (gbin % nbin - SEARCH_RAD).astype(jnp.int32)
    gv_r = jnp.full((B,), g_r)
    gv_c = jnp.full((B,), g_c)
    gv_r, gv_c = _subpel_refine(s16, ref, gy, gx, gv_r, gv_c,
                                lo_r, hi_r, lo_c, hi_c, crop_h, crop_w,
                                kernels)
    gqr, gqc = _clamp_mv_q4(gv_r, gv_c, lo_r, hi_r, lo_c, hi_c, 0)
    predg = _mc_blocks(ref, gy, gx, gqr, gqc, 16, crop_h, crop_w, kernels)
    sse_g = ((predg - s16) ** 2).sum((-1, -2)).astype(jnp.float32)
    sse0 = ((pred0 - s16) ** 2).sum((-1, -2)).astype(jnp.float32)

    # pick {searched, dominant, zero} in the RD domain: a flat SAD slack
    # mis-fires on noisy content (noise hides a large SSE gap behind a
    # small SAD gap), so the costs are SSE + lambda * mv-rate
    lam = rdf16 / 512.0
    rd_srch = 2048.0 * sse_srch + lam * _mv_rate_proxy(mv8_r, mv8_c)
    rd_g = 2048.0 * sse_g + lam * _mv_rate_proxy(gv_r, gv_c)
    rd_0 = 2048.0 * sse0 + lam * RATE_ZEROMV
    choice = jnp.argmin(jnp.stack([rd_srch, rd_g, rd_0]), axis=0)
    mv8_r = jnp.where(choice == 1, gv_r, jnp.where(choice == 2, 0, mv8_r))
    mv8_c = jnp.where(choice == 1, gv_c, jnp.where(choice == 2, 0, mv8_c))

    # ---- frame-level interpolation filter selection ----
    # av1/encoder/interp_search.c's role at frame granularity: with the
    # final MV field, motion-compensate the 16-grid with each filter
    # family and signal the SSE-minimal one (interp_filter header field;
    # is_filter_switchable stays off)
    qr, qc = _clamp_mv_q4(mv8_r, mv8_c, lo_r, hi_r, lo_c, hi_c, 0)
    preds_f = []
    sses_f = []
    for f in range(all_kernels.shape[0]):
        pf = _mc_blocks(ref, gy, gx, qr, qc, 16, crop_h, crop_w,
                        all_kernels[f])
        preds_f.append(pf)
        sses_f.append(((pf - s16) ** 2).astype(jnp.float32).sum())
    interp_sel = jnp.argmin(jnp.stack(sses_f))
    kernels = all_kernels[interp_sel]
    pred16 = jnp.stack(preds_f)[interp_sel]

    # ---- 16 TQ + skip-RD ----
    lv16, e16, rec16 = _tq_recon(s16, pred16, dc_q, ac_q, tx16, scan16)
    lv16, e16, rec16, sse16, crate16 = _skip_rd(
        lv16, e16, rec16, pred16, s16, rdf16, *rt16)
    cost16b = 2048.0 * sse16 + (rdf16 / 512.0) * (
        crate16 + _mv_rate_proxy(mv8_r, mv8_c))
    cost16 = cost16b.reshape(R2, C2)
    cost16 = (cost16.reshape(R, 2, C, 2).sum((1, 3)))

    # ---- 32 path: best of the 4 sub-MVs + zero at 32x32 ----
    Bc = R * C
    cy = 32 * (np.arange(Bc, dtype=np.int32) // C)
    cx = 32 * (np.arange(Bc, dtype=np.int32) % C)
    rows32 = cy[:, None] + np.arange(32)[None, :]
    cols32 = cx[:, None] + np.arange(32)[None, :]
    s32 = src[rows32[:, :, None], cols32[:, None, :]]
    lo32 = [x.reshape(-1) for x in c32]
    mvr2 = mv8_r.reshape(R, 2, C, 2)
    mvc2 = mv8_c.reshape(R, 2, C, 2)
    cand_mvs = [(mvr2[:, qr_, :, qc_].reshape(-1),
                 mvc2[:, qr_, :, qc_].reshape(-1))
                for qr_ in (0, 1) for qc_ in (0, 1)]
    cand_mvs.append((jnp.zeros(Bc, jnp.int32), jnp.zeros(Bc, jnp.int32)))
    rdf32 = rd32.reshape(-1)
    rds, preds = [], []
    for ci, (mr, mc) in enumerate(cand_mvs):
        qr, qc = _clamp_mv_q4(mr, mc, *lo32, 0)
        p = _mc_blocks(ref, cy, cx, qr, qc, 32, crop_h, crop_w, kernels)
        preds.append(p)
        sse = ((p - s32) ** 2).sum((-1, -2)).astype(jnp.float32)
        mvr = RATE_ZEROMV if ci == len(cand_mvs) - 1 \
            else _mv_rate_proxy(mr, mc)
        rds.append(2048.0 * sse + (rdf32 / 512.0) * mvr)
    k32 = jnp.argmin(jnp.stack(rds), axis=0)
    pred32 = jnp.take_along_axis(
        jnp.stack(preds), k32[None, :, None, None], axis=0)[0]
    mv32_r = jnp.take_along_axis(
        jnp.stack([m[0] for m in cand_mvs]), k32[None], 0)[0]
    mv32_c = jnp.take_along_axis(
        jnp.stack([m[1] for m in cand_mvs]), k32[None], 0)[0]

    lv32, e32, rec32 = _tq_recon(s32, pred32, dc_q, ac_q, tx32, scan32)
    lv32, e32, rec32, sse32, crate32 = _skip_rd(
        lv32, e32, rec32, pred32, s32, rdf32, *rt32)
    cost32 = (2048.0 * sse32 + (rdf32 / 512.0) * (
        crate32 + _mv_rate_proxy(mv32_r, mv32_c))).reshape(R, C)

    split = forced | ((cost16 < cost32) & ~no_split)
    # the 32 block's mv replaces all four sub mvs when NONE is chosen
    mvs = jnp.stack([mv8_r.reshape(R2, C2), mv8_c.reshape(R2, C2)], -1)
    mv32_up = jnp.stack(
        [jnp.repeat(jnp.repeat(mv32_r.reshape(R, C), 2, 0), 2, 1),
         jnp.repeat(jnp.repeat(mv32_c.reshape(R, C), 2, 0), 2, 1)], -1)
    smask = jnp.repeat(jnp.repeat(split, 2, 0), 2, 1)
    mv_out = jnp.where(smask[:, :, None], mvs, mv32_up)

    # recon assembly
    r16f = rec16.reshape(R2, C2, 16, 16).transpose(0, 2, 1, 3) \
        .reshape(R2 * 16, C2 * 16)
    r32f = rec32.reshape(R, C, 32, 32).transpose(0, 2, 1, 3) \
        .reshape(R * 32, C * 32)
    pix_mask = jnp.repeat(jnp.repeat(split, 32, 0), 32, 1)
    recon = jnp.where(pix_mask, r16f, r32f)
    return (split.astype(jnp.int32), mv_out,
            lv32.reshape(R, C, 1024), e32.reshape(R, C),
            lv16.reshape(R2, C2, 256), e16.reshape(R2, C2), recon,
            interp_sel)


@functools.partial(jax.jit,
                   static_argnames=("R", "C", "crop_h", "crop_w"))
def _chroma_inter(src_u, src_v, ref_u, ref_v, dc_q, ac_q, rd16, rd32,
                  split, mv8, kernels, cc16, cc32, rtc16, rtc8,
                  *, R, C, crop_h, crop_w):
    """Chroma (4:2:0) follows the luma structure: 16px blocks for NONE
    cells, 8px for split subs, same MVs. Returns per-plane levels/eobs
    at both granularities + recon (2, H, W)."""
    tx16, tx8 = BS_TO_TX[16], BS_TO_TX[8]
    scan16 = jnp.asarray(tables.scan_table(tx16, 0))
    scan8 = jnp.asarray(tables.scan_table(tx8, 0))
    R2, C2 = 2 * R, 2 * C
    B8 = R2 * C2
    Bc = R * C

    gy8 = 8 * (np.arange(B8, dtype=np.int32) // C2)
    gx8 = 8 * (np.arange(B8, dtype=np.int32) % C2)
    cy16 = 16 * (np.arange(Bc, dtype=np.int32) // C)
    cx16 = 16 * (np.arange(Bc, dtype=np.int32) % C)
    mvr = mv8[:, :, 0].reshape(-1)
    mvc = mv8[:, :, 1].reshape(-1)
    # 32-cell mv = TL sub's mv (all four equal when NONE was chosen)
    mvr32 = mv8[::2, ::2, 0].reshape(-1)
    mvc32 = mv8[::2, ::2, 1].reshape(-1)

    lo8 = [x.reshape(-1) for x in cc16]
    lo16 = [x.reshape(-1) for x in cc32]
    outs = []
    for srcp, refp in ((src_u, ref_u), (src_v, ref_v)):
        rows8 = gy8[:, None] + np.arange(8)[None, :]
        cols8 = gx8[:, None] + np.arange(8)[None, :]
        s8 = srcp[rows8[:, :, None], cols8[:, None, :]]
        qr, qc = _clamp_mv_q4(mvr, mvc, *lo8, 1)
        p8 = _mc_blocks(refp, gy8, gx8, qr, qc, 8, crop_h, crop_w, kernels)
        lv8, e8, rec8 = _tq_recon(s8, p8, dc_q, ac_q, tx8, scan8)
        lv8, e8, rec8, _, _ = _skip_rd(lv8, e8, rec8, p8, s8,
                                       rd16.reshape(-1), *rtc8)

        rows16 = cy16[:, None] + np.arange(16)[None, :]
        cols16 = cx16[:, None] + np.arange(16)[None, :]
        s16 = srcp[rows16[:, :, None], cols16[:, None, :]]
        qr, qc = _clamp_mv_q4(mvr32, mvc32, *lo16, 1)
        p16 = _mc_blocks(refp, cy16, cx16, qr, qc, 16, crop_h, crop_w,
                         kernels)
        lv16, e16, rec16 = _tq_recon(s16, p16, dc_q, ac_q, tx16, scan16)
        lv16, e16, rec16, _, _ = _skip_rd(lv16, e16, rec16, p16, s16,
                                          rd32.reshape(-1), *rtc16)

        r8f = rec8.reshape(R2, C2, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(R2 * 8, C2 * 8)
        r16f = rec16.reshape(R, C, 16, 16).transpose(0, 2, 1, 3) \
            .reshape(R * 16, C * 16)
        pix_mask = jnp.repeat(jnp.repeat(split.astype(bool), 16, 0), 16, 1)
        recon = jnp.where(pix_mask, r8f, r16f)
        outs.append((lv16.reshape(R, C, 256), e16.reshape(R, C),
                     lv8.reshape(R2, C2, 64), e8.reshape(R2, C2), recon))
    lv16 = jnp.stack([o[0] for o in outs])
    e16 = jnp.stack([o[1] for o in outs])
    lv8 = jnp.stack([o[2] for o in outs])
    e8 = jnp.stack([o[3] for o in outs])
    rec = jnp.stack([o[4] for o in outs])
    return lv16, e16, lv8, e8, rec


def plan_inter_frame(src_planes, ref_planes, q, rdmult, mi_rows, mi_cols,
                     crop_w, crop_h, fetch_recon=False):
    """Batched inter plan for one frame vs one LAST reference.

    src_planes: mi-aligned int32 planes padded to 32 (luma) / 16 (chroma)
    multiples; ref_planes: same-dims reference recon (device arrays ok);
    crop_w/crop_h: TRUE frame dims (border-replication clamp bounds).
    Returns the plan dict for the inter symbol-script pack."""
    from .tpu_intra import (_shrink_levels, _rate_tables,
                            partition_edge_grids, plan_part_supported)
    from ..ec.context import FrameContext
    assert plan_part_supported(mi_rows, mi_cols)
    rt = _rate_tables(FrameContext(q))
    y = src_planes[0]
    R, C = y.shape[0] // 32, y.shape[1] // 32
    R2, C2 = 2 * R, 2 * C
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)

    rd16 = np.asarray(rdmult, np.float32)
    if rd16.ndim == 0:
        rd16 = np.full((R2, C2), float(rdmult), np.float32)
    rd32 = np.exp(np.log(rd16).reshape(R, 2, C, 2).mean((1, 3))) \
        .astype(np.float32)

    forced, no_split = partition_edge_grids(mi_rows, mi_cols, R, C)

    all_kernels = jnp.stack([jnp.asarray(CONV.filter_kernels(f, 16))
                             for f in (0, 1, 2)])   # REGULAR/SMOOTH/SHARP
    c16 = _edge_grids(R2, C2, mi_rows, mi_cols, 16, 0)
    c32 = _edge_grids(R2, C2, mi_rows, mi_cols, 32, 0)
    cc16 = _edge_grids(R2, C2, mi_rows, mi_cols, 16, 1)
    cc32 = _edge_grids(R2, C2, mi_rows, mi_cols, 32, 1)

    split, mv8, lv32, e32, lv16, e16, yrec, interp_sel = _luma_inter(
        jnp.asarray(y), jnp.asarray(ref_planes[0]), dc_q, ac_q,
        jnp.asarray(rd16), jnp.asarray(rd32), jnp.asarray(forced),
        jnp.asarray(no_split), all_kernels,
        tuple(jnp.asarray(x) for x in c16),
        tuple(jnp.asarray(x) for x in c32),
        rt["y32"], rt["y16"],
        R=R, C=C, crop_h=crop_h, crop_w=crop_w)
    plan = {
        "inter": True,
        "interp_filter": int(interp_sel),
        "split32": np.asarray(split).astype(np.uint8),
        "mv8": np.asarray(mv8),
        "y_levels32": np.asarray(_shrink_levels(lv32)).astype(np.int32),
        "y_levels16": np.asarray(_shrink_levels(lv16)).astype(np.int32),
        "y_eob32": np.asarray(e32), "y_eob16": np.asarray(e16),
        "recon_dev": [yrec],
    }
    if len(src_planes) > 1:
        ch = (crop_h + 1) >> 1
        cw = (crop_w + 1) >> 1
        uvlv16, uve16, uvlv8, uve8, uvrec = _chroma_inter(
            jnp.asarray(src_planes[1]), jnp.asarray(src_planes[2]),
            jnp.asarray(ref_planes[1]), jnp.asarray(ref_planes[2]),
            dc_q, ac_q, jnp.asarray(rd16), jnp.asarray(rd32), split, mv8,
            all_kernels[interp_sel],
            tuple(jnp.asarray(x) for x in cc16),
            tuple(jnp.asarray(x) for x in cc32),
            rt["uv16"], rt["uv8"],
            R=R, C=C, crop_h=ch, crop_w=cw)
        plan["uv_levels16"] = np.asarray(_shrink_levels(uvlv16)) \
            .astype(np.int32)
        plan["uv_levels8"] = np.asarray(_shrink_levels(uvlv8)) \
            .astype(np.int32)
        plan["uv_eob16"] = np.asarray(uve16)
        plan["uv_eob8"] = np.asarray(uve8)
        plan["recon_dev"] += [uvrec[0], uvrec[1]]
    if fetch_recon:
        plan["recon"] = [np.asarray(r) for r in plan["recon_dev"]]
    return plan


def _edge_grids(R2, C2, mi_rows, mi_cols, bs, ss):
    """Per-block q4 MV clamp bounds (clamp_mv_to_umv_border_sb).

    For bs=16 the grid is (R2, C2); for bs=32 it is (R2/2, C2/2).
    ss applies the chroma subsampling scaling of the PLANE (block dims
    halve, 1/8-pel -> 1/16 via the <<(1-ss) in _clamp_mv_q4)."""
    n4 = bs // 4
    nr = R2 if bs == 16 else R2 // 2
    nc = C2 if bs == 16 else C2 // 2
    rr = n4 * np.arange(nr)
    cc = n4 * np.arange(nc)
    mb_top = -(rr * 4 * 8)
    mb_bottom = (mi_rows - n4 - rr) * 4 * 8
    mb_left = -(cc * 4 * 8)
    mb_right = (mi_cols - n4 - cc) * 4 * 8
    cw = bs >> ss
    spel_lo = (AOM_INTERP_EXTEND + cw) << 4
    spel_hi = spel_lo - 16
    sh = 1 - ss
    z_c = np.zeros(nc, np.int64)[None, :]
    z_r = np.zeros(nr, np.int64)[:, None]
    lo_r = (mb_top[:, None] << sh) - spel_lo + z_c
    hi_r = (mb_bottom[:, None] << sh) + spel_hi + z_c
    lo_c = (mb_left[None, :] << sh) - spel_lo + z_r
    hi_c = (mb_right[None, :] << sh) + spel_hi + z_r
    return (lo_r.astype(np.int32), hi_r.astype(np.int32),
            lo_c.astype(np.int32), hi_c.astype(np.int32))
