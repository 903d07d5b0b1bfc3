"""Directional intra modes for the fused plan — batched edge pipeline.

Extends the fused wavefront's candidate set from the 7 extension-free
modes to the full 13 AV1 intra modes with angle deltas, re-expressing the
reference's per-block edge pipeline (``av1/common/reconintra.c:1081``
build_intra_predictors: corner smoothing, strength-dependent 5-tap edge
filtering, z1/z2/z3 directional gathers) as static-index batched gathers
over a unified per-block edge buffer:

  - every candidate's (mode, delta) geometry — dx/dy walks, base/shift
    grids, filter strengths — is compile-time static, so a directional
    prediction is ONE gather + one weighted add on the device;
  - the per-block dynamic part is only (a) which neighbours exist and
    (b) the smooth-neighbour edge-filter type (reconintra.c
    get_intra_edge_filter_type), which selects between pre-filtered edge
    variants;
  - top-right / bottom-left extensions follow the normative availability
    rules (reconintra.c:178 has_top_right / :246 has_bottom_left, shared
    with the decoder via ``normative/intra_avail.py``): where the rule
    says "unavailable" the decoder replicates the edge — reproduced here
    exactly — and where it says "available" the candidate is only offered
    at positions whose real pixels exist in wavefront order (an encoder-
    side restriction, not a conformance issue).

No upsampling paths are needed: use_intra_edge_upsample requires
w + h <= 16 (type 0), and the plan's luma blocks are 16/32.
"""
from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from ..ops import intra as intra_ops
from ..normative.enums import PredictionMode, MODE_TO_ANGLE

# class ids
PLAIN, Z1, Z2, Z3 = 0, 1, 2, 3

# the 7 extension-free candidates first (same order as the legacy
# PLAN_MODES so ties keep preferring cheap modes), then directional
# (mode, delta) pairs
_PLAIN = ((0, 0), (1, 0), (2, 0), (9, 0), (10, 0), (11, 0), (12, 0))


def _p_angle(mode: int, delta: int) -> int:
    return int(MODE_TO_ANGLE[PredictionMode(mode)]) + 3 * delta


@functools.cache
def candidates():
    """[(mode, delta, cls)] — PLAIN entries first, then directional."""
    out = [(m, d, PLAIN) for (m, d) in _PLAIN]
    for m in range(1, 9):
        for d in (-3, -2, -1, 0, 1, 2, 3):
            if m in (1, 2) and d == 0:
                continue  # V/H delta 0 are in the PLAIN set
            pa = _p_angle(m, d)
            cls = Z1 if pa < 90 else (Z2 if pa < 180 else Z3)
            if pa in (90, 180):
                cls = PLAIN  # cannot happen for d != 0, defensive
            out.append((m, d, cls))
    return tuple(out)


_FILTER_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


@functools.cache
def tables(bs: int):
    """Static gather tables for one block size.

    Edge buffer layout per block (concat along axis 1):
      A1[s] s=0..3 : [corner, above(2bs)]      len 2bs+1  (z1 edges)
      A2[s]        : [pad127, corner2, above(bs)] len bs+2 (z2 above)
      L2[s]        : [pad129, corner2, left(bs)]  len bs+2 (z2 left)
      L3[s]        : [corner, left(2bs)]        len 2bs+1 (z3 edges)
    corner2 is the z2-smoothed corner (w+h>=24 always holds at 16/32).

    Returns dict with MODE/DELTA/CLS (K,), and for the directional tail
    IDXa/IDXb/SH of shape (2, Kd, bs, bs) — first axis = edge-filter type
    (smooth-neighbour rule).
    """
    assert bs in (16, 32), bs
    cands = candidates()
    K = len(cands)
    nd = sum(1 for c in cands if c[2] != PLAIN)
    n_plain = K - nd

    seg_a1 = 2 * bs + 1
    seg_a2 = bs + 2
    off_a1 = [s * seg_a1 for s in range(4)]
    base = 4 * seg_a1
    off_a2 = [base + s * seg_a2 for s in range(4)]
    base += 4 * seg_a2
    off_l2 = [base + s * seg_a2 for s in range(4)]
    base += 4 * seg_a2
    off_l3 = [base + s * seg_a1 for s in range(4)]
    L = base + 4 * seg_a1

    r = np.arange(bs)[:, None]
    c = np.arange(bs)[None, :]

    idxa = np.zeros((2, nd, bs, bs), np.int64)
    idxb = np.zeros((2, nd, bs, bs), np.int64)
    sh = np.zeros((nd, bs, bs), np.int64)
    k = 0
    for mode, delta, cls in cands:
        if cls == PLAIN:
            continue
        pa = _p_angle(mode, delta)
        dx, dy = intra_ops.get_dx(pa), intra_ops.get_dy(pa)
        # per-type filter strengths (reconintra.c intra_edge_filter_strength)
        sa = [intra_ops.intra_edge_filter_strength(bs, bs, pa - 90, t)
              for t in (0, 1)]
        sl = [intra_ops.intra_edge_filter_strength(bs, bs, pa - 180, t)
              for t in (0, 1)]
        assert not intra_ops.use_intra_edge_upsample(bs, bs, pa - 90, 0)
        assert not intra_ops.use_intra_edge_upsample(bs, bs, pa - 180, 0)
        if cls == Z1:
            x = dx * (r + 1)
            bse = (x >> 6) + c
            shift = (x & 0x3F) >> 1
            mb = 2 * bs - 1
            over = bse >= mb
            b0 = np.where(over, mb, np.minimum(bse, mb))
            b1 = np.where(over, mb, np.minimum(bse + 1, mb))
            shift = np.where(over, 0, shift)
            for t in (0, 1):
                idxa[t, k] = off_a1[sa[t]] + 1 + b0
                idxb[t, k] = off_a1[sa[t]] + 1 + b1
            sh[k] = shift
        elif cls == Z3:
            y = dy * (c + 1)
            bse = (y >> 6) + r
            shift = (y & 0x3F) >> 1
            mb = 2 * bs - 1
            over = bse >= mb
            b0 = np.where(over, mb, np.minimum(bse, mb))
            b1 = np.where(over, mb, np.minimum(bse + 1, mb))
            shift = np.where(over, 0, shift)
            for t in (0, 1):
                idxa[t, k] = off_l3[sl[t]] + 1 + b0
                idxb[t, k] = off_l3[sl[t]] + 1 + b1
            sh[k] = shift
        else:  # Z2
            x = (c << 6) - (r + 1) * dx
            base_x = x >> 6
            use_above = base_x >= -1
            shift_x = (x & 0x3F) >> 1
            bx0 = np.clip(base_x, -2, bs - 1) + 2
            bx1 = np.clip(base_x + 1, -2, bs - 1) + 2
            y2 = (r << 6) - (c + 1) * dy
            base_y = y2 >> 6
            shift_y = (y2 & 0x3F) >> 1
            by0 = np.clip(base_y, -2, bs - 1) + 2
            by1 = np.clip(base_y + 1, -2, bs - 1) + 2
            for t in (0, 1):
                idxa[t, k] = np.where(use_above, off_a2[sa[t]] + bx0,
                                      off_l2[sl[t]] + by0)
                idxb[t, k] = np.where(use_above, off_a2[sa[t]] + bx1,
                                      off_l2[sl[t]] + by1)
            sh[k] = np.where(use_above, shift_x, shift_y)
        k += 1
    assert k == nd

    return {
        "K": K, "nd": nd, "n_plain": n_plain, "L": L,
        "MODE": np.array([m for m, _, _ in cands], np.int32),
        "DELTA": np.array([d for _, d, _ in cands], np.int32),
        "CLS": np.array([cl for _, _, cl in cands], np.int32),
        "IDXa": idxa.astype(np.int32), "IDXb": idxb.astype(np.int32),
        "SH": sh.astype(np.int32),
    }


def _filter_edge_b(edge, strength: int):
    """Batched av1_filter_intra_edge_c: edge (B, sz) int32; position 0
    (the corner) is used as a neighbour but never modified."""
    if strength == 0:
        return edge
    sz = edge.shape[1]
    kern = jnp.asarray(_FILTER_KERNELS[strength - 1], jnp.int32)
    idx = np.clip(np.arange(sz)[:, None] + np.arange(-2, 3)[None, :],
                  0, sz - 1)
    s = (edge[:, idx] * kern[None, None, :]).sum(-1)
    out = (s + 8) >> 4
    return jnp.concatenate([edge[:, :1], out[:, 1:]], axis=1)


def build_edge_buffer(above, left, tl, have_a, have_l, trreal, blreal,
                      abext, lfext, bs: int):
    """(B, L) unified edge buffer for the directional gathers.

    above/left: (B, bs) raw gathered recon edges; tl (B,); have_a/have_l
    (B,) bool; trreal/blreal (B,) bool select REAL top-right/bottom-left
    extension pixels (abext/lfext, (B, bs)) over replication — positions
    where the normative availability says the decoder reads real pixels
    (masks guarantee those lanes only fire where abext/lfext are valid).
    """
    ha = have_a[:, None]
    hl = have_l[:, None]
    above_eff = jnp.where(ha, above, jnp.where(hl, left[:, :1], 127))
    left_eff = jnp.where(hl, left, jnp.where(ha, above[:, :1], 129))
    tl_eff = jnp.where(have_a & have_l, tl,
                       jnp.where(have_a, above[:, 0],
                                 jnp.where(have_l, left[:, 0], 128)))

    trpix = jnp.where(trreal[:, None], abext,
                      jnp.broadcast_to(above_eff[:, bs - 1 :],
                                       above_eff.shape))
    blpix = jnp.where(blreal[:, None], lfext,
                      jnp.broadcast_to(left_eff[:, bs - 1 :],
                                       left_eff.shape))

    # z2 corner smoothing (reconintra.c: need_above && need_left && wh>=24)
    c2 = (left_eff[:, 0] * 5 + tl_eff * 6 + above_eff[:, 0] * 5 + 8) >> 4

    a1 = jnp.concatenate([tl_eff[:, None], above_eff, trpix], axis=1)
    l3 = jnp.concatenate([tl_eff[:, None], left_eff, blpix], axis=1)
    a2c = jnp.concatenate([c2[:, None], above_eff], axis=1)
    l2c = jnp.concatenate([c2[:, None], left_eff], axis=1)
    B = above.shape[0]
    pad127 = jnp.full((B, 1), 127, jnp.int32)
    pad129 = jnp.full((B, 1), 129, jnp.int32)

    segs = []
    for s in range(4):
        segs.append(_filter_edge_b(a1, s))
    for s in range(4):
        segs.append(jnp.concatenate([pad127, _filter_edge_b(a2c, s)], axis=1))
    for s in range(4):
        segs.append(jnp.concatenate([pad129, _filter_edge_b(l2c, s)], axis=1))
    for s in range(4):
        segs.append(_filter_edge_b(l3, s))
    return jnp.concatenate(segs, axis=1)


def dir_predict(E, ef_type, bs: int):
    """Directional predictions: (nd, B, bs, bs) int32 from the edge buffer
    E (B, L) and the per-block edge-filter type bit ef_type (B,).

    The gathers use STATIC index arrays (one per edge-filter type,
    selected per block afterwards). A per-block ``take_along_axis`` form
    runs the 1080p luma wavefront in the same time on an H100 (49.4 vs
    49.4 ms, CHANGES.md), so the static form stays."""
    tab = tables(bs)
    SH = jnp.asarray(tab["SH"])      # (nd, bs, bs)
    B = E.shape[0]
    nd = SH.shape[0]

    def static_gather(idx):          # idx numpy (nd, bs, bs)
        return E[:, idx.reshape(-1)].reshape(B, nd, bs, bs)

    va0 = static_gather(tab["IDXa"][0])
    vb0 = static_gather(tab["IDXb"][0])
    va1 = static_gather(tab["IDXa"][1])
    vb1 = static_gather(tab["IDXb"][1])
    t = ef_type[:, None, None, None]
    va = jnp.where(t, va1, va0)
    vb = jnp.where(t, vb1, vb0)
    pred = (va * (32 - SH[None]) + vb * SH[None] + 16) >> 5
    return jnp.transpose(pred, (1, 0, 2, 3))


def allowed_mask(okz1, okz2, okz3, bs: int):
    """(K, B) bool candidate mask from the per-class position masks (B,)."""
    tab = tables(bs)
    cls = jnp.asarray(tab["CLS"])    # (K,)
    ones = jnp.ones_like(okz1)
    per_cls = jnp.stack([ones, okz1, okz2, okz3])  # (4, B)
    return per_cls[cls]


# ----------------------------------------------------------------------
# host-side availability masks
# ----------------------------------------------------------------------
def position_masks(mi_rows: int, tile_mi_w: int, vis_mi_w: int,
                   R: int, C: int):
    """Per-position candidate-class masks for the two-level plan.

    mi_rows: frame mi rows; tile_mi_w: the tile's ACTUAL mi width (bounds
    right_avail — tiles are prediction-independent); vis_mi_w: visible mi
    width in this tile (== tile_mi_w except the last tile). All coords
    tile-local. Returns dict of bool grids:
      ok1_32/ok2_32/ok3_32 (R, C);
      ok1_16/ok2_16/ok3_16/trreal_16/blreal_16 (2R, 2C).
    """
    from ..normative import intra_avail as IA
    from ..normative.enums import BlockSize, TxSize
    NONE = 0  # PARTITION_NONE (leaf blocks of the two-level plan)
    b32, t32 = int(BlockSize.BLOCK_32X32), int(TxSize.TX_32X32)
    b16, t16 = int(BlockSize.BLOCK_16X16), int(TxSize.TX_16X16)

    ok1_32 = np.zeros((R, C), bool)
    ok2_32 = np.zeros((R, C), bool)
    ok3_32 = np.zeros((R, C), bool)
    for r in range(R):
        for c in range(C):
            mi_r, mi_c = 8 * r, 8 * c
            align = (vis_mi_w >= mi_c + 8) and (mi_rows >= mi_r + 8)
            top = mi_r > 0
            left = mi_c > 0
            right = mi_c + 8 < tile_mi_w
            bottom = mi_r + 8 < mi_rows
            if not align:
                continue
            htr = IA.has_top_right(16, b32, mi_r, mi_c, top, right, NONE,
                                   t32, 0, 0, 0, 0)
            hbl = IA.has_bottom_left(16, b32, mi_r, mi_c, bottom, left,
                                     NONE, t32, 0, 0, 0, 0)
            # at 32 granularity no real TR/BL pixels exist in wavefront
            # order (same/next anti-diagonal) — only replication positions
            ok1_32[r, c] = top and htr == 0
            ok2_32[r, c] = top and left
            ok3_32[r, c] = left and hbl == 0

    R2, C2 = 2 * R, 2 * C
    ok1_16 = np.zeros((R2, C2), bool)
    ok2_16 = np.zeros((R2, C2), bool)
    ok3_16 = np.zeros((R2, C2), bool)
    trreal = np.zeros((R2, C2), bool)
    blreal = np.zeros((R2, C2), bool)
    for i in range(R2):
        for j in range(C2):
            mi_r, mi_c = 4 * i, 4 * j
            align = (vis_mi_w >= mi_c + 4) and (mi_rows >= mi_r + 4)
            top = mi_r > 0
            left = mi_c > 0
            right = mi_c + 4 < tile_mi_w
            bottom = mi_r + 4 < mi_rows
            if not align:
                continue
            htr = IA.has_top_right(16, b16, mi_r, mi_c, top, right, NONE,
                                   t16, 0, 0, 0, 0)
            hbl = IA.has_bottom_left(16, b16, mi_r, mi_c, bottom, left,
                                     NONE, t16, 0, 0, 0, 0)
            # real TR pixels exist in wavefront+Z order only for left-half
            # quads (qc==0): quad (0,0) reads the above-cell row, quad
            # (1,0) reads quad (0,1)'s recon inside the cell
            tr_avail = (j % 2 == 0)
            # real BL pixels only for quad (0,0): the left cell's column
            bl_avail = (i % 2 == 0) and (j % 2 == 0)
            ok1_16[i, j] = top and (htr == 0 or tr_avail)
            ok2_16[i, j] = top and left
            ok3_16[i, j] = left and (hbl == 0 or bl_avail)
            trreal[i, j] = bool(htr == 1 and tr_avail)
            blreal[i, j] = bool(hbl == 1 and bl_avail)

    return {"ok1_32": ok1_32, "ok2_32": ok2_32, "ok3_32": ok3_32,
            "ok1_16": ok1_16, "ok2_16": ok2_16, "ok3_16": ok3_16,
            "trreal_16": trreal, "blreal_16": blreal}
