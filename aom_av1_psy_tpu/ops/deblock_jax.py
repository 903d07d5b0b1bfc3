"""On-device (jax) deblocking for the fused encoder's grids.

The general AV1 loop filter (``ops/deblock.py``, conformance-proven
host path) walks edges sequentially with per-edge parameter derivation
(av1/common/av1_loopfilter.c). For the fused plan's restricted geometry —
TX == block size, aligned 32/16 luma cells (8/16 chroma), uniform filter
level (delta_lf off), sharpness 0 — every edge's parameters collapse:

  * filter length is CONSTANT per plane: min(tx)/4 >= 4 on luma ⇒ 14-tap
    everywhere; >= 2 on chroma ⇒ 6-tap everywhere;
  * an edge exists at a cell boundary iff the boundary is a tx origin
    (split cell, or an even cell index for the unsplit 32);
  * all edges are INDEPENDENT: a 14-tap filter writes ±6 around its edge
    and reads ±7, and edges are >= 16 px apart (8 px with ±2 writes / ±3
    reads on chroma), so the spec's sequential walk and band interleaving
    equal one parallel gather→filter→scatter per direction — data-parallel
    device work, and the reason the filter can run inside the plan epilogue and
    on the inter reference chain (VERDICT r4 #2).

Bit-exactness vs the host walker is asserted in tests/test_deblock_jax.py.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def _clamp127(v):
    return jnp.clip(v, -128, 127)


def _filter4(p1, p0, q0, q1, mask, hev):
    ps1, ps0 = p1 - 128, p0 - 128
    qs0, qs1 = q0 - 128, q1 - 128
    f = _clamp127(ps1 - qs1) * hev
    f = _clamp127(f + 3 * (qs0 - ps0)) * mask
    f1 = _clamp127(f + 4) >> 3
    f2 = _clamp127(f + 3) >> 3
    oq0 = _clamp127(qs0 - f1) + 128
    op0 = _clamp127(ps0 + f2) + 128
    f = ((f1 + 1) >> 1) * (1 - hev)
    oq1 = _clamp127(qs1 - f) + 128
    op1 = _clamp127(ps1 + f) + 128
    return op1, op0, oq0, oq1


def _r3(v):
    return (v + 4) >> 3


def _r4(v):
    return (v + 8) >> 4


def _filter_seg14(px, on, level):
    """Length-14 luma edge filter on (N, 14) segments (p6..p0,q0..q6).

    ``on`` (N,) int mask; ``level`` traced scalar (sharpness 0). Mirrors
    ops/deblock._filter_edge for length==14 exactly.
    Returns the modified 12 middle taps (N, 12) = indices 1..12.
    """
    lim = jnp.maximum(level, 1)
    blimit = 2 * (level + 2) + lim
    thresh = level >> 4
    p = [px[:, 6 - i] for i in range(7)]
    q = [px[:, 7 + i] for i in range(7)]
    ab = lambda a, b: jnp.abs(a - b)

    fm2 = ~((ab(p[1], p[0]) > lim) | (ab(q[1], q[0]) > lim)
            | (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 > blimit))
    fm3 = fm2 & ~((ab(p[2], p[1]) > lim) | (ab(q[2], q[1]) > lim))
    fm4 = fm3 & ~((ab(p[3], p[2]) > lim) | (ab(q[3], q[2]) > lim))
    flat3 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[2], p[0]) > 1) | (ab(q[2], q[0]) > 1))
    flat4 = flat3 & ~((ab(p[3], p[0]) > 1) | (ab(q[3], q[0]) > 1))
    flat2 = ~((ab(p[1], p[0]) > 1) | (ab(q[1], q[0]) > 1)
              | (ab(p[4], p[0]) > 1) | (ab(q[4], q[0]) > 1)
              | (ab(p[5], p[0]) > 1) | (ab(q[5], q[0]) > 1)
              | (ab(p[6], p[0]) > 1) | (ab(q[6], q[0]) > 1))

    mask = fm4 & on.astype(bool)
    hev = ((ab(p[1], p[0]) > thresh) | (ab(q[1], q[0]) > thresh)) \
        .astype(jnp.int32)
    n4p1, n4p0, n4q0, n4q1 = _filter4(p[1], p[0], q[0], q[1],
                                      mask.astype(jnp.int32), hev)

    wide8 = flat4 & mask
    wide14 = flat4 & flat2 & mask
    narrow = mask & ~wide8

    out = [px[:, i] for i in range(14)]
    for idx, v in ((5, n4p1), (6, n4p0), (7, n4q0), (8, n4q1)):
        out[idx] = jnp.where(narrow, v, out[idx])

    w8 = wide8 & ~wide14
    o2 = _r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0])
    o1 = _r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1])
    o0 = _r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2])
    u0 = _r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3])
    u1 = _r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2)
    u2 = _r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3)
    for idx, v in ((4, o2), (5, o1), (6, o0), (7, u0), (8, u1), (9, u2)):
        out[idx] = jnp.where(w8, v, out[idx])

    w14 = wide14
    o5 = _r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0]
             + q[0])
    o4 = _r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0]
             + q[0] + q[1])
    o3 = _r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0]
             + q[0] + q[1] + q[2])
    o2 = _r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0]
             + q[0] + q[1] + q[2] + q[3])
    o1 = _r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2
             + q[0] + q[1] + q[2] + q[3] + q[4])
    o0 = _r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
             + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5])
    u0 = _r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
             + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6])
    u1 = _r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
             + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2)
    u2 = _r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
             + q[3] * 2 + q[4] + q[5] + q[6] * 3)
    u3 = _r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
             + q[4] * 2 + q[5] + q[6] * 4)
    u4 = _r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
             + q[5] * 2 + q[6] * 5)
    u5 = _r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
             + q[6] * 7)
    for idx, v in ((1, o5), (2, o4), (3, o3), (4, o2), (5, o1), (6, o0),
                   (7, u0), (8, u1), (9, u2), (10, u3), (11, u4), (12, u5)):
        out[idx] = jnp.where(w14, v, out[idx])
    return jnp.stack(out[1:13], axis=-1)


def _filter_seg6(px, on, level):
    """Length-6 chroma edge filter on (N, 6) segments (p2,p1,p0,q0,q1,q2).
    Returns the modified 4 middle taps (N, 4) = p1,p0,q0,q1."""
    lim = jnp.maximum(level, 1)
    blimit = 2 * (level + 2) + lim
    thresh = level >> 4
    p2, p1, p0, q0, q1, q2 = (px[:, i] for i in range(6))
    ab = lambda a, b: jnp.abs(a - b)
    fm2 = ~((ab(p1, p0) > lim) | (ab(q1, q0) > lim)
            | (ab(p0, q0) * 2 + ab(p1, q1) // 2 > blimit))
    fm3 = fm2 & ~((ab(p2, p1) > lim) | (ab(q2, q1) > lim))
    flat3 = ~((ab(p1, p0) > 1) | (ab(q1, q0) > 1)
              | (ab(p2, p0) > 1) | (ab(q2, q0) > 1))
    mask = fm3 & on.astype(bool)
    hev = ((ab(p1, p0) > thresh) | (ab(q1, q0) > thresh)).astype(jnp.int32)
    n4p1, n4p0, n4q0, n4q1 = _filter4(p1, p0, q0, q1,
                                      mask.astype(jnp.int32), hev)
    wide6 = flat3 & mask
    narrow = mask & ~wide6
    o1 = _r3(p2 * 3 + p1 * 2 + p0 * 2 + q0)
    o0 = _r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1)
    u0 = _r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2)
    u1 = _r3(p0 + q0 * 2 + q1 * 2 + q2 * 3)
    outs = []
    for nar, wid, orig in ((n4p1, o1, p1), (n4p0, o0, p0),
                           (n4q0, u0, q0), (n4q1, u1, q1)):
        outs.append(jnp.where(narrow, nar, jnp.where(wide6, wid, orig)))
    return jnp.stack(outs, axis=-1)


def _edge_geometry(cell: int, w: int, h: int, bufshape):
    """Static boundary lists + line extents for one plane."""
    n4c = (w + 3) // 4
    n4r = (h + 3) // 4
    ks_v = [k for k in range(1, bufshape[1] // cell + 1)
            if cell * k < 4 * n4c]
    ks_h = [k for k in range(1, bufshape[0] // cell + 1)
            if cell * k < 4 * n4r]
    nl_v = min(n4r * 4, bufshape[0])
    nl_h = min(n4c * 4, bufshape[1])
    return ks_v, ks_h, nl_v, nl_h


@functools.partial(jax.jit, static_argnames=("cell", "w", "h", "luma"))
def deblock_plane_fused(buf, split16, lvl_v, lvl_h, *, cell: int, w: int,
                        h: int, luma: bool):
    """Filter one plane of the fused plan's recon on device.

    buf (Hb, Wb) int32; split16 (R2, C2) bool per-cell split map (cell =
    16 px luma / 8 px chroma — the same grid indexes both); lvl_v/lvl_h
    traced scalars (uniform levels, delta off). w/h: cropped plane dims.
    """
    ks_v, ks_h, nl_v, nl_h = _edge_geometry(cell, w, h, buf.shape)
    taps = 14 if luma else 6
    half = taps // 2
    wr0 = 1 if luma else 1           # first written tap index
    nw = 12 if luma else 4           # written taps per edge
    filt = _filter_seg14 if luma else _filter_seg6

    if ks_v:
        xs = np.asarray(ks_v) * cell                       # (Kv,)
        cols = (xs[:, None] - half + np.arange(taps))      # (Kv, taps)
        seg = buf[:nl_v][:, cols]                          # (NL, Kv, taps)
        i_of_y = np.arange(nl_v) // cell
        karr = np.asarray(ks_v)
        tu = np.zeros((nl_v, len(ks_v)), bool)
        tu[:, karr % 2 == 0] = True
        tu_dyn = split16[i_of_y][:, karr] | jnp.asarray(tu)
        on = tu_dyn & (lvl_v > 0)
        N = nl_v * len(ks_v)
        res = filt(seg.reshape(N, taps), on.reshape(N),
                   lvl_v).reshape(nl_v, len(ks_v), nw)
        wcols = (xs[:, None] - half + wr0 + np.arange(nw))
        buf = buf.at[:nl_v, jnp.asarray(wcols)].set(res)

    if ks_h:
        ys = np.asarray(ks_h) * cell
        rows = (ys[:, None] - half + np.arange(taps))
        seg = buf[rows][:, :, :nl_h]                       # (Kh, taps, NL)
        seg = jnp.transpose(seg, (2, 0, 1))                # (NL, Kh, taps)
        j_of_x = np.arange(nl_h) // cell
        karr = np.asarray(ks_h)
        tu = np.zeros((nl_h, len(ks_h)), bool)
        tu[:, karr % 2 == 0] = True
        tu_dyn = split16[karr][:, j_of_x].T | jnp.asarray(tu)  # (NL, Kh)
        on = tu_dyn & (lvl_h > 0)
        N = nl_h * len(ks_h)
        res = filt(seg.reshape(N, taps), on.reshape(N),
                   lvl_h).reshape(nl_h, len(ks_h), nw)
        wrows = (ys[:, None] - half + wr0 + np.arange(nw))
        buf = buf.at[jnp.asarray(wrows), :nl_h].set(
            jnp.transpose(res, (1, 2, 0)))
    return buf


@functools.partial(jax.jit, static_argnames=("w", "h", "nplanes"))
def lpf_pick_and_filter(planes, srcs, split16, cands, *, w: int, h: int,
                        nplanes: int):
    """Device LPF ladder (av1_pick_filter_level analogue) + apply.

    planes/srcs: tuples of device int32 arrays (pre-LPF recon, source),
    luma first; split16 (2R, 2C) bool; cands (L,) int32 candidate levels
    (level 0 must be one of them). Each plane picks its own level by MSE
    over the cropped frame; chroma levels are zeroed when luma picks 0
    (they are only codable with a nonzero luma level). Returns
    (levels (3,) int32, filtered planes tuple).
    """
    cands = jnp.asarray(cands, jnp.int32)

    def eval_plane(p, buf, src, pw, ph, cell, luma):
        def run(lvl):
            return deblock_plane_fused(buf, split16, lvl, lvl, cell=cell,
                                       w=pw, h=ph, luma=luma)
        outs = jax.vmap(run)(cands)                       # (L, Hb, Wb)
        d = outs[:, :ph, :pw] - src[None, :ph, :pw]
        # int32 would overflow the frame-wide SSE (2e6 px * 255^2) and
        # x64 is disabled; f32 accumulation can flip near-tied candidates
        # only, which changes nothing normative (the picked level is
        # signalled either way)
        mse = (d * d).astype(jnp.float32).sum((1, 2))
        best = jnp.argmin(mse)                            # first-best ties
        return cands[best], outs[best]

    lvl_y, out_y = eval_plane(0, planes[0], srcs[0], w, h, 16, True)
    levels = [lvl_y]
    outs = [out_y]
    if nplanes > 1:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for p in (1, 2):
            lvl, out = eval_plane(p, planes[p], srcs[p], cw, ch, 8, False)
            lvl = jnp.where(lvl_y > 0, lvl, 0)
            out = jnp.where(lvl_y > 0, out, planes[p])
            levels.append(lvl)
            outs.append(out)
    else:
        levels += [jnp.int32(0), jnp.int32(0)]
    return jnp.stack(levels), tuple(outs)


@functools.partial(jax.jit, static_argnames=("w", "h", "nplanes"))
def lpf_apply(planes, split16, levels, *, w: int, h: int, nplanes: int):
    """Apply given (3,) levels to the plane tuple (no search)."""
    out = [deblock_plane_fused(planes[0], split16, levels[0], levels[0],
                               cell=16, w=w, h=h, luma=True)]
    if nplanes > 1:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for p in (1, 2):
            out.append(deblock_plane_fused(planes[p], split16, levels[p],
                                           levels[p], cell=8, w=cw, h=ch,
                                           luma=False))
    return tuple(out)
