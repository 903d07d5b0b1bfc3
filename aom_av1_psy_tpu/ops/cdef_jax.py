"""On-device (jax) CDEF apply for the fused encoder's grids.

Ports the conformance-proven host CDEF (`ops/cdef.py`, av1/common/cdef.c
semantics) to a single jitted whole-frame program for the fused path's
case: frame-level strengths (cdef_bits=0), 8-bit 4:2:0, 64x64-SB units
all coded. Every CDEF tap reads pre-CDEF (post-deblock) pixels, so the
frame filters as a pure function of one padded copy, fully parallel
over 8x8 blocks.

The direction-dependent taps are computed as 8 STATIC shifts of each
block's context, selected per block by a small take; a per-block
dynamic gather runs the 1080p apply in the same time on an H100
(CHANGES.md), so the static form stays.

The DIRECTION search stays on the host (ops/cdef.find_dir_blocks):
it is NORMATIVE (the decoder recomputes it from the same pixels) and
its cost comparisons need exact 64-bit integers, which JAX does not use
here (x64 off; f32 einsum ties could silently diverge from the
decoder).

Strengths are TRACED scalars: a future device strength search is a vmap
over candidates with no recompilation.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .cdef import DIRS, PRI_TAPS, SEC_TAPS, CDEF_VERY_LARGE

def floor_log2(x):
    """Integer floor(log2(max(x, 1))) of an int32 array: the bit length
    minus one, exact on every backend (a float log2 can land one ulp
    under an exact power of two)."""
    x = jnp.asarray(x, jnp.int32)
    return 31 - jax.lax.clz(jnp.maximum(x, 1))


def _adjust_strength(strength, var):
    """av1_cdef_filter's luma strength adjustment (adjust_strength):
    strength * (4 + min(msb(var>>6), 12)) + 8 >> 4, 0 when var == 0.
    strength is a traced scalar, var (B,)."""
    i = jnp.minimum(floor_log2(var >> 6), 12)
    adj = (strength * (4 + i) + 8) >> 4
    return jnp.where(var != 0, adj, 0)


def _constrain(diff, threshold, damping):
    """cdef constrain with a TRACED threshold: shift = max(0,
    damping - bit_length(threshold) + 1) = damping - floor(log2(t))."""
    tbl = jnp.maximum(damping - floor_log2(threshold), 0)
    a = jnp.abs(diff)
    v = jnp.sign(diff) * jnp.minimum(
        a, jnp.maximum(0, threshold - (a >> tbl)))
    return jnp.where(threshold == 0, 0, v)


def _plane_blocks(pad, nb_r, nb_c, bh, bw):
    """(B, bh+4, bw+4) contexts from a padded plane, static indices."""
    by = np.arange(nb_r) * bh
    bx = np.arange(nb_c) * bw
    rows = np.broadcast_to(
        by[:, None, None] + np.arange(bh + 4)[None, None, :],
        (nb_r, nb_c, bh + 4))
    cols = np.broadcast_to(
        bx[None, :, None] + np.arange(bw + 4)[None, None, :],
        (nb_r, nb_c, bw + 4))
    ctx = pad[rows[:, :, :, None], cols[:, :, None, :]]
    return ctx.reshape(nb_r * nb_c, bh + 4, bw + 4)


def _filter_plane(pad, dirs, pri_t, sec_t, damping, nb_r, nb_c, bh, bw,
                  touched):
    """Filter one plane's (nb_r*nb_c) blocks; returns (B, bh, bw).

    pad: (H+4, W+4) with CDEF_VERY_LARGE outside; dirs/pri_t (B,);
    sec_t/damping traced scalars; touched (B,) gates skip units.
    """
    ctx = _plane_blocks(pad, nb_r, nb_c, bh, bw)       # (B, bh+4, bw+4)
    B = ctx.shape[0]
    x = ctx[:, 2 : 2 + bh, 2 : 2 + bw]
    total = jnp.zeros((B, bh, bw), jnp.int32)
    mx = x
    mn = x

    def taps_all_dirs(ring):
        """(8, B, bh, bw) pixel reads for every direction (static
        shifts), selected per block afterwards."""
        outs = []
        for d in range(8):
            dy, dx = int(DIRS[d, ring, 0]), int(DIRS[d, ring, 1])
            outs.append((dy, dx))
        return outs

    for k in range(2):
        offs = taps_all_dirs(k)
        # primary: direction = dirs
        p_all = jnp.stack([
            ctx[:, 2 + dy : 2 + dy + bh, 2 + dx : 2 + dx + bw]
            for dy, dx in offs])                        # (8, B, bh, bw)
        n_all = jnp.stack([
            ctx[:, 2 - dy : 2 - dy + bh, 2 - dx : 2 - dx + bw]
            for dy, dx in offs])
        sel = dirs[None, :, None, None]
        p = jnp.take_along_axis(p_all, sel, axis=0)[0]
        pneg = jnp.take_along_axis(n_all, sel, axis=0)[0]
        # secondary: directions +/- 2 (same static shift stack)
        sel_p2 = ((dirs + 2) & 7)[None, :, None, None]
        sel_m2 = ((dirs - 2) & 7)[None, :, None, None]
        s_p = jnp.take_along_axis(p_all, sel_p2, axis=0)[0]
        s_m = jnp.take_along_axis(p_all, sel_m2, axis=0)[0]
        s_pn = jnp.take_along_axis(n_all, sel_p2, axis=0)[0]
        s_mn = jnp.take_along_axis(n_all, sel_m2, axis=0)[0]

        # taps: PRI_TAPS[pri_t & 1][k] is per-block via where
        tap_even = PRI_TAPS[0][k]
        tap_odd = PRI_TAPS[1][k]
        tap = jnp.where((pri_t & 1) == 1, tap_odd, tap_even)[:, None, None]
        for pv in (p, pneg):
            valid = pv != CDEF_VERY_LARGE
            mx = jnp.where(valid, jnp.maximum(pv, mx), mx)
            mn = jnp.minimum(pv, mn)
            contrib = tap * _constrain(pv - x, pri_t[:, None, None],
                                       damping)
            total = total + jnp.where((pri_t != 0)[:, None, None],
                                      contrib, 0)
        for sv in (s_p, s_m, s_pn, s_mn):
            valid = sv != CDEF_VERY_LARGE
            mx = jnp.where(valid, jnp.maximum(sv, mx), mx)
            mn = jnp.minimum(sv, mn)
            total = total + jnp.where(
                sec_t != 0,
                SEC_TAPS[k] * _constrain(sv - x, sec_t, damping), 0)

    y = x + ((8 + total - (total < 0)) >> 4)
    clip = (pri_t != 0)[:, None, None] & (sec_t != 0)
    y = jnp.where(clip, jnp.clip(y, mn, mx), y)
    untouched = ((pri_t == 0)[:, None, None] & (sec_t == 0)) \
        | ~touched[:, None, None]
    return jnp.where(untouched, x, y)


@functools.partial(jax.jit, static_argnames=("mi_rows", "mi_cols",
                                             "nplanes"))
def cdef_apply_fused(planes, skip8, dirs, var, y_pri, y_sec, uv_pri,
                     uv_sec, damping, *, mi_rows: int, mi_cols: int,
                     nplanes: int):
    """Apply frame-level CDEF on device (cdef_bits=0, 4:2:0, 8-bit).

    planes: (y, u, v) device int32 (mi-aligned or larger); skip8
    (ceil(mi_rows/2), ceil(mi_cols/2)) bool — True where the 8x8 unit is
    all-skip (untouched); dirs/var (nb,) per 8x8 block in raster order —
    computed EXACTLY on the host (ops/cdef.find_dir_blocks int64: the
    direction search is NORMATIVE, the decoder recomputes it from the
    same pixels, and its tie-exact cost comparisons need 64-bit ints);
    strengths/damping traced ints. Returns the
    filtered planes written back into the input shapes.
    """
    mh, mw = mi_rows * 4, mi_cols * 4
    nb_r, nb_c = mh // 8, mw // 8
    y = planes[0]
    ypad = jnp.full((mh + 4, mw + 4), CDEF_VERY_LARGE, jnp.int32)
    ypad = ypad.at[2 : 2 + mh, 2 : 2 + mw].set(y[:mh, :mw])
    touched = ~skip8[:nb_r, :nb_c].reshape(-1)

    pri_y = _adjust_strength(y_pri, var)
    # cdef.c: dir participates only when the plane's primary strength is
    # nonzero (use_dirs = pri_strength ? dir : 0) — the secondary taps of
    # a pri=0 plane read direction 0's offsets
    dirs_y = jnp.where(y_pri != 0, dirs, 0)
    dirs_uv = jnp.where(uv_pri != 0, dirs, 0)
    out_y = _filter_plane(ypad, dirs_y, pri_y, y_sec, damping, nb_r, nb_c,
                          8, 8, touched)
    newy = y.at[:mh, :mw].set(
        out_y.reshape(nb_r, nb_c, 8, 8).transpose(0, 2, 1, 3)
        .reshape(mh, mw))
    outs = [newy]
    if nplanes > 1:
        pri_uv = jnp.full((nb_r * nb_c,), uv_pri, jnp.int32)
        for p in (1, 2):
            pl = planes[p]
            ch, cw = mh // 2, mw // 2
            ppad = jnp.full((ch + 4, cw + 4), CDEF_VERY_LARGE, jnp.int32)
            ppad = ppad.at[2 : 2 + ch, 2 : 2 + cw].set(pl[:ch, :cw])
            out_p = _filter_plane(ppad, dirs_uv, pri_uv, uv_sec,
                                  damping - 1, nb_r, nb_c, 4, 4, touched)
            newp = pl.at[:ch, :cw].set(
                out_p.reshape(nb_r, nb_c, 4, 4).transpose(0, 2, 1, 3)
                .reshape(ch, cw))
            outs.append(newp)
    return tuple(outs)
