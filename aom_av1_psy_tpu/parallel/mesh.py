"""Device-mesh sharding for the encode pipeline.

The reference scales with a pthread pool over tiles/SB-rows/frames
(``av1/encoder/ethread.c``, SURVEY §2.8). Here the tile columns of a KEY
frame are sharded over a 1-D ``jax.sharding.Mesh`` ("tiles" axis — spatial
tile parallelism P1): each device runs the fused intra plan of its own
tile, and tiles share no prediction state, so no collective is needed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..normative import tables


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def tile_plans_sharded(mesh: Mesh, slabs: list, q: int, mi_rows: int):
    """Run the fused two-level intra plan for equal tile-column slabs,
    sharded one tile per device over ``mesh`` (tile parallelism P1 on the
    PRODUCT path — av1/encoder/ethread.c:1505 av1_encode_tiles_mt
    analogue). The per-tile computation is the exact integer program of
    ``tpu_intra.plan_frame_part``, so the resulting bitstream is
    byte-identical to the single-device tile loop.

    slabs: list of dicts with y/u/v int32 arrays, an rd (2R,2C) lambda
    grid and mi_cols_eff. Returns a list of per-tile plan dicts."""
    from ..encoder import tpu_intra as TI
    from ..ec.context import FrameContext

    T = len(slabs)
    assert np.prod(mesh.devices.shape) == T, (mesh.devices.shape, T)
    fc = FrameContext(q)
    kf_cost, angle_cost, uv_cost = TI._plan_cost_tables2(fc)
    rt = TI._rate_tables(fc)
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    pr_none, pr_split = TI._part_rate_scalars(fc)
    y0 = slabs[0]["y"]
    R, C = y0.shape[0] // 32, y0.shape[1] // 32

    from ..encoder import tpu_intra_dir as DIR
    _mask_keys = ("ok1_32", "ok2_32", "ok3_32", "ok1_16", "ok2_16",
                  "ok3_16", "trreal_16", "blreal_16")
    tile_masks = []
    for s in slabs:
        m = DIR.position_masks(mi_rows, s["tile_mi_w"], s["vis_mi_w"], R, C)
        tile_masks.append(m)
    masks_st = {k: jnp.stack([jnp.asarray(m[k]) for m in tile_masks])
                for k in _mask_keys}

    ys = jnp.stack([jnp.asarray(s["y"]) for s in slabs])
    us = jnp.stack([jnp.asarray(s["u"]) for s in slabs])
    vs = jnp.stack([jnp.asarray(s["v"]) for s in slabs])
    rd16 = jnp.stack([jnp.asarray(s["rd"], jnp.float32) for s in slabs])
    rd32 = jnp.stack([
        jnp.asarray(np.exp(np.log(np.asarray(s["rd"], np.float64))
                           .reshape(R, 2, C, 2).mean((1, 3))), jnp.float32)
        for s in slabs])
    grids = [TI.partition_edge_grids(mi_rows, s["mi_cols_eff"], R, C)
             for s in slabs]
    forceds = jnp.stack([jnp.asarray(g[0]) for g in grids])
    no_splits = jnp.stack([jnp.asarray(g[1]) for g in grids])
    # last visible luma column of each tile (edge-read clamp)
    last_cols = jnp.asarray([s["vis_mi_w"] * 4 - 1 for s in slabs],
                            jnp.int32)
    kf_cost = jnp.asarray(kf_cost)
    angle_cost = jnp.asarray(angle_cost)
    uv_cost = jnp.asarray(uv_cost)

    def body(y, u, v, rdf, rdc, forced, nos, last_col, *mask_leaves):
        y, u, v = y[0], u[0], v[0]
        rdf, rdc = rdf[0], rdc[0]
        forced, nos, last_col = forced[0], nos[0], last_col[0]
        masks = {k: ml[0] for k, ml in zip(_mask_keys, mask_leaves)}
        split, m32, d32, lv32, e32, m16, d16, lv16, e16, yrec = \
            TI._luma_wavefront_part(
                y, kf_cost, angle_cost, dc_q, ac_q, rdf, rdc, forced, nos,
                pr_none, pr_split, rt["y32"], rt["y16"],
                masks, mi_rows * 4 - 1, last_col, R=R, C=C)
        uvm16, uvlv16, uve16, uvm8, uvlv8, uve8, uvrec = \
            TI._chroma_wavefront_part(
                u, v, uv_cost, dc_q, ac_q, rdf, rdc, split,
                m32, m16, rt["uv16"], rt["uv8"], mi_rows * 2 - 1,
                (last_col + 1) // 2 - 1, R=R, C=C)
        outs = (split, m32, d32, lv32, e32, m16, d16, lv16, e16, yrec,
                uvm16, uvlv16, uve16, uvm8, uvlv8, uve8, uvrec)
        return tuple(o[None] for o in outs)

    n_in = 8 + len(_mask_keys)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("tiles"),) * n_in,
        out_specs=(P("tiles"),) * 17, check_vma=False))
    outs = fn(ys, us, vs, rd16, rd32, forceds, no_splits, last_cols,
              *[masks_st[k] for k in _mask_keys])
    outs = [np.asarray(o) for o in outs]
    (split, m32, d32, lv32, e32, m16, d16, lv16, e16, yrec,
     uvm16, uvlv16, uve16, uvm8, uvlv8, uve8, uvrec) = outs
    plans = []
    for t in range(T):
        plans.append({
            "part": True,
            "split32": split[t].astype(np.uint8),
            "y_mode32": m32[t], "y_mode16": m16[t],
            "y_delta32": d32[t], "y_delta16": d16[t],
            "y_levels32": lv32[t].astype(np.int32),
            "y_levels16": lv16[t].astype(np.int32),
            "y_eob32": e32[t], "y_eob16": e16[t],
            "uv_mode16": uvm16[t], "uv_mode8": uvm8[t],
            "uv_levels16": uvlv16[t].astype(np.int32),
            "uv_levels8": uvlv8[t].astype(np.int32),
            "uv_eob16": uve16[t], "uv_eob8": uve8[t],
            "recon_dev": [yrec[t], uvrec[t][0], uvrec[t][1]],
        })
    return plans
