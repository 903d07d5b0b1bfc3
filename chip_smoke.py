#!/usr/bin/env python3
"""Smoke run of the fused AV1 encoder on one GPU at 1920x1080.

One process, phases in order; the first failing phase ends the run with a
non-zero exit status and no result line.

  device     JAX must report a GPU; prints the card, the compile-cache
             directory and the native entropy-coder library.
  kernels    device programs against their plain references at 1080p
             shapes: the full-pel motion search (int64 brute-force SSD),
             the CDEF apply and the loop filter (host walkers) and the
             integer transforms (numpy path), bit for bit.
  end2end    one all-intra KEY frame and one 5-frame IPPP GOP with CDEF
             on; every packet is decoded by the repo's decoder and must
             equal the encoder's reference planes exactly.
  cpu        a 352x288 KEY+2P GOP encoded on the CPU and on the card in
             this process: total bytes within 1%, Y-PSNR within 0.05 dB.

With ``--devices 4`` only the multi-device phase runs: a 3840x2160 KEY
frame in 4 tile columns, encoded by the one-device tile loop and sharded
one tile per card; the bitstreams must be byte-identical and decode
closed loop.

The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage: python chip_smoke.py [--devices 1|4]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench  # noqa: E402
from aom_av1_psy_tpu.bitstream.headers import (  # noqa: E402
    FrameHeader, SequenceHeader)
from aom_av1_psy_tpu.decoder.obu import Av1Decoder  # noqa: E402
from aom_av1_psy_tpu.encoder.frame import EncoderConfig  # noqa: E402
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder  # noqa: E402
from aom_av1_psy_tpu.encoder.tpu_interframe import (  # noqa: E402
    _ref_chain_planes, encode_video_tpu)
from aom_av1_psy_tpu.normative.enums import (  # noqa: E402
    BlockSize, TxSize, TxType)

Q = 100


class SmokeFailure(RuntimeError):
    pass


def _check(ok, msg) -> None:
    """A phase's pass condition (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# device
# ----------------------------------------------------------------------
def check_device(count: int = 1):
    """The first ``count`` JAX devices; raises unless they are GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's platform is {devs[0].platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX has {len(devs)}")
    return devs[:count]


def gpu_name_and_power() -> str:
    """``name, power.limit`` per card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def report_device(devs, cache_dir: str) -> None:
    import jax
    from aom_av1_psy_tpu import native
    print(f"device_kind: {devs[0].device_kind}")
    print(f"device_count: {len(jax.devices())}")
    print(f"jax: {jax.__version__}")
    print(f"compile_cache: {cache_dir}")
    if native.get_lib() is None:
        raise RuntimeError(f"native EC library: {native.build_error()}")
    print(f"native_ec: {native.LIB_PATH}")
    print(gpu_name_and_power())


# ----------------------------------------------------------------------
# kernels against their plain references
# ----------------------------------------------------------------------
def _ssd_brute(src, ref, oy, ox, crop_h, crop_w, bw, r):
    """int64 SSD of each block against every offset of its window:
    (B, (2r+1)^2), the same clamped window as the device search."""
    span = np.arange(bw + 2 * r) - r
    ys = np.clip(oy[:, None] + span, 0, crop_h - 1)
    xs = np.clip(ox[:, None] + span, 0, crop_w - 1)
    win = ref[ys[:, :, None], xs[:, None, :]].astype(np.int64)
    s = src.astype(np.int64)
    n = 2 * r + 1
    ssd = np.empty((len(oy), n, n), np.int64)
    for dy in range(n):
        for dx in range(n):
            d = win[:, dy : dy + bw, dx : dx + bw] - s
            ssd[:, dy, dx] = np.einsum("bij,bij->b", d, d)
    return ssd.reshape(len(oy), n * n)


def check_fullpel(src_y, ref_y, seed: int = 0) -> dict:
    """Device full-pel search, static-origin and traced-centre calls,
    against the int64 brute-force SSD. A block may differ only where the
    reference has an exact tie at the device's pick."""
    import jax
    import jax.numpy as jnp
    from aom_av1_psy_tpu.encoder.tpu_inter import SEARCH_RAD, _fullpel_search
    h, w = ref_y.shape
    bw, r = 16, SEARCH_RAD
    R2, C2 = -(-h // bw), -(-w // bw)
    src = np.pad(src_y, ((0, R2 * bw - h), (0, C2 * bw - w)), mode="edge")
    B = R2 * C2
    gy = (bw * (np.arange(B) // C2)).astype(np.int32)
    gx = (bw * (np.arange(B) % C2)).astype(np.int32)
    rows = gy[:, None] + np.arange(bw)
    cols = gx[:, None] + np.arange(bw)
    s16 = src[rows[:, :, None], cols[:, None, :]].astype(np.int32)
    ref = ref_y.astype(np.int32)
    rng = np.random.default_rng(seed)
    cy = rng.integers(-r // 2, r // 2 + 1, B).astype(np.int32)
    cx = rng.integers(-r // 2, r // 2 + 1, B).astype(np.int32)

    static = jax.jit(lambda s, f: _fullpel_search(s, f, gy, gx, h, w))
    traced = jax.jit(lambda s, f, a, b: _fullpel_search(
        s, f, gy, gx, h, w, cy=a, cx=b))
    out = {"blocks": B}
    calls = (("static", lambda: static(jnp.asarray(s16), jnp.asarray(ref)),
              np.zeros(B, np.int32), np.zeros(B, np.int32)),
             ("traced", lambda: traced(jnp.asarray(s16), jnp.asarray(ref),
                                       jnp.asarray(cy), jnp.asarray(cx)),
              cy, cx))
    n = 2 * r + 1
    for name, run, oy, ox in calls:
        dy, dx = (np.asarray(v) for v in run())
        ssd = _ssd_brute(s16, ref, gy + oy, gx + ox, h, w, bw, r)
        pick = (dy - oy + r) * n + (dx - ox + r)
        _check(((pick >= 0) & (pick < n * n)).all(),
               f"full-pel {name}: pick outside the window")
        best = ssd.min(axis=1)
        exact = pick == ssd.argmin(axis=1)
        tie = ~exact & (ssd[np.arange(B), pick] == best)
        bad = int((~exact & ~tie).sum())
        _check(bad == 0, f"full-pel {name}: {bad} of {B} blocks off the SSD")
        out[name] = {"exact": int(exact.sum()), "ties": int(tie.sum())}
    return out


def _recon_like(w, h, seed):
    """Synthetic post-LPF recon planes (int32), padded to 32 luma px."""
    f = bench.make_frame(w, h, seed=seed)
    pw, ph = -(-w // 32) * 32, -(-h // 32) * 32
    out = []
    for i, p in enumerate(f.planes()):
        s = 2 if i else 1
        out.append(np.pad(p.astype(np.int32),
                          ((0, ph // s - p.shape[0]),
                           (0, pw // s - p.shape[1])), mode="edge"))
    return out


def check_cdef(w, h, seed: int = 0) -> dict:
    """Device CDEF apply vs the host cdef_frame, two strength sets (the
    second puts primary strengths on exact powers of two)."""
    import jax.numpy as jnp
    from aom_av1_psy_tpu.ops import cdef as HC
    from aom_av1_psy_tpu.ops import cdef_jax as DC
    mi_rows, mi_cols = (h + 7) // 8 * 2, (w + 7) // 8 * 2
    mh, mw = mi_rows * 4, mi_cols * 4
    planes = [p[: mh >> (i > 0), : mw >> (i > 0)]
              for i, p in enumerate(_recon_like(w, h, seed))]
    rng = np.random.default_rng(seed)
    skip = (rng.random((mi_rows, mi_cols)) < 0.3).astype(np.int32)
    skip8 = skip.reshape(mi_rows // 2, 2, mi_cols // 2, 2).all((1, 3))
    yb = planes[0].reshape(mh // 8, 8, mw // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    dirs, var = HC.find_dir_blocks(yb, 0)
    seq = SequenceHeader(max_frame_width=w, max_frame_height=h)
    unit = np.zeros(((mi_rows + 15) // 16, (mi_cols + 15) // 16), np.int32)
    changed = 0
    for yp, ys, up, us, damping in ((4, 2, 3, 1, 5), (8, 3, 4, 2, 6)):
        fh = FrameHeader(width=w, height=h)
        c = fh.cdef
        c.bits, c.damping = 0, damping
        c.y_pri, c.y_sec, c.uv_pri, c.uv_sec = [yp], [ys], [up], [us]
        host = [p.copy() for p in planes]
        HC.cdef_frame(host, skip, unit, fh, seq, mi_rows, mi_cols)
        dev = DC.cdef_apply_fused(
            tuple(jnp.asarray(p) for p in planes), jnp.asarray(skip8),
            jnp.asarray(dirs), jnp.asarray(var.astype(np.int32)),
            yp, ys + (ys == 3), up, us + (us == 3), damping,
            mi_rows=mi_rows, mi_cols=mi_cols, nplanes=3)
        for i, (a, b) in enumerate(zip(host, dev)):
            nd = int((a != np.asarray(b)).sum())
            _check(nd == 0, f"CDEF {(yp, ys, up, us)} plane {i}: {nd} px")
        changed += sum(int((a != p).sum()) for a, p in zip(host, planes))
    _check(changed > 0, "CDEF changed no pixel")
    return {"filtered_px": changed}


def check_lpf(w, h, seed: int = 0) -> dict:
    """Device loop filter (lpf_apply) vs the host walker on every plane."""
    import jax.numpy as jnp
    from aom_av1_psy_tpu.ops import deblock as HB
    from aom_av1_psy_tpu.ops import deblock_jax as DJ
    planes = _recon_like(w, h, seed)
    planes[0][:, ::16] = 128           # blocky columns: long filters fire
    rng = np.random.default_rng(seed)
    ph, pw = planes[0].shape
    split16 = np.repeat(np.repeat(
        rng.integers(0, 2, (ph // 32, pw // 32)).astype(bool), 2, 0), 2, 1)
    mi_rows, mi_cols = (h + 7) // 8 * 2, (w + 7) // 8 * 2
    sp = np.repeat(np.repeat(split16, 4, 0), 4, 1)[:mi_rows, :mi_cols]
    ytx = np.where(sp, int(TxSize.TX_16X16), int(TxSize.TX_32X32))
    uvtx = np.where(sp, int(TxSize.TX_8X8), int(TxSize.TX_16X16))
    bsz = np.where(sp, int(BlockSize.BLOCK_16X16), int(BlockSize.BLOCK_32X32))
    info = HB.DeblockInfo(ytx, bsz, np.zeros_like(ytx), np.zeros_like(ytx),
                          mi_rows, mi_cols)
    seq = SequenceHeader(max_frame_width=w, max_frame_height=h)
    fh = FrameHeader(width=w, height=h)
    levels = (24, 12, 17)
    fh.lf.filter_level = (levels[0], levels[0])
    fh.lf.filter_level_u, fh.lf.filter_level_v = levels[1], levels[2]
    dev = DJ.lpf_apply(tuple(jnp.asarray(p) for p in planes),
                       jnp.asarray(split16), jnp.asarray(levels, jnp.int32),
                       w=mi_cols * 4, h=mi_rows * 4, nplanes=3)
    changed = 0
    for i, (p, d) in enumerate(zip(planes, dev)):
        host = p.copy()
        HB.loop_filter_plane(host, i, info, fh, seq, uv_tx_grid=uvtx)
        nd = int((host != np.asarray(d)).sum())
        _check(nd == 0, f"LPF plane {i}: {nd} px differ")
        changed += int((host != p).sum())
    _check(changed > 0, "LPF changed no pixel")
    return {"filtered_px": changed}


def check_txfm(w, h, seed: int = 0) -> dict:
    """Jitted transforms vs the numpy path of the same code (ops/txfm),
    over every block of a frame, for the sizes and types the fused path
    codes."""
    import jax
    import jax.numpy as jnp
    from aom_av1_psy_tpu.ops import txfm
    a, b = (f.planes()[0].astype(np.int32)
            for f in bench.make_gop(w, h, 2, seed=seed))
    cases = [(TxSize.TX_32X32, TxType.DCT_DCT)] + [
        (ts, tt) for ts in (TxSize.TX_16X16, TxSize.TX_8X8)
        for tt in (TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST,
                   TxType.ADST_ADST)]
    blocks = 0
    for ts, tt in cases:
        n = {TxSize.TX_32X32: 32, TxSize.TX_16X16: 16, TxSize.TX_8X8: 8}[ts]
        hh, ww = h // n * n, w // n * n

        def tiles(x):
            return x[:hh, :ww].reshape(hh // n, n, ww // n, n) \
                .transpose(0, 2, 1, 3).reshape(-1, n, n)

        res, pred = tiles(b - a), tiles(a)
        fwd = jax.jit(functools.partial(txfm.fwd_txfm2d, tx_size=int(ts),
                                        tx_type=int(tt), bd=8))
        want = txfm.fwd_txfm2d(res.astype(np.int64), int(ts), int(tt), bd=8)
        got = np.asarray(fwd(jnp.asarray(res)))
        _check(np.array_equal(want, got), f"fwd {ts.name} {tt.name}")
        coeff = (want // 24 * 24).astype(np.int32)
        inv = jax.jit(functools.partial(txfm.inv_txfm2d_add, tx_size=int(ts),
                                        tx_type=int(tt), bd=8))
        want = txfm.inv_txfm2d_add(coeff, pred, int(ts), int(tt), bd=8)
        got = np.asarray(inv(jnp.asarray(coeff), jnp.asarray(pred)))
        _check(np.array_equal(want, got), f"inv {ts.name} {tt.name}")
        blocks += len(res)
    return {"cases": len(cases), "blocks": blocks}


# ----------------------------------------------------------------------
# end to end
# ----------------------------------------------------------------------
def _closed_loop(pkts, encs, sources) -> list[dict]:
    """Decode the packets in order; every plane of every frame must equal
    the encoder's reference planes. Returns bytes and Y-PSNR per frame."""
    dec = Av1Decoder()
    out = []
    for i, (pkt, enc, src) in enumerate(zip(pkts, encs, sources)):
        frames = dec.decode_packet(pkt)
        _check(len(frames) == 1, f"frame {i}: {len(frames)} shown frames")
        ref = [np.asarray(p) for p in _ref_chain_planes(enc)]
        for p, (d, r) in enumerate(zip(frames[0].planes(), ref)):
            d = d.astype(np.int32)
            nd = int((d != r[: d.shape[0], : d.shape[1]]).sum())
            _check(nd == 0, f"frame {i} plane {p}: {nd} px off closed loop")
        err = frames[0].y.astype(np.float64) - src.y.astype(np.float64)
        mse = float((err * err).mean())
        out.append({"bytes": len(pkt),
                    "y_psnr": 10 * np.log10(255.0 ** 2 / max(mse, 1e-10)),
                    "mse": mse})
    return out


def encode_key(w, h) -> dict:
    """One all-intra KEY frame, encoded twice (the second is timed)."""
    import jax
    frame = bench.make_frame(w, h)
    cfg = EncoderConfig(base_q_idx=Q)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        enc = TpuFrameEncoder(frame, cfg)
        pkt = enc.encode()
        jax.block_until_ready(_ref_chain_planes(enc))
        times.append(time.perf_counter() - t0)
    stats = _closed_loop([pkt], [enc], [frame])[0]
    stats.update(first_s=times[0], steady_s=times[1])
    return stats


def encode_gop(w, h, n: int = 5) -> dict:
    """One IPPP GOP through encode_video_tpu (defaults: CDEF on)."""
    frames = bench.make_gop(w, h, n)
    pkts, encs = encode_video_tpu(frames, EncoderConfig(base_q_idx=Q))
    _check(encs[0].seq.enable_cdef, "CDEF is off in the GOP")
    per = _closed_loop(pkts, encs, frames)
    for s, e in zip(per, encs):
        s["frame_s"] = e.frame_s
    # the KEY and the first P frame compile; later P frames are steady
    steady_p = [e.frame_s for e in encs[2:]] or [encs[-1].frame_s]
    return {"frames": per, "p_steady_s": float(np.median(steady_p))}


def cpu_vs_device(w, h, device) -> dict:
    """The same KEY+2P GOP on the CPU and on ``device``: bytes within 1%
    and Y-PSNR within 0.05 dB (f32 decision sums may reorder)."""
    import jax
    res = {}
    for name, dev in (("cpu", jax.devices("cpu")[0]), ("device", device)):
        with jax.default_device(dev):
            frames = bench.make_gop(w, h, 3)
            pkts, encs = encode_video_tpu(frames, EncoderConfig(base_q_idx=Q))
            per = _closed_loop(pkts, encs, frames)
        mse = float(np.mean([s["mse"] for s in per]))
        res[name] = {"pkts": pkts, "bytes": sum(len(p) for p in pkts),
                     "y_psnr": 10 * np.log10(255.0 ** 2 / max(mse, 1e-10))}
    a, b = res["cpu"], res["device"]
    d_bytes = abs(a["bytes"] - b["bytes"]) / a["bytes"]
    d_psnr = abs(a["y_psnr"] - b["y_psnr"])
    _check(d_bytes <= 0.01, f"bytes differ by {100 * d_bytes:.3f}%")
    _check(d_psnr <= 0.05, f"Y-PSNR differs by {d_psnr:.4f} dB")
    return {"identical": a["pkts"] == b["pkts"],
            "bytes_cpu": a["bytes"], "bytes_device": b["bytes"],
            "y_psnr_cpu": a["y_psnr"], "y_psnr_device": b["y_psnr"]}


def sharded_tiles(w, h, n: int) -> dict:
    """A KEY frame in ``n`` tile columns: the one-device tile loop vs the
    plan sharded one tile per device. Byte-identical, closed loop."""
    from aom_av1_psy_tpu.parallel.mesh import make_mesh
    frame = bench.make_frame(w, h)
    cfg = EncoderConfig(base_q_idx=Q, tile_cols_log2=n.bit_length() - 1)
    times = {}
    pkts = {}
    for name in ("loop", "sharded"):
        enc = TpuFrameEncoder(frame, cfg)
        _check(enc.tile_T == n, f"{enc.tile_T} tiles, not {n}")
        if name == "sharded":
            enc.mesh = make_mesh(n)
        t0 = time.perf_counter()
        pkts[name] = enc.encode()
        times[name] = time.perf_counter() - t0
    _check(pkts["loop"] == pkts["sharded"], (
        f"sharded bitstream differs: {len(pkts['sharded'])} vs "
        f"{len(pkts['loop'])} bytes"))
    stats = _closed_loop([pkts["sharded"]], [enc], [frame])[0]
    stats.update(loop_s=times["loop"], sharded_s=times["sharded"])
    return stats


# ----------------------------------------------------------------------
def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {out}",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-GPU sharded 4K KEY frame")
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)

    # the CPU comparison needs JAX's CPU backend beside the GPU
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax
    devs = check_device(args.devices)
    from aom_av1_psy_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    report_device(devs, cache_dir)
    card = gpu_name_and_power().splitlines()[0]

    if args.devices == 4:
        _phase("sharded 3840x2160 KEY, 4 tiles", sharded_tiles, 3840, 2160, 4)
    else:
        w, h = 1920, 1080
        gop = bench.make_gop(w, h, 2)
        _phase("fullpel 1080p", check_fullpel, gop[1].y, gop[0].y)
        _phase("cdef 1080p", check_cdef, w, h)
        _phase("lpf 1080p", check_lpf, w, h)
        _phase("txfm 1080p", check_txfm, w, h)
        key = _phase("KEY 1080p", encode_key, w, h)
        print(f"KEY 1080p steady {key['steady_s']:.3f} s/frame ({card})")
        g = _phase("IPPP 1080p x5", encode_gop, w, h, 5)
        for i, s in enumerate(g["frames"]):
            print(f"  frame {i}: {s['bytes']} bytes, "
                  f"Y-PSNR {s['y_psnr']:.3f} dB, {s['frame_s']:.3f} s")
        print(f"P 1080p steady {g['p_steady_s']:.3f} s/frame ({card})")
        _phase("cpu vs card 352x288 KEY+2P", cpu_vs_device, 352, 288,
               devs[0])
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
