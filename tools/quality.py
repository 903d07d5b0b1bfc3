#!/usr/bin/env python3
"""BD-rate quality harness — our encoders vs the reference aomenc.

For each synthetic clip and each encoder path, sweeps quantizer points,
collects (bits/frame, global PSNR) rate-distortion points, and reports
Bjontegaard BD-rate deltas against the aomenc anchor (negative = we need
fewer bits at equal PSNR). Reference standard: the PSNR-threshold
end-to-end tests of the reference (test/end_to_end_psnr_test.cc) and the
<=1% BD-rate BASELINE target.

Default modes are the PRODUCT (fused device) paths only — the host-Python
reference encoders take tens of minutes per point and are opt-in via
--modes (VERDICT r4 weak #1). Our q ladder is wider and lower than the
naive qindex=4*cq alignment so the two PSNR ranges overlap and the BD
fit has support (r4's None cells).

Usage: PYTHONPATH=. python tools/quality.py [--out QUALITY.json] [--quick]
       [--modes intra_tpu,inter_tpu,...] [--budget SECONDS_PER_MODE]
       [--device cpu|gpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu.bitstream.containers import write_y4m, write_ivf

AOMENC = "/tmp/refbuild/aomenc"
AOMDEC = "/tmp/refbuild/aomdec"


# ----------------------------------------------------------------------
# synthetic clips (deterministic, content-diverse)
# ----------------------------------------------------------------------
def _plane(h, w, f):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.clip(f(yy, xx), 0, 255).astype(np.uint8)


def clip_gradient(w, h, n, seed=1):
    """Smooth gradients + low-frequency sinusoids, slow pan."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 3.0, (h + 16, w + 16)).astype(np.float32)
    frames = []
    for i in range(n):
        dx = 2 * i
        y = _plane(h, w, lambda yy, xx: 90 + 55 * np.sin((xx + dx) / 83.0)
                   * np.cos(yy / 47.0) + 45 * ((xx + dx) / w)
                   + noise[8 : 8 + h, 8 : 8 + w])
        u = _plane(h // 2, w // 2,
                   lambda yy, xx: 128 + 28 * np.sin((xx + dx / 2) / 67.0))
        v = _plane(h // 2, w // 2,
                   lambda yy, xx: 128 - 24 * np.cos(yy / 59.0))
        frames.append(Frame(y, u, v))
    return frames


def clip_detail(w, h, n, seed=2):
    """High-frequency texture + hard edges (detail-retention stressor)."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 64, (h + 32, w + 32)).astype(np.float32)
    frames = []
    for i in range(n):
        dy = i
        y = _plane(h, w, lambda yy, xx: 60 + tex[dy : dy + h, dy : dy + w]
                   + 80 * (((xx // 24) + (yy // 24)) % 2)
                   + 30 * np.sin(xx / 11.0))
        u = _plane(h // 2, w // 2,
                   lambda yy, xx: 128 + 20 * (((xx // 12) % 2)))
        v = _plane(h // 2, w // 2, lambda yy, xx: 118 + 12 * np.cos(xx / 13.0))
        frames.append(Frame(y, u, v))
    return frames


def clip_noisy(w, h, n, seed=5, sigma=4.0):
    """Static scene + per-frame independent noise (temporal-filter
    showcase: the only clip whose noise is temporal, not part of the
    panned field)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (100 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
            + 25 * ((xx // 32 + yy // 32) % 2))
    out = []
    for _ in range(n):
        y = np.clip(base + rng.normal(0, sigma, (h, w)), 0,
                    255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        out.append(Frame(y, u, v))
    return out


def clip_moving(w, h, n, seed=3):
    """Textured scene with global translation + a moving object."""
    rng = np.random.default_rng(seed)
    pad = 4 * n + 32
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 6, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(n):
        ox = 3 * i
        oy = 2 * i
        y = np.clip(bg[oy : oy + h, ox : ox + w].copy(), 0, 255)
        # moving square object
        bx, by = 20 + 5 * i, 30 + 3 * i
        y[by : by + 40, bx : bx + 40] = 210 - 4 * i
        u = np.full((h // 2, w // 2), 120, np.float32)
        u[(by // 2) : (by + 40) // 2, (bx // 2) : (bx + 40) // 2] = 90
        v = np.full((h // 2, w // 2), 135, np.float32)
        frames.append(Frame(y.astype(np.uint8), u.astype(np.uint8),
                            v.astype(np.uint8)))
    return frames


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
def global_psnr(src_frames, dec_frames):
    """libaom-style global PSNR over all planes of all frames."""
    sse = 0
    samples = 0
    for s, d in zip(src_frames, dec_frames):
        for p_s, p_d in zip(s.planes(), d.planes()):
            p_d = p_d[: p_s.shape[0], : p_s.shape[1]]
            sse += float(((p_s.astype(np.int64) - p_d.astype(np.int64)) ** 2)
                         .sum())
            samples += p_s.size
    if sse == 0:
        return 99.0
    return 10 * np.log10(255.0 ** 2 * samples / sse)


def pareto_front(rates, psnrs):
    """Drop RD points dominated by another point (<= rate AND >= psnr):
    a non-monotone curve (e.g. mid-q quantization pathologies) breaks the
    Bjontegaard fit; the front is what an encoder user would operate on."""
    pts = sorted(zip(rates, psnrs))
    keep = []
    for i, (r, p) in enumerate(pts):
        dominated = any((r2 <= r and p2 >= p and (r2, p2) != (r, p))
                        for r2, p2 in pts)
        if not dominated:
            keep.append((r, p))
    if len(keep) < 2:
        return rates, psnrs
    return [k[0] for k in keep], [k[1] for k in keep]


def bd_rate(anchor_rate, anchor_psnr, test_rate, test_psnr):
    """Bjontegaard delta-rate (%), cubic fit in (psnr, log rate) over the
    Pareto fronts of both curves."""
    anchor_rate, anchor_psnr = pareto_front(anchor_rate, anchor_psnr)
    test_rate, test_psnr = pareto_front(test_rate, test_psnr)
    if len(anchor_rate) < 2 or len(test_rate) < 2:
        return None
    lr1 = np.log(np.asarray(anchor_rate, float))
    lr2 = np.log(np.asarray(test_rate, float))
    p1 = np.asarray(anchor_psnr, float)
    p2 = np.asarray(test_psnr, float)
    o1 = np.argsort(p1)
    o2 = np.argsort(p2)
    p1, lr1 = p1[o1], lr1[o1]
    p2, lr2 = p2[o2], lr2[o2]
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    if hi <= lo:
        return None  # no PSNR overlap
    # piecewise-LINEAR integration in (psnr, log rate): a cubic fit on
    # sparse/cliffy ladders produces wild inter-point excursions (observed
    # -100% artifacts); linear interpolation is the robust, conservative
    # variant of the Bjontegaard measure
    grid = np.linspace(lo, hi, 256)
    v1 = np.interp(grid, p1, lr1)
    v2 = np.interp(grid, p2, lr2)
    avg = float(np.mean(v2 - v1))
    return float((np.exp(avg) - 1) * 100)


# ----------------------------------------------------------------------
# encoders under test
# ----------------------------------------------------------------------
def decode_with_aomdec(ivf_path, w, h, n):
    """Decode through the reference aomdec (oracle) to raw I420 frames."""
    raw = ivf_path + ".raw"
    subprocess.run([AOMDEC, "--rawvideo", "-o", raw, ivf_path],
                   check=True, capture_output=True)
    data = np.fromfile(raw, np.uint8)
    os.unlink(raw)
    fsz = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)
    assert data.size == fsz * n, (data.size, fsz, n)
    out = []
    cw, ch = (w + 1) // 2, (h + 1) // 2
    for i in range(n):
        f = data[i * fsz : (i + 1) * fsz]
        y = f[: w * h].reshape(h, w)
        u = f[w * h : w * h + cw * ch].reshape(ch, cw)
        v = f[w * h + cw * ch :].reshape(ch, cw)
        out.append(Frame(y, u, v))
    return out


def run_aomenc(frames, tmpdir, cq, intra: bool, cpu_used=6):
    w, h = frames[0].width, frames[0].height
    y4m = os.path.join(tmpdir, "src.y4m")
    if not os.path.exists(y4m):
        write_y4m(y4m, frames)
    out = os.path.join(tmpdir, f"aom_{intra}_{cq}.ivf")
    args = [AOMENC, "--passes=1", "--end-usage=q", f"--cq-level={cq}",
            f"--cpu-used={cpu_used}", "--threads=1", "--ivf", "-o", out, y4m]
    if intra:
        args.insert(1, "--kf-max-dist=1")
    else:
        args.insert(1, "--lag-in-frames=0")
    subprocess.run(args, check=True, capture_output=True)
    bits = os.path.getsize(out) * 8 - 32 * 8 - 12 * 8 * len(frames)
    dec = decode_with_aomdec(out, w, h, len(frames))
    return bits / len(frames), global_psnr(frames, dec)


def perceptual_scores(src_frames, dec_frames):
    """Mean PSNR-HVS (dB) and VIF-lite over the clip (ops/metrics.psnr_hvs
    golden-exact vs aom_dsp/psnrhvs.c; encoder/tune_vmaf.vif_lite)."""
    from aom_av1_psy_tpu.ops.metrics import psnr_hvs
    from aom_av1_psy_tpu.encoder.tune_vmaf import vif_lite
    hv, vf = [], []
    for s, d in zip(src_frames, dec_frames):
        sp, dp = s.planes(), d.planes()
        dpc = [p2[: p1.shape[0], : p1.shape[1]] for p1, p2 in zip(sp, dp)]
        hv.append(psnr_hvs(sp, dpc)[0])
        vf.append(float(vif_lite(sp[0].astype(np.float32),
                                 dpc[0].astype(np.float32))))
    return float(np.mean(hv)), float(np.mean(vf))


def run_ours(frames, tmpdir, make_packets, tag):
    w, h = frames[0].width, frames[0].height
    t0 = time.perf_counter()
    packets = make_packets(frames)
    dt = time.perf_counter() - t0
    out = os.path.join(tmpdir, f"ours_{tag}.ivf")
    write_ivf(out, packets, w, h)
    bits = sum(len(p) for p in packets) * 8
    dec = decode_with_aomdec(out, w, h, len(frames))
    hvs, vif = perceptual_scores(frames, dec)
    return bits / len(frames), global_psnr(frames, dec), dt, hvs, vif


# ----------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="QUALITY_r05.json")
    ap.add_argument("--quick", action="store_true",
                    help="fewer q points / smaller clips")
    ap.add_argument("--modes", default="intra_tpu,inter_tpu",
                    help="comma list from intra_tpu,intra_tpu_cdef,"
                    "intra_host,inter_tpu,inter_ippp (host modes are "
                    "minutes/point and opt-in)")
    ap.add_argument("--budget", type=float, default=240.0,
                    help="wall-clock budget per (mode, clip) in seconds; "
                    "remaining q points are skipped once exceeded")
    ap.add_argument("--device", default="cpu", choices=("cpu", "gpu"),
                    help="platform for the fused paths; rate and PSNR "
                    "agree across platforms up to f32 decision sums, and "
                    "gpu fails when JAX finds no GPU")
    args = ap.parse_args()

    import jax
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            sys.exit(f"--device gpu: JAX platform is {platform!r}, not gpu")
    from aom_av1_psy_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aom_av1_psy_tpu.encoder.frame import EncoderConfig, FrameEncoder
    from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
    from aom_av1_psy_tpu.encoder.interframe import encode_video
    from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu

    # Anchor cq ladder (cq-level 0..63) and OUR base_q_idx ladder.  The
    # naive qindex=4*cq alignment leaves our (lower-PSNR) curve below the
    # anchor's range (r4 None cells) — instead our ladder extends well
    # below 4*cq so the PSNR intervals overlap and the BD fit integrates
    # over a real common range.
    if args.quick:
        CQ = [20, 32, 44, 56]
        QIDX = [32, 64, 96, 128, 168, 208]
    else:
        CQ = [16, 24, 32, 40, 48, 56]
        # 112/136 close the 40-45 dB gap that let piecewise-linear BD
        # interpolate optimistically on smooth clips (see QUALITY_r05
        # notes); budget-truncated runs drop from the tail, so the added
        # mid points stay in even under tight budgets
        QIDX = [24, 48, 72, 96, 112, 136, 168, 216]

    intra_clips = {
        "gradient_352": clip_gradient(352, 288, 2),
        "detail_352": clip_detail(352, 288, 2),
        "moving_352": clip_moving(352, 288, 2),
    }
    inter_clips = {
        "gradient_176": clip_gradient(176, 144, 4),
        "detail_176": clip_detail(176, 144, 4),
        "moving_176": clip_moving(176, 144, 4),
        "noisy_176": clip_noisy(176, 144, 4),
    }

    results = {"configs": {"cq_levels": CQ, "q_idx": QIDX,
                           "modes": args.modes,
                           "budget_s_per_mode_clip": args.budget},
               "clips": {}, "bd_rate_vs_aomenc": {}}

    def tpu_intra_packets(q):
        def mk(frames):
            return [TpuFrameEncoder(f, EncoderConfig(base_q_idx=q)).encode()
                    for f in frames]
        return mk

    def tpu_intra_cdef_packets(q):
        def mk(frames):
            return [TpuFrameEncoder(f, EncoderConfig(
                base_q_idx=q, search_cdef=True)).encode() for f in frames]
        return mk

    def host_intra_packets(q):
        def mk(frames):
            out = []
            for f in frames:
                out.append(FrameEncoder(f, EncoderConfig(
                    base_q_idx=q)).encode())
            return out
        return mk

    def inter_packets(q):
        def mk(frames):
            pkts, _ = encode_video(frames, EncoderConfig(base_q_idx=q))
            return pkts
        return mk

    def inter_tpu_packets(q):
        def mk(frames):
            pkts, _ = encode_video_tpu(frames, EncoderConfig(base_q_idx=q))
            return pkts
        return mk

    def inter_tpu_arf_packets(q):
        def mk(frames):
            from aom_av1_psy_tpu.encoder.tpu_interframe import \
                encode_video_tpu_arf
            pkts, _ = encode_video_tpu_arf(
                frames, EncoderConfig(base_q_idx=q), group=len(frames) - 1)
            return pkts
        return mk

    mode_defs = {
        "intra_tpu": (intra_clips, tpu_intra_packets),
        "intra_tpu_cdef": (intra_clips, tpu_intra_cdef_packets),
        "intra_host": (intra_clips, host_intra_packets),
        "inter_tpu": (inter_clips, inter_tpu_packets),
        "inter_tpu_arf": (inter_clips, inter_tpu_arf_packets),
        "inter_ippp": (inter_clips, inter_packets),
    }
    run_modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    for m in run_modes:
        assert m in mode_defs, f"unknown mode {m}"

    all_bd = {}
    for mode in run_modes:
        clips, ours = mode_defs[mode]
        for name, frames in clips.items():
            key = f"{mode}/{name}"
            t_start = time.perf_counter()
            with tempfile.TemporaryDirectory() as td:
                anchor = []
                for cq in CQ:
                    r, p = run_aomenc(frames, td, cq,
                                      intra=mode.startswith("intra"))
                    anchor.append((r, p))
                pts = []
                total_dt = 0.0
                truncated = False
                perc = []
                for q in QIDX:
                    if time.perf_counter() - t_start > args.budget \
                            and len(pts) >= 4:
                        truncated = True
                        print(f"{key}: budget hit after {len(pts)} points",
                              flush=True)
                        break
                    r, p, dt, hvs, vif = run_ours(frames, td, ours(q),
                                                  f"{mode}_{q}")
                    pts.append((r, p))
                    perc.append({"psnr_hvs": round(hvs, 3),
                                 "vif_lite": round(vif, 4)})
                    total_dt += dt
            bd = bd_rate([a[0] for a in anchor], [a[1] for a in anchor],
                         [x[0] for x in pts], [x[1] for x in pts])
            all_bd[key] = bd
            results["clips"][key] = {
                "anchor_rd": anchor, "ours_rd": pts,
                "ours_perceptual": perc,
                "bd_rate_pct": bd, "encode_s_total": round(total_dt, 1),
                "truncated_by_budget": truncated,
            }
            print(f"{key}: BD-rate {bd if bd is None else round(bd, 1)}% "
                  f"(anchor {anchor}, ours {pts})", flush=True)

    for mode in run_modes:
        vals = [v for k, v in all_bd.items()
                if k.split("/")[0] == mode and v is not None]
        nones = sum(1 for k, v in all_bd.items()
                    if k.split("/")[0] == mode and v is None)
        results["bd_rate_vs_aomenc"][mode] = (
            round(float(np.mean(vals)), 1) if vals else None)
        results["bd_rate_vs_aomenc"][f"{mode}_cells_without_overlap"] = nones

    results["notes"] = (
        "BD-rate vs aomenc --cpu-used=6 (generic-C build) on synthetic "
        "clips; negative = fewer bits at equal PSNR. Anchor decodes via "
        "reference aomdec; our streams also decoded by reference aomdec "
        "(conformance implied).")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["bd_rate_vs_aomenc"]))


if __name__ == "__main__":
    main()
