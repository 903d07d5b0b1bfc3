#!/usr/bin/env python3
"""Benchmark: 1080p conforming all-intra encode on one GPU, end-to-end.

Times ``TpuFrameEncoder`` (encoder/tpu_frame.py) — the product path that
``av1_get_compressed_data`` (av1/encoder/encoder.c:4597) corresponds to:
batched wavefront mode search + bit-exact transform/quantize/recon on the
device, then the one-call native syntax pack. The output packets are fully
conforming AV1 KEY frames (bit-exact through the reference aomdec,
tests/test_tpu_encoder.py). Also times the fused inter path on a 1080p
IPPP GOP and the 2-tile-column intra path.

Reported metric: median steady-state frames/s at 1080p on one GPU.
``extra`` carries the first-frame latency (compilation included), the
min/max steady-state spread, the plan/pack split, and the device: JAX's
platform, device kind and count, and the card's name and power limit as
nvidia-smi reports them. Without a GPU the benchmark exits non-zero.
Compiled programs persist in JAX's compilation cache
(aom_av1_psy_tpu/utils/compile_cache.py).

Baseline: aomenc --cpu-used=6 --threads=1 all-intra 1080p at 0.141 fps on
a CPU host (reference built with AOM_TARGET_CPU=generic — no SIMD — so
this flatters us vs a production aomenc build).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""
import json
import statistics
import time

import numpy as np

AOMENC_CPU6_1080P_FPS = 0.141  # generic-C build (no SIMD), 1 thread


def make_frame(w: int, h: int, seed: int = 0):
    """Deterministic, moderately textured 1080p frame: smooth gradients +
    sinusoidal detail + mild noise (random noise alone is a pathological
    coding target; this keeps pack time representative)."""
    from aom_av1_psy_tpu.utils.frame import Frame

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (96 + 60 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
            + 40 * (xx / w) + 20 * (yy / h))
    y = np.clip(base + rng.normal(0, 4.0, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(128 + 30 * np.sin(xx[::2, ::2] / 131.0)
                + rng.normal(0, 2.0, (h // 2, w // 2)), 0, 255)
    v = np.clip(128 - 25 * np.cos(yy[::2, ::2] / 89.0)
                + rng.normal(0, 2.0, (h // 2, w // 2)), 0, 255)
    return Frame(y, u.astype(np.uint8), v.astype(np.uint8))


def make_gop(w: int, h: int, n: int, seed: int = 1):
    """Busy inter content: global pan + a moving object + per-frame noise
    (worst-case-ish for the host symbol-script build: many coded blocks)."""
    from aom_av1_psy_tpu.utils.frame import Frame

    rng = np.random.default_rng(seed)
    pad = 4 * n + 32
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(n):
        y = np.clip(bg[2 * i : 2 * i + h, 3 * i : 3 * i + w].copy(), 0, 255)
        y[200 : 440, 300 + 8 * i : 540 + 8 * i] = 205 - 3 * i
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        frames.append(Frame(y.astype(np.uint8), u, v))
    return frames


def main():
    import subprocess
    import jax
    from aom_av1_psy_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's platform is "
                         f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from aom_av1_psy_tpu.encoder.frame import EncoderConfig
    from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
    from aom_av1_psy_tpu.encoder.tpu_interframe import TpuInterFrameEncoder

    frame = make_frame(1920, 1080)
    cfg = EncoderConfig(base_q_idx=100)

    t0 = time.perf_counter()
    enc = TpuFrameEncoder(frame, cfg)
    pkt = enc.encode()
    first_s = time.perf_counter() - t0
    nbytes = len(pkt)

    iters = 6
    times, plans, packs = [], [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        enc = TpuFrameEncoder(frame, cfg)
        enc.encode()
        times.append(time.perf_counter() - t0)
        plans.append(enc.timings["plan_s"])
        packs.append(enc.timings["pack_s"])
    med = statistics.median(times)
    fps = 1.0 / med

    # ---- inter steady state (fused inter plan + symbol-script pack +
    # device LPF on the reference chain), busy 1080p content ----
    gop = make_gop(1920, 1080, 5)
    key = TpuFrameEncoder(gop[0], cfg)
    key_pkt = key.encode()
    ref = key.ref_planes_dev
    prev_fc = key.saved_fc
    inter_times, inter_plans, inter_packs, inter_bytes = [], [], [], []
    for i, f in enumerate(gop[1:]):
        t0 = time.perf_counter()
        ie = TpuInterFrameEncoder(f, cfg, key.seq, ref, 1920, 1080,
                                  prev_fc=prev_fc)
        p = ie.encode()
        inter_times.append(time.perf_counter() - t0)
        inter_plans.append(ie.timings["plan_s"])
        inter_packs.append(ie.timings["pack_s"])
        inter_bytes.append(len(p))
        ref = ie.ref_planes_out
        prev_fc = ie.saved_fc
    # first inter frame pays the inter-plan compile; report steady median
    inter_steady = inter_times[1:] or inter_times
    inter_fps = 1.0 / statistics.median(inter_steady)

    # ---- 2-tile-column intra path (P1 shape; one chip runs the tiles
    # as a loop — the mesh-sharded variant is byte-identical, proven in
    # tests/test_multichip.py) ----
    cfg2 = EncoderConfig(base_q_idx=100, tile_cols_log2=1)
    enc2 = TpuFrameEncoder(frame, cfg2)
    enc2.encode()                       # compile
    t0 = time.perf_counter()
    enc2 = TpuFrameEncoder(frame, cfg2)
    enc2.encode()
    tiled_s = time.perf_counter() - t0

    print(json.dumps({
        "metric": "1080p_allintra_conforming_encode_fps",
        "value": round(fps, 3),
        "unit": "frames/s/gpu",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "vs_baseline": round(fps / AOMENC_CPU6_1080P_FPS, 2),
        "extra": {
            "first_frame_s": round(first_s, 2),
            "steady_min_s": round(min(times), 3),
            "steady_max_s": round(max(times), 3),
            "plan_median_s": round(statistics.median(plans), 3),
            "pack_median_s": round(statistics.median(packs), 3),
            "frame_bytes": nbytes,
            "iters": iters,
            "inter_1080p_fps": round(inter_fps, 3),
            "inter_first_s": round(inter_times[0], 2),
            "inter_plan_median_s": round(
                statistics.median(inter_plans[1:] or inter_plans), 3),
            "inter_pack_median_s": round(
                statistics.median(inter_packs[1:] or inter_packs), 3),
            "inter_frame_bytes": inter_bytes,
            "tiled2_intra_s": round(tiled_s, 3),
            "key_frame_bytes": len(key_pkt),
            "baseline_note": "aomenc cpu-used=6 generic-C (no SIMD) build",
        },
    }))


if __name__ == "__main__":
    main()
