"""Fused inter path: closed loop (plan recon == decoder recon) and
bitstream conformance through the reference aomdec (reference analogue:
test/coding_path_sync.cc for inter frames)."""
import os
import subprocess

import numpy as np
import pytest

from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu
from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.bitstream.containers import write_ivf

AOMDEC = "/tmp/refbuild/aomdec"


def panning(w, h, n, seed=5):
    rng = np.random.default_rng(seed)
    pad = 4 * n + 16
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.)[None, :]
          * np.cos(np.arange(h + pad) / 29.)[:, None]
          + rng.normal(0, 6, (h + pad, w + pad))).clip(0, 255) \
        .astype(np.uint8)
    u0 = (128 + 20 * np.cos(np.arange((w + pad) // 2) / 17.)[None, :]
          * np.ones(((h + pad) // 2, 1))).clip(0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        ox, oy = 3 * i, 2 * i
        y = bg[oy : oy + h, ox : ox + w].copy()
        u = u0[oy // 2 : oy // 2 + h // 2, ox // 2 : ox // 2 + w // 2].copy()
        v = 255 - u
        out.append(Frame(y, u, v))
    return out


def _decode_all(packets):
    dec = Av1Decoder()
    out = []
    for p in packets:
        out.extend(dec.decode_packet(p))
    return out


@pytest.mark.parametrize("w,h,q", [(96, 64, 80), (160, 112, 120)])
def test_tpu_inter_closed_loop(w, h, q):
    frames = panning(w, h, 3, seed=w)
    packets, encs = encode_video_tpu(frames, EncoderConfig(base_q_idx=q))
    dec = _decode_all(packets)
    assert len(dec) == len(frames)
    for i, f in enumerate(dec):
        # decoder output is post-LPF: it must equal the encoder's
        # reference-chain planes (device LPF applied), not the raw
        # plan recon
        from aom_av1_psy_tpu.encoder.tpu_interframe import _ref_chain_planes
        rec = [np.asarray(r) for r in _ref_chain_planes(encs[i])]
        for pi, d_ in enumerate((f.y, f.u, f.v)):
            d_ = d_.astype(np.int32)
            np.testing.assert_array_equal(
                d_, rec[pi][: d_.shape[0], : d_.shape[1]],
                err_msg=f"frame {i} plane {pi}")
    # a STATIC repeat of the same frame must cost far less than the KEY
    static = [frames[0]] * 2
    spk, _ = encode_video_tpu(static, EncoderConfig(base_q_idx=q))
    assert len(spk[1]) < 0.3 * len(spk[0]), (len(spk[1]), len(spk[0]))


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_tpu_inter_aomdec_bitexact(tmp_path):
    w, h = 112, 80
    frames = panning(w, h, 4, seed=9)
    packets, _ = encode_video_tpu(frames, EncoderConfig(base_q_idx=100))
    path = str(tmp_path / "gop.ivf")
    raw = str(tmp_path / "gop.yuv")
    write_ivf(path, packets, w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = _decode_all(packets)
    ours = np.concatenate([np.concatenate([f.y.ravel(), f.u.ravel(),
                                           f.v.ravel()]) for f in dec])
    assert ref.size == ours.size
    assert np.array_equal(ref, ours)


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_tpu_inter_mid_gop_key(tmp_path):
    w, h = 96, 64
    frames = panning(w, h, 5, seed=3)
    packets, _ = encode_video_tpu(frames, EncoderConfig(base_q_idx=90),
                                  key_interval=2)
    path = str(tmp_path / "kgop.ivf")
    raw = str(tmp_path / "kgop.yuv")
    write_ivf(path, packets, w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = _decode_all(packets)
    ours = np.concatenate([np.concatenate([f.y.ravel(), f.u.ravel(),
                                           f.v.ravel()]) for f in dec])
    assert np.array_equal(ref, ours)


def test_cdf_forwarding_bits_win():
    """Backward CDF adaptation (primary_ref_frame forwarding) must cost
    fewer bits than per-frame reset and stay closed-loop exact
    (av1/common/entropymode.h:71 semantics)."""
    frames = panning(160, 112, 5, seed=11)
    cfg = EncoderConfig(base_q_idx=100)
    pk_fwd, encs = encode_video_tpu(frames, cfg, forward_cdf=True)
    pk_rst, _ = encode_video_tpu(frames, cfg, forward_cdf=False)
    assert sum(map(len, pk_fwd)) < sum(map(len, pk_rst))
    # forwarded streams signal the primary ref
    assert encs[2].fh.primary_ref_frame == 0
    assert not encs[2].fh.disable_frame_end_update_cdf
    dec = _decode_all(pk_fwd)
    from aom_av1_psy_tpu.encoder.tpu_interframe import _ref_chain_planes
    for i, f in enumerate(dec):
        rec = [np.asarray(r) for r in _ref_chain_planes(encs[i])]
        for pi, d_ in enumerate((f.y, f.u, f.v)):
            d_ = d_.astype(np.int32)
            np.testing.assert_array_equal(
                d_, rec[pi][: d_.shape[0], : d_.shape[1]],
                err_msg=f"frame {i} plane {pi}")


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_cdf_forwarding_aomdec_bitexact(tmp_path):
    w, h = 112, 80
    frames = panning(w, h, 5, seed=13)
    packets, _ = encode_video_tpu(frames, EncoderConfig(base_q_idx=110),
                                  forward_cdf=True)
    path = str(tmp_path / "fwd.ivf")
    raw = str(tmp_path / "fwd.yuv")
    write_ivf(path, packets, w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = _decode_all(packets)
    ours = np.concatenate([np.concatenate([f.y.ravel(), f.u.ravel(),
                                           f.v.ravel()]) for f in dec])
    assert np.array_equal(ref, ours)


def test_rate_control_hits_target():
    """One-pass VBR-lite lands within 12% of an achievable target and the
    stream stays closed-loop exact (ratectrl.c regulate-q analogue)."""
    from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu_rc
    rng = np.random.default_rng(7)
    # structured moving content (smooth rate response, no all-skip cliff)
    frames = []
    w, h, n = 176, 144, 8
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        y = (110 + 45 * np.sin((xx + 3 * i) / 37.0) * np.cos(yy / 29.0)
             + 30 * (((xx // 24) + (yy // 24) + i) % 2)).clip(0, 255)
        bx, by = 20 + 5 * i, 30 + 3 * i
        y[by : by + 40, bx : bx + 40] = 210 - 4 * i
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        frames.append(Frame(y.astype(np.uint8), u, v))
    target_bps = 400_000
    pk, encs, qs = encode_video_tpu_rc(frames, target_bps, fps=30)
    achieved = sum(len(p) * 8 for p in pk) * 30 / n
    assert abs(achieved / target_bps - 1) < 0.12, (achieved, qs)
    dec = _decode_all(pk)
    assert len(dec) == n
    # q must actually adapt (not stay pinned at start_q)
    assert len(set(qs)) > 1, qs


def test_inter_pan_noise_efficiency():
    """A noisy global pan must be coded by motion, not residuals: the
    exact SSD full-pel search + dominant-MV candidate must find the pan
    everywhere (the step-2 SAD grid was blind to odd offsets on noise and
    sent most blocks to junk MVs with dense residuals — round 5). P-frames
    must be a small fraction of the KEY's bytes at near-reference quality."""
    rng = np.random.default_rng(21)
    w, h = 176, 144
    pad = 48
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 6, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(3):
        y = np.clip(bg[2 * i : 2 * i + h, 3 * i : 3 * i + w], 0,
                    255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        frames.append(Frame(y, u, v))
    packets, encs = encode_video_tpu(frames, EncoderConfig(base_q_idx=96))
    key_b, p_b = len(packets[0]), max(len(p) for p in packets[1:])
    assert p_b < 0.2 * key_b, (p_b, key_b)
    # the dominant pan (dy=2, dx=3 full-pel => mv8 (16, 24)) must carry
    mv = encs[1].plan["mv8"].reshape(-1, 2)
    frac = (np.abs(mv - np.array([16, 24])) <= 8).all(1).mean()
    assert frac > 0.7, frac


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_arf_star_gop_conformance(tmp_path):
    """ARF star group (encode_video_tpu_arf): non-shown temporally
    filtered ALTREF + star-referencing middles + show_existing display
    position. Streams must decode identically through aomdec and our
    decoder, with the right display-frame count and order."""
    from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu_arf
    w, h = 112, 80
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 100 + 50 * np.sin(xx / 17.0) * np.cos(yy / 13.0)
    frames = []
    for i in range(6):
        y = np.clip(base + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 118, np.uint8)
        v = np.full((h // 2, w // 2), 132, np.uint8)
        frames.append(Frame(y, u, v))
    packets, encs = encode_video_tpu_arf(
        frames, EncoderConfig(base_q_idx=100), group=5)
    # one KEY + ARF + middles + show_existing
    assert encs[-1] is None and not encs[1].show
    path = str(tmp_path / "arf.ivf")
    raw = str(tmp_path / "arf.yuv")
    write_ivf(path, packets, w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = _decode_all(packets)
    assert len(dec) == len(frames)
    ours = np.concatenate([np.concatenate([f.y.ravel(), f.u.ravel(),
                                           f.v.ravel()]) for f in dec])
    assert ref.size == ours.size and np.array_equal(ref, ours)


def test_temporal_filter_consumed_by_arf():
    """On temporally-noisy content the strength-2 TF (psy rule) must
    shrink the ARF's coded size vs an unfiltered ARF — the filter is
    consumed by the GOP structure, not just golden-tested."""
    from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu_arf
    w, h = 112, 80
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 100 + 50 * np.sin(xx / 19.0) * np.cos(yy / 23.0)
    frames = []
    for i in range(5):
        y = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 118, np.uint8)
        v = np.full((h // 2, w // 2), 132, np.uint8)
        frames.append(Frame(y, u, v))
    cfg = EncoderConfig(base_q_idx=96)
    p_tf, e_tf = encode_video_tpu_arf(frames, cfg, group=4, tf_strength=2)
    p_no, e_no = encode_video_tpu_arf(frames, cfg, group=4, tf_strength=0)
    arf_tf = len(p_tf[1])
    arf_no = len(p_no[1])
    assert arf_tf < arf_no, (arf_tf, arf_no)


def test_cbr_buffer_model():
    """One-pass CBR (encode_video_tpu_cbr): the leaky-bucket buffer must
    never underrun after the startup transient and the delivered bitrate
    must track the target (ratectrl.c one-pass CBR role)."""
    from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu_cbr
    rng = np.random.default_rng(8)
    w, h = 176, 144
    pad = 80
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(10):
        y = np.clip(bg[2 * i : 2 * i + h, 3 * i : 3 * i + w], 0,
                    255).astype(np.uint8)
        frames.append(Frame(y, np.full((h // 2, w // 2), 120, np.uint8),
                            np.full((h // 2, w // 2), 135, np.uint8)))
    target = 220_000.0
    fps = 30.0
    pkts, encs, qs, trace = encode_video_tpu_cbr(frames, target, fps=fps)
    total_bits = sum(len(p) for p in pkts) * 8
    rate = total_bits * fps / len(frames)
    assert 0.5 * target < rate < 1.6 * target, rate
    # buffer never pinned empty after the KEY transient
    assert min(trace[2:]) > 0.0, trace
    # q reacts: steady-state P-frame q settles within the clamps
    assert all(8 <= v <= 250 for v in qs)


def test_two_stage_search_fast_pan():
    """A 24 px/frame pan exceeds the fine stage's +/-16 px radius: the
    half-resolution coarse stage must recover it (two-stage exact-SSD
    search, av1_full_pixel_search's multi-step role)."""
    rng = np.random.default_rng(4)
    w, h, n = 176, 144, 3
    pad = 30 * n + 32
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    frames = []
    for i in range(n):
        y = np.clip(bg[6 * i : 6 * i + h, 24 * i : 24 * i + w], 0,
                    255).astype(np.uint8)
        frames.append(Frame(y, np.full((h // 2, w // 2), 120, np.uint8),
                            np.full((h // 2, w // 2), 135, np.uint8)))
    pkts, encs = encode_video_tpu(frames, EncoderConfig(base_q_idx=96))
    mv = encs[1].plan["mv8"].reshape(-1, 2)
    frac = (np.abs(mv - np.array([48, 192])) <= 8).all(1).mean()
    assert frac > 0.6, frac
    assert max(len(p) for p in pkts[1:]) < 0.2 * len(pkts[0])
