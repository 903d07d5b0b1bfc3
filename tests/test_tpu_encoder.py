"""Fused encoder conformance: the plan+native-pack path must produce
streams our decoder reconstructs exactly and the reference aomdec decodes
bit-identically (reference analogue: test/coding_path_sync.cc +
test/test_vector_test.cc applied to our own streams)."""
import os
import subprocess

import numpy as np
import pytest

from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.decoder.obu import decode_ivf
from aom_av1_psy_tpu.bitstream.containers import write_ivf

AOMDEC = "/tmp/refbuild/aomdec"


def make_frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 13) * np.cos(yy / 9)
         + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    u = (128 + 40 * np.sin(np.arange(ch)[:, None] / 7
                           + np.arange(cw)[None, :] / 11)) \
        .clip(0, 255).astype(np.uint8)
    v = (100 + rng.normal(0, 6, (ch, cw))).clip(0, 255).astype(np.uint8)
    return Frame(y, u, v)


CASES = [(96, 64, 60, 6),      # bs=16 exact grid
         (178, 130, 60, 6),    # odd dims -> bs=8, partial SBs
         (128, 128, 100, 9),   # bs=32 (no coded tx type)
         (176, 144, 200, 6)]   # high q, mostly skip


@pytest.mark.parametrize("w,h,q,bsz", CASES)
def test_tpu_stream_self_decodes(tmp_path, w, h, q, bsz):
    f = make_frame(w, h, seed=w + q)
    enc = TpuFrameEncoder(f, EncoderConfig(base_q_idx=q, block_size=bsz))
    data = enc.encode()
    path = str(tmp_path / "t.ivf")
    write_ivf(path, [data], w, h)
    dec = decode_ivf(path)
    assert len(dec) == 1
    mse = ((dec[0].y.astype(float) - f.planes()[0].astype(float)) ** 2).mean()
    psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-9))
    assert psnr > 28, psnr
    # decoder recon (pre-loop-filter path check): the plan recon must match
    # the decoded recon wherever the loop filter left pixels untouched is
    # hard to isolate; the aomdec oracle test below is the full contract.


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
@pytest.mark.parametrize("w,h,q,bsz", CASES)
def test_tpu_stream_aomdec_bitexact(tmp_path, w, h, q, bsz):
    f = make_frame(w, h, seed=w + q)
    enc = TpuFrameEncoder(f, EncoderConfig(base_q_idx=q, block_size=bsz))
    data = enc.encode()
    path = str(tmp_path / "t.ivf")
    raw = str(tmp_path / "t.yuv")
    write_ivf(path, [data], w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = decode_ivf(path)
    ours = np.concatenate([dec[0].y.ravel(), dec[0].u.ravel(),
                           dec[0].v.ravel()])
    assert ref.size == ours.size
    assert np.array_equal(ref, ours)


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_tpu_tune_psy_per_block_rdmult(tmp_path):
    """tune_psy drives a per-block rdmult grid through the fused plan:
    the grid must vary across blocks (dark/flat vs textured regions) and
    the stream must stay bit-exact through the reference aomdec."""
    w, h = 96, 64
    rng = np.random.default_rng(7)
    y = np.full((h, w), 30, np.uint8)               # dark flat left half
    y[:, w // 2 :] = (128 + rng.normal(0, 40, (h, w // 2))).clip(0, 255) \
        .astype(np.uint8)                           # textured right half
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = np.full((h // 2, w // 2), 128, np.uint8)
    f = Frame(y, u, v)
    enc = TpuFrameEncoder(f, EncoderConfig(base_q_idx=100, tune_psy=True))
    grid = np.asarray(enc.rdmult)
    assert grid.ndim == 2 and grid.std() > 0, "rdmult grid must vary"
    # flat/dark region gets a smaller lambda (more bits) than texture
    assert grid[:, 0].mean() < grid[:, -1].mean()
    data = enc.encode()
    path = str(tmp_path / "psy.ivf")
    raw = str(tmp_path / "psy.yuv")
    write_ivf(path, [data], w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    ref = np.fromfile(raw, np.uint8)
    dec = decode_ivf(path)
    ours = np.concatenate([dec[0].y.ravel(), dec[0].u.ravel(),
                           dec[0].v.ravel()])
    assert np.array_equal(ref, ours)


def test_plan_recon_is_decode_recon():
    """Closed-loop contract: the plan's on-device recon must equal the
    decoder's recon bit-exactly (LPF disabled to isolate the coding loop).
    Guards the chroma DERIVED-tx-type path (decoder/frame.py:_uv_tx_type):
    chroma TQ must apply the uv-mode-derived ADST/DCT combo, not DCT."""
    from aom_av1_psy_tpu.encoder import tpu_intra
    from aom_av1_psy_tpu.decoder.obu import Av1Decoder

    class NoLpf(TpuFrameEncoder):
        def make_headers(self):
            seq, fh = super().make_headers()
            fh.lf.filter_level = (0, 0)
            fh.lf.filter_level_u = 0
            fh.lf.filter_level_v = 0
            return seq, fh

    w, h = 96, 64
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 13) * np.cos(yy / 9)
         + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 50 * np.sin(np.arange(h // 2)[:, None] / 5
                           + np.arange(w // 2)[None, :] / 7)) \
        .clip(0, 255).astype(np.uint8)
    v = (100 + 40 * np.cos(np.arange(h // 2)[:, None] / 6)) \
        .clip(0, 255).astype(np.uint8)
    f = Frame(y, u, v)
    enc = NoLpf(f, EncoderConfig(base_q_idx=60))
    data = enc.encode()
    recon = [np.asarray(r) for r in enc.plan["recon_dev"]]
    # chroma must actually exercise non-DC modes for this to guard anything
    uvm = enc.plan["uv_mode8"] if enc.use_part else enc.plan["uv_mode"]
    uv_modes = np.unique(np.asarray(tpu_intra.PLAN_MODES)[uvm])
    assert len(uv_modes) > 1, uv_modes
    fr = Av1Decoder().decode_packet(data)[0]
    for name, d_, p_ in (("y", fr.y, recon[0]),
                         ("u", fr.u, recon[1]),
                         ("v", fr.v, recon[2])):
        d_ = d_.astype(np.int32)
        np.testing.assert_array_equal(d_, p_[: d_.shape[0], : d_.shape[1]],
                                      err_msg=name)


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
def test_tpu_cdef_search_conforming(tmp_path):
    """search_cdef on the fused path: frame-level strength pick
    (av1/encoder/pickcdef.c role) signaled with cdef_bits=0 — the stream
    must stay bit-exact through aomdec vs our decoder, pick a nonzero
    strength on a noisy clip at high q, and not lose PSNR vs CDEF-off."""
    rng = np.random.default_rng(11)
    w, h = 176, 144
    yy, xx = np.mgrid[0:h, 0:w]
    y = (110 + 50 * np.sin(xx / 17) * np.cos(yy / 13)
         + rng.normal(0, 14, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + rng.normal(0, 8, (h // 2, w // 2))).clip(0, 255) \
        .astype(np.uint8)
    v = (120 + rng.normal(0, 8, (h // 2, w // 2))).clip(0, 255) \
        .astype(np.uint8)
    f = Frame(y, u, v)

    def roundtrip(cdef):
        enc = TpuFrameEncoder(f, EncoderConfig(base_q_idx=200,
                                               search_cdef=cdef))
        data = enc.encode()
        path = str(tmp_path / f"c{cdef}.ivf")
        raw = str(tmp_path / f"c{cdef}.yuv")
        write_ivf(path, [data], w, h)
        r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        ref = np.fromfile(raw, np.uint8)
        dec = decode_ivf(path)
        ours = np.concatenate([dec[0].y.ravel(), dec[0].u.ravel(),
                               dec[0].v.ravel()])
        assert np.array_equal(ref, ours)
        mse = ((dec[0].y.astype(float) - y.astype(float)) ** 2).mean()
        return enc, 10 * np.log10(255 ** 2 / max(mse, 1e-9))

    enc_off, psnr_off = roundtrip(False)
    enc_on, psnr_on = roundtrip(True)
    c = enc_on.fh.cdef
    assert c.y_pri[0] > 0 or c.y_sec[0] > 0, "no strength picked"
    assert psnr_on >= psnr_off - 1e-9, (psnr_on, psnr_off)


# ----------------------------------------------------------------------
# directional modes in the fused plan (round 5)
# ----------------------------------------------------------------------
def make_diag_frame(w, h, seed=3):
    """Content with strong diagonal structure so directional modes win."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = np.clip(100 + 70 * np.sin((xx + 0.7 * yy) / 9.0)
                + 40 * ((xx - yy) // 24 % 2) + rng.normal(0, 4, (h, w)),
                0, 255).astype(np.uint8)
    u = np.clip(120 + 30 * np.sin(xx[:h:2, :w:2] / 19.0), 0,
                255).astype(np.uint8)
    v = np.clip(100 + 30 * np.cos((xx + yy)[:h:2, :w:2] / 13.0), 0,
                255).astype(np.uint8)
    return Frame(y, u, v)


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="aomdec oracle absent")
@pytest.mark.parametrize("q", [32, 80, 160])
def test_tpu_directional_modes_closed_loop(tmp_path, q):
    """Directional (z1/z2/z3 + angle delta) candidates must be chosen on
    diagonal content AND the plan recon must equal the decoder recon
    bit-exactly — guards the batched edge pipeline (corner smoothing,
    strength/type edge filtering, availability-gated TR/BL extensions,
    reconintra.c:1081) against closed-loop divergence. q=32 guards the
    small-rdmult regime where a rate-penalty mask once let disallowed
    candidates win."""
    w, h = 176, 144
    f = make_diag_frame(w, h)
    enc = TpuFrameEncoder(f, EncoderConfig(base_q_idx=q))
    data = enc.encode()
    ndir = int(((enc.plan["y_mode32"] >= 3) & (enc.plan["y_mode32"] <= 8))
               .sum()) + \
        int(((enc.plan["y_mode16"] >= 3) & (enc.plan["y_mode16"] <= 8)).sum())
    assert ndir > 10, f"directional modes unused on diagonal content: {ndir}"
    assert int((enc.plan["y_delta32"] != 0).sum()
               + (enc.plan["y_delta16"] != 0).sum()) > 0

    path = str(tmp_path / "dir.ivf")
    raw = str(tmp_path / "dir.yuv")
    write_ivf(path, [data], w, h)
    r = subprocess.run([AOMDEC, "--rawvideo", "-o", raw, path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    buf = np.fromfile(raw, np.uint8)
    cw, ch = w // 2, h // 2
    dy = buf[: w * h].reshape(h, w).astype(np.int32)
    du = buf[w * h : w * h + cw * ch].reshape(ch, cw).astype(np.int32)
    dv = buf[w * h + cw * ch :].reshape(ch, cw).astype(np.int32)
    # decoder output is post-LPF: compare the device-filtered reference
    # planes (the closed-loop recon incl. the on-device loop filter)
    rec = [np.asarray(x) for x in enc.ref_planes_dev]
    assert np.array_equal(rec[0][:h, :w], dy)
    assert np.array_equal(rec[1][:ch, :cw], du)
    assert np.array_equal(rec[2][:ch, :cw], dv)
