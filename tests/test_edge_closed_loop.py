"""Closed loop at frame sizes whose mi grid ends half-way into the last
32x32 cell row or column (mi_rows % 8 == 6 or mi_cols % 8 == 6; 1080p is
such a height): the partition plan codes that cell as one 32x32 block
overhanging the frame, and its intra edges must repeat the last in-frame
pixel exactly as the decoder does (n_left/n_top in
av1_predict_intra_block). The decoder's output must equal the encoder's
reference planes in every plane of every frame."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402
from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.encoder.tpu_interframe import (_ref_chain_planes,
                                                    encode_video_tpu)


def _assert_closed_loop(pkts, encs):
    dec = Av1Decoder()
    for i, (pkt, enc) in enumerate(zip(pkts, encs)):
        out = dec.decode_packet(pkt)
        assert len(out) == 1
        ref = [np.asarray(p) for p in _ref_chain_planes(enc)]
        for name, d, r in zip("yuv", out[0].planes(), ref):
            d = d.astype(np.int32)
            np.testing.assert_array_equal(
                d, r[: d.shape[0], : d.shape[1]],
                err_msg=f"frame {i} plane {name}")


@pytest.mark.parametrize("w,h", [(256, 120), (256, 184), (248, 120)])
def test_key_frame_closed_loop_at_partial_cell(w, h):
    enc = TpuFrameEncoder(bench.make_frame(w, h),
                          EncoderConfig(base_q_idx=100, try_smooth64=False))
    assert enc.use_part
    assert enc.mi_rows % 8 == 6 or enc.mi_cols % 8 == 6
    pkt = enc.encode()
    _assert_closed_loop([pkt], [enc])


def test_ippp_gop_closed_loop_at_partial_cell():
    w, h = 256, 120
    frames = bench.make_gop(w, h, 2)
    pkts, encs = encode_video_tpu(
        frames, EncoderConfig(base_q_idx=100, try_smooth64=False))
    assert encs[0].use_part and encs[0].mi_rows % 8 == 6
    _assert_closed_loop(pkts, encs)
