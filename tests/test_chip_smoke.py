"""chip_smoke.py's phases at 128x64 on the CPU (the script runs them at
1080p on a GPU), its refusal to run without a GPU, and the 1080p kernel
checks on a GPU (marker ``gpu``; they skip without one)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402
import chip_smoke as CS  # noqa: E402

W, H = 128, 64


def test_check_device_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        CS.check_device(1)


def test_main_fails_without_gpu(capsys):
    with pytest.raises(RuntimeError):
        CS.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_fullpel_phase():
    g = bench.make_gop(W, H, 2)
    out = CS.check_fullpel(g[1].y, g[0].y)
    assert out["blocks"] == (W // 16) * (H // 16)


def test_cdef_phase():
    assert CS.check_cdef(W, H)["filtered_px"] > 0


def test_lpf_phase():
    assert CS.check_lpf(W, H)["filtered_px"] > 0


def test_txfm_phase():
    assert CS.check_txfm(W, H)["cases"] == 9


def test_key_phase():
    out = CS.encode_key(W, H)
    assert out["bytes"] > 0 and out["y_psnr"] > 30


def test_gop_phase():
    out = CS.encode_gop(W, H, 3)
    assert len(out["frames"]) == 3
    assert all(f["bytes"] > 0 for f in out["frames"])


def test_cpu_vs_device_phase():
    import jax
    out = CS.cpu_vs_device(W, H, jax.devices()[0])
    assert out["identical"]


def test_sharded_phase():
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (conftest sets 8 virtual CPUs)")
    out = CS.sharded_tiles(256, H, 4)
    assert out["bytes"] > 0


@pytest.mark.gpu
def test_gpu_fullpel_1080p(gpu):
    g = bench.make_gop(1920, 1080, 2)
    CS.check_fullpel(g[1].y, g[0].y)


@pytest.mark.gpu
@pytest.mark.parametrize("check", ["check_cdef", "check_lpf", "check_txfm"])
def test_gpu_kernel_1080p(gpu, check):
    getattr(CS, check)(1920, 1080)
