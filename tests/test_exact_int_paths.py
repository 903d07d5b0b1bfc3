"""Integer forms of the device programs whose float versions could round
differently on a GPU: the CDEF bit length, the full-pel SSD search
(f32 convolutions at reduced tensor-core precision would round the sums
of squares), and the compile-cache helper of the command-line tools."""
import os
import sys

import numpy as np
import pytest

from aom_av1_psy_tpu.ops import cdef as HC
from aom_av1_psy_tpu.ops import cdef_jax as DC

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.mark.parametrize("k", range(21))
def test_floor_log2_at_powers_of_two(k):
    vals = [v for v in (2 ** k - 1, 2 ** k, 2 ** k + 1) if v > 0]
    got = np.asarray(DC.floor_log2(np.asarray(vals, np.int32)))
    assert got.tolist() == [v.bit_length() - 1 for v in vals]


@pytest.mark.parametrize("strength", [1, 4, 8, 15])
def test_device_adjust_strength_matches_host(strength):
    rng = np.random.default_rng(strength)
    var = np.concatenate([
        rng.integers(0, 1 << 20, 500),
        (1 << np.arange(0, 20)) * 64, (1 << np.arange(0, 20)) * 64 - 1,
        [0, 63, 64, 65]]).astype(np.int32)
    got = np.asarray(DC._adjust_strength(strength, var))
    want = [HC._adjust_strength(strength, int(v)) for v in var]
    assert got.tolist() == want


@pytest.mark.parametrize("damping", [3, 4, 5, 6])
def test_device_constrain_matches_host(damping):
    rng = np.random.default_rng(damping)
    diff = rng.integers(-255, 256, 400).astype(np.int32)
    for t in (1, 2, 3, 4, 7, 8, 15, 16):
        got = np.asarray(DC._constrain(diff, np.int32(t), damping))
        want = HC._constrain(diff, t, damping)
        assert np.array_equal(got, want), t


@pytest.mark.parametrize("seed", [0, 1])
def test_fullpel_search_matches_int64_ssd_near_white(seed):
    """Pixels near 255: sums of squares need 16 significant bits, which a
    reduced-precision pass would round; the device pick must equal the
    int64 brute force (exact ties aside) in both call forms."""
    import chip_smoke as CS
    rng = np.random.default_rng(seed)
    ref = rng.integers(230, 256, (96, 128)).astype(np.uint8)
    src = np.roll(ref, (3, -5), (0, 1)).astype(np.int32)
    src = np.clip(src + rng.integers(-2, 3, src.shape), 0, 255) \
        .astype(np.uint8)
    out = CS.check_fullpel(src, ref, seed=seed)
    assert out["static"]["exact"] + out["static"]["ties"] == out["blocks"]


def test_compile_cache_honours_env(monkeypatch):
    import jax
    from aom_av1_psy_tpu.utils import compile_cache as CC
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(CC.ENV_VAR, "/elsewhere/cache")
    assert CC.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    import jax
    from aom_av1_psy_tpu.utils import compile_cache as CC
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert CC.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
