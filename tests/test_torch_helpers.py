"""rtm_tpu_torch's remaining public helpers against rtm_tpu's, on numpy
inputs made from a seed: the four-tap bilinear samplers (`sample_bilinear`,
`sample_texture_array`, `sky_color`), the NumPy RNG mirror
(`pcg_hash_np`, `fast_random_np`) and the dependency-free PNG writer
(`save_png_pure`).

The texel samplers are the same f32 expressions in the same order and
are held bitwise; `sky_color` maps the direction to uv by atan2 and asin,
which XLA's CPU backend does not round correctly (the uv moves by an
ulp), so it is held within rtol 1e-6 / atol 1e-6.  The RNG mirror and the
PNG bytes are held bitwise.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm_tpu.io import image as jimage
from rtm_tpu.ops import rng as jrng
from rtm_tpu.ops import shade as jshade
from rtm_tpu_torch.io import image as timage
from rtm_tpu_torch.ops import rng as trng
from rtm_tpu_torch.ops import shade as tshade

TOL = dict(rtol=1e-6, atol=1e-6)


def _uv(rng, n, lo=-2.0, hi=3.0):
    return (rng.uniform(lo, hi, n).astype(np.float32),
            rng.uniform(lo, hi, n).astype(np.float32))


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sample_bilinear_matches_jax(wrap):
    rng = np.random.default_rng(31)
    img = rng.random((7, 11, 3), dtype=np.float32)
    u, v = _uv(rng, 500)
    want = np.asarray(jshade.sample_bilinear(jnp.asarray(img), jnp.asarray(u),
                                             jnp.asarray(v), wrap))
    got = tshade.sample_bilinear(torch.from_numpy(img), torch.from_numpy(u),
                                 torch.from_numpy(v), wrap).numpy()
    assert got.shape == (500, 3)
    np.testing.assert_array_equal(got, want)


def test_sample_texture_array_matches_jax():
    """A padded stack of three textures of their own extents; tex ids
    include -1 and past the last texture (clamped)."""
    rng = np.random.default_rng(32)
    tex = rng.random((3, 9, 13, 3), dtype=np.float32)
    size = np.array([[9, 13], [4, 6], [7, 2]], np.int32)
    tid = rng.integers(-1, 4, 600).astype(np.int32)
    u, v = _uv(rng, 600)
    want = np.asarray(jshade.sample_texture_array(
        jnp.asarray(tex), jnp.asarray(size), jnp.asarray(tid),
        jnp.asarray(u), jnp.asarray(v)))
    got = tshade.sample_texture_array(
        torch.from_numpy(tex), torch.from_numpy(size),
        torch.from_numpy(tid), torch.from_numpy(u),
        torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sky_color_matches_jax_and_the_quad_table():
    """The equirect sky by four taps, against rtm_tpu's and against the
    port's one-row form through the quad table (the renderer's)."""
    rng = np.random.default_rng(33)
    sky = rng.random((16, 32, 3), dtype=np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jshade.sky_color(jnp.asarray(d), jnp.asarray(sky)))
    got = tshade.sky_color(torch.from_numpy(d), torch.from_numpy(sky))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    quads = torch.from_numpy(tshade.build_quad_flat(sky, "clamp"))
    np.testing.assert_allclose(
        tshade.sky_color_quads(torch.from_numpy(d), quads, 16, 32).numpy(),
        got.numpy(), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 999, 0x7FFFFFFF, 0xFFFFFFFF,
                                  123456789])
def test_rng_mirror_matches_jax_and_torch(seed):
    """pcg_hash_np / fast_random_np bitwise against rtm_tpu's mirror and
    the port's torch fast_random, as tests/test_rng.py holds rtm_tpu's
    mirror against its jnp version."""
    assert trng.pcg_hash_np(seed) == jrng.pcg_hash_np(seed)
    v, s = trng.fast_random_np(seed)
    jv, js = jrng.fast_random_np(seed)
    assert s == js and v == jv and isinstance(v, np.float32)
    tv, ts = trng.fast_random(torch.tensor([seed], dtype=torch.int64))
    assert int(ts[0]) == s and np.float32(tv[0].item()) == v


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_save_png_pure_matches_jax_bytes(tmp_path, dtype):
    rng = np.random.default_rng(34)
    img = rng.uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    u8 = timage.to_u8(img)
    if dtype == "u8":
        img = u8
    jimage.save_png_pure(tmp_path / "j.png", img)
    timage.save_png_pure(tmp_path / "t.png", img)
    data = (tmp_path / "t.png").read_bytes()
    assert data == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(timage.decode_png(data), u8)
