"""The port's threefry streams vs jax.random (jax_threefry_partitionable).

fold_in, uniform and normal must be bitwise: normal goes through XLA's
float32 ErfInv polynomial and XLA's own CPU log1p, both ported operation
for operation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.utils import rng as jrng
from rust_ray_tracer_tpu_torch.utils import rng
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_key_and_fold_in_chain_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.key(seed, "cpu")
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    for data in (0, 1, 10, 123456, 2**31 + 5, 2**32 - 1):
        jk = jax.random.fold_in(jk, data)
        tk = rng.fold_in(tk, data)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())


def test_fold_in_batched_keys_and_data():
    base = rng.key(3, "cpu")
    ks = rng.fold_in(base, torch.arange(5))                 # [5, 2]
    ks2 = rng.fold_in(ks[:, None, :], torch.arange(3))      # [5, 3, 2]
    for i in range(5):
        ji = jax.random.fold_in(jax.random.PRNGKey(3), i)
        np.testing.assert_array_equal(np.asarray(ji), ks[i].numpy())
        for j in range(3):
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(ji, j)), ks2[i, j].numpy())


@pytest.mark.parametrize("shape", [(1000, 9), (1000, 2), (1000,)])
def test_uniform_bitwise(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tk = rng.fold_in(rng.key(11, "cpu"), 4)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  rng.uniform(tk, shape).numpy())


def test_log1p_bitwise():
    """Both branches of XLA's log1p (|x| below and above sqrt(2) - 1) and
    its special values."""
    x = np.concatenate([
        np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (200000,),
                                      minval=-1.0, maxval=8.0)),
        np.float32([0.0, -0.0, -1.0, -2.0, np.inf, 1e-30, -0.41421354,
                    0.41421357])])
    ref = np.asarray(jnp.log1p(jnp.asarray(x)))
    np.testing.assert_array_equal(rng._log1p(torch.from_numpy(x)).numpy(),
                                  ref)


def test_erf_inv_bitwise():
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (200000,),
                                      minval=-1.0, maxval=1.0))
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erf_inv(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_bitwise(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 10)
    tk = rng.fold_in(rng.key(seed, "cpu"), 10)
    ref = np.asarray(jax.random.normal(jk, (20000, 6)))
    got = rng.normal(tk, (20000, 6)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_stream_tags_unchanged():
    for name in ("JITTER", "TIME", "SCATTER", "FUZZ", "COIN", "MEDIUM",
                 "ISO", "LIGHT_PICK", "LIGHT_SAMPLE", "MIX_COIN", "CHUNK"):
        assert getattr(rng, name) == getattr(jrng, name), name


def test_wave_chunk_bounce_chain_matches_trace_wave_uber():
    """The key chain of pallas_uber.trace_wave_uber (wave -> chunk ->
    CHUNK stream -> bounce -> SCATTER / FUZZ, pallas_uber.py:1176-1195)
    lands in the port's random planes at the same lanes."""
    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    from rust_ray_tracer_tpu_torch.ops import uber

    scene = compile_scene(builders.cornell_box(1.0), device="cpu")
    w, h, depth, chunk = 40, 30, 3, 500        # 3 chunks, padded to 1024
    root, wave = 9, 2
    _, rnd = uber.wave_inputs(scene, rng.wave_key(rng.key(root, "cpu"), wave),
                              w, h, depth, chunk)
    rnd = rnd.reshape(depth, 15, 3, 1024).numpy()
    wkey = jrng.wave_key(jax.random.PRNGKey(root), wave)
    for cid in range(3):
        ck = jrng.stream(jax.random.fold_in(wkey, cid), jrng.CHUNK)
        for b in range(depth):
            bk = jrng.bounce_key(ck, b)
            ub = jax.random.uniform(jrng.stream(bk, jrng.SCATTER), (chunk, 9))
            gb = jax.random.normal(jrng.stream(bk, jrng.FUZZ), (chunk, 6))
            np.testing.assert_array_equal(rnd[b, 0:9, cid, :chunk],
                                          np.asarray(ub).T)
            np.testing.assert_array_equal(rnd[b, 9:15, cid, :chunk],
                                          np.asarray(gb).T)
            assert not rnd[b, :, cid, chunk:].any()   # dead pad lanes
