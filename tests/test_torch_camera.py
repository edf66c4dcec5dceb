"""The port's camera vs rust_ray_tracer_tpu/ops/camera.py."""

import numpy as np
import jax
import pytest
import torch

from rust_ray_tracer_tpu.ops import camera as jc
from rust_ray_tracer_tpu_torch.ops import camera as tc
from rust_ray_tracer_tpu_torch.utils import rng


@pytest.mark.parametrize("w,h", [(64, 36), (37, 23), (512, 288)])
def test_morton_orders_identical(w, h):
    jp, ji = jc._pixel_order(w, h)
    tp, ti = tc._pixel_order(w, h)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(ji, ti)
    for chunk in (256, 1000, 9216):
        np.testing.assert_array_equal(
            jc._pixel_order_chunked(w, h, chunk, True),
            tc._pixel_order_chunked(w, h, chunk))


@pytest.mark.parametrize("pose", [
    ((278, -278, -800), (278, -278, 0)),     # Cornell
    ((13, -2, 3), (0, 0, 0)),                # random / earth
    ((26, -6, 6), (0, -2, 0)),               # rect_light
])
def test_look_at_and_camera_identical(pose):
    eye, at = pose
    jm = np.asarray(jc.look_at_rh(eye, at, (0.0, 1.0, 0.0)))
    tm = tc.look_at_rh(eye, at, (0.0, 1.0, 0.0))
    # XLA's rot @ eye may fuse differently from numpy's: ~1e-7 absolute
    # on the translation components that cancel to ~0
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-6)
    jcam = jc.make_camera(jm, 40.0, 16 / 9, 0.0, 1.0)
    tcam = tc.make_camera(jm, 40.0, 16 / 9, 0.0, 1.0)
    for f in ("c2w", "scale", "aspect", "time0", "time1"):
        np.testing.assert_array_equal(np.asarray(getattr(jcam, f)),
                                      getattr(tcam, f).numpy())


@pytest.mark.parametrize("chunk_id", [0, 1, 2])
def test_camera_rays_for_chunk(chunk_id):
    """Jitter/time streams from the global chunk id, pad tail clamped to
    the last pixel (chunk 2 of a 50x47 image at 1000 rays is ragged)."""
    c2w = jc.look_at_rh((278, -278, -800), (278, -278, 0), (0, 1, 0))
    jcam = jc.make_camera(c2w, 40.0, 1.3, 0.0, 1.0)
    tcam = tc.make_camera(np.asarray(c2w), 40.0, 1.3, 0.0, 1.0)
    wk = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    tk = rng.fold_in(rng.key(3, "cpu"), 1)
    o, d, t, ck = jc.camera_rays_for_chunk(jcam, wk, chunk_id, 1000, 50, 47)
    o2, d2, t2, ck2 = tc.camera_rays_for_chunk(tcam, tk, chunk_id, 1000, 50,
                                               47)
    # the 3-term sum of transform_point may reassociate
    np.testing.assert_allclose(o2.numpy(), np.asarray(o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(t), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ck2.numpy(), np.asarray(ck))


def test_image_from_positions_exact():
    w, h = 37, 23
    flat = np.random.default_rng(0).normal(size=(w * h, 3)).astype(np.float32)
    ref = np.asarray(jc.image_from_positions(jax.numpy.asarray(flat), w, h))
    got = tc.image_from_positions(torch.from_numpy(flat), w, h).numpy()
    np.testing.assert_array_equal(got, ref)
