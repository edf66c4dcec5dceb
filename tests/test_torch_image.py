"""Image textures in the port (the earth map of the reference's random,
earth, two_spheres and final_scene) against the JAX package on the CPU.

  * Decoders: ``utils/image.decode_image`` of the port and of the JAX
    package give the same bytes on PNG (synthesized rows under every
    filter type 0-4, RGB and RGBA, and PIL's own), baseline JPEG (4:4:4,
    4:2:2, 4:2:0, grey), progressive JPEG, BMP, GIF and TIFF (raw, LZW,
    PackBits) files written by PIL; ``ImageTexture.load`` gives the same
    array in both packages through PIL and, with the PIL import blocked,
    through their own decoders.
  * Compile: the builder scenes that read ``./earthmap.jpg`` (a 64x32 map
    in the test's working directory) compile to the same tables in both
    packages under ``torch_parity.pin_jax_texture_cache`` (the two
    ``_earth_texture()`` temporaries of two_spheres and final_scene are
    the case ``id()`` caching can alias): texture rows, atlas and sizes
    equal; and a JAX-compiled scene carried across by
    ``scene_from_numpy`` equals the port's own compile field for field
    (the camera within 1e-6, as ``tests/test_torch_scene.py`` holds it:
    ``look_at_rh`` in torch and in jnp).
  * The image leaf: ``ops/texture.texture_value`` against JAX's on the
    same (texture id, u, v, p), u and v at 0, at 1 and outside [0, 1],
    an image as a checker's leaf among them: equal. Its gradient with
    respect to ``img_data`` (the texel gathers' row sums) against
    ``jax.vjp`` within 1e-6 (sums of the same cotangents in another
    order).
  * The whole slice: random with the map at 32x18, 2 spp, depth 2 through
    ``render_waves`` (TPU kernel N a bounce for its 1,024 sphere rows, J,
    ``texture_value``, H) and ``torch.autograd`` of the render's mean
    over every float leaf, against JAX's TPU route in interpret mode
    (its render and gradients from one ``jax.vjp``). random's camera
    never sees its earth sphere at (4, 1, 0), so ``img_data`` would take
    no gradient in either package at this size:
    ``torch_parity.random_earth_view`` adds a second earth sphere where
    the camera looks. The image under
    ``torch_parity.assert_flips_arbitrated`` (the flip budget with a
    float64 render of the port as the arbiter; measured at seeds 0-3:
    0, 1, 1, 2 flips, of which 0, 0, 1, 2 count, of 576 pixels; the port
    off float64 on 8, 10, 11, 13 pixels, JAX on 8, 11, 11, 11); every
    leaf's gradient within 16 rays' share (``1 / (W * H * 3)``) of JAX's,
    as final_scene's gradients are held (measured at seed 0: 11.4 rays'
    share at most, on ``camera.c2w``); ``img_data`` within 1e-5 of its
    largest gradient (measured 3.5e-6, 6.0e-6, 4.0e-6, 2.6e-6 at seeds
    0-3, 34-38 texels). At seeds 1-3 the marble ground forks paths
    between the packages and the geometry's and camera's gradients differ
    by up to 3,286 rays' share, where each float32 package is hundreds to
    thousands of rays' share from a float64 replay of the port.
"""

import builtins
import dataclasses
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import texture as jtex
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu.utils import image as jimage
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition,
                                                    scene_from_numpy)
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import texture as ttex
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import (render_waves,
                                                      split_reason)
from rust_ray_tracer_tpu_torch.utils import image as timage
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_flips_arbitrated, jax_compile,
                                random_earth_view, scene_dict, split_recorder,
                                write_earth_map)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture
def earth_dir(tmp_path, monkeypatch):
    """A working directory holding a 64x32 ``earthmap.jpg``."""
    write_earth_map(tmp_path, 64, 32)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def split_route(monkeypatch):
    """The JAX package's split route on the CPU: its Pallas kernels in
    interpret mode, the integrator told it runs on a TPU."""
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)


def _block_pil(monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name.startswith("PIL"):
            raise ImportError("blocked")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _picture(h=21, w=30, ch=3):
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [xx * 255 // w, yy * 255 // h, (xx * yy) % 256,
              (xx + 2 * yy) * 255 // (w + 2 * h)]
    return np.stack(planes[:ch], -1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_every_filter(img):
    """An 8-bit RGB(A) PNG whose rows take the filter types 0-4 in turn."""
    h, w, ch = img.shape
    prev = np.zeros(w * ch, np.int64)
    rows = []
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        ft = y % 5
        out = np.zeros_like(cur)
        for i in range(cur.size):
            a = cur[i - ch] if i >= ch else 0
            b = prev[i]
            c = prev[i - ch] if i >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            out[i] = (cur[i] - pred) & 0xFF
        rows.append(bytes([ft]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    color = 2 if ch == 3 else 6
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _pil_bytes(img, fmt, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


FILES = {
    "png_filters_rgb": lambda: _png_every_filter(_picture()),
    "png_filters_rgba": lambda: _png_every_filter(_picture(ch=4)),
    "png_pil": lambda: _pil_bytes(_picture(), "PNG", optimize=True),
    "jpeg_444": lambda: _pil_bytes(_picture(40, 56), "JPEG", quality=90,
                                   subsampling=0),
    "jpeg_422": lambda: _pil_bytes(_picture(40, 56), "JPEG", quality=90,
                                   subsampling=1),
    "jpeg_420": lambda: _pil_bytes(_picture(40, 56), "JPEG", quality=90,
                                   subsampling=2),
    "jpeg_grey": lambda: _pil_bytes(_picture(40, 56)[..., 0], "JPEG",
                                    quality=85),
    "jpeg_progressive": lambda: _pil_bytes(
        _picture(41, 57), "JPEG", quality=90, progressive=True,
        restart_marker_blocks=2),
    "bmp": lambda: _pil_bytes(_picture(), "BMP"),
    "gif": lambda: _pil_bytes(_picture(), "GIF"),
    "tiff": lambda: _pil_bytes(_picture(), "TIFF"),
    "tiff_lzw": lambda: _pil_bytes(_picture(), "TIFF",
                                   compression="tiff_lzw"),
    "tiff_packbits": lambda: _pil_bytes(_picture(), "TIFF",
                                        compression="packbits"),
}


@pytest.mark.parametrize("name", list(FILES))
def test_decoders_match_jax(name):
    pytest.importorskip("PIL")
    data = FILES[name]()
    got = timage.decode_image(data)
    ref = jimage.decode_image(data)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, ref)
    if name.startswith("png"):
        np.testing.assert_array_equal(got, _picture()[..., :3])


@pytest.mark.parametrize("block_pil", [False, True],
                         ids=["via-PIL", "self-contained"])
@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "BMP"])
def test_image_texture_loads_as_jax(tmp_path, monkeypatch, fmt, block_pil):
    """``ImageTexture(path).load()`` of both packages on one file: equal
    arrays, through PIL or, with its import blocked, the decoders; a file
    that decodes as nothing is None in both."""
    pytest.importorskip("PIL")
    path = tmp_path / f"tex.{fmt.lower()}"
    path.write_bytes(_pil_bytes(_picture(), fmt))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    if block_pil:
        _block_pil(monkeypatch)
    got = TS.ImageTexture(path=str(path)).load()
    ref = JS.ImageTexture(path=str(path)).load()
    assert got is not None and got.dtype == np.float32
    assert got.shape == (21, 30, 3)
    np.testing.assert_array_equal(got, ref)
    assert TS.ImageTexture(path=str(bad)).load() is None
    assert JS.ImageTexture(path=str(bad)).load() is None


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

def _fields(sd):
    params, static = partition(sd)
    return {**params, **static}


@pytest.mark.parametrize("name", ["random", "earth", "two_spheres",
                                  "final_scene"])
def test_earth_scenes_compile_as_jax(name, earth_dir, monkeypatch):
    js = jax_compile(jb.get_scene(name, 2.0), monkeypatch)
    ts = compile_scene(tb.get_scene(name, 2.0), device="cpu")
    ref = scene_dict(js)
    n_img = {"random": 1, "earth": 1, "two_spheres": 2, "final_scene": 2}
    assert ts.img_data.shape == (n_img[name], 32, 64, 3)
    for k in ("tex_kind", "tex_image", "tex_color", "tex_even", "tex_odd",
              "img_data", "img_size", "mat_tex", "mat_kind"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), ref[k],
                                      err_msg=k)
    assert int((ts.tex_kind == TS.TEX_IMAGE).sum()) == n_img[name]
    assert not uber.uber_eligible(ts) and split_reason(ts) is None
    own = _fields(ts)
    for k, v in _fields(scene_from_numpy(ref, device="cpu")).items():
        assert v.dtype == own[k].dtype and v.shape == own[k].shape, k
        if k.startswith("camera."):
            # look_at_rh in torch and in jnp (tests/test_torch_scene.py)
            np.testing.assert_allclose(v.numpy(), own[k].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), own[k].numpy(),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# the image leaf
# ---------------------------------------------------------------------------

def _leaf_host(S, cam_mod):
    """Two images of different sizes (an image leaf and a checker whose
    odd leaf is the second), a solid and a checker of solids."""
    g = np.random.default_rng(2)
    a = g.random((8, 16, 3)).astype(np.float32)
    b = g.random((5, 7, 3)).astype(np.float32)
    grey = S.SolidColor((0.5, 0.5, 0.5))
    world = [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian(S.ImageTexture(data=a))),
        S.Sphere((2, 0, -4), 1.0, S.Lambertian(S.Checker(
            grey, S.ImageTexture(data=b)))),
        S.Sphere((-2, 0, -4), 1.0, S.Lambertian.from_rgb(0.2, 0.3, 0.4)),
        S.Sphere((0, 2, -4), 1.0, S.Lambertian(S.Checker.from_colors(
            (0.9, 0.1, 0.1), (0.1, 0.9, 0.1)))),
    ]
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return S.Scene(cam, world, [], (0.5, 0.7, 1.0))


def test_image_leaf_matches_jax(monkeypatch):
    js = jax_compile(_leaf_host(JS, jcam), monkeypatch)
    ts = compile_scene(_leaf_host(TS, tcam), device="cpu")
    assert ts.img_data.shape == (2, 8, 16, 3)
    n_tex = ts.tex_kind.shape[0]
    g = np.random.default_rng(4)
    edge = np.array([0.0, 1.0, -0.25, 1.5, 0.5, 1e-7, 1.0 - 1e-7],
                    np.float32)
    u = np.concatenate([np.repeat(edge, edge.size),
                        g.uniform(-0.1, 1.1, 200)]).astype(np.float32)
    v = np.concatenate([np.tile(edge, edge.size),
                        g.uniform(-0.1, 1.1, 200)]).astype(np.float32)
    n = u.size
    tid = np.arange(n, dtype=np.int32) % n_tex
    p = g.normal(size=(n, 3)).astype(np.float32)
    got = ttex.texture_value(ts, torch.from_numpy(tid), torch.from_numpy(u),
                             torch.from_numpy(v), torch.from_numpy(p))
    ref = jtex.texture_value(js, jnp.asarray(tid), jnp.asarray(u),
                             jnp.asarray(v), jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    cot = g.normal(size=(n, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda img: jtex.texture_value(
        js._replace(img_data=img), jnp.asarray(tid), jnp.asarray(u),
        jnp.asarray(v), jnp.asarray(p)), js.img_data)
    (ref_g,) = vjp(jnp.asarray(cot))
    img = ts.img_data.clone().requires_grad_()
    out = ttex.texture_value(dataclasses.replace(ts, img_data=img),
                             torch.from_numpy(tid), torch.from_numpy(u),
                             torch.from_numpy(v), torch.from_numpy(p))
    out.backward(torch.from_numpy(cot))
    ref_g = np.asarray(ref_g)
    assert np.abs(ref_g).max() > 0
    np.testing.assert_allclose(img.grad.numpy(), ref_g, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _jax_image_and_grads(js, w, h, spp, depth, seed):
    """JAX's render and the gradients of its mean over every float leaf,
    from one ``jax.vjp`` (one compile)."""
    diff, static = jpartition(js)
    img, vjp = jax.vjp(lambda d: jax_render(
        jcombine(d, static), w, h, jax.random.PRNGKey(seed), 0, spp,
        depth=depth, chunk_size=w * h), diff)
    (g,) = vjp(jnp.full(img.shape, 1.0 / img.size, img.dtype))
    out = {k: np.asarray(getattr(g, k)) for k in g._fields if k != "camera"}
    out.update({f"camera.{k}": np.asarray(v)
                for k, v in g.camera._asdict().items()})
    return np.asarray(img), out


def _port_image_and_grads(ts, w, h, spp, depth, seed):
    params, static = partition(ts)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    img = render_waves(combine(leaves, static), w, h, rng.key(seed, "cpu"),
                       0, spp, depth=depth, chunk_size=w * h)
    img.mean().backward()
    return img.detach().numpy(), {
        k: (torch.zeros_like(v) if v.grad is None else v.grad)
        .double().numpy() for k, v in leaves.items()}


def test_random_earth_matches_jax(split_route, earth_dir, monkeypatch):
    w, h, spp, depth = 32, 18, 2, 2
    js = jax_compile(random_earth_view(JS, jb, w / h), monkeypatch)
    ts = compile_scene(random_earth_view(TS, tb, w / h), device="cpu")
    assert ts.n_spheres == 1024 and ts.img_data.shape[0] == 2
    assert not uber.uber_eligible(ts) and split_reason(ts) is None
    with split_recorder() as rec:
        got, got_g = _port_image_and_grads(ts, w, h, spp, depth, 0)
    assert (len(rec["sph"]), len(rec["hit"]), len(rec["su"])) == (4, 4, 4)
    assert not rec["search"] and not rec["tri"]
    ref, ref_g = _jax_image_and_grads(js, w, h, spp, depth, 0)
    params, static = partition(ts)
    exact = render_waves(combine({k: v.double() for k, v in params.items()},
                                 static), w, h, rng.key(0, "cpu"), 0, spp,
                         depth=depth, chunk_size=w * h).numpy()
    assert got.shape == (h, w, 3) and got.mean() > 0.1
    assert_flips_arbitrated(got, ref, exact)

    share = 1.0 / (w * h * 3)
    for k, v in got_g.items():
        assert np.isfinite(v).all(), k
        np.testing.assert_array_less(np.abs(v - ref_g[k]), 16 * share,
                                     err_msg=k)
    img, img_ref = got_g["img_data"], ref_g["img_data"]
    np.testing.assert_array_less(np.abs(img - img_ref),
                                 1e-5 * np.abs(img_ref).max())
    assert int((np.abs(img).sum(-1) > 0).sum()) > 20
    for k in ("tex_color", "background", "sph_c0", "camera.c2w"):
        assert np.abs(got_g[k]).max() > 0 and np.abs(ref_g[k]).max() > 0, k
