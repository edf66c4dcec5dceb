"""glTF scenes (``models/gltf.py``, ``Mesh``, Mesh media; ROADMAP queue 1
item 4) and the 9-light slice (TPU kernels I and I') against the JAX
package on the CPU. Every file is written by the test
(``torch_parity.GltfWriter``); none is read from the reference's assets.

  * The loader: the port's ``load_gltf_scene`` + ``compile_scene`` against
    the JAX package's on three files — a data-URI ``.gltf`` (u16 indices,
    a TRS node tree with a child mesh, Lambertian, no lights, no camera),
    an external-``.bin`` ``.gltf`` (u32 indices, a strided accessor, a
    matrix node, Metal and Lambertian, 9 point lights, a camera) and a
    ``.glb`` (no indices, a primitive with no material, 9 point lights, a
    camera without an aspect ratio): every ``SceneData`` leaf equal,
    integers exactly and floats within 1 ulp (measured: equal, but the
    default camera's ``scale``, 1 ulp apart: the two packages' own
    ``make_camera``).
  * The slice: the 9-light glTF flagship (``torch_parity.
    write_gltf_flagship``: the procedural flagship's 968 triangles and 9
    point lights) at 32x18, 2 spp, depth 2, chunk 576, on the split route
    (K, M, J, ``texture_value``, I; I', J' in the backward), against the
    JAX package's ``render_waves`` (its XLA route, ``shade_core`` where
    its TPU runs kernel I): the image under the flip budget of
    ``tests/test_uber.py`` and the gradient of ``mean(render_waves(...))``
    by ``jax.vjp`` against torch autograd, ``tri_v0``, ``tex_color``,
    ``light_c``, ``light_r`` and ``camera.c2w`` within 16 rays' share
    (``tests/test_torch_split_grad.py``'s budget) and non-zero (measured:
    the image within 8.5e-5, the gradients within 1.1e-4 rays' share).
  * The ``.glb`` single-light flagship compiles to
    ``builders.procedural_flagship()``'s tables but for the triangles'
    double-sided flag, takes the trace kernel's route, and renders as
    JAX's at 32x18, 1 spp, depth 2.
  * A Mesh medium boundary (``torch_parity.mesh_medium``: the 12-triangle
    cube, Translate/RotateY-wrapped once, beside a world-object Mesh): its
    ``med_tri`` and ``_med_t`` against JAX's (rtol 1e-5), and a depth-2
    render at 16x16 against JAX's.
  * The CLI's ``-g``: the PNG of the 9-light file at 16x9, 1 spp against
    the JAX package's CLI, its mean within 0.5 of 255 (measured: the
    same bytes).
  * ``composite`` raises ``FileNotFoundError`` without the reference's
    assets, in both packages.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.models import composite as jcomposite
from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.models.gltf import load_gltf_scene as jload
from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu.ops.intersect import _med_t as jax_med_t
from rust_ray_tracer_tpu.utils import cli as jcli
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import composite as tcomposite
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import (SceneData, combine,
                                                    compile_scene, partition)
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import (make_split_tables,
                                                      render_waves,
                                                      split_reason)
from rust_ray_tracer_tpu_torch.ops.intersect import _med_t
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import rng
from rust_ray_tracer_tpu_torch.utils.image import decode_image

from tests.torch_parity import (GLTF_LIGHTS, GltfWriter, assert_flip_budget,
                                jax_compile, mesh_medium, scene_dict,
                                split_recorder, write_gltf_flagship)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

NONZERO = ("tri_v0", "tex_color", "light_c", "light_r", "camera.c2w")


def _tris(seed, n, z):
    """``n`` random triangles near (0, 0, z)."""
    rng_ = np.random.default_rng(seed)
    v0 = rng_.uniform(-1, 1, (n, 1, 3)) + (0.0, 0.0, z)
    return (v0 + np.concatenate([np.zeros((n, 1, 3)), rng_.uniform(
        -0.3, 0.3, (n, 2, 3))], 1)).astype(np.float32)


def _quat(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    h = np.deg2rad(deg) / 2
    return [*(np.sin(h) * axis), np.cos(h)]


def _lights(w, parent=None):
    """The 9 flagship point lights, the last three children of
    ``parent``."""
    kids = []
    for i, (pos, color, intensity) in enumerate(GLTF_LIGHTS[:9]):
        node = w.node(root=parent is None or i < 6,
                      translation=list(pos), light=w.light(color, intensity))
        if parent is not None and i >= 6:
            kids.append(node)
    if kids:
        w.doc["nodes"][parent]["children"] = (
            w.doc["nodes"][parent].get("children", []) + kids)


def _write(case, tmp_path):
    w = GltfWriter()
    if case == "data_uri":
        mat = w.material((0.7, 0.4, 0.2))
        child = w.node(root=False, mesh=w.mesh(_tris(1, 20, 0.0), mat,
                                               index="u16"),
                       translation=[0.5, -0.25, 0.0])
        w.node(translation=[0.0, 0.5, -4.0], rotation=_quat((0, 1, 0.3), 35),
               scale=[1.5, 1.0, 0.8], children=[child])
        return w.save(tmp_path / "a.gltf", "data_uri")
    if case == "bin":
        metal = w.material((0.9, 0.8, 0.7), metallic=1.0, roughness=0.3)
        lam = w.material((0.2, 0.6, 0.3))
        m = np.eye(4)
        c, s = np.cos(0.6), np.sin(0.6)
        m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        m[:3, 3] = (0.3, -0.2, -5.0)
        w.node(mesh=w.mesh(_tris(2, 24, 0.0), metal, index="u32",
                           strided=True),
               matrix=[float(x) for x in m.T.reshape(-1)])
        w.node(mesh=w.mesh(_tris(3, 16, -4.0), lam, index="u32"))
        root = w.node(translation=[0.0, 0.2, 0.0])
        _lights(w, root)
        w.node(camera=w.camera(0.6, 1.5), translation=[0.0, 0.5, 1.0],
               rotation=_quat((1, 0, 0), -5))
        return w.save(tmp_path / "b.gltf", "bin")
    metal = w.material((0.5, 0.5, 0.9), metallic=0.5, roughness=0.1)
    w.node(mesh=w.mesh(_tris(4, 30, -4.0), metal, index=None))
    w.node(mesh=w.mesh(_tris(5, 10, -3.0), None, index=None))
    _lights(w)
    w.node(camera=w.camera(0.5))
    return w.save(tmp_path / "c.glb", "glb")


@pytest.mark.parametrize("case", ["data_uri", "bin", "glb"])
def test_loader_matches_jax(case, tmp_path, monkeypatch):
    path = _write(case, tmp_path)
    jh, th = jload(path, 16 / 9), load_gltf_scene(path, 16 / 9)
    assert len(jh.world) == len(th.world) and len(jh.lights) == len(
        th.lights) == (0 if case == "data_uri" else 9)
    ref = scene_dict(jax_compile(jh, monkeypatch))
    ts = compile_scene(th, device="cpu")
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            got = {f"camera.{k}": getattr(ts.camera, k).numpy()
                   for k in ("c2w", "scale", "aspect", "time0", "time1")}
        else:
            got = {f.name: getattr(ts, f.name).numpy()}
        for k, g in got.items():
            r = ref[k]
            assert g.shape == r.shape, k
            if np.issubdtype(r.dtype, np.floating):
                np.testing.assert_array_max_ulp(g, r, maxulp=1)
            else:
                np.testing.assert_array_equal(g, r, err_msg=k)
    assert sum(isinstance(o, TS.Triangle) for o in th.world) == {
        "data_uri": 20, "bin": 40, "glb": 40}[case]
    if case != "data_uri":
        assert set(ts.mat_kind.tolist()) >= {TS.MAT_METAL, TS.MAT_LIGHT}


def _grads(g):
    out = {k: np.asarray(getattr(g, k)) for k in g._fields if k != "camera"}
    out.update({f"camera.{k}": np.asarray(v)
                for k, v in g.camera._asdict().items()})
    return out


def test_nine_light_flagship_matches_jax(tmp_path, monkeypatch):
    w, h, spp, depth, chunk = 32, 18, 2, 2, 576
    path = write_gltf_flagship(tmp_path / "f9.gltf")
    js = jax_compile(jload(path, 16 / 9), monkeypatch)
    ts = compile_scene(load_gltf_scene(path, 16 / 9), device="cpu")
    tables = make_split_tables(ts)
    assert ts.n_lights == 9 and split_reason(ts) is None
    assert not (uber.uber_eligible(ts) or tables.fused or tables.su)
    assert tables.unified
    diff, static = jpartition(js)
    ref, vjp = jax.vjp(lambda d: jax_render(
        jcombine(d, static), w, h, jax.random.PRNGKey(0), 0, spp,
        depth=depth, chunk_size=chunk), diff)
    (g,) = vjp(jnp.full_like(ref, 1.0 / ref.size))
    g_ref = _grads(g)
    params, static_t = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    with split_recorder() as rec:
        img = render_waves(combine(leaves, static_t), w, h,
                           rng.key(0, "cpu"), 0, spp, depth=depth,
                           chunk_size=chunk)
    assert len(rec["shade"]) == spp * depth and not rec["su"]
    img.mean().backward()
    got = img.detach().numpy()
    assert got.mean() > 0.05
    assert_flip_budget(got, np.asarray(ref))
    share = 1.0 / (w * h * 3)
    for k in NONZERO:
        gk = leaves[k].grad.numpy()
        assert np.isfinite(gk).all(), k
        np.testing.assert_array_less(np.abs(gk - g_ref[k]), 16 * share,
                                     err_msg=k)
        assert np.abs(gk).max() > 0 and np.abs(g_ref[k]).max() > 0, k
    for k, v in leaves.items():
        assert v.grad is None or bool(torch.isfinite(v.grad).all()), k


def test_glb_single_light_flagship(tmp_path, monkeypatch):
    path = write_gltf_flagship(tmp_path / "f1.glb", 1, "glb")
    ts = compile_scene(load_gltf_scene(path, 16 / 9), device="cpu")
    flag = compile_scene(tb.procedural_flagship(), device="cpu")
    for f in dataclasses.fields(SceneData):
        a, b = getattr(ts, f.name), getattr(flag, f.name)
        if f.name == "camera":
            for k in ("c2w", "scale", "aspect", "time0", "time1"):
                assert torch.equal(getattr(a, k), getattr(b, k)), k
        elif f.name == "tri_double":
            assert not a[:968].any() and b[:968].all()
        else:
            assert a.shape == b.shape and torch.equal(a, b), f.name
    assert uber.uber_eligible(ts)
    js = jax_compile(jload(path, 16 / 9), monkeypatch)
    got = render_waves(ts, 32, 18, rng.key(0, "cpu"), 0, 1, depth=2,
                       chunk_size=576).numpy()
    ref = np.asarray(jax_render(js, 32, 18, jax.random.PRNGKey(0), 0, 1,
                                depth=2, chunk_size=576))
    assert got.mean() > 0.01
    assert_flip_budget(got, ref)


def test_mesh_medium_matches_jax(monkeypatch):
    js = jax_compile(mesh_medium(JS, jcam), monkeypatch)
    ts = compile_scene(mesh_medium(TS, tcam), device="cpu")
    assert ts.med_kind.tolist() == [TS.MED_MESH]
    assert tuple(ts.med_tri.shape) == (1, 12, 10)
    assert bool((ts.med_tri[..., 9] == 1.0).all())
    np.testing.assert_array_max_ulp(ts.med_tri.numpy(),
                                    np.asarray(js.med_tri), maxulp=1)
    # _med_t on rays from around the camera aimed near the cube, a tenth
    # with a collapsed (dead) window
    r = np.random.default_rng(0)
    c = 512
    o = r.uniform(-1, 1, (c, 3)).astype(np.float32)
    d = ((-0.6, 0.0, -3.6) + r.normal(scale=0.4, size=(c, 3)) - o).astype(
        np.float32)
    med_u = r.uniform(0, 1, (c, 1)).astype(np.float32)
    t_min = np.full(c, 1e-4, np.float32)
    t_max = np.where(r.uniform(size=c) < 0.9, np.inf, -1.0).astype(
        np.float32)
    ref = np.asarray(jax_med_t(js, *(jnp.asarray(x) for x in (
        o, d, med_u, t_min, t_max))))
    got = _med_t(ts, *(torch.from_numpy(x) for x in (
        o, d, med_u, t_min, t_max))).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.mean() > 0.2
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-6)
    img = render_waves(ts, 16, 16, rng.key(0, "cpu"), 0, 2, depth=2,
                       chunk_size=256).numpy()
    ref_img = np.asarray(jax_render(js, 16, 16, jax.random.PRNGKey(0), 0, 2,
                                    depth=2, chunk_size=256))
    assert img.mean() > 0.05
    assert_flip_budget(img, ref_img)


def test_cli_gltf_matches_jax(tmp_path):
    path = write_gltf_flagship(tmp_path / "f9.gltf")
    out_t, out_j = tmp_path / "t.png", tmp_path / "j.png"
    assert cli.main(["9", "1", "-g", path, "-a", str(16 / 9), "-o",
                     str(out_t), "--device", "cpu"]) == 0
    assert jcli.main(["9", "1", "-g", path, "-a", str(16 / 9), "-o",
                      str(out_j), "--devices", "1"]) == 0
    got = decode_image(out_t.read_bytes()).astype(np.float64)
    ref = decode_image(out_j.read_bytes()).astype(np.float64)
    assert got.shape == ref.shape == (9, 16, 3)
    assert got.mean() > 10
    np.testing.assert_allclose(got.mean(), ref.mean(), atol=0.5)


def test_composite_needs_the_assets(tmp_path):
    for mod in (jcomposite, tcomposite):
        with pytest.raises(FileNotFoundError):
            mod.composite_scene(1.0, assets_dir=str(tmp_path))
