"""Kernel M's packed input (``ops/search.py``: ``packed_rows``,
``assemble_rows``, ``search_tables(..., packed=True)``) and clusters wider
than 128 triangles, against the JAX package on the CPU.

  * (a) ``assemble_rows(packed_rows(scene))`` is ``compact_rows(
    _tri_coeffs(...))`` bit for bit, on a scene with zero-area pad rows,
    collinear triangles, millimetre-scale ones (edges ~1e-5, the case
    ``rust_ray_tracer_tpu/ops/intersect.py:89-92`` describes) and
    coordinates near 1e3;
  * (b) the port's packed ``search`` against JAX's ``fused_search`` with
    ``INKERNEL_COEFFS=True`` (``_coeffs_from_pack``, interpret mode) on
    both of its grids (``RRT_PAIR`` 0 and 1), on
    ``tests/test_torch_search.py``'s tie scene and rays: kinds and indices
    equal, t within that test's 1e-5 relative; the port's packed winners
    its staged ones bit for bit;
  * (c) clusters of 256 and 2,048 triangles (``MAX_CLUSTERS`` lowered in
    both packages, so a cluster is 2 or 16 of M's 128-row stages; the
    second with pad rows): a 4,608-triangle mesh (past the trace
    kernel's 4,096 rows, so on the split route: a mesh of 1,024 to 2,048
    triangles renders on kernel A) rendered 24x12, 1 spp, depth 2
    with the packed and the staged input (the same bits) against JAX's
    ``render_waves`` under the flip budget; each recorded search's
    winners packed and staged bit for bit and, with the sort's gate
    lowered, the sorted search's;
  * (d) a u32 ``.gltf`` with an external ``.bin`` (``torch_parity.
    write_bigmesh``) compiles to the same tables in both packages, the
    cluster width 512 (floats within 1 ulp, as ``test_torch_gltf.py``),
    and the port's packed rows are JAX's packed [10, T] table transposed,
    bit for bit;
  * (e) ``torch_parity.flagship_tri_array``, the big mesh's vectorised
    draws, holds the vertices of ``flagship_tris`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.models.gltf import load_gltf_scene as jload
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import SceneData, compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import search
from rust_ray_tracer_tpu_torch.ops.integrator import (make_split_tables,
                                                      render_waves)
from rust_ray_tracer_tpu_torch.ops.intersect import _tri_coeffs
from rust_ray_tracer_tpu_torch.utils import rng

from tests.test_torch_search import T_RTOL, _tie_rays, _tie_scenes
from tests.torch_parity import (assert_flip_budget, flagship_tri_array,
                                flagship_tris, jax_compile, mesh, scene_dict,
                                split_recorder, write_bigmesh)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_winners(a, b):
    return (torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(a[1], b[1])
            and torch.equal(a[2], b[2]))


def _edge_tris(S):
    """Triangles at the edges of the assembly's arithmetic: collinear
    (zero area, det 0), millimetre-scale (edges ~1e-5: |n| ~1e-10),
    near 1e3 with small edges (t's constant cancels), a sliver, and a few
    ordinary ones; some double-sided."""
    g = np.random.default_rng(5)
    grey = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
    tris = []
    for i in range(40):
        v0 = g.uniform(-1, 1, 3).astype(np.float32)
        e1 = g.uniform(-1, 1, 3).astype(np.float32)
        kind = i % 5
        if kind == 0:                           # collinear, exactly
            v0, e1 = np.round(v0 * 8) / 8, np.round(e1 * 8) / 8
            v1, v2 = v0 + e1, v0 + np.float32(2.5) * e1
        elif kind == 1:                         # millimetre scale
            v0 = v0 * np.float32(1e-2)
            v1 = v0 + g.uniform(-1e-5, 1e-5, 3).astype(np.float32)
            v2 = v0 + g.uniform(-1e-5, 1e-5, 3).astype(np.float32)
        elif kind == 2:                         # near 1e3
            v0 = v0 + np.float32(1e3)
            v1 = v0 + g.uniform(-1e-2, 1e-2, 3).astype(np.float32)
            v2 = v0 + g.uniform(-1e-2, 1e-2, 3).astype(np.float32)
        elif kind == 3:                         # a sliver
            v1, v2 = v0 + e1, v0 + e1 * np.float32(0.5) + np.float32(1e-7)
        else:
            v1 = v0 + e1
            v2 = v0 + g.uniform(-1, 1, 3).astype(np.float32)
        tris.append(S.Triangle(v0, v1, v2, grey, double_sided=i % 2 == 0))
    return tris


def test_assembled_rows_are_the_compact_rows():
    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 30.0, 1.0)
    ts = compile_scene(TS.Scene(cam, _edge_tris(TS), [], (0, 0, 0)),
                       device="cpu")
    assert ts.n_tris == 128                       # 88 zero-area pad rows
    pack = search.packed_rows(ts)
    assert pack.shape == (128, search.PACK_ROW)
    ref = search.compact_rows(_tri_coeffs(ts.tri_v0, ts.tri_e1, ts.tri_e2),
                              ts.tri_double)
    got = search.assemble_rows(pack)
    assert torch.equal(_bits(got), _bits(ref))
    # the cases it is there for: zero rows (pads and collinear), rows
    # scaled from |n| ~1e-10, the flag carried
    assert int((ref[:, :3] == 0).all(1).sum()) >= 88 + 8
    assert bool((ref[:, 3:6].norm(dim=1) > 0.99).sum() >= 32)
    assert torch.equal(ref[:, search.TRI_FLAG], ts.tri_double.float())
    tabs = search.search_tables(ts, packed=True)
    assert tabs.packed and torch.equal(tabs.tri, pack)
    assert torch.equal(_bits(search.tri_rows(tabs)),
                       _bits(search.search_tables(ts, packed=False).tri))


@pytest.mark.parametrize("pair", ["0", "1"])
def test_packed_search_matches_jax_packed_kernel(pair, monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)
    js, ts, (a, _) = _tie_scenes(monkeypatch)
    o, d, time, t_min, t_max = _tie_rays(ts, a)
    monkeypatch.setenv("RRT_PAIR", pair)
    monkeypatch.setattr(pim, "INKERNEL_COEFFS", True)
    ref_t, ref_k, ref_i = (np.asarray(x) for x in pim.fused_search(
        js, *(jnp.asarray(x) for x in (o, d, time, t_min, t_max))))
    rays = search.ray_planes(*(torch.from_numpy(x) for x in
                               (o, d, time, t_min, t_max)))
    packed = search.search(rays, search.search_tables(ts, packed=True))
    staged = search.search(rays, search.search_tables(ts, packed=False))
    assert _same_winners(packed, staged)
    got_t, got_k, got_i = (x.numpy() for x in packed)
    np.testing.assert_array_equal(got_k, ref_k)
    np.testing.assert_array_equal(got_i, ref_i)
    assert set(got_k.tolist()) == {0, 1, 2, 3}
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t), fin)
    np.testing.assert_allclose(got_t[fin], ref_t[fin], rtol=T_RTOL)


def _wide(monkeypatch, max_clusters):
    """Both packages' ``MAX_CLUSTERS`` at ``max_clusters``."""
    monkeypatch.setattr(TS, "MAX_CLUSTERS", max_clusters)
    monkeypatch.setattr(JS, "MAX_CLUSTERS", max_clusters)


@pytest.mark.parametrize("max_clusters,width", [(18, 256), (4, 2048)])
def test_wide_clusters_match_jax(max_clusters, width, monkeypatch):
    w, h, chunk = 24, 12, 288
    _wide(monkeypatch, max_clusters)
    js = jax_compile(mesh(JS, jcam, 4608), monkeypatch)
    ts = compile_scene(mesh(TS, tcam, 4608), device="cpu")
    k = ts.tri_cluster_min.shape[0]
    assert ts.n_tris == k * width >= 4608
    np.testing.assert_array_equal(ts.tri_cluster_min.numpy(),
                                  np.asarray(js.tri_cluster_min))
    key = rng.key(0, "cpu")
    imgs, calls = {}, {}
    for packed in (True, False):
        monkeypatch.setattr(search, "packed_input", lambda n, p=packed: p)
        assert make_split_tables(ts).search.packed == packed
        with split_recorder() as rec:
            imgs[packed] = render_waves(ts, w, h, key, 0, 1, depth=2,
                                        chunk_size=chunk)
        calls[packed] = rec["search"]
        assert len(rec["search"]) == 2
    assert torch.equal(imgs[True], imgs[False])
    ref = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 1,
                                depth=2, chunk_size=chunk))
    got = imgs[True].numpy()
    assert got.mean() > 0.02
    assert_flip_budget(got, ref)
    # every recorded search: packed and staged, unsorted and sorted
    monkeypatch.setattr(search, "PACKED_MIN_TRIS", 0)
    for cp, cs in zip(calls[True], calls[False]):
        assert cp[2].packed and not cs[2].packed and cp[2].width == width
        rays, ent, _, chk = cp
        got = search.fused_search(*cp)
        assert _same_winners(got, search.fused_search(*cs))
        assert bool((got[1] == 1).any())
        perm = search.search_order(rays, cp[2], chk)
        assert _same_winners(search.search(rays, cp[2], chk, perm), got)


def test_u32_bin_gltf_tables_match_jax(tmp_path, monkeypatch):
    _wide(monkeypatch, 2)
    path = write_bigmesh(tmp_path, 1000)
    assert (tmp_path / "bigmesh.bin").exists()
    jh, th = jload(path, 16 / 9), load_gltf_scene(path, 16 / 9)
    assert len(jh.world) == len(th.world) == 1000
    assert not any(t.double_sided for t in th.world)
    js = jax_compile(jh, monkeypatch)
    ref = scene_dict(js)
    ts = compile_scene(th, device="cpu")
    assert ts.n_tris == 1024 and ts.tri_cluster_min.shape[0] == 2
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            continue
        g, r = getattr(ts, f.name).numpy(), ref[f.name]
        assert g.shape == r.shape, f.name
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_array_max_ulp(g, r, maxulp=1)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f.name)
    jpack = np.asarray(jnp.concatenate(
        [js.tri_v0.T, js.tri_e1.T, js.tri_e2.T,
         js.tri_double.astype(jnp.float32)[None, :]], axis=0))
    tabs = search.search_tables(ts)
    assert not tabs.packed                        # below the gate
    got = search.search_tables(ts, packed=True).tri.numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  jpack.T.view(np.int32))


@pytest.mark.parametrize("n_tris", [968, 4096])
def test_flagship_tri_array_is_flagship_tris(n_tris):
    want = np.array([[t.v0, t.v1, t.v2] for t in flagship_tris(TS, n_tris)],
                    dtype=np.float32)
    got = flagship_tri_array(n_tris)
    assert got.dtype == np.float32 and got.shape == (n_tris, 3, 3)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
