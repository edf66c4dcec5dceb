"""Kernel N's sweep (``csrc/sphere.cu`` ``sph_search_kernel``) on the CPU:
``ops/sphere.sph_sweep_replay`` replays it in torch (live rays packed per
256-ray tile, the tile's vote on the cluster boxes, each warp's vote on
the 32-row sub-boxes of ``ops/sphere.sph_boxes``, the staged
test), since a CUDA kernel cannot run here. Its winners are held bit for
bit to ``ops/sphere.sph_search_plain`` and, indices equal and t by the
float64 arbiter of ``tests/test_torch_sphere.py`` (XLA contracts the
discriminant into an FMA, so JAX's t is not the port's to the ulp; on
the hand-made table t within :data:`T_RTOL` of JAX's), to JAX's
``pallas_sphere.sph_search`` in interpret mode:

  * on each bounce of a 32x16 wave of ``random`` with a 64x32 earth map
    (1,024 sphere rows in eight clusters, moving spheres, dead lanes
    after bounce 0), and on two bounces' rays together against JAX;
  * on ``torch_parity.hollow_spheres``: a hand-made table whose hollow
    spheres (r < 0) sit at the edges of 32-row groups (inside a glass
    sphere at rows 30-31 and 159-160, alone at row 32) in two flagged
    clusters, beside a third without one, whose sub-boxes the warps vote
    on in the same call, with rays whose windows are empty or collapsed
    and a short last tile.

The sub-boxes contain every row's swept box where no row of the cluster
has r < 0, equal the cluster box (flagged) where one does, and are
inverted over the table's far pad rows. The replay's tests fall from the
per-tile cull's on every bounce.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models.scene import CLUSTER, compile_scene
from rust_ray_tracer_tpu_torch.ops import search, sphere
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.test_torch_sphere import _assert_same_hits, _exact, _jax_sph
from tests.torch_parity import (hollow_spheres, jax_compile,
                                split_kernel_inputs, split_recorder,
                                write_earth_map)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

# t of the hollow table against JAX's: the discriminant cancels and XLA
# contracts it into an FMA (tests/test_torch_sphere.py); measured 2.6e-5
# at most, on an ordinary row (row 3)
T_RTOL = 5e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)


@pytest.fixture
def random_scene(tmp_path, monkeypatch):
    """The port's ``random`` (aspect 2) with a 64x32 earth map, compiled in
    ``tmp_path`` (the working directory for the test)."""
    write_earth_map(tmp_path, 64, 32)
    monkeypatch.chdir(tmp_path)
    return compile_scene(tb.get_scene("random", 2.0), device="cpu")


def _hollow(lib):
    """``hollow_spheres``' table as a scene-like namespace of ``lib``'s
    arrays (torch tensors or jax arrays), and its rays as a torch tensor."""
    fields, rays = hollow_spheres()
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return (types.SimpleNamespace(**{k: conv(v) for k, v in fields.items()}),
            torch.from_numpy(rays))


def _equal(got, ref):
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1].long(), ref[1].long())


def test_replay_matches_plain_on_every_bounce(random_scene):
    ts = random_scene
    with split_recorder() as rec:
        render_waves(ts, 32, 16, rng.key(7, "cpu"), 0, 1, depth=4,
                     chunk_size=512)
    assert len(rec["sph"]) == 4
    boxes = sphere.sph_boxes(ts)
    fewer = []
    for b, args in enumerate(rec["sph"]):
        rays, tab, cl_min, cl_max, n_sph, chunk, route_boxes = args
        assert torch.equal(route_boxes, boxes)
        ref = sphere.sph_search_plain(*args)
        got_t, got_i, work = sphere.sph_sweep_replay(*args)
        _equal((got_t, got_i), ref)
        assert work["live_rays"] == int((rays[8] > rays[7]).sum())
        assert work["ray_tests"] <= work["tests"] <= work["tile_tests"]
        assert work["ray_root_tests"] <= work["root_tests"] <= work["tests"]
        assert work["ray_box_tests"] <= work["box_tests"]
        fewer.append(work["tests"] < work["tile_tests"])
        if b == 0:
            assert bool(torch.isfinite(got_t).any())
    assert all(fewer)


def test_replay_matches_kernel_n_interpret(interpret, random_scene,
                                           monkeypatch):
    ts = random_scene
    js = jax_compile(jb.get_scene("random", 2.0), monkeypatch)
    rays, tab, cl_min, cl_max, n_sph, chunk, boxes = split_kernel_inputs(
        ts, 32, 16, 2)["sph"]
    assert rays.shape == (9, 1024) and chunk == 512
    got = sphere.sph_sweep_replay(rays, tab, cl_min, cl_max, n_sph, chunk,
                                  boxes)
    _equal(got[:2], sphere.sph_search_plain(rays, tab, cl_min, cl_max,
                                            n_sph, chunk))
    fin = _assert_same_hits(got[:2], _jax_sph(js, rays),
                            _exact(rays, tab, cl_min, cl_max, n_sph, chunk))
    assert 0.3 < fin.mean() < 1.0


def test_replay_hollow_table_matches_plain_and_kernel_n(interpret):
    sc, rays = _hollow("torch")
    js, _ = _hollow("jax")
    n_sph = sc.sph_c0.shape[0]
    tab = sphere.sph_table(sc)
    boxes = sphere.sph_boxes(sc)
    per = CLUSTER // sphere.SUB_ROWS
    assert tab.shape == (3 * CLUSTER, 12)
    assert boxes[:, 3].tolist() == [1.0] * (2 * per) + [0.0] * per
    ref = sphere.sph_search_plain(rays, tab, sc.sph_cluster_min,
                                  sc.sph_cluster_max, n_sph)
    got_t, got_i, work = sphere.sph_sweep_replay(
        rays, tab, sc.sph_cluster_min, sc.sph_cluster_max, n_sph, None,
        boxes)
    _equal((got_t, got_i), ref)
    ref_t, ref_i = _jax_sph(js, rays)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t.numpy()), fin)
    np.testing.assert_allclose(got_t.numpy()[fin], ref_t[fin], rtol=T_RTOL)
    empty = (rays[8] <= rays[7]).numpy()
    assert not fin[empty].any() and (got_i.numpy()[empty] == 0).all()
    # a hollow sphere wins somewhere (the flagged clusters are swept), and
    # so does a row of the third cluster, whose sub-boxes the warps vote on
    won = got_i[torch.isfinite(got_t)]
    assert bool((sc.sph_r[won] < 0).any())
    assert bool((won >= 2 * CLUSTER).any())
    assert work["box_tests"] > 0
    assert work["ray_tests"] <= work["tests"] < work["tile_tests"]
    assert work["ray_root_tests"] <= work["root_tests"]


def test_sub_boxes_contain_their_rows(random_scene):
    sc, _ = _hollow("torch")
    for scene, hollow in ((random_scene, ()), (sc, (0, 1))):
        c0, c1, r = scene.sph_c0, scene.sph_c1, scene.sph_r
        lo = torch.minimum(c0, c1) - r[:, None]
        hi = torch.maximum(c0, c1) + r[:, None]
        n, rows = c0.shape[0], sphere.SUB_ROWS
        boxes = sphere.sph_boxes(scene)
        per = CLUSTER // rows
        assert boxes.shape == (scene.sph_cluster_min.shape[0] * per, 8)
        assert boxes.data_ptr() % 16 == 0 and bool((boxes[:, 7] == 0).all())
        for b in range(boxes.shape[0]):
            c, rs = b // per, slice(b * rows, min((b + 1) * rows, n))
            if c in hollow:
                assert boxes[b, 3] == 1.0
                assert torch.equal(boxes[b, 0:3], scene.sph_cluster_min[c])
                assert torch.equal(boxes[b, 4:7], scene.sph_cluster_max[c])
            elif b * rows >= n:                      # the table's far pads
                assert boxes[b, 3] == 0.0
                assert bool((boxes[b, 0:3] == torch.inf).all())
                assert bool((boxes[b, 4:7] == -torch.inf).all())
            else:
                assert boxes[b, 3] == 0.0
                assert bool((boxes[b, 0:3] <= lo[rs]).all())
                assert bool((boxes[b, 4:7] >= hi[rs]).all())


def test_sph_table_rows(random_scene):
    ts = random_scene
    tab = sphere.sph_table(ts)
    n, k = ts.n_spheres, ts.sph_cluster_min.shape[0]
    assert tab.shape == (k * CLUSTER, 12) and tab.is_contiguous()
    assert torch.equal(tab[:n, :9], search.sphere_rows(ts))
    assert torch.equal(tab[:, 9], tab[:, 8] * tab[:, 8])
    assert bool((tab[:, 10:] == 0).all())
    assert bool((tab[n:, 0:3] == sphere.FAR).all())
    assert bool((tab[n:, 3:] == 0).all())
