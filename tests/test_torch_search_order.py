"""The unified search's sort of the rays (``ops/search.search_order``,
JAX's ``intersect._search_order``) and the sweep of the redesigned kernel
M (``csrc/search.cu``), against the JAX package on the CPU.

  * (a) ``search_key`` and ``search_order`` against ``_search_order`` bit
    for bit: the 65,536-triangle mesh (``torch_parity.mesh``, exactly
    JAX's ``PACKED_MIN_TRIS``) rendered 24x12 on the split route, three
    bounces as the route's recorder gives them (dead lanes from bounce 1
    on), two chunks of 144 rays: JAX sorts each chunk in its own call,
    so the port's segmented sort is held chunk by chunk. JAX's key is the
    argument its ``_search_order`` hands ``jnp.argsort`` (a spy);
  * (b) the unified search with the sort gives the winners it gives
    without it (t, kind and index bit for bit), and ``intersect_select``
    the kinds and indices of JAX's ``intersect_select`` on its unified
    branch (``on_tpu`` patched, its Pallas kernels in interpret mode), on
    ``test_torch_search.py``'s tie scene with ``PACKED_MIN_TRIS`` lowered
    in both packages so the sort runs at 384 triangles;
  * (c) a replay of M's sweep (:func:`replay_search`: the live rays packed
    per tile, the compact 20-float rows (the mesh's packed rows
    assembled) summed term by term, the staged
    checks, the clusters front to back by K's entry, dealt to parts) held
    to ``fused_search_plain`` on every lane of (a)'s recorded bounces
    (tiles of up to 24 parts) and of two walls, one behind the other,
    where the staged t check skips the back wall's u and v dots: t, kind
    and index bit for bit;
  * (d) ``search_tables``' compact rows are exactly the columns of
    ``_tri_coeffs`` that are not structural zeros, and the flag; the
    mesh's packed rows (its input at its size) assemble to them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.ops import intersect as jisect
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import intersect as tisect
from rust_ray_tracer_tpu_torch.ops import search
from rust_ray_tracer_tpu_torch.ops.integrator import (make_split_tables,
                                                      render_waves)
from rust_ray_tracer_tpu_torch.utils import rng

from tests.test_torch_search import _tie_rays, _tie_scenes
from tests.torch_parity import mesh, split_recorder
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def mesh_calls():
    """The split route's recorded sort, K and M calls over three bounces of
    a 24x12 wave of the 65,536-triangle mesh, chunks of 144 rays, and what
    M (its plain version, on the CPU) returned to each (``rec["m_out"]``)."""
    ts = compile_scene(mesh(TS, tcam), device="cpu")
    assert ts.n_tris == search.PACKED_MIN_TRIS
    outs = []
    with split_recorder() as rec:
        recording = search.fused_search

        def keeping(*args):
            outs.append(recording(*args))
            return outs[-1]

        search.fused_search = keeping      # the recorder restores the real
        render_waves(ts, 24, 12, rng.key(0, "cpu"), 0, 1, depth=3,
                     chunk_size=144)
    assert len(rec["order"]) == len(rec["search"]) == len(outs) == 3
    rec["m_out"] = outs
    return ts, rec


def test_search_order_matches_jax(mesh_calls, monkeypatch):
    _, rec = mesh_calls
    keys = []
    real = jnp.argsort

    def spy(x, *a, **kw):
        keys.append(np.asarray(x))
        return real(x, *a, **kw)

    monkeypatch.setattr(jnp, "argsort", spy)
    dead = []
    for (rays, tabs, chunk), (_, _, _, _, perm) in zip(rec["order"],
                                                       rec["search"]):
        n = rays.shape[1]
        assert n // chunk == 2
        key = search.search_key(rays, tabs.cl_min, tabs.cl_max).numpy()
        got = search.search_order(rays, tabs, chunk)
        assert torch.equal(got, perm)           # what the route searched
        r = rays.numpy()
        for c in range(n // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            keys.clear()
            ref = np.asarray(jisect._search_order(
                jnp.asarray(r[0:3, sl].T), jnp.asarray(r[3:6, sl].T),
                jnp.asarray(r[7, sl]), jnp.asarray(r[8, sl]),
                jnp.asarray(tabs.cl_min.numpy()),
                jnp.asarray(tabs.cl_max.numpy())))
            assert len(keys) == 1
            np.testing.assert_array_equal(key[sl], keys[0])
            np.testing.assert_array_equal(got[sl].numpy() - c * chunk, ref)
        dead.append(int((key == search.DEAD_KEY).sum()))
        # live keys: an octant in bits 27-29 over a 27-bit Morton code
        assert (key[key != search.DEAD_KEY] < 1 << 30).all()
    assert dead[0] == 0 and dead[1] > 0 and dead[2] > dead[1]


def test_sorted_search_matches_unsorted_and_jax(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)
    js, ts, (a, _) = _tie_scenes(monkeypatch)
    o, d, time, t_min, t_max = _tie_rays(ts, a)
    chunk = o.shape[0] // 2
    tables = make_split_tables(ts)
    assert tables.unified and ts.n_tris == 384
    tv = [torch.from_numpy(x) for x in (o, d, time, t_min, t_max)]
    rays = search.ray_planes(*tv)

    def port_select():
        return tisect.intersect_select(ts, tv[0], tv[1], tv[2], tables,
                                       t_min=tv[3], t_max=tv[4], chunk=chunk)

    unsorted = port_select()
    ref = search.search(rays, tables.search, chunk)
    monkeypatch.setattr(search, "PACKED_MIN_TRIS", 300)
    monkeypatch.setattr(pim, "PACKED_MIN_TRIS", 300)
    with split_recorder() as rec:
        sorted_ = port_select()
    assert len(rec["order"]) == 1 and len(rec["search"]) == 1
    perm = rec["search"][0][4]
    assert not torch.equal(perm, torch.arange(perm.numel()))
    got = search.search(rays, tables.search, chunk, perm)
    for x, y in zip(got, ref):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(sorted_.kind, unsorted.kind)
    assert torch.equal(sorted_.idx, unsorted.idx)

    calls = []
    real = jisect._search_order
    monkeypatch.setattr(jisect, "_search_order",
                        lambda *x: calls.append(1) or real(*x))
    for c in range(2):
        sl = slice(c * chunk, (c + 1) * chunk)
        sel = jisect.intersect_select(
            js, *(jnp.asarray(x[sl]) for x in (o, d, time)),
            t_min=jnp.asarray(t_min[sl]), t_max=jnp.asarray(t_max[sl]))
        np.testing.assert_array_equal(sorted_.kind[sl].numpy(),
                                      np.asarray(sel.kind))
        np.testing.assert_array_equal(sorted_.idx[sl].numpy(),
                                      np.asarray(sel.idx))
    assert len(calls) == 2
    # the ties: the lowest copy; triangle > sphere > quad; every kind
    assert (int(sorted_.kind[0]), int(sorted_.idx[0])) == (1, a)
    assert int(sorted_.kind[1]) == 1 and int(sorted_.kind[2]) == 2
    assert set(sorted_.kind.tolist()) == {0, 1, 2, 3}


GROUP = 16          # clusters the replay tests at once
# a tile's clusters go to up to MAX_PARTS blocks, at least PART_CLUSTERS
# each (csrc/search.cu)
MAX_PARTS, PART_CLUSTERS = 32, 8


def _features(r):
    """(o, d, o x d, the determinant's epsilon, t_min, t_max) of packed
    rays ``r`` [9, L], as M computes them."""
    ox, oy, oz, dx, dy, dz, _, tmin, tmax = r
    cx, cy, cz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    eps = tisect.TRI_DET_EPS * torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (ox, oy, oz, dx, dy, dz, cx, cy, cz), eps, tmin, tmax


def _cluster_best(tabs, cs, feats):
    """(t [G, L], index [G, L], staged t [G, width, L]): for each cluster
    of ``cs`` [G], the least (t, index) over its rows that count for the
    packed rays ``feats`` (:func:`_features`), inf where none: M's staged
    tests on the compact rows (a packed table's assembled first, as M
    assembles them), each dot summed over its live terms in feature
    order. The staged t is a row's t where the face is seen and t
    lies in the window (the rows whose t M compares with its best), inf
    elsewhere."""
    (ox, oy, oz, dx, dy, dz, cx, cy, cz), eps, tmin, tmax = feats
    rows = (cs[:, None] * tabs.width
            + torch.arange(tabs.width)).reshape(-1)  # ascending a cluster
    w = search.tri_rows(tabs, rows).T[:, :, None]     # [20, G * width, 1]
    dm = w[0] * dx
    dm = dm + w[1] * dy
    dm = dm + w[2] * dz
    side = (dm > eps) | ((dm < -eps) & (w[7] > 0.5))
    tm = w[3] * ox
    tm = tm + w[4] * oy
    tm = tm + w[5] * oz
    tm = tm + w[6]
    inv = 1.0 / torch.where(dm.abs() > eps, dm, torch.ones_like(dm))
    t = tm * inv
    um, vm = w[8] * dx, w[14] * dx
    for j, f in enumerate((dy, dz, cx, cy, cz), 1):
        um = um + w[8 + j] * f
        vm = vm + w[14 + j] * f
    u, v = um * inv, vm * inv
    staged = side & (t >= tmin) & (t <= tmax)
    ok = staged & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v < 1.0 - u)
    shape = (cs.numel(), tabs.width, -1)
    tt = torch.where(ok, t, torch.inf).reshape(shape)
    loc_t = tt.amin(dim=1)
    at = torch.argmax((tt == loc_t[:, None]).to(torch.int32), dim=1)
    return (loc_t, cs[:, None] * tabs.width + at,
            torch.where(staged, t, torch.inf).reshape(shape))


def _sweep(tabs, cs, feats):
    """(best t, best row, u and v tests skipped) of one block of M over the
    clusters ``cs`` (in sweep order) for the packed rays ``feats``. The
    kernel takes a row whose t is at most its best so far and, on a tie in
    t, a lower index: after a cluster its best is the least (t, index) of
    the cluster's rows that count and its best before, which this takes
    at once. The skipped tests are the staged rows whose t is above the
    ray's best before their cluster: M skips their u and v dots (and more,
    its best falling within a cluster)."""
    bt = torch.full_like(feats[0][0], torch.inf)
    bi = torch.full(bt.shape, -1, dtype=torch.int64)
    skipped = 0
    for g0 in range(0, cs.numel(), GROUP):
        group = cs[g0:g0 + GROUP]
        for loc_t, row, staged in zip(*_cluster_best(tabs, group, feats)):
            skipped += int((torch.isfinite(staged) & (staged > bt)).sum())
            take = (loc_t < bt) | (
                (loc_t == bt) & torch.isfinite(loc_t) & (row < bi))
            bt = torch.where(take, loc_t, bt)
            bi = torch.where(take, row, bi)
    return bt, bi, skipped


def replay_search(rays, ent, tabs, chunk=None, perm=None):
    """(best t, kind, index, u and v tests skipped) of M's sweep
    (``csrc/search.cu`` ``fused_search_kernel``), replayed in torch: per
    256-ray tile, the live rays packed in thread order, 32 a warp; the
    tile's entered clusters by ascending entry, then id, dealt to
    ``parts`` blocks (every parts-th each; parts = m // PART_CLUSTERS of
    the m clusters, 1 to MAX_PARTS), each swept by :func:`_sweep`; the
    parts' bests met as the least (t, row); each row's
    det, t, u and v summed over the compact row's live terms in feature
    order; a row counts where the face is seen (|det| > eps, a back face
    only when double-sided), t lies in [t_min, t_max] and u, v inside.
    The spheres and quads fold as the plain version's (strict <, triangle
    > sphere > quad)."""
    if perm is not None:
        t, k, i, skipped = replay_search(rays[:, perm], ent, tabs, chunk)
        back = [torch.empty_like(x).index_copy_(0, perm, x)
                for x in (t, k, i)]
        return (*back, skipped)
    rp, n, chunk, chunk_p = search._padded_rays(rays, chunk)
    t_n = tabs.tri.shape[0]
    out_t = torch.full((rp.shape[1],), torch.inf)
    out_k = torch.zeros(rp.shape[1], dtype=torch.int32)
    out_i = torch.zeros(rp.shape[1], dtype=torch.int32)
    skipped = 0
    for tile in range(rp.shape[1] // search.BC):
        r = rp[:, tile * search.BC:(tile + 1) * search.BC]
        lanes = torch.nonzero(r[8] > r[7])[:, 0]
        if not lanes.numel():
            continue
        ox, oy, oz, dx, dy, dz, time, tmin, tmax = r[:, lanes]
        lanes_f = _features(r[:, lanes])
        e = ent[tile]
        cs = torch.nonzero(torch.isfinite(e))[:, 0] if t_n else e[:0].long()
        cs = cs[torch.argsort(e[cs], stable=True)]
        parts = max(1, min(MAX_PARTS, cs.numel() // PART_CLUSTERS))
        bt = torch.full_like(ox, torch.inf)
        bi = torch.full(ox.shape, -1, dtype=torch.int64)
        for p in range(parts):
            pt, pi, n_skip = _sweep(tabs, cs[p::parts], lanes_f)
            skipped += n_skip
            take = (pi >= 0) & ((pt < bt) | ((pt == bt) & (pi < bi)))
            bt = torch.where(take, pt, bt)
            bi = torch.where(take, pi, bi)
        tri_won = bi >= 0
        best = (bt, torch.where(tri_won, tisect.KIND_TRI, 0).to(torch.int32),
                torch.where(tri_won, bi.clamp(max=max(t_n - 1, 0)), 0))
        if tabs.sph.shape[0]:
            best = search.fold(best, *search.first_min(search.sphere_tests(
                (ox, oy, oz, dx, dy, dz, time), tabs.sph, tmin, tmax)),
                tisect.KIND_SPH)
        if tabs.quad.shape[0]:
            best = search.fold(best, *search.first_min(search.quad_tests(
                (ox, oy, oz, dx, dy, dz), tabs.quad, tmin, tmax)),
                tisect.KIND_QUAD)
        at = tile * search.BC + lanes
        out_t[at], out_k[at], out_i[at] = (best[0], best[1],
                                           best[2].to(torch.int32))
    return (*(search._unpad(x, n, chunk, chunk_p)
              for x in (out_t, out_k, out_i)), skipped)


def _assert_replay_matches_plain(args, ref=None):
    got_t, got_k, got_i, skipped = replay_search(*args)
    ref_t, ref_k, ref_i = ref or search.fused_search_plain(*args)
    assert torch.equal(got_t.view(torch.int32), ref_t.view(torch.int32))
    assert torch.equal(got_k, ref_k)
    assert torch.equal(got_i, ref_i)
    return skipped, ref_k


def test_replayed_sweep_matches_plain(mesh_calls):
    _, rec = mesh_calls
    most = 0
    for args, out in zip(rec["search"], rec["m_out"]):
        _, kind = _assert_replay_matches_plain(args, out)
        assert bool((kind == tisect.KIND_TRI).any())
        most = max(most, int(torch.isfinite(args[1]).sum(1).max()))
    assert most // PART_CLUSTERS > 1                # tiles swept in parts


def _walls(S, cam_mod):
    """Two walls of 256 double-sided triangles each (16 x 8 squares) across
    the +x axis at x = 3 and x = 6, and a sphere off to the side. The
    scene's Morton order puts x first, so each wall is two clusters of its
    own: a ray from the origin along +x hits the front wall, and its
    tile enters the back wall's clusters too."""
    mat = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
    tris = []
    for x in (3.0, 6.0):
        for i in range(16):
            for j in range(8):
                y0, z0 = -4.0 + 0.5 * i, -4.0 + 1.0 * j
                a, b = (x, y0, z0), (x, y0 + 0.5, z0)
                c, e = (x, y0, z0 + 1.0), (x, y0 + 0.5, z0 + 1.0)
                tris += [S.Triangle(a, b, c, mat, double_sided=True),
                         S.Triangle(b, e, c, mat, double_sided=True)]
    ball = S.Sphere((4.0, 6.0, 0.0), 0.5, mat)
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 40.0, 1.0)
    return S.Scene(cam, tris + [ball], [], (0.1, 0.1, 0.1))


def test_replayed_sweep_prunes_behind_a_wall():
    ts = compile_scene(_walls(TS, tcam), device="cpu")
    tabs = search.search_tables(ts)
    assert ts.n_tris == 512 and tabs.width == 128
    g = np.random.default_rng(5)
    n, chunk = 600, 300
    d = g.uniform([0.9, -0.9, -0.9], [1.1, 0.9, 0.9], (n, 3))
    t_max = np.where(np.arange(n) % 9 == 4, -1.0, np.inf)
    rays = search.ray_planes(*(torch.from_numpy(x.astype(np.float32)) for x in
                               (np.zeros((n, 3)), d, g.uniform(0, 1, n),
                                np.full(n, 1e-4), t_max)))
    perm = search.search_order(rays, tabs, chunk)
    ent = search.tile_enter_plain(rays, tabs.cl_min, tabs.cl_max, chunk,
                                  perm)
    assert int(torch.isfinite(ent).sum(1).max()) == 4
    skipped, kind = _assert_replay_matches_plain(
        (rays, ent, tabs, chunk, perm))
    assert bool((kind[t_max > 0] == tisect.KIND_TRI).all())
    assert skipped > 0


def test_compact_rows_are_the_live_columns(mesh_calls):
    ts, _ = mesh_calls
    tabs = search.search_tables(ts, packed=False)
    coeffs = tisect._tri_coeffs(ts.tri_v0, ts.tri_e1, ts.tri_e2)
    jco = jisect._tri_coeffs(*(jnp.asarray(getattr(ts, k).numpy())
                               for k in ("tri_v0", "tri_e1", "tri_e2")))
    assert tabs.tri.shape == (ts.n_tris, search.TRI_ROW)
    assert search.TRI_ROW == 1 + sum(len(fs) for _, fs in search.TRI_LIVE)
    at = 0
    for r, fs in search.TRI_LIVE:
        if at == search.TRI_FLAG:
            at += 1
        for f in range(10):
            col = coeffs[r][f]
            if f in fs:
                assert torch.equal(tabs.tri[:, at].view(torch.int32),
                                   col.view(torch.int32))
                assert bool((col != 0).any())
                at += 1
            else:                                   # a structural zero
                assert torch.equal(col.view(torch.int32),
                                   torch.zeros_like(col, dtype=torch.int32))
                assert not np.asarray(jco[r][f]).any()
    assert at == search.TRI_ROW
    assert torch.equal(tabs.tri[:, search.TRI_FLAG],
                       ts.tri_double.to(torch.float32))
    full = search.full_rows(tabs.tri)
    for got, want in zip(full[:4], coeffs):
        assert torch.equal(got.view(torch.int32), want.T.view(torch.int32))
    assert dataclasses.is_dataclass(tabs) and tabs.width == 128
    packed = search.search_tables(ts)
    assert packed.packed and torch.equal(
        search.tri_rows(packed).view(torch.int32), tabs.tri.view(torch.int32))
