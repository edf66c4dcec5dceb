"""The trace kernels' packed tables (``ops/uber.pack_tri_rows``;
``TraceCtx.tri_pack``, ``sph_pack``, ``quad_pack``): row for row the
Plücker coefficients det | u | v | t of ``ops/intersect._tri_coeffs`` and
the double-sided flag, then three zeros, and the sphere and quad rows
with three zero columns; float32, contiguous and 16-byte aligned, so
kernels A, D and E (``csrc/trace_wave.cu``) read a triangle as eleven
float4 loads and a sphere or quad as three. The plain versions read
column views of the same tensors (``uber.tri_cols``, ``[:, :9]``). The
kernels' own reading of a triangle row (which float4 lanes make which
dot) and their order of checks are replayed here on those loads and held
to the plain version's ``tri_tests``; their lanes of a sphere row are
its nine columns. No JAX: the plain search is held to JAX's in
``tests/test_torch_scene.py``."""

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch.kernels import _check_search_tables
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops.intersect import _tri_coeffs
from rust_ray_tracer_tpu_torch.ops import search as search_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng
from tests.torch_parity import mesh
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

TRI_SCENES = ["flagship", "cornell_triangle", "chunk_full", "chunk_and_one"]


def _ctx(name):
    if name == "flagship":
        host = builders.procedural_flagship()
    elif name == "chunk_full":          # one whole chunk: no pad rows
        host = mesh(S, cam_ops, uber.TCC)
    elif name == "chunk_and_one":       # a second chunk of one real row
        host = mesh(S, cam_ops, uber.TCC + 1)
    else:
        host = builders.get_scene(name, 1.0)
    scene = compile_scene(host, device="cpu")
    ctx = uber.make_ctx(scene)
    # the triangles: the compiled rows with an edge (its pad rows have none)
    n_real = int((scene.tri_e1.ne(0).any(1) | scene.tri_e2.ne(0).any(1))
                 .sum())
    return ctx, n_real, scene


def _layout(ctx):
    for t, grain, cols in ((ctx.tri_pack, uber.TCC, uber.TRI_PACK),
                           (ctx.sph_pack, 8, uber.PRIM_PACK),
                           (ctx.quad_pack, 8, uber.PRIM_PACK)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.data_ptr() % 16 == 0
        assert not t.requires_grad
        assert t.dim() == 2 and t.shape[1] == cols
        assert t.shape[0] % grain == 0 and t.shape[0] >= grain
    # the plain versions' views: the pack's own storage, no copy
    for k, view in enumerate(uber.tri_cols(ctx.tri_pack)):
        assert view.data_ptr() == ctx.tri_pack.data_ptr() + 40 * k
        assert view.shape == (ctx.tri_pack.shape[0], 1 if k == 4 else 10)


@pytest.mark.parametrize("name", TRI_SCENES)
def test_tri_pack_rows(name):
    ctx, n_real, scene = _ctx(name)
    _layout(ctx)
    pack = ctx.tri_pack
    tp = pack.shape[0]
    assert ctx.n_tri_chunks * uber.TCC <= tp
    n = scene.n_tris
    coeffs = _tri_coeffs(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    for k, (view, c) in enumerate(zip(uber.tri_cols(pack), coeffs)):
        assert torch.equal(view[:n], c.T), k
    assert torch.equal(pack[:n, 40], scene.tri_double.to(torch.float32))
    assert not pack[:, 41:].any()
    # the pad rows past the compiled triangles are zeros: det 0, rejected;
    # every real triangle has a det row
    assert not pack[n:].any()
    assert int(pack[:, 0:10].ne(0).any(1).sum()) == n_real > 0
    for pack in (ctx.sph_pack, ctx.quad_pack):
        assert not pack[:, 9:].any()
    if name == "chunk_full":
        assert n_real == ctx.n_tris == tp == uber.TCC
    if name == "chunk_and_one":
        assert n_real == uber.TCC + 1 and tp == 2 * uber.TCC
        assert ctx.n_tri_chunks == 2


def test_tri_pack_without_triangles():
    """No triangles: the zero tables (8 rows padded to one chunk), packed
    as zeros, and no chunk for the kernels to sweep."""
    ctx, _, _ = _ctx("two_spheres")
    assert ctx.n_tris == 0 and ctx.n_tri_chunks == 0
    _layout(ctx)
    assert tuple(ctx.tri_pack.shape) == (uber.TCC, uber.TRI_PACK)
    assert not ctx.tri_pack.any()


def test_wrappers_refuse_a_misaligned_pack():
    """The kernels read the pack as float4: a view 4 bytes into its
    storage is refused before any launch."""
    ctx, _, _ = _ctx("cornell_triangle")
    _check_search_tables(ctx, torch.device("cpu"))
    flat = torch.zeros(ctx.tri_pack.numel() + 1)
    ctx.tri_pack = flat[1:].view(ctx.tri_pack.shape)
    with pytest.raises(ValueError, match="tri_pack must be 16-byte"):
        _check_search_tables(ctx, torch.device("cpu"))


def _kernel_tests(pack, f, eps, tmin, tmax):
    """(valid, t) [T, B] as ``closest_hit``'s sweep computes them from the
    float4 loads r[0..10] of each row: det from r0, r1, r2.xy; t from
    r7.zw, r8, r9; u from r2.zw, r3, r4; v from r5, r6, r7.xy; the flag
    r10.x; the kernel's checks (a face, t, then u and v)."""
    r = pack.view(-1, 11, 4)

    def dot(cols):
        acc = cols[0][:, None] * f[0]
        for k in range(1, 10):
            acc = acc + cols[k][:, None] * f[k]
        return acc

    def lanes(*parts):
        return [r[:, i, c] for i, cs in parts for c in cs]

    dm = dot(lanes((0, range(4)), (1, range(4)), (2, (0, 1))))
    side = (dm > eps) | ((dm < -eps) & (r[:, 10, 0:1] > 0.5))
    tm = dot(lanes((7, (2, 3)), (8, range(4)), (9, range(4))))
    inv = 1.0 / torch.where(dm.abs() > eps, dm, torch.ones_like(dm))
    t = tm * inv
    u = dot(lanes((2, (2, 3)), (3, range(4)), (4, range(4)))) * inv
    v = dot(lanes((5, range(4)), (6, range(4)), (7, (0, 1)))) * inv
    ok_t = (t >= tmin) & (t <= tmax)
    valid = side & ok_t & (u >= 0) & (u <= 1) & (v >= 0) & (v < 1.0 - u)
    return valid, t


@pytest.mark.parametrize("name", ["flagship", "chunk_and_one"])
def test_kernel_reading_of_the_pack_matches_tri_tests(name):
    """The kernels' lanes of the pack and their order of checks give the
    plain version's (valid, t) on a 32x18 wave's primary rays and on rays
    of random directions from inside the triangles' cloud."""
    ctx, _, _ = _ctx(name)
    scene_rays, _ = uber.wave_inputs(
        compile_scene(builders.procedural_flagship(), device="cpu"),
        rng.wave_key(rng.key(3, "cpu"), 0), 32, 18, 1, 32 * 18)
    g = np.random.default_rng(5)
    o2 = torch.from_numpy(g.uniform(-1, 1, (3, 256)).astype(np.float32))
    o2[2] -= 4.0
    d2 = torch.from_numpy(g.normal(size=(3, 256)).astype(np.float32))
    o = torch.cat([scene_rays[0:3], o2], dim=1)
    d = torch.cat([scene_rays[3:6], d2], dim=1)
    ox, oy, oz = o
    dx, dy, dz = d
    f = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
         ox * dy - oy * dx, torch.ones_like(ox))
    tmin = torch.full_like(ox, uber.T_MIN)
    tmax = torch.full_like(ox, torch.inf)
    eps = search_ops.TRI_DET_EPS * torch.sqrt(dx * dx + dy * dy + dz * dz)
    want_valid, want_t = search_ops.tri_tests(
        f, uber.tri_cols(ctx.tri_pack), tmin, tmax)
    got_valid, got_t = _kernel_tests(ctx.tri_pack, f, eps, tmin, tmax)
    assert int(want_valid.sum()) > 0
    assert torch.equal(got_valid, want_valid)
    assert torch.equal(got_t[want_valid], want_t[want_valid])


@pytest.mark.parametrize("name", ["two_spheres", "cornell_box"])
def test_sphere_and_quad_packs(name):
    """A scene of spheres (far pad rows among them) and one of quads: the
    packed rows are the scene's sphere rows (``search.sphere_rows``) and
    quad rows (q, u, v) with three zero columns, far or zero pad rows
    after them, and the float4 lanes ``sphere_t`` reads are the row's
    nine columns in order."""
    ctx, _, scene = _ctx(name)
    _layout(ctx)
    s_n, q_n = scene.n_spheres, scene.n_quads
    assert s_n + q_n > 0
    assert torch.equal(ctx.sph_pack[:s_n, :9], search_ops.sphere_rows(scene))
    assert (ctx.sph_pack[s_n:, 0:3] == 1e30).all()
    assert torch.equal(ctx.quad_pack[:q_n, :9], torch.cat(
        [scene.quad_q, scene.quad_u, scene.quad_v], dim=1))
    assert not ctx.quad_pack[q_n:].any()
    for pack in (ctx.sph_pack, ctx.quad_pack):
        assert not pack[:, 9:].any()
    # sphere_t's lanes: s0 = c0, e1.x; s1 = e1.yz, t0, 1/dt; s2.x = r
    s = ctx.sph_pack.view(-1, 3, 4)
    lanes = torch.stack([s[:, 0, 0], s[:, 0, 1], s[:, 0, 2], s[:, 0, 3],
                         s[:, 1, 0], s[:, 1, 1], s[:, 1, 2], s[:, 1, 3],
                         s[:, 2, 0]], dim=1)
    assert torch.equal(lanes, ctx.sph_pack[:, :9])
