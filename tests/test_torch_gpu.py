"""The Hopper kernels (csrc/trace_wave.cu, csrc/trace_wave_bwd.cu,
csrc/split.cu, csrc/search.cu, csrc/sphere.cu, csrc/shade.cu) against
their plain versions.

Imports no JAX, so it runs on a GPU machine without it. tests/conftest.py
imports JAX, so there it runs without the conftest (and without the
pytest.ini workers):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \\
        tests/test_torch_gpu.py -q

The tests marked ``gpu`` skip where there is no CUDA device; the others
check on the CPU what the wrapper and the dispatcher refuse.
"""

import functools

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.kernels import (bounce_planes_bwd_kernel,
                                               bounce_planes_kernel,
                                               bwd_reduce_kernel,
                                               fused_search_kernel,
                                               hit_attrs_bwd_kernel,
                                               hit_attrs_kernel,
                                               quad_search_kernel,
                                               shade_bwd_kernel,
                                               shade_kernel,
                                               shade_update_bwd_kernel,
                                               shade_update_kernel,
                                               sph_search_kernel,
                                               tile_enter_kernel,
                                               trace_wave_bwd_kernel,
                                               trace_wave_bwd_noise_kernel,
                                               trace_wave_kernel,
                                               trace_wave_noise_kernel,
                                               tri_search_kernel)
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import (LIGHT_QUAD, LIGHT_SPHERE,
                                                    compile_scene)
from rust_ray_tracer_tpu_torch.ops import shade as shade_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng

# by its own name (pytest puts tests/ on sys.path): on a machine where an
# installed package is called ``tests``, ``tests.torch_parity`` is not found
from torch_parity import (SMALL_SCENES, assert_flip_budget,
                          assert_scaled_close, enter_cases, hollow_spheres,
                          mesh, random_earth_view, random_tris, rel_l2,
                          split_cots, split_kernel_inputs, split_recorder,
                          spread_lights, torch_scene, write_earth_map,
                          write_gltf_flagship)
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

W = H = 32          # one 1024-ray chunk
DEPTH = 4


def _scene(name):
    if name in SMALL_SCENES:
        return torch_scene(name)
    if name == "flagship":          # the one with a sphere light
        return compile_scene(builders.procedural_flagship(), device="cpu")
    return compile_scene(builders.get_scene(name, 1.0), device="cpu")


def _inputs(ts, seed=7):
    return uber.wave_inputs(ts, rng.wave_key(rng.key(seed, "cpu"), 0), W, H,
                            DEPTH, W * H)


def test_kernel_wrapper_refuses_cpu_tensors():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    before = trace_wave_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_wave_kernel(st0, rnd, uber.make_ctx(ts), DEPTH)
    assert trace_wave_kernel.launches == before


def test_dispatcher_refuses_other_devices():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    with pytest.raises(ValueError, match="unsupported device"):
        uber.trace_wave(st0.to("meta"), rnd.to("meta"), uber.make_ctx(ts),
                        DEPTH)


def test_fused_bounce_wrappers_refuse_cpu_tensors():
    """Kernels D and D' take CUDA tensors only; ops/uber.bounce_uber
    refuses other devices."""
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    kind = torch.zeros(st0.shape[1], dtype=torch.int32)
    for kern, args in ((K.fused_bounce_kernel(ctx), (st0, rnd[0], ctx)),
                       (K.fused_bounce_bwd_kernel(ctx),
                        (st0, rnd[0], kind, kind, ctx, st0))):
        before = kern.launches
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            kern(*args)
        assert kern.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        uber.bounce_uber(ts, rnd[0].to("meta"), st0.to("meta"), ctx)


def test_marble_probe_refuses_cpu_tensors():
    """C's probe (``kernels.marble_probe_kernel``) launches only on CUDA
    tensors; nothing falls back to the plain marble."""
    ctx = uber.make_ctx(_scene("noise"))
    p = torch.zeros((4, 3))
    before = K.marble_probe_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K.marble_probe_kernel(p, torch.ones(4), ctx.perlin)
    assert K.marble_probe_kernel.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the trace kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "quad", "cornell_box",
                                  "cornell_triangle"])
def test_kernel_matches_plain_on_card(name, cuda):
    """Kernel A's image against the plain version's under the flip
    budget (CUDA's sinf/cosf/expf/logf in the shading differ from the
    host's by an ulp, and a path can fork on it), and its winners of every
    bounce equal the plain search's on the bounce's input state (A's own
    residual) bit for bit: both round each product and sum alone."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    ctx_c = uber.make_ctx(ts)
    before = trace_wave_kernel.launches
    got = uber.trace_wave(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
    torch.cuda.synchronize()
    assert trace_wave_kernel.launches == before + 1
    ref = uber.trace_wave_plain(st0, rnd, ctx_c, DEPTH)
    assert_flip_budget(got[8:11].cpu().numpy().T, ref[8:11].numpy().T)
    stf, hist, kind, idx = trace_wave_kernel(st0.to(cuda), rnd.to(cuda),
                                             ctx, DEPTH, residuals=True)
    assert torch.equal(stf, got)
    for b in range(DEPTH):
        want_kind, want_idx = uber.search_row_plain(hist[b].cpu(), ctx_c)
        assert torch.equal(kind[b].cpu(), want_kind), b
        assert torch.equal(idx[b].cpu().long(), want_idx), b


@pytest.mark.gpu
def test_wave_inputs_bitwise_on_card(cuda):
    """The camera rays and threefry draws on the card are the CPU's, bit
    for bit (and so JAX's): the image depends only on (seed, chunk)."""
    ts = compile_scene(builders.procedural_flagship(), device="cpu")
    key = rng.wave_key(rng.key(3, "cpu"), 1)
    want = uber.wave_inputs(ts, key, 48, 27, DEPTH, 500)
    got = uber.wave_inputs(ts.to(cuda), key.to(cuda), 48, 27, DEPTH, 500)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _residuals_like(st0):
    """Zero residuals of the shapes the backward takes."""
    n = st0.shape[1]
    kind = torch.zeros((DEPTH, n), dtype=torch.int32)
    return torch.zeros((DEPTH, 14, n)), kind, kind.clone()


def test_bwd_wrappers_refuse_cpu_tensors():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    hist, kind, idx = _residuals_like(st0)
    before = (trace_wave_bwd_kernel.launches, bwd_reduce_kernel.launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_wave_bwd_kernel(hist, rnd, kind, idx, ctx, st0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        i32 = torch.int32
        bwd_reduce_kernel(torch.zeros(4, 17), torch.zeros(4, dtype=i32),
                          torch.zeros(4, dtype=i32), 3, torch.zeros(8, 28))
    assert (trace_wave_bwd_kernel.launches,
            bwd_reduce_kernel.launches) == before


def test_bwd_dispatcher_refuses_other_devices():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    hist, kind, idx = _residuals_like(st0)
    with pytest.raises(ValueError, match="unsupported device"):
        uber.trace_wave_bwd(hist, rnd, kind, idx, ctx, st0.to("meta"))


def _bwd_on_card(name, cuda):
    """Kernel A with residuals, then B + bwd_reduce, on the card; and the
    plain backward on the CPU fed the card's residuals."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    stf, hist, kind, idx = trace_wave_kernel(st0.to(cuda), rnd.to(cuda), ctx,
                                             DEPTH, residuals=True)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32))
    got = uber.trace_wave_bwd(hist, rnd.to(cuda), kind, idx, ctx,
                              g.to(cuda))
    torch.cuda.synchronize()
    ref = uber.trace_wave_bwd_plain(hist.cpu(), rnd, kind.cpu(), idx.cpu(),
                                    uber.make_ctx(ts), g)
    return st0, rnd, ts, (stf, hist, kind, idx), got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "quad", "cornell_box",
                                  "flagship"])
def test_bwd_kernel_matches_plain_on_card(name, cuda):
    """B + bwd_reduce vs trace_wave_bwd_plain on the same residuals: dst
    per ray to rtol 1e-4 of its largest plane / atol 1e-6, at most 0.5% of
    the rays outside (an FMA can flip a recomputed branch: tir, metal_ok,
    a checker parity); duni and dlt to a relative L2 error of 1e-4 (sums
    in another order), and each light's row of dlt to 1e-4 of the row's
    largest entry, so a light's share is not hidden in the table's norm.
    A sphere light's centre and radius take a cotangent. A's residuals
    match the plain forward's."""
    st0, rnd, ts, (_, hist, kind, idx), got, ref = _bwd_on_card(name, cuda)
    _, p_hist, p_kind, p_idx = uber.trace_wave_plain(
        st0, rnd, uber.make_ctx(ts), DEPTH, residuals=True)
    assert torch.equal(kind[0].cpu(), p_kind[0])
    assert torch.equal(idx[0].cpu(), p_idx[0])
    for b in range(DEPTH):
        assert_scaled_close(hist[b].cpu().numpy(), p_hist[b].numpy(), 3e-4,
                            3e-5, axis=0, budget=0.005, what="hist")
    dst, duni, dlt = (x.cpu().numpy() for x in got)
    assert_scaled_close(dst, ref[0].numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert rel_l2(duni, ref[1]) <= 1e-4 and rel_l2(dlt, ref[2]) <= 1e-4
    ref_dlt = ref[2].numpy()
    for r in range(ref_dlt.shape[0]):
        assert np.abs(dlt[r] - ref_dlt[r]).max() <= (
            1e-6 + 1e-4 * np.abs(ref_dlt[r]).max()), f"dlt row {r}"
    assert np.abs(duni).max() > 0
    for li in range(ts.n_lights):
        if int(ts.light_kind[li]) == LIGHT_SPHERE:
            assert np.abs(ref_dlt[li, 1:5]).max() > 0


@pytest.mark.gpu
def test_bwd_kernel_bitwise_repeatable(cuda):
    """No float atomics: two runs of B + bwd_reduce agree bit for bit."""
    _, _, _, (_, hist, kind, idx), first, _ = _bwd_on_card("solid", cuda)
    ts = _scene("solid")
    ctx = uber.make_ctx(ts.to(cuda))
    _, rnd = _inputs(ts)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(14, hist.shape[2])).astype(np.float32)).to(cuda)
    second = uber.trace_wave_bwd(hist, rnd.to(cuda), kind, idx, ctx, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _found_outputs(out, p_rows):
    """A backward kernel's (dst, contrib, keys, part) with the contrib rows
    of ray-bounces without a winner (key p_rows, scratch B' never reads)
    zeroed."""
    dst, contrib, keys, part = out
    found = (keys < p_rows)[..., None]
    return dst, torch.where(found, contrib, torch.zeros_like(contrib)), \
        keys, part


@pytest.mark.gpu
def test_bwd_kernels_eight_lights_on_card(cuda, tmp_path):
    """B and D' on the 8-light glTF flagship (968 triangles, 8 point
    lights: 126 light-table entries), where each ray's light-table share
    and the warps' row stages take more than 48 KB of a block's dynamic
    shared memory. B + bwd_reduce against trace_wave_bwd_plain, and D' +
    its sums against fused_bounce_bwd_plain on bounces 0 and 1, under
    test_bwd_kernel_matches_plain_on_card's budgets (dst per ray rtol 1e-4
    of its largest plane, at most 0.5% outside; duni and dlt relative L2
    1e-4; each light's row of dlt within 1e-4 of its largest entry); each
    kernel's dst, keys, partials and found rows the same bits twice."""
    path = write_gltf_flagship(str(tmp_path / "f8.gltf"), 8)
    ts = compile_scene(load_gltf_scene(path, 1.0), device="cpu")
    assert ts.n_lights == 8 and uber.uber_eligible(ts)
    st0, rnd = _inputs(ts)
    ctx_c, ctx = uber.make_ctx(ts), uber.make_ctx(ts.to(cuda))
    p_rows = ctx.uni.shape[0]
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32))
    gc, rndc = g.to(cuda), rnd.to(cuda)
    _, hist, kind, idx = trace_wave_kernel(st0.to(cuda), rndc, ctx, DEPTH,
                                           residuals=True)

    def held(got, want):
        dst, duni, dlt = (x.cpu().numpy() for x in got)
        assert_scaled_close(dst, want[0].numpy(), 1e-4, 1e-6, axis=0,
                            budget=0.005, what="dst")
        assert rel_l2(duni, want[1]) <= 1e-4
        assert rel_l2(dlt, want[2]) <= 1e-4
        ref_dlt = want[2].numpy()
        for r in range(ref_dlt.shape[0]):
            assert np.abs(dlt[r] - ref_dlt[r]).max() <= (
                1e-6 + 1e-4 * np.abs(ref_dlt[r]).max()), f"dlt row {r}"
        assert np.abs(ref_dlt[:-1]).max() > 0

    before = trace_wave_bwd_kernel.launches
    got = uber.trace_wave_bwd(hist, rndc, kind, idx, ctx, gc)
    torch.cuda.synchronize()
    assert trace_wave_bwd_kernel.launches == before + 1
    held(got, uber.trace_wave_bwd_plain(hist.cpu(), rnd, kind.cpu(),
                                        idx.cpu(), ctx_c, g))
    runs = [_found_outputs(trace_wave_bwd_kernel(hist, rndc, kind, idx, ctx,
                                                 gc), p_rows)
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))

    d, d_bwd = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
    st = st0.to(cuda)
    for b in (0, 1):
        st2, dk, di = d(st, rndc[b], ctx)
        before = d_bwd.launches
        got = K.fused_bounce_backward(st, rndc[b], dk, di, ctx, gc)
        torch.cuda.synchronize()
        assert d_bwd.launches == before + 1
        held(got, uber.fused_bounce_bwd_plain(st.cpu(), rnd[b], dk.cpu(),
                                              di.cpu(), ctx_c, g))
        runs = [_found_outputs(d_bwd(st, rndc[b], dk, di, ctx, gc), p_rows)
                for _ in range(2)]
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        st = st2


@pytest.mark.gpu
def test_render_waves_grads_on_card(cuda):
    """torch.autograd through render_waves on the card goes through A
    with residuals, B and bwd_reduce (one launch each), never the plain
    versions, and gives finite gradients, bit for bit the same twice."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    params, static = partition(compile_scene(builders.cornell_box(1.0)))
    out = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        counts = [k.launches for k in (trace_wave_kernel,
                                       trace_wave_bwd_kernel,
                                       bwd_reduce_kernel)]
        render_waves(combine(leaves, static), 32, 32, rng.key(0), 0, 1,
                     chunk_size=1024).mean().backward()
        torch.cuda.synchronize()
        assert [k.launches - c for k, c in zip(
            (trace_wave_kernel, trace_wave_bwd_kernel, bwd_reduce_kernel),
            counts)] == [1, 1, 1]
        out.append({k: v.grad for k, v in leaves.items()
                    if v.grad is not None})
    assert out[0]["tex_color"].abs().max() > 0
    for k, v in out[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, out[1][k]), k


@pytest.mark.gpu
def test_marble_probe_matches_plain_on_card(cuda):
    """C alone (``kernels.marble_probe_kernel``) against its plain
    version ``ops/perlin.marble`` and against the split route's
    ``ops/texture.texture_value`` on the card, bit for bit, at seeded
    points near the origin and out to |p| ~ 1000 (random's ground): all
    three add each corner's dot left to right, as C does."""
    from rust_ray_tracer_tpu_torch.models.scene import TEX_NOISE
    from rust_ray_tracer_tpu_torch.ops import perlin, texture

    sc = _scene("random").to(cuda)
    ctx = uber.make_ctx(sc)
    tid = int(torch.nonzero(sc.tex_kind == TEX_NOISE)[0])
    g = torch.Generator().manual_seed(5)
    p = torch.cat([torch.rand(4096, 3, generator=g) * 8 - 4,
                   torch.rand(4096, 3, generator=g) * 2000 - 1000]).to(cuda)
    n = p.shape[0]
    scale = sc.tex_scale[tid].expand(n).contiguous()
    before = K.marble_probe_kernel.launches
    acc, value = K.marble_probe_kernel(p, scale, ctx.perlin)
    torch.cuda.synchronize()
    assert K.marble_probe_kernel.launches == before + 1
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    assert torch.equal(acc, perlin._turb_acc(ctx.perlin, px, py, pz))
    assert torch.equal(value, perlin.marble(ctx.perlin, px, py, pz, scale))
    tids = torch.full((n,), tid, dtype=torch.int32, device=cuda)
    zero = torch.zeros(n, device=cuda)
    alb = texture.texture_value(sc, tids, zero, zero, p)
    assert torch.equal(alb[:, 0], value)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["noise", "perlin_spheres", "rect_light",
                                  "random"])
def test_noise_kernel_matches_plain_on_card(name, cuda):
    """The noise variant of A (the marble of TPU kernel C inside the trace)
    against the plain forward on the card: one launch, the flip budget of
    tests/test_uber.py:117-120. The plain version rounds as the kernel
    (no FMA, 1 / sqrt), so the marble's amplification of a hit point's
    last ulp has nothing to amplify."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    assert ctx.has_noise
    before = (trace_wave_kernel.launches, trace_wave_noise_kernel.launches)
    got = uber.trace_wave(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
    torch.cuda.synchronize()
    assert (trace_wave_kernel.launches,
            trace_wave_noise_kernel.launches) == (before[0], before[1] + 1)
    ref = uber.trace_wave_plain(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
    assert_flip_budget(got[8:11].cpu().numpy().T, ref[8:11].cpu().numpy().T)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["noise", "random"])
def test_noise_bwd_kernel_matches_plain_on_card(name, cuda):
    """The noise variants of A (with residuals) and B, then bwd_reduce,
    against the plain backward on the card fed the same residuals: dst per
    ray to rtol 1e-4 of its largest plane / atol 1e-6 (at most 0.5% of the
    rays outside), duni and dlt to a relative L2 error of 1e-4; the rows'
    scale column takes a cotangent."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    _, hist, kind, idx = trace_wave_noise_kernel(
        st0.to(cuda), rnd.to(cuda), ctx, DEPTH, residuals=True)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32)).to(cuda)
    before = trace_wave_bwd_noise_kernel.launches
    got = uber.trace_wave_bwd(hist, rnd.to(cuda), kind, idx, ctx, g)
    torch.cuda.synchronize()
    assert trace_wave_bwd_noise_kernel.launches == before + 1
    ref = uber.trace_wave_bwd_plain(hist, rnd.to(cuda), kind, idx, ctx, g)
    dst, duni, dlt = (x.cpu().numpy() for x in got)
    assert_scaled_close(dst, ref[0].cpu().numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert rel_l2(duni, ref[1].cpu()) <= 1e-4
    assert rel_l2(dlt, ref[2].cpu()) <= 1e-4
    assert np.abs(duni[:, uber.A_COL + 6]).max() > 0


@pytest.mark.gpu
def test_kernel_variants_refuse_the_other_scenes(cuda):
    """A scene with noise runs only the noise variants, one without only
    the others: each wrapper refuses the other kind of context."""
    plain_ctx = uber.make_ctx(_scene("solid").to(cuda))
    noise_ctx = uber.make_ctx(_scene("noise").to(cuda))
    st0, rnd = _inputs(_scene("solid"))
    st0, rnd = st0.to(cuda), rnd.to(cuda)
    for kern, ctx in ((trace_wave_kernel, noise_ctx),
                      (trace_wave_noise_kernel, plain_ctx)):
        with pytest.raises(ValueError, match="marble noise"):
            kern(st0, rnd, ctx, DEPTH)
    hist, kind, idx = (x.to(cuda) for x in _residuals_like(st0))
    for kern, ctx in ((trace_wave_bwd_kernel, noise_ctx),
                      (trace_wave_bwd_noise_kernel, plain_ctx)):
        with pytest.raises(ValueError, match="marble noise"):
            kern(hist, rnd, kind, idx, ctx, st0)


@pytest.mark.gpu
def test_render_waves_noise_grads_on_card(cuda):
    """torch.autograd through render_waves on perlin_spheres goes through
    the noise variants of A and B and bwd_reduce (one launch each), never
    the others, and gives finite gradients, bit for bit the same twice;
    tex_scale takes one, the detached Perlin tables none."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    params, static = partition(compile_scene(builders.perlin_spheres(1.0)))
    kernels = (trace_wave_kernel, trace_wave_noise_kernel,
               trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel,
               bwd_reduce_kernel)
    out = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        counts = [k.launches for k in kernels]
        render_waves(combine(leaves, static), 32, 32, rng.key(0), 0, 1,
                     chunk_size=1024).mean().backward()
        torch.cuda.synchronize()
        assert [k.launches - c for k, c in zip(kernels, counts)] == [
            0, 1, 0, 1, 1]
        assert leaves["perlin_vec"].grad is None
        out.append({k: v.grad for k, v in leaves.items()
                    if v.grad is not None})
    assert out[0]["tex_scale"].abs().max() > 0
    for k, v in out[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, out[1][k]), k


SPLIT = (quad_search_kernel, hit_attrs_kernel, shade_update_kernel)


def test_split_wrappers_refuse_cpu_tensors():
    x = split_kernel_inputs(torch_scene("fog"), 16, 16, 1)
    P = x["hit"][0]                 # o, d, time, t_min, t_max, ...
    before = [k.launches for k in SPLIT]
    ts = torch_scene("fog")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        quad_search_kernel(torch.cat([P[0:6], P[7:9]]).T.contiguous(),
                           torch.zeros(8, 16), ts.quad_cluster_min,
                           ts.quad_cluster_max)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        hit_attrs_kernel(*x["hit"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shade_update_kernel(*x["su"])
    assert [k.launches for k in SPLIT] == before


def _final_scene():
    return compile_scene(builders.get_scene("final_scene", 1.0),
                         device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fog", "final_scene"])
def test_split_kernels_match_plain_on_card(name, cuda):
    """O, J and H against their plain versions on the card, on the inputs
    the split route gives them over two bounces of a 32x32 wave: O's
    winners and t identical (both round alike: no FMA; final_scene's 1,408
    quads — the fog scene's two take the unified search, M); J's and H's
    planes within rtol 1e-5 of each lane's largest value / atol 1e-6, at
    most 0.5% of H's lanes outside (cosf, sinf, expf, logf of the card's
    torch and of the kernel may round a branch's input apart). One launch
    each."""
    from rust_ray_tracer_tpu_torch.ops import bounce, hit, quad

    ts = _final_scene() if name == "final_scene" else torch_scene(name)
    tg = ts.to(cuda)
    x = split_kernel_inputs(ts)
    assert (x["quad"] is not None) == (name == "final_scene")
    before = [k.launches for k in SPLIT]
    if x["quad"] is not None:
        o, d, t_min, t_max = (v.to(cuda) for v in x["quad"])
        got_t, got_i = quad.quad_search(tg, o, d, t_min, t_max)
    P, kind, flip = (v.to(cuda) for v in x["hit"])
    got_h = hit.hit_planes(P, kind, flip)
    S, mkind, lt, n_lights = x["su"]
    S, mkind, lt = S.to(cuda), mkind.to(cuda), lt.to(cuda)
    got_s = bounce.su_planes(S, mkind, lt, n_lights)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(SPLIT, before)] == [
        int(x["quad"] is not None), 1, 1]
    if x["quad"] is not None:
        ref_t, ref_i = quad._quad_candidates(tg, o, d, t_min, t_max)
        assert torch.equal(got_i.long(), ref_i) and torch.equal(got_t, ref_t)
    ref_h = hit.hit_plane_core(P, kind, flip)
    miss = kind == 0
    assert bool(torch.isinf(got_h[0, miss]).all())
    got_h[0, miss] = ref_h[0, miss] = 0.0
    sph = (kind == 2).cpu().numpy()
    assert_scaled_close(got_h[:9].cpu().numpy(), ref_h[:9].cpu().numpy(),
                        1e-5, 1e-6, axis=0, what="hit attrs")
    assert_scaled_close(got_h[9:].cpu().numpy()[:, sph],
                        ref_h[9:].cpu().numpy()[:, sph], 1e-5, 1e-6, axis=0,
                        what="sphere UV source")
    assert_scaled_close(got_s.cpu().numpy(),
                        bounce.su_plane_core(S, mkind, lt, n_lights)
                        .cpu().numpy(), 1e-5, 1e-6, axis=0, budget=0.005,
                        what="next state")


@pytest.mark.gpu
def test_render_waves_split_route_on_card(cuda):
    """render_waves on a media scene with noise textures goes through M
    (the unified search: its spheres and two quads), J and H (depth
    launches each a wave), never O, F or the trace kernel, and matches the
    plain route on the card within the flip budget."""
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    ts = torch_scene("fog").to(cuda)
    watched = SPLIT + (fused_search_kernel, tile_enter_kernel,
                       bounce_planes_kernel, trace_wave_kernel,
                       trace_wave_noise_kernel)
    before = [k.launches for k in watched]
    got = render_waves(ts, 32, 32, rng.key(0), 0, 1, chunk_size=1024)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(watched, before)] == [
        0, DEPTH, DEPTH, DEPTH, 0, 0, 0, 0]
    with split_recorder(plain=True):
        ref = render_waves(ts, 32, 32, rng.key(0), 0, 1, chunk_size=1024)
    assert_flip_budget(got.cpu().numpy(), ref.cpu().numpy())


SPLIT_BWD = (hit_attrs_bwd_kernel, shade_update_bwd_kernel)


def _split_cots(x, seed=3):
    return split_cots(x["hit"][1], x["su"][0].shape[1], seed)


def test_split_bwd_wrappers_refuse_cpu_tensors():
    x = split_kernel_inputs(torch_scene("fog"), 16, 16, 1)
    gh, gs = _split_cots(x)
    before = [k.launches for k in SPLIT_BWD]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        hit_attrs_bwd_kernel(*x["hit"], gh)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shade_update_bwd_kernel(*x["su"], gs)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shade_update_bwd_kernel.partials(*x["su"], gs)
    assert [k.launches for k in SPLIT_BWD] == before


def test_split_bwd_dispatchers_refuse_other_devices():
    from rust_ray_tracer_tpu_torch.ops import bounce, hit

    x = split_kernel_inputs(torch_scene("fog"), 16, 16, 1)
    gh, gs = _split_cots(x)
    with pytest.raises(ValueError, match="unsupported device"):
        hit.hit_planes_bwd(*(v.to("meta") for v in x["hit"]), gh.to("meta"))
    P, mkind, lt, n_lights = x["su"]
    with pytest.raises(ValueError, match="unsupported device"):
        bounce.su_planes_bwd(P.to("meta"), mkind.to("meta"), lt.to("meta"),
                             n_lights, gs.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fog", "final_scene"])
def test_split_bwd_kernels_match_plain_on_card(name, cuda):
    """J' and H' against their plain versions on the card, on the inputs
    the split route gives J and H over two bounces of a 32x32 wave and a
    cotangent from a seed: dP within rtol 1e-4 of each lane's largest
    value / atol 1e-6, at most 0.5% of the lanes outside (the recomputed
    forward's transcendentals and a far sphere root's cancellation, as
    tests/test_torch_split_bwd.py measures against JAX); H''s light-table
    cotangent within relative L2 1e-4 (summed in another order). One
    launch each (and one of B' for H''s light-table partials), and a
    second run gives the same bits."""
    from rust_ray_tracer_tpu_torch.ops import bounce, hit

    ts = _final_scene() if name == "final_scene" else torch_scene(name)
    x = split_kernel_inputs(ts)
    gh, gs = (g.to(cuda) for g in _split_cots(x))
    P, kind, flip = (v.to(cuda) for v in x["hit"])
    S, mkind, lt, n_lights = x["su"]
    S, mkind, lt = S.to(cuda), mkind.to(cuda), lt.to(cuda)
    before = [k.launches for k in SPLIT_BWD + (bwd_reduce_kernel,)]
    got_h = hit.hit_planes_bwd(P, kind, flip, gh)
    got_s, got_lt = bounce.su_planes_bwd(S, mkind, lt, n_lights, gs)
    torch.cuda.synchronize()
    # B' sums H''s light-table partials
    assert [k.launches - b for k, b in zip(SPLIT_BWD + (bwd_reduce_kernel,),
                                           before)] == [1, 1, 1]
    ref_h = hit.hit_plane_core_vjp(P, kind, flip, gh)
    ref_s, ref_lt = bounce.su_plane_core_vjp(S, mkind, lt, n_lights, gs)
    assert_scaled_close(got_h.cpu().numpy(), ref_h.cpu().numpy(), 1e-4, 1e-6,
                        axis=0, budget=0.005, what="J' dP")
    assert_scaled_close(got_s.cpu().numpy(), ref_s.cpu().numpy(), 1e-4, 1e-6,
                        axis=0, budget=0.005, what="H' dP")
    assert rel_l2(got_lt.cpu().numpy(), ref_lt.cpu().numpy()) <= 1e-4
    assert torch.equal(got_h, hit_attrs_bwd_kernel(P, kind, flip, gh))
    again = shade_update_bwd_kernel(S, mkind, lt, n_lights, gs)
    assert torch.equal(got_s, again[0]) and torch.equal(got_lt, again[1])


@functools.lru_cache(maxsize=1)
def _final_hit_inputs():
    return split_kernel_inputs(_final_scene())["hit"]


def _hit_inputs(n):
    """Kernel J's inputs (P, kind, flip) at ``n`` rays and J''s cotangent:
    final_scene's 32x32 inputs over two bounces (2,048 lanes), lane 7 j
    mod 2,048 in column j (every kind among the first 129); ``split_cots``'
    cotangent of them."""
    P, kind, flip = _final_hit_inputs()
    lanes = torch.arange(n) * 7 % P.shape[1]
    P, kind, flip = P[:, lanes].contiguous(), kind[lanes], flip[lanes]
    return P, kind, flip, split_cots(kind, 1, 3)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1001, 129, 147_456])
def test_hit_kernels_any_n_on_card(n, cuda):
    """J and J' at n rays: 1,001 and 129 (neither a multiple of 4, so a
    plane starts off 16 bytes, nor of the 128-ray tile a block walks) and
    the wave's 147,456 (more tiles than the grid has blocks), on
    final_scene's inputs, against their plain versions within the
    tolerances of ``test_split_kernels_match_plain_on_card`` and
    ``test_split_bwd_kernels_match_plain_on_card``; each twice, bitwise,
    one launch a call."""
    from rust_ray_tracer_tpu_torch.ops import hit

    P, kind, flip, g = (v.to(cuda) for v in _hit_inputs(n))
    before = [k.launches for k in (hit_attrs_kernel, hit_attrs_bwd_kernel)]
    got = hit.hit_planes(P, kind, flip)
    got_b = hit.hit_planes_bwd(P, kind, flip, g)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(
        (hit_attrs_kernel, hit_attrs_bwd_kernel), before)] == [1, 1]
    assert torch.equal(got, hit_attrs_kernel(P, kind, flip))
    assert torch.equal(got_b, hit_attrs_bwd_kernel(P, kind, flip, g))
    ref = hit.hit_plane_core(P, kind, flip)
    miss = kind == 0
    assert bool(torch.isinf(got[0, miss]).all())
    got[0, miss] = ref[0, miss] = 0.0
    sph = (kind == 2).cpu().numpy()
    assert_scaled_close(got[:9].cpu().numpy(), ref[:9].cpu().numpy(), 1e-5,
                        1e-6, axis=0, what="hit attrs")
    assert_scaled_close(got[9:].cpu().numpy()[:, sph],
                        ref[9:].cpu().numpy()[:, sph], 1e-5, 1e-6, axis=0,
                        what="sphere UV source")
    assert_scaled_close(got_b.cpu().numpy(),
                        hit.hit_plane_core_vjp(P, kind, flip, g).cpu().numpy(),
                        1e-4, 1e-6, axis=0, budget=0.005, what="J' dP")
    assert sph.any() and (kind == 3).any() and (kind == 4).any()


def _int_bits_zero(x):
    """Every float of ``x`` is +0 (bit pattern 0)."""
    return not bool(x.contiguous().view(torch.int32).any())


def _final_lights(n_lights):
    """``n_lights`` light rows in final_scene's frame
    (``torch_parity.spread_lights``): the reference's ceiling rectangle (an
    XZRect over x 123-423, z 147-412 at y = 554) and a sphere light at its
    glass sphere ((260, 150, 45), radius 50) in turn. (final_scene's own
    light takes the Hittable defaults: no pdf, no cotangent.)"""
    base = torch.zeros((2, 14))
    base[0, 0] = LIGHT_QUAD
    base[0, 5:14] = torch.tensor([123.0, 554.0, 147.0, 300.0, 0.0, 0.0,
                                  0.0, 0.0, 265.0])
    base[1, 0] = LIGHT_SPHERE
    base[1, 1:5] = torch.tensor([260.0, 150.0, 45.0, 50.0])
    return spread_lights(base, n_lights)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [1, 6, 8])
def test_shade_update_bwd_light_counts_on_card(n_lights, cuda):
    """H' at 1, 6 and 8 lights (8: 126 light-table entries, each ray's
    share 64,512 bytes of a block's dynamic shared memory, past the
    default 48 KB) on the inputs the split route gives H over two bounces
    of a 32x32 wave of final_scene, the table's rows
    (:func:`_final_lights`) beside its background: against
    ``su_plane_core_vjp`` with a seeded cotangent under B's budget (dP
    within rtol 1e-4 / atol 1e-6 of each lane's largest plane, at most
    0.5% of the lanes outside; dlt within relative L2 1e-4, some light
    row non-zero), twice for the same bits, one launch a call and one of
    B' for its partials."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    x = split_kernel_inputs(_final_scene())
    P, mkind, lt0, _ = x["su"]
    lt = torch.cat([_final_lights(n_lights), lt0[-1:]])
    g = torch.from_numpy(np.random.default_rng(n_lights).normal(
        size=(13, P.shape[1])).astype(np.float32))
    args = (P.to(cuda), mkind.to(cuda), lt.to(cuda), n_lights, g.to(cuda))
    before = [shade_update_bwd_kernel.launches, bwd_reduce_kernel.launches]
    runs = [shade_update_bwd_kernel(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert [shade_update_bwd_kernel.launches - before[0],
            bwd_reduce_kernel.launches - before[1]] == [2, 2]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ref_p, ref_lt = bounce.su_plane_core_vjp(P, mkind, lt, n_lights, g)
    dP, dlt = runs[0]
    assert_scaled_close(dP.cpu().numpy(), ref_p.numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what=f"H' {n_lights} lights")
    assert rel_l2(dlt.cpu().numpy(), ref_lt.numpy()) <= 1e-4
    assert float(dlt[:n_lights].abs().max()) > 0


@pytest.mark.gpu
def test_shade_update_bwd_blocks_without_adds_on_card(cuda):
    """H' on final_scene's bounce-0 inputs of a 32x32 wave, rearranged so
    that block 0 is all dead, block 1 all found on metal (neither adds to
    the light table) and the rest as the route gave them: the first two
    blocks' partials +0 bit for bit, block 0's lanes the pass-through's
    cotangents (o, d, L, beta from ``g``, every other plane +0), the rest
    within B's budget of ``su_plane_core_vjp``; on a wave all dead every
    partial +0 and dlt +0; twice for the same bits."""
    from rust_ray_tracer_tpu_torch.ops import bounce
    from rust_ray_tracer_tpu_torch.models.scene import MAT_METAL

    x = split_kernel_inputs(_final_scene(), depth=1)
    P, mkind, lt, n_lights = (v.clone() if torch.is_tensor(v) else v
                              for v in x["su"])
    P[38, :128] = 0.0
    P[38:40, 128:256] = 1.0
    mkind[128:256] = MAT_METAL
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(13, P.shape[1])).astype(np.float32))
    args = (P.to(cuda), mkind.to(cuda), lt.to(cuda), n_lights, g.to(cuda))
    dP, part = shade_update_bwd_kernel.partials(*args)
    again = shade_update_bwd_kernel.partials(*args)
    _, dlt = shade_update_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(dP, again[0]) and torch.equal(part, again[1])
    assert _int_bits_zero(part[:2])
    want = torch.zeros((40, 128))
    want[0:6] = g[0:6, :128]
    want[17:23] = g[6:12, :128]
    assert torch.equal(dP[:, :128].cpu(), want)
    ref_p, ref_lt = bounce.su_plane_core_vjp(P, mkind, lt, n_lights, g)
    assert_scaled_close(dP.cpu().numpy(), ref_p.numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what="H' blocks without adds")
    assert rel_l2(dlt.cpu().numpy(), ref_lt.numpy()) <= 1e-4
    dead = args[0].clone()
    dead[38] = 0.0
    d_dP, d_part = shade_update_bwd_kernel.partials(dead, *args[1:])
    _, d_dlt = shade_update_bwd_kernel(dead, *args[1:])
    assert _int_bits_zero(d_part) and _int_bits_zero(d_dlt)
    assert torch.equal(d_dP[23:], torch.zeros_like(d_dP[23:]))


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [1, 8])
def test_shade_update_light_counts_on_card(n_lights, cuda):
    """H at 1 and 8 lights (8: the split kernels' cap, 126 light-table
    entries) on the inputs the split route gives it over two bounces of a
    32x32 wave of final_scene, the table's rows (:func:`_final_lights`)
    beside its background: against ``su_plane_core`` within
    :func:`test_split_kernels_match_plain_on_card`'s bound (rtol 1e-5 of
    each lane's largest value / atol 1e-6, at most 0.5% of the lanes
    outside), twice for the same bits, one launch a call."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    x = split_kernel_inputs(_final_scene())
    P, mkind, lt0, _ = x["su"]
    lt = torch.cat([_final_lights(n_lights), lt0[-1:]])
    args = (P.to(cuda), mkind.to(cuda), lt.to(cuda), n_lights)
    before = shade_update_kernel.launches
    runs = [shade_update_kernel(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert shade_update_kernel.launches - before == 2
    assert torch.equal(runs[0], runs[1])
    ref = bounce.su_plane_core(P, mkind, lt, n_lights)
    assert_scaled_close(runs[0].cpu().numpy(), ref.numpy(), 1e-5, 1e-6,
                        axis=0, budget=0.005,
                        what=f"H {n_lights} lights")


def _fog_grads(device):
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    params, static = partition(torch_scene("fog").to(device))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    render_waves(combine(leaves, static), 16, 16, rng.key(0, device), 0, 1,
                 chunk_size=256).mean().backward()
    return {k: v.grad for k, v in leaves.items() if v.grad is not None}


@pytest.mark.gpu
def test_render_waves_split_route_grads_on_card(cuda):
    """torch.autograd through render_waves on the fog scene on the card
    runs M, J, H, J' and H' once a bounce, not O, and none of the
    whole-wave kernels but B' (``bwd_reduce``, the row sums of the glue's
    gathers, ``ops/gather.rows``); its gradients are finite, the same bits
    twice, and within
    1e-6 + 2e-3 of each leaf's largest entry of the CPU plain route's
    (the card's sinf/cosf in the marble glue and the kernels' rounding
    move the last bits; a forked path would move a leaf by a ray's share,
    1 / 768 of a beta)."""
    watched = SPLIT + SPLIT_BWD + (fused_search_kernel, trace_wave_kernel,
                                   trace_wave_bwd_kernel)
    out = []
    for _ in range(2):
        before = [k.launches for k in watched]
        sums = bwd_reduce_kernel.launches
        out.append(_fog_grads(cuda))
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(watched, before)] == \
            [0] + [DEPTH] * 5 + [0, 0]
        assert bwd_reduce_kernel.launches > sums   # the glue's row sums
    ref = _fog_grads("cpu")
    for k, v in out[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, out[1][k]), k
        r = ref[k].double()
        assert float((v.cpu().double() - r).abs().max()) <= \
            1e-6 + 2e-3 * float(r.abs().max()), k
    for k in ("perlin_vec", "tex_scale", "sph_r", "quad_q", "med_pl_d",
              "background", "camera.c2w"):
        assert float(out[0][k].abs().max()) > 0, k


@pytest.mark.gpu
def test_row_sums_on_card(cuda):
    """``ops/gather.row_sums`` on the card (``reduce_order`` +
    ``bwd_reduce_kernel``) on 147,456 rows, 100,000 of them into row 0 (a
    wave's miss lanes): equal bit for bit to ``ops/uber.
    bwd_reduce_replay`` (the kernel's order of operations on the host),
    the same bits twice, and against a float64 sum within 1e-5 of the sum
    of the terms' magnitudes: the fixed order rounds each term at most
    ~120 times (4 in its thread, 5 scan steps, 8 warps, ~100 pieces in
    turn), 7e-6 at float32's 6e-8. (Against the CPU's float32
    ``index_add_``, which adds in series, an earlier order differed by
    8e-4 on row 0's sum of 43, whose terms' magnitudes add to ~80,000:
    cancellation, not a bound for either order; measured on the H100.)"""
    from rust_ray_tracer_tpu_torch.ops import gather

    r = np.random.default_rng(3)
    idx = torch.from_numpy(r.integers(0, 256, size=147456))
    idx[: 100000] = 0
    g = torch.from_numpy(r.normal(size=(147456, 3)).astype(np.float32))
    before = bwd_reduce_kernel.launches
    got = gather.row_sums(g.to(cuda), idx.to(cuda), 256)
    again = gather.row_sums(g.to(cuda), idx.to(cuda), 256)
    torch.cuda.synchronize()
    assert bwd_reduce_kernel.launches - before == 2
    assert torch.equal(got, again)
    keys, perm = K.reduce_order(idx.to(torch.int32))
    replay = uber.bwd_reduce_replay(g, keys, perm, 256,
                                    torch.zeros((0, 0)))[0]
    assert torch.equal(got.cpu(), replay)
    g64 = g.double()
    ref = torch.zeros(256, 3, dtype=torch.float64).index_add_(0, idx, g64)
    mag = torch.zeros(256, 3, dtype=torch.float64).index_add_(0, idx,
                                                              g64.abs())
    assert bool(((got.cpu().double() - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 3, 17, 32])
def test_bwd_reduce_atlas_on_card(w, cuda):
    """B' on an atlas-sized table (524,288 rows, the earth map's) whose
    147,456 terms go to ~80 rows, with keys past the table (rays that found
    no row) and a light table of partials: duni and dlt equal to the
    host's replay bit for bit, twice, and every other row exactly zero."""
    r = np.random.default_rng(11)
    rows = r.choice(524_288 - 1, size=79, replace=False).tolist()
    rows.append(524_287)                        # the last row
    keys = np.asarray(rows)[np.minimum(r.geometric(0.05, size=147_456) - 1,
                                       79)]
    keys[r.random(keys.size) < 0.2] = 524_288   # no row
    k = torch.from_numpy(keys.astype(np.int32))
    contrib = torch.from_numpy(r.normal(size=(keys.size, w))
                               .astype(np.float32))
    part = torch.from_numpy(r.normal(size=(1152, 28)).astype(np.float32))
    skeys, perm = K.reduce_order(k)
    want = uber.bwd_reduce_replay(contrib, skeys, perm, 524_288, part)
    args = (contrib.to(cuda), skeys.to(cuda), perm.to(cuda), 524_288,
            part.to(cuda))
    before = bwd_reduce_kernel.launches
    got = bwd_reduce_kernel(*args)
    again = bwd_reduce_kernel(*args)
    torch.cuda.synchronize()
    assert bwd_reduce_kernel.launches - before == 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    named = torch.zeros(524_288, dtype=torch.bool)
    named[rows] = True
    assert bool((got[0].cpu()[~named] == 0).all())


def quad_cases(device="cpu"):
    """Kernel O's edge cases: a scene-like table of 300 unit quads in 3
    clusters and 333 rays (not a multiple of 32 or 128), as (scene with
    ``quad_q``, ``quad_u``, ``quad_v``, ``n_quads``, the cluster boxes;
    rays [333, 8]). Clusters 0 and 1 are 16 x 8 grids of unit squares at
    z = 5 around x = 0 and x = 100; cluster 2 repeats quads 0-43, so a ray
    there hits two quads at the same t and the lower index must win. The
    rays go down -z from z = 10 (t = 5 exactly) onto corners, edges and
    centres (alpha, beta exactly 0, 1 or 0.5), alternating between the two
    grids, so a warp's rays enter disjoint clusters; some have t exactly at
    tmin or tmax, some run parallel to the plane (denom = 0), some are dead
    (tmax < tmin: a collapsed window is a dead lane to JAX's kernel and
    to this one), some miss."""
    import types

    j = np.arange(128)
    grid = np.stack([j % 16, j // 16 % 8, np.full(128, 5.0)], 1)
    q = np.concatenate([grid, grid + [100.0, 0.0, 0.0], grid[:44]])
    u = np.tile([1.0, 0.0, 0.0], (300, 1))
    v = np.tile([0.0, 1.0, 0.0], (300, 1))
    corners = np.stack([q, q + u, q + v, q + u + v])
    lo = np.stack([corners[:, c * 128:(c + 1) * 128].min((0, 1))
                   for c in range(3)])
    hi = np.stack([corners[:, c * 128:(c + 1) * 128].max((0, 1))
                   for c in range(3)])
    r = np.random.default_rng(12)
    n = 333
    side = np.arange(n) % 2 * 100.0
    x = r.integers(0, 33, n) / 2.0 + side
    y = r.integers(0, 17, n) / 2.0
    o = np.stack([x, y, np.full(n, 10.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    tmin, tmax = np.full(n, 1e-3), np.full(n, np.inf)
    tmax[7::31] = 5.0                     # t exactly at tmax
    tmin[11::29], tmax[11::29] = 5.0, np.inf   # t exactly at tmin
    tmax[13::17] = -1.0                   # dead
    flat = np.arange(3, n, 37)            # parallel to the quads' plane
    o[flat, 2], d[flat], tmin[flat] = 5.0, [1.0, 0.0, 0.0], 0.0
    o[5::41, 0] = 50.0                    # between the grids: a miss
    rays = np.concatenate([o, d, tmin[:, None], tmax[:, None]], 1)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                                ).to(device)

    scene = types.SimpleNamespace(
        quad_q=t32(q), quad_u=t32(u), quad_v=t32(v), n_quads=300,
        quad_cluster_min=t32(lo), quad_cluster_max=t32(hi))
    return scene, t32(rays)


@pytest.mark.gpu
def test_quad_search_on_card(cuda):
    """Kernel O on final_scene's recorded rays (two bounces of a 32x32
    wave, dead lanes among them) and on :func:`quad_cases`: through
    ``ops/quad.quad_search`` one launch and no call of the plain version
    (a spy on ``_quad_candidates``), then winners and t equal to the plain
    version's and to ``quad_sweep_replay``'s bit for bit, the dead lanes
    (inf, 0)."""
    from rust_ray_tracer_tpu_torch.ops import quad

    ts = _final_scene()
    tg = ts.to(cuda)
    o, d, t_min, t_max = (v.to(cuda) for v in split_kernel_inputs(ts)["quad"])
    real = quad._quad_candidates
    plain_calls = []

    def spy(*a):
        plain_calls.append(1)
        return real(*a)

    quad._quad_candidates = spy
    try:
        before = quad_search_kernel.launches
        got_t, got_i = quad.quad_search(tg, o, d, t_min, t_max)
        torch.cuda.synchronize()
    finally:
        quad._quad_candidates = real
    assert not plain_calls and quad_search_kernel.launches == before + 1
    cases = [(tg, torch.cat([o, d, t_min[:, None], t_max[:, None]], 1)
              .contiguous(), got_t, got_i)]
    sc, rays = quad_cases(cuda)
    cases.append((sc, rays) + quad_search_kernel(
        rays, quad.quad_table(sc), sc.quad_cluster_min, sc.quad_cluster_max))
    for sc, rays, bt, bi in cases:
        ref_t, ref_i = real(sc, rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                            rays[:, 7])
        rep_t, rep_i, _ = quad.quad_sweep_replay(
            rays, quad.quad_table(sc), sc.quad_cluster_min,
            sc.quad_cluster_max)
        assert torch.equal(bi.long(), ref_i) and torch.equal(bt, ref_t)
        assert torch.equal(bi.long(), rep_i) and torch.equal(bt, rep_t)
        dead = rays[:, 7] <= rays[:, 6]
        assert bool(torch.isinf(bt[dead]).all()) and not bool(bi[dead].any())


# ---- the triangle search (K, M) and the fused bounce (F, F') -------------

SEARCH = (tile_enter_kernel, fused_search_kernel)
FUSED = (bounce_planes_kernel, bounce_planes_bwd_kernel)


def _mesh_calls():
    """The calls of K, M and F over two bounces of a 32x18 wave of a
    4,608-triangle mesh on the CPU (36 clusters; chunk 576: two whole
    256-ray tiles and a short one)."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops import camera as tcam
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    ts = compile_scene(mesh(TS, tcam, 4608), device="cpu")
    with split_recorder() as rec:
        render_waves(ts, 32, 18, rng.key(0, "cpu"), 0, 1, depth=2,
                     chunk_size=576)
    return rec


def _fused_calls():
    """The calls of F over two bounces of a 32x32 wave of the fog scene
    with solid textures (checkers, media) on the CPU."""
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    with split_recorder() as rec:
        render_waves(torch_scene("solid_fog"), 32, 32, rng.key(7, "cpu"), 0,
                     1, depth=2, chunk_size=1024)
    return rec["bp"]


def test_search_and_fused_wrappers_refuse_cpu_tensors():
    rec = _mesh_calls()
    bp = rec["bp"][0]
    g = torch.zeros((13, bp[0].shape[1]))
    before = [k.launches for k in SEARCH + FUSED]
    for call in (lambda: tile_enter_kernel(*rec["enter"][0]),
                 lambda: fused_search_kernel(*rec["search"][0]),
                 lambda: bounce_planes_kernel(*bp),
                 lambda: bounce_planes_bwd_kernel(*bp, g),
                 lambda: bounce_planes_bwd_kernel.partials(*bp, g)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    assert [k.launches for k in SEARCH + FUSED] == before


def test_search_and_fused_dispatchers_refuse_other_devices():
    import dataclasses

    from rust_ray_tracer_tpu_torch.ops import bounce, search

    rec = _mesh_calls()
    rays, cl_min, cl_max, chunk = rec["enter"][0]
    _, ent, tabs, _ = rec["search"][0]
    meta = dataclasses.replace(tabs, **{
        k: v.to("meta") for k, v in dataclasses.asdict(tabs).items()
        if torch.is_tensor(v)})
    P, pk, mk, fl, lt, n_lights = rec["bp"][0]
    with pytest.raises(ValueError, match="unsupported device"):
        search.tile_enter(rays.to("meta"), cl_min.to("meta"),
                          cl_max.to("meta"), chunk)
    with pytest.raises(ValueError, match="unsupported device"):
        search.fused_search(rays.to("meta"), ent.to("meta"), meta, chunk)
    args = [x.to("meta") for x in (P, pk, mk, fl, lt)]
    with pytest.raises(ValueError, match="unsupported device"):
        bounce.bounce_planes(*args, n_lights)
    with pytest.raises(ValueError, match="unsupported device"):
        bounce.bounce_planes_bwd(*args, n_lights,
                                 torch.zeros((13, P.shape[1]),
                                             device="meta"))


def _to(x, dev):
    import dataclasses

    if torch.is_tensor(x):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            k: v.to(dev) for k, v in dataclasses.asdict(x).items()
            if torch.is_tensor(v)})
    return x


@pytest.mark.gpu
def test_search_kernels_match_plain_on_card(cuda):
    """K and M against their plain versions on the card, on the inputs the
    split route gives them over two bounces of a 32x18 wave of a
    4,608-triangle mesh: K's entries equal (the same arithmetic, no FMA),
    M's kinds, indices and t equal. One launch each a call."""
    from rust_ray_tracer_tpu_torch.ops import search

    rec = _mesh_calls()
    for enter, srch in zip(rec["enter"], rec["search"]):
        before = [k.launches for k in SEARCH]
        e_args = [_to(x, cuda) for x in enter]
        s_args = [_to(x, cuda) for x in srch]
        got_e = search.tile_enter(*e_args)
        got_s = search.fused_search(*s_args)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(SEARCH, before)] == [1, 1]
        assert torch.equal(got_e, search.tile_enter_plain(*e_args))
        for a, b in zip(got_s, search.fused_search_plain(*s_args)):
            assert torch.equal(a, b)
        assert bool((got_s[1] == 1).any())         # triangles won


@pytest.mark.gpu
def test_sorted_search_kernels_match_plain_on_card(cuda, monkeypatch):
    """K and M on the rays the search-order sort permutes, against their
    plain versions on the card: the 4,608-triangle mesh's calls recorded
    with the sort's gate lowered below its triangles (two bounces, chunk
    576: a short tile a chunk), the permutation the card's the host's, K's
    entries and M's kinds, indices and t equal."""
    from rust_ray_tracer_tpu_torch.ops import search

    monkeypatch.setattr(search, "PACKED_MIN_TRIS", 4096)
    rec = _mesh_calls()
    assert len(rec["order"]) == 2
    for order, enter, srch in zip(rec["order"], rec["enter"], rec["search"]):
        o_args = [_to(x, cuda) for x in order]
        perm = search.search_order(*o_args)
        assert torch.equal(perm.cpu(), srch[4])
        e_args = [_to(x, cuda) for x in enter]
        s_args = [_to(x, cuda) for x in srch]
        got_e = search.tile_enter(*e_args)
        got_s = search.fused_search(*s_args)
        torch.cuda.synchronize()
        assert torch.equal(got_e, search.tile_enter_plain(*e_args))
        for a, b in zip(got_s, search.fused_search_plain(*s_args)):
            assert torch.equal(a, b)


def _wide_calls(monkeypatch, max_clusters):
    """A 4,608-triangle mesh (past the trace kernel's 4,096 rows: the split
    route) in at most ``max_clusters`` clusters (``MAX_CLUSTERS`` lowered,
    so each cluster is several of M's 128-row stages) on the CPU, and the
    calls of K and M over two bounces of a 32x18 wave (chunk 576), the
    rays sorted (the sort's gate lowered too)."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops import camera as tcam
    from rust_ray_tracer_tpu_torch.ops import search
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    monkeypatch.setattr(TS, "MAX_CLUSTERS", max_clusters)
    monkeypatch.setattr(search, "PACKED_MIN_TRIS", 1024)
    ts = compile_scene(mesh(TS, tcam, 4608), device="cpu")
    with split_recorder() as rec:
        render_waves(ts, 32, 18, rng.key(0, "cpu"), 0, 1, depth=2,
                     chunk_size=576)
    assert len(rec["search"]) == 2 and len(rec["search"][0]) == 5
    return ts, rec


def test_packed_search_wrapper_refuses_cpu_and_staged_tables(monkeypatch):
    """M's packed wrapper takes CUDA tensors and packed tables only; each
    variant refuses the other's tables; ``search_kernel`` picks by the
    tables. Nothing launches."""
    import dataclasses

    from rust_ray_tracer_tpu_torch.ops import search

    ts, rec = _wide_calls(monkeypatch, 9)
    rays, ent, packed, chunk, perm = rec["search"][0]
    staged = search.search_tables(ts, packed=False)
    assert packed.packed and not staged.packed and packed.width == 512
    assert K.search_kernel(staged) is fused_search_kernel
    assert K.search_kernel(packed) is K.fused_search_packed_kernel
    before = [k.launches for k in (fused_search_kernel,
                                   K.fused_search_packed_kernel,
                                   K.packed_rows_probe_kernel)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K.fused_search_packed_kernel(rays, ent, packed, chunk, perm)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K.packed_rows_probe_kernel(packed.tri)
    meta = dataclasses.replace(packed, **{
        k: v.to("meta") for k, v in dataclasses.asdict(packed).items()
        if torch.is_tensor(v)})
    with pytest.raises(ValueError, match="unsupported device"):
        search.fused_search(rays.to("meta"), ent.to("meta"), meta, chunk)
    assert [k.launches for k in (fused_search_kernel,
                                 K.fused_search_packed_kernel,
                                 K.packed_rows_probe_kernel)] == before


@pytest.mark.gpu
@pytest.mark.parametrize("max_clusters,width", [(18, 256), (9, 512),
                                                (5, 1024), (4, 2048)])
def test_packed_search_kernel_matches_staged_on_card(cuda, monkeypatch,
                                                     max_clusters, width):
    """M's packed input against its staged input and the plain version on
    the card, on clusters of 256 to 2,048 triangles (2 to 16 of M's
    stages a cluster; the last two with pad rows) over two sorted
    bounces: kinds, indices and t
    equal on every lane, one launch of each variant a call; each variant
    refuses the other's tables. The probe's rows equal
    ``compact_rows(_tri_coeffs(...))`` on the card and the staged table
    bit for bit."""
    from rust_ray_tracer_tpu_torch.ops import search
    from rust_ray_tracer_tpu_torch.ops.intersect import _tri_coeffs

    ts, rec = _wide_calls(monkeypatch, max_clusters)
    tc = ts.to(cuda)
    staged = search.search_tables(tc, packed=False)
    packed = search.search_tables(tc, packed=True)
    assert packed.width == width
    pair = (fused_search_kernel, K.fused_search_packed_kernel)
    for srch in rec["search"]:
        rays, ent, _, chunk, perm = (_to(x, cuda) for x in srch)
        before = [k.launches for k in pair]
        gs = search.fused_search(rays, ent, staged, chunk, perm)
        gp = search.fused_search(rays, ent, packed, chunk, perm)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(pair, before)] == [1, 1]
        ref = search.fused_search_plain(rays, ent, packed, chunk, perm)
        for a, b, c in zip(gp, gs, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert bool((gp[1] == 1).any())
        with pytest.raises(ValueError, match="tables"):
            fused_search_kernel(rays, ent, packed, chunk, perm)
        with pytest.raises(ValueError, match="tables"):
            K.fused_search_packed_kernel(rays, ent, staged, chunk, perm)
    rows = K.packed_rows_probe_kernel(packed.tri)
    torch.cuda.synchronize()
    ref = search.compact_rows(_tri_coeffs(tc.tri_v0, tc.tri_e1, tc.tri_e2),
                              tc.tri_double)
    assert torch.equal(rows.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), staged.tri.view(torch.int32))


@pytest.mark.gpu
def test_bounce_planes_kernels_match_plain_on_card(cuda):
    """F and F' against their plain versions on the card, on the inputs
    the split route gives F over two bounces of a 32x32 wave of the fog
    scene with solid textures (checkers, media) and a cotangent from a
    seed: F's planes within rtol 1e-5 of each lane's largest value / atol
    1e-6, at most 0.5% of the lanes outside (the card's transcendentals in
    torch and in the kernel may round a branch's input apart, as H's);
    F''s dP within rtol 1e-4 / atol 1e-6, at most 0.5% of the lanes
    outside, its light-table cotangent within relative L2 1e-4. One launch
    of each (and one of B' for F''s light-table partials); a second run
    of F' gives the same bits."""
    from rust_ray_tracer_tpu_torch.ops import bounce
    from rust_ray_tracer_tpu_torch.ops.bounce_core import (
        N_IN_B, bounce_plane_core, bounce_plane_core_vjp)

    for P, pk, mk, fl, lt, n_lights in _fused_calls():
        P, pk, mk, fl, lt = (x.to(cuda) for x in (P, pk, mk, fl, lt))
        g = torch.from_numpy(np.random.default_rng(3).normal(
            size=(13, P.shape[1])).astype(np.float32)).to(cuda)
        before = [k.launches for k in FUSED + (bwd_reduce_kernel,)]
        out = bounce.bounce_planes(P, pk, mk, fl, lt, n_lights)
        dP, dlt = bounce.bounce_planes_bwd(P, pk, mk, fl, lt, n_lights, g)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(FUSED + (bwd_reduce_kernel,),
                                               before)] == [1, 1, 1]
        chk = P.shape[0] > N_IN_B
        assert_scaled_close(
            out.cpu().numpy(), bounce_plane_core(
                P, pk, mk, fl, lt, n_lights, chk).cpu().numpy(), 1e-5, 1e-6,
            axis=0, budget=0.005, what="F")
        ref_p, ref_lt = bounce_plane_core_vjp(P, pk, mk, fl, lt, n_lights,
                                              chk, g)
        assert_scaled_close(dP.cpu().numpy(), ref_p.cpu().numpy(), 1e-4,
                            1e-6, axis=0, budget=0.005, what="F' dP")
        assert rel_l2(dlt.cpu().numpy(), ref_lt.cpu().numpy()) <= 1e-4
        again = bounce_planes_bwd_kernel(P, pk, mk, fl, lt, n_lights, g)
        assert torch.equal(dP, again[0]) and torch.equal(dlt, again[1])


def _mixed_bounce_planes(n, seed=13):
    """Kernel F's arguments on ``n`` lanes drawn from the split route's
    two bounces of the fog scene with solid textures (checkers, media):
    lanes in a seeded order so that each 128-lane block mixes live, dead,
    found and missed lanes, a seeded tenth of them dead."""
    calls = _fused_calls()
    P = torch.cat([c[0] for c in calls], 1)
    pk, mk, fl = (torch.cat([c[i] for c in calls]) for i in (1, 2, 3))
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, P.shape[1], (n,), generator=gen)
    P, pk, mk, fl = P[:, idx].contiguous(), pk[idx], mk[idx], fl[idx]
    P[45, torch.rand(n, generator=gen) < 0.1] = 0.0
    _, _, _, _, lt, n_lights = calls[0]
    return P, pk, mk, fl, lt, n_lights


@pytest.mark.gpu
@pytest.mark.parametrize("checker", [True, False])
def test_bounce_planes_mixed_blocks_on_card(checker, cuda):
    """F and G on 163,840 lanes (more than a round of resident blocks:
    9 an SM on 132 SMs hold 152,064) whose every block mixes live, dead,
    found and missed lanes (:func:`_mixed_bounce_planes`), with the
    checker leaves and without (the leaves dropped, flag bit 1 cleared):
    F on n - 37 lanes (a short last block) against
    ``bounce_plane_core``, G with every fifth tile dead against
    ``bounce_planes_live_plain``, both within F's budget (rtol 1e-5 of
    each lane's largest plane / atol 1e-6, at most 0.5% of the lanes
    outside); each twice for the same bits, G equal to F on its live
    tiles and its dead tiles' planes copied bit for bit."""
    from rust_ray_tracer_tpu_torch.ops import bounce
    from rust_ray_tracer_tpu_torch.ops.bounce_core import (N_IN_B,
                                                           bounce_plane_core)

    n = 160 * 1024
    P, pk, mk, fl, lt, n_lights = _mixed_bounce_planes(n)
    if not checker:
        P, fl = P[:N_IN_B].contiguous(), fl & ~2
    assert bool((fl & 2).any()) == checker
    args = tuple(x.to(cuda) for x in (P, pk, mk, fl, lt)) + (n_lights,)
    m = n - 37
    short = tuple(x[..., :m].contiguous() if i < 4 else x
                  for i, x in enumerate(args))
    tlive = (torch.arange(n // 1024) % 5 != 0).to(torch.int32).to(cuda)
    before = [bounce_planes_kernel.launches,
              K.bounce_planes_live_kernel.launches]
    f_runs = [bounce_planes_kernel(*short) for _ in range(2)]
    g_runs = [K.bounce_planes_live_kernel(*args, tlive) for _ in range(2)]
    f_full = bounce_planes_kernel(*args)
    torch.cuda.synchronize()
    assert [bounce_planes_kernel.launches - before[0],
            K.bounce_planes_live_kernel.launches - before[1]] == [3, 2]
    assert torch.equal(*f_runs) and torch.equal(*g_runs)
    chk = short[0].shape[0] > N_IN_B
    assert_scaled_close(f_runs[0].cpu().numpy(),
                        bounce_plane_core(*short, chk).cpu().numpy(), 1e-5,
                        1e-6, axis=0, budget=0.005, what="F mixed blocks")
    assert_scaled_close(
        g_runs[0].cpu().numpy(),
        bounce.bounce_planes_live_plain(*args, tlive).cpu().numpy(), 1e-5,
        1e-6, axis=0, budget=0.005, what="G mixed blocks")
    live = torch.repeat_interleave(tlive > 0, 1024)
    assert torch.equal(g_runs[0][:, live], f_full[:, live])
    through = torch.cat([args[0][0:6], args[0][24:30], args[0][45:46]])
    assert torch.equal(g_runs[0][:, ~live], through[:, ~live])


@pytest.mark.gpu
def test_bounce_planes_bwd_eight_lights_on_card(cuda, tmp_path):
    """F' and G' at 8 lights (126 light-table entries: each ray's share
    takes 64,512 bytes of a block's dynamic shared memory, past the
    default 48 KB) on bounces 0 and 1 of the 8-light glTF flagship's
    1024-ray chunk beside a tile of the same rays all dead (kernel G's
    inputs): F' (no flags) against ``bounce_plane_core_vjp`` and G'
    against ``bounce_planes_live_bwd_plain`` with a seeded cotangent, dP
    within rtol 1e-4 / atol 1e-6 of each lane's largest plane (at most
    0.5% of the lanes outside) and dlt within relative L2 1e-4, some light
    row non-zero; each twice for the same bits; G' equal to F' on the live
    tile bit for bit."""
    from rust_ray_tracer_tpu_torch.ops import bounce
    from rust_ray_tracer_tpu_torch.ops.bounce_core import (
        N_IN_B, bounce_plane_core_vjp)

    path = write_gltf_flagship(str(tmp_path / "f8.gltf"), 8)
    ts = compile_scene(load_gltf_scene(path, 1.0), device="cpu")
    assert ts.n_lights == 8
    st, rnd = _unfused_pair(ts)
    ctx = uber.make_ctx(ts)
    live = torch.arange(st.shape[1], device=cuda) < W * H
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=(13, st.shape[1])).astype(np.float32))
    for b in range(2):
        P, kind, mkind, flags, lt, n_lights, tlive = _live_inputs(st, rnd[b],
                                                                  ctx)
        assert n_lights == 8 and lt.shape == (9, 14)
        cpu = (P, kind, mkind, flags, lt, n_lights)
        args = tuple(x.to(cuda) if torch.is_tensor(x) else x for x in cpu)
        gc, tl = g.to(cuda), tlive.to(cuda)
        f_runs = [bounce_planes_bwd_kernel(*args, gc) for _ in range(2)]
        g_runs = [K.bounce_planes_live_bwd_kernel(*args, tl, gc)
                  for _ in range(2)]
        torch.cuda.synchronize()
        for runs in (f_runs, g_runs):
            assert all(torch.equal(x, y) for x, y in zip(*runs))
        refs = (bounce_plane_core_vjp(*cpu, P.shape[0] > N_IN_B, g),
                bounce.bounce_planes_live_bwd_plain(*cpu, tlive, g))
        for what, (dP, dlt), (ref_p, ref_lt) in zip(
                ("F'", "G'"), (f_runs[0], g_runs[0]), refs):
            assert_scaled_close(dP.cpu().numpy(), ref_p.numpy(), 1e-4, 1e-6,
                                axis=0, budget=0.005,
                                what=f"{what} 8 lights bounce {b}")
            assert rel_l2(dlt.cpu().numpy(), ref_lt.numpy()) <= 1e-4
            assert float(dlt[:8].abs().max()) > 0
        assert torch.equal(g_runs[0][0][:, live], f_runs[0][0][:, live])
        st = _next_state(st, rnd[b], ctx)


def _next_state(st, rnd_b, ctx):
    """The next state of ``st`` [14, N] for its bounce's randoms: kernel
    G's plain version on E's plain winners, as the unfused bounce takes
    it."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    out = bounce.bounce_planes_live_plain(*_live_inputs(st, rnd_b, ctx))
    return torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])


@pytest.mark.gpu
def test_bounce_planes_live_bwd_mixed_tiles_on_card(cuda):
    """G' on a wave of four tiles, live, dead, dead, live (the flagship's
    1024-ray chunk and the same rays all dead): each dead tile's lanes take
    the pass-through's cotangent and its eight blocks a zero light-table
    partial, bit for bit; each live tile's lanes and block partials equal
    F''s (no flags) on the same wave bit for bit; dP and dlt within B's
    budget of ``bounce_planes_live_bwd_plain``."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    ts = _scene("flagship")
    st2, rnd2 = _unfused_pair(ts)
    n1 = W * H
    st = torch.cat([st2[:, :n1], st2[:, n1:], st2[:, n1:], st2[:, :n1]], 1)
    rnd = torch.cat([rnd2[:, :, :n1], rnd2[:, :, n1:], rnd2[:, :, n1:],
                     rnd2[:, :, :n1]], 2)
    ctx = uber.make_ctx(ts)
    cpu = _live_inputs(st, rnd[0], ctx)
    tlive = cpu[6]
    assert tlive.tolist() == [1, 0, 0, 1]
    args = tuple(x.to(cuda) if torch.is_tensor(x) else x for x in cpu)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(13, st.shape[1])).astype(np.float32))
    gc = g.to(cuda)
    dP, part = K.bounce_planes_live_bwd_kernel.partials(*args, gc)
    f_dP, f_part = bounce_planes_bwd_kernel.partials(*args[:6], gc)
    _, dlt = K.bounce_planes_live_bwd_kernel(*args, gc)
    torch.cuda.synchronize()
    live = torch.repeat_interleave(tlive > 0, 1024).to(cuda)
    blk = torch.repeat_interleave(tlive > 0, 8).to(cuda)
    assert torch.equal(dP[:, live], f_dP[:, live])
    assert torch.equal(part[blk], f_part[blk])
    assert not bool(part[~blk].any())
    want = torch.zeros_like(dP[:, ~live])
    want[0:6] = gc[0:6, ~live]
    want[24:30] = gc[6:12, ~live]
    assert torch.equal(dP[:, ~live], want)
    ref_p, ref_lt = bounce.bounce_planes_live_bwd_plain(*cpu, g)
    assert_scaled_close(dP.cpu().numpy(), ref_p.numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what="G' mixed tiles")
    assert rel_l2(dlt.cpu().numpy(), ref_lt.numpy()) <= 1e-4


@pytest.mark.gpu
def test_render_waves_mesh_on_card(cuda):
    """render_waves and torch.autograd on a 4,608-triangle mesh on the
    card go through K, M, F and F' once a bounce and none of A, B, O, J or
    H; the image matches the plain route on the card within the flip
    budget, and the gradients are finite and the same bits twice."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops import camera as tcam
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    ts = compile_scene(mesh(TS, tcam, 4608), device=cuda)
    watched = SEARCH + FUSED + SPLIT + (trace_wave_kernel,
                                        trace_wave_bwd_kernel)
    before = [k.launches for k in watched]
    got = render_waves(ts, 32, 18, rng.key(0), 0, 1, chunk_size=576)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(watched, before)] == \
        [DEPTH] * 3 + [0] * 6
    with split_recorder(plain=True):
        ref = render_waves(ts, 32, 18, rng.key(0), 0, 1, chunk_size=576)
    assert_flip_budget(got.cpu().numpy(), ref.cpu().numpy())
    grads = []
    for _ in range(2):
        params, static = partition(ts)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        before = bounce_planes_bwd_kernel.launches
        render_waves(combine(leaves, static), 32, 18, rng.key(0), 0, 1,
                     chunk_size=576).mean().backward()
        torch.cuda.synchronize()
        assert bounce_planes_bwd_kernel.launches - before == DEPTH
        grads.append({k: v.grad for k, v in leaves.items()
                      if v.grad is not None})
    for k, v in grads[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, grads[1][k]), k
    assert float(grads[0]["tri_v0"].abs().max()) > 0


CULL = (sph_search_kernel, tri_search_kernel)


def _cull_calls(tmp_path, monkeypatch):
    """The calls of N and L over two bounces of a 32x16 wave of
    ``torch_parity.random_tris`` (random's 1,024 sphere rows beside 1,024
    triangle rows) with a 64x32 earth map, on the CPU: {"sph": [...],
    "tri": [...]}."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    write_earth_map(tmp_path, 64, 32)
    monkeypatch.chdir(tmp_path)
    ts = compile_scene(random_tris(TS, builders, 2.0), device="cpu")
    with split_recorder() as rec:
        render_waves(ts, 32, 16, rng.key(7, "cpu"), 0, 1, depth=2,
                     chunk_size=512)
    return rec


def test_cull_wrappers_refuse_cpu_tensors(tmp_path, monkeypatch):
    rec = _cull_calls(tmp_path, monkeypatch)
    before = [k.launches for k in CULL]
    for call in (lambda: sph_search_kernel(*rec["sph"][0]),
                 lambda: tri_search_kernel(*rec["tri"][0])):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    assert [k.launches for k in CULL] == before


def test_cull_dispatchers_refuse_other_devices(tmp_path, monkeypatch):
    from rust_ray_tracer_tpu_torch.ops import search, sphere

    rec = _cull_calls(tmp_path, monkeypatch)
    rays, tab, cl_min, cl_max, n_sph, chunk, boxes = rec["sph"][0]
    with pytest.raises(ValueError, match="unsupported device"):
        sphere.sph_search(rays.to("meta"), tab.to("meta"), cl_min.to("meta"),
                          cl_max.to("meta"), n_sph, chunk, boxes.to("meta"))
    rays, ent, tabs, chunk = rec["tri"][0]
    with pytest.raises(ValueError, match="unsupported device"):
        search.tri_search(rays.to("meta"), ent.to("meta"),
                          _to(tabs, "meta"), chunk)


@pytest.mark.gpu
def test_cull_kernels_match_plain_on_card(cuda, tmp_path, monkeypatch):
    """N and L against their plain versions on the card, on the inputs the
    split route gives them over two bounces of a 32x16 wave of the L
    check scene: the same indices and the same bits of t. One launch
    each a call."""
    from rust_ray_tracer_tpu_torch.ops import search, sphere

    rec = _cull_calls(tmp_path, monkeypatch)
    for sph, tri in zip(rec["sph"], rec["tri"]):
        before = [k.launches for k in CULL]
        s_args = [_to(x, cuda) for x in sph]
        t_args = [_to(x, cuda) for x in tri]
        got_s = sphere.sph_search(*s_args)
        got_t = search.tri_search(*t_args)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(CULL, before)] == [1, 1]
        for got, ref in ((got_s, sphere.sph_search_plain(*s_args)),
                         (got_t, search.tri_search_plain(*t_args))):
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1].long(), ref[1].long())
        assert bool(torch.isfinite(got_s[0]).any())
        assert bool(torch.isfinite(got_t[0]).any())


def _bits(x):
    return x.contiguous().view(torch.int32)


def _enter_inputs(dev):
    """``torch_parity.enter_cases`` on ``dev``: (rays, chunk, {name:
    (cl_min, cl_max)}, perm)."""
    rays, chunk, boxes, perm = enter_cases()
    return (torch.from_numpy(rays).to(dev), chunk,
            {k: tuple(torch.from_numpy(x).to(dev) for x in v)
             for k, v in boxes.items()},
            torch.from_numpy(perm).to(dev))


def test_enter_cases_reach_the_edges():
    """The K cases the card's test takes, through the plain version on the
    CPU: chunks of 600 (a short third tile), one tile with no live ray
    (a row of +inf), 40 and 300 clusters, some entered and some not."""
    from rust_ray_tracer_tpu_torch.ops import search

    rays, chunk, boxes, perm = _enter_inputs("cpu")
    assert rays.shape[1] % 256 and chunk % 256 and rays.is_contiguous()
    for lo, hi in boxes.values():
        ent = search.tile_enter_plain(rays, lo, hi, chunk)
        assert ent.shape == (6, lo.shape[0])
        assert bool(torch.isinf(ent[3]).all())           # the dead tile
        fin = torch.isfinite(ent)
        assert 0.05 < float(fin[[0, 1, 2, 4, 5]].float().mean()) < 0.95
        assert not bool(fin[:, 5].any())                 # the empty box
        sorted_ent = search.tile_enter_plain(rays, lo, hi, chunk, perm)
        assert not torch.equal(sorted_ent, ent)


@pytest.mark.gpu
def test_tile_enter_kernel_edges_on_card(cuda):
    """K bit for bit against ``tile_enter_plain`` on the card, on
    ``torch_parity.enter_cases``: a chunk that is not a multiple of 256, a
    tile with no live ray, k = 40 (< 256; one part-filled block a tile)
    and 300 (> 256; five blocks a tile, the last part-filled), rays
    parallel to an axis, with and without a permutation. One launch a
    call; two give the same bits."""
    from rust_ray_tracer_tpu_torch.ops import search

    rays, chunk, boxes, perm = _enter_inputs(cuda)
    for lo, hi in boxes.values():
        for pm in (None, perm):
            ref = search.tile_enter_plain(rays, lo, hi, chunk, pm)
            before = tile_enter_kernel.launches
            got = search.tile_enter(rays, lo, hi, chunk, pm)
            again = search.tile_enter(rays, lo, hi, chunk, pm)
            torch.cuda.synchronize()
            assert tile_enter_kernel.launches == before + 2
            assert torch.equal(_bits(got), _bits(ref)), pm
            assert torch.equal(_bits(again), _bits(got))
            if pm is None:                           # the dead tile
                assert bool(torch.isinf(got[3]).all())


def _hollow_calls(dev):
    """N's calls on ``torch_parity.hollow_spheres`` on ``dev``: the 300
    rays as one chunk and as two of 150."""
    import types

    from rust_ray_tracer_tpu_torch.ops import sphere

    fields, rays = hollow_spheres()
    sc = types.SimpleNamespace(**{k: torch.from_numpy(v).to(dev)
                                  for k, v in fields.items()})
    rays = torch.from_numpy(rays).to(dev)
    tab = sphere.sph_table(sc)
    return [(rays, tab, sc.sph_cluster_min, sc.sph_cluster_max,
             sc.sph_c0.shape[0], chunk, sphere.sph_boxes(sc))
            for chunk in (None, 150)]


@pytest.mark.gpu
def test_sph_search_kernel_edges_on_card(cuda, tmp_path, monkeypatch):
    """N against ``sph_search_plain`` on the card (t bit for bit, indices
    equal) and against ``ops/sphere.sph_sweep_replay`` (the same): on the
    hollow table (hollow spheres at 32-row edges in two flagged clusters
    beside one the warps vote on, empty and collapsed windows, a short
    tile) and on the L check scene's recorded calls. Two runs give the
    same bits."""
    from rust_ray_tracer_tpu_torch.ops import sphere

    rec = _cull_calls(tmp_path, monkeypatch)
    calls = _hollow_calls(cuda) + [tuple(_to(x, cuda) for x in c)
                                   for c in rec["sph"]]
    for args in calls:
        ref = sphere.sph_search_plain(*args)
        rep = sphere.sph_sweep_replay(*args)
        got = sphere.sph_search(*args)
        again = sphere.sph_search(*args)
        torch.cuda.synchronize()
        for r in (ref, rep[:2]):
            assert torch.equal(_bits(got[0]), _bits(r[0]))
            assert torch.equal(got[1].long(), r[1].long())
        assert torch.equal(_bits(again[0]), _bits(got[0]))
        assert torch.equal(again[1], got[1])
        assert bool(torch.isfinite(ref[0]).any())


def test_hollow_calls_hit_hollow_rows():
    """The hollow table's calls on the CPU: a hollow row of a flagged
    cluster wins on some ray of each, and so does a row of the cluster
    without one (sub-boxes flagged and not, so the card's call runs the
    warps' vote beside the flagged path); the dead lanes miss."""
    from rust_ray_tracer_tpu_torch.models.scene import CLUSTER
    from rust_ray_tracer_tpu_torch.ops import sphere

    for args in _hollow_calls("cpu"):
        assert all(x.is_contiguous() for x in args if torch.is_tensor(x))
        flags = args[6][:, 3]
        assert bool((flags == 1).any()) and bool((flags == 0).any())
        t, i = sphere.sph_search_plain(*args)
        fields, _ = hollow_spheres()
        r = torch.from_numpy(fields["sph_r"])
        won = i[torch.isfinite(t)]
        assert bool((r[won] < 0).any())
        assert bool((won >= 2 * CLUSTER).any())
        dead = args[0][8] <= args[0][7]
        assert not bool(torch.isfinite(t[dead]).any())


@pytest.mark.gpu
def test_render_waves_earth_on_card(cuda, tmp_path, monkeypatch):
    """random with a 64x32 earth map and a second earth sphere in view, on
    the card: N, J and H once a bounce and none of A, K, M, L, O or F; the
    image within the flip budget of the plain route on the card (every
    pixel outside rtol 3e-4 / atol 3e-5 a flip: the marble ground); the
    gradients finite, the same bits twice, and non-zero on ``img_data``."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    write_earth_map(tmp_path, 64, 32)
    monkeypatch.chdir(tmp_path)
    ts = compile_scene(random_earth_view(TS, builders, 2.0), device=cuda)
    watched = CULL + SPLIT + SEARCH + FUSED + (trace_wave_kernel,
                                               trace_wave_noise_kernel)
    before = [k.launches for k in watched]
    got = render_waves(ts, 32, 16, rng.key(0), 0, 1, chunk_size=512)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(watched, before)] == \
        [DEPTH, 0, 0, DEPTH, DEPTH] + [0] * 6
    with split_recorder(plain=True):
        ref = render_waves(ts, 32, 16, rng.key(0), 0, 1, chunk_size=512)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    outside = (np.abs(got - ref) > 3e-5 + 3e-4 * np.abs(ref)).any(-1)
    assert outside.mean() <= 0.005
    grads = []
    for _ in range(2):
        params, static = partition(ts)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        render_waves(combine(leaves, static), 32, 16, rng.key(0), 0, 1,
                     chunk_size=512).mean().backward()
        torch.cuda.synchronize()
        grads.append({k: v.grad for k, v in leaves.items()
                      if v.grad is not None})
    for k, v in grads[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, grads[1][k]), k
    assert float(grads[0]["img_data"].abs().max()) > 0



# ---- the shading of 9 or more lights: kernels I and I' (csrc/shade.cu) --

def _gltf_lights(tmp_path, n_lights):
    return compile_scene(load_gltf_scene(write_gltf_flagship(
        tmp_path / f"f{n_lights}.gltf", n_lights), 16 / 9), device="cpu")


def _render_cpu(ts, w=32, h=18):
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    with torch.no_grad():
        return render_waves(ts, w, h, rng.key(0, "cpu"), 0, 1,
                            chunk_size=w * h)


def test_shade_wrappers_refuse_cpu_tensors_and_light_counts(monkeypatch):
    """The wrappers refuse CPU tensors at any light count, before they
    build anything, and launch nothing. The light limit is the built
    library's (``shade_max_lights``, checked on the card below): with it
    stubbed at 32, the split route on the card refuses a 33-light scene,
    naming the limit, and takes 32; on the CPU it takes any count."""
    from types import SimpleNamespace

    from rust_ray_tracer_tpu_torch.ops.integrator import split_reason

    data, rng_p = torch.zeros((14, 128)), torch.zeros((15, 128))
    kind = torch.zeros((128,), dtype=torch.int32)
    for k in (shade_kernel, shade_bwd_kernel):
        before = k.launches
        for nl in (9, 33):
            args = ((data, rng_p, kind, torch.zeros((nl, 14)), nl)
                    + ((torch.zeros((9, 128)),) if k is shade_bwd_kernel
                       else ()))
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                k(*args)
        assert k.launches == before
    monkeypatch.setattr(shade_bwd_kernel, "_max_lights", 32)
    card = torch.device("cuda")
    assert "at most 32" in split_reason(SimpleNamespace(device=card,
                                                        n_lights=33))
    assert split_reason(SimpleNamespace(device=card, n_lights=32)) is None
    assert split_reason(SimpleNamespace(device=torch.device("cpu"),
                                        n_lights=33)) is None


@pytest.mark.gpu
def test_shade_wrappers_refuse_light_counts_past_the_library(cuda):
    """On the card the wrappers take the light count the built library
    gives (3,892: the light table a block of I' holds in shared memory
    beside its two light-major stages) and refuse one more, naming the
    limit, without a launch."""
    from rust_ray_tracer_tpu_torch.kernels import shade_max_lights

    most = shade_max_lights()
    assert most == 3892
    n = 128
    data = torch.zeros((14, n), device=cuda)
    rng_p = torch.zeros((15, n), device=cuda)
    kind = torch.zeros((n,), dtype=torch.int32, device=cuda)
    g = torch.zeros((9, n), device=cuda)
    for nl, ok in ((most, True), (most + 1, False)):
        lt = torch.zeros((nl, 14), device=cuda)
        for k in (shade_kernel, shade_bwd_kernel):
            args = (data, rng_p, kind, lt, nl) + (
                (g,) if k is shade_bwd_kernel else ())
            before = k.launches
            if ok:
                k(*args)
                assert k.launches == before + 1
            else:
                with pytest.raises(ValueError, match=f"at most {most}"):
                    k(*args)
                assert k.launches == before
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_shade_launchers_refuse_past_the_cap_on_card(cuda):
    """The C launchers of I and I' themselves (not only the wrappers)
    return -1 for one light past ``shade_max_lights`` and 0 at it (n = 0:
    nothing to launch), so no caller of the library can run I' past the
    shared memory a block holds."""
    import ctypes

    lib = ctypes.CDLL(str(shade_bwd_kernel.load().path))
    most = int(lib.shade_max_lights())
    null = ctypes.c_void_p(None)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for nl, want in ((most, 0), (most + 1, -1)):
        assert lib.shade_launch(null, null, null, null, ctypes.c_int(nl),
                                null, ctypes.c_int(0), stream) == want
        assert lib.shade_bwd_launch(null, null, null, null,
                                    ctypes.c_int(nl), null, null, null,
                                    ctypes.c_int(0), stream) == want


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [1, 9, 16, 32, "cap"])
def test_shade_bwd_light_counts_on_card(n_lights, cuda, tmp_path):
    """I' at 1, 9, 16, 32 lights and at the cap (``shade_max_lights``) on
    the lanes a CPU wave of the 9-light glTF flagship gives I (bounces 0
    and 1; 256 lanes of bounce 0 at the cap), the table built from its 9
    lights (``torch_parity.spread_lights``), against its plain version
    with a seeded cotangent under B's budget (rtol 1e-4 / atol 1e-6 a
    lane, at most 0.5% of the lanes outside, the light table's cotangent
    within relative L2 1e-4 and some light taking one), twice for the
    same bits, one launch a call and one of B' for its partials."""
    from rust_ray_tracer_tpu_torch.kernels import shade_max_lights

    nl = shade_max_lights() if n_lights == "cap" else n_lights
    ts = _gltf_lights(tmp_path, 9)
    with split_recorder() as rec:
        _render_cpu(ts)
    calls = rec["shade"][:1] if n_lights == "cap" else rec["shade"][:2]
    for b, (data, rng_p, kind, lt9, _) in enumerate(calls):
        if n_lights == "cap":
            data, rng_p, kind = data[:, :256], rng_p[:, :256], kind[:256]
        lt = spread_lights(lt9, nl)
        args = [x.contiguous() for x in (data, rng_p, kind, lt)]
        g = torch.from_numpy(np.random.default_rng(b).normal(
            size=(9, data.shape[1])).astype(np.float32))
        dev = [x.to(cuda) for x in args] + [nl, g.to(cuda)]
        before = [shade_bwd_kernel.launches, bwd_reduce_kernel.launches]
        d1, l1 = shade_bwd_kernel(*dev)
        d2, l2 = shade_bwd_kernel(*dev)
        torch.cuda.synchronize()
        assert [shade_bwd_kernel.launches - before[0],
                bwd_reduce_kernel.launches - before[1]] == [2, 2]
        assert torch.equal(d1, d2) and torch.equal(l1, l2)
        rd, rl = shade_ops.shade_plane_core_vjp(*args, nl, g)
        assert_scaled_close(d1.cpu().numpy(), rd.numpy(), 1e-4, 1e-6,
                            axis=0, budget=0.005,
                            what=f"I' {nl} lights bounce {b}")
        assert rel_l2(l1.cpu().numpy(), rl.numpy()) <= 1e-4
        assert float(l1.abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [9, 16, 40])
def test_shade_kernel_light_counts_on_card(n_lights, cuda, tmp_path):
    """I at 9, 16 and 40 lights (40: past one 32-light chunk of its
    candidate mask) on the lanes a CPU wave of the 9-light glTF flagship
    gives it (bounces 0 and 1), the table spread from its 9 lights
    (``torch_parity.spread_lights``), against ``shade_plane_core`` with
    ``chip_smoke.shade_vs_plain``'s tolerance (rtol 3e-4 of each lane's
    largest value / atol 3e-5, at most 0.5% of the lanes outside, alive
    equal), twice for the same bits, one launch a call."""
    ts = _gltf_lights(tmp_path, 9)
    with split_recorder() as rec:
        _render_cpu(ts)
    for b, (data, rng_p, kind, lt9, _) in enumerate(rec["shade"][:2]):
        args = (data, rng_p, kind, spread_lights(lt9, n_lights), n_lights)
        dev = [x.to(cuda) if torch.is_tensor(x) else x for x in args]
        before = shade_kernel.launches
        got, again = shade_kernel(*dev), shade_kernel(*dev)
        torch.cuda.synchronize()
        assert shade_kernel.launches == before + 2
        assert torch.equal(got, again)
        ref = shade_ops.shade_plane_core(*args)
        assert torch.equal(got[9].cpu(), ref[9])
        assert_scaled_close(got.cpu().numpy(), ref.numpy(), 3e-4, 3e-5,
                            axis=0, budget=0.005,
                            what=f"I {n_lights} lights bounce {b}")


def test_shade_dispatchers_refuse_other_devices():
    meta = [torch.zeros((14, 128), device="meta"),
            torch.zeros((15, 128), device="meta"),
            torch.zeros((128,), dtype=torch.int32, device="meta"),
            torch.zeros((9, 14), device="meta"), 9]
    with pytest.raises(ValueError, match="unsupported device"):
        shade_ops.shade_planes(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        shade_ops.shade_planes_bwd(*meta, torch.zeros((9, 128),
                                                      device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [9, 16])
def test_shade_kernels_match_plain_on_card(n_lights, cuda, tmp_path):
    """I and I' on the inputs a CPU wave of the glTF flagship gives them
    (bounces 0 and 1): I's planes within rtol 3e-4 of each lane's largest
    value / atol 3e-5, at most 0.5% of the lanes outside, alive equal; I'
    with a seeded cotangent within B's budget (rtol 1e-4 / atol 1e-6 per
    lane, the light table's cotangent within relative L2 1e-4), twice for
    the same bits."""
    ts = _gltf_lights(tmp_path, n_lights)
    with split_recorder() as rec:
        _render_cpu(ts)
    for b, call in enumerate(rec["shade"][:2]):
        data, rng_p, kind, lt, nl = (x.to(cuda) if torch.is_tensor(x) else x
                                     for x in call)
        before = shade_kernel.launches
        got = shade_kernel(data, rng_p, kind, lt, nl)
        assert shade_kernel.launches == before + 1
        ref = shade_ops.shade_plane_core(*call)
        assert torch.equal(got[9].cpu(), ref[9])
        assert_scaled_close(got.cpu().numpy(), ref.numpy(), 3e-4, 3e-5,
                            axis=0, budget=0.005, what=f"I bounce {b}")
        g = torch.from_numpy(np.random.default_rng(b).normal(
            size=(9, data.shape[1])).astype(np.float32))
        d1, l1 = shade_bwd_kernel(data, rng_p, kind, lt, nl, g.to(cuda))
        d2, l2 = shade_bwd_kernel(data, rng_p, kind, lt, nl, g.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(d1, d2) and torch.equal(l1, l2)
        rd, rl = shade_ops.shade_plane_core_vjp(*call, g)
        assert_scaled_close(d1.cpu().numpy(), rd.numpy(), 1e-4, 1e-6,
                            axis=0, budget=0.005, what=f"I' bounce {b}")
        assert rel_l2(l1.cpu().numpy(), rl.numpy()) <= 1e-4


@pytest.mark.gpu
def test_render_waves_gltf_lights_on_card(cuda, tmp_path):
    """The 9-light glTF flagship through render_waves on the card (K, M,
    J, I every bounce) against the CPU's plain route, and its gradients
    finite (J', I' in the backward)."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    ts = _gltf_lights(tmp_path, 9)
    before = shade_kernel.launches
    got = render_waves(ts.to(cuda), 32, 18, rng.key(0, cuda), 0, 1,
                       chunk_size=576)
    torch.cuda.synchronize()
    assert shade_kernel.launches == before + DEPTH
    ref = _render_cpu(ts)
    assert_flip_budget(got.cpu().numpy(), ref.numpy())
    params, static = partition(ts.to(cuda))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = shade_bwd_kernel.launches
    render_waves(combine(leaves, static), 32, 18, rng.key(0, cuda), 0, 1,
                 chunk_size=576).mean().backward()
    torch.cuda.synchronize()
    assert shade_bwd_kernel.launches == before + DEPTH
    for k, v in leaves.items():
        assert v.grad is None or bool(torch.isfinite(v.grad).all()), k
    assert float(leaves["light_c"].grad.abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "noise", "flagship"])
def test_fused_bounce_kernels_match_plain_on_card(name, cuda):
    """Kernels D and D' (their variant for the scene) against
    fused_bounce_plain / fused_bounce_bwd_plain on bounces 0 and 1 of a
    1024-ray chunk: the winners equal at bounce 0, the state under the flip
    budget, D' within B's budget (dst per lane rtol 1e-4 of its largest
    plane, at most 0.5% of the lanes outside; duni, dlt relative L2 1e-4)
    and the same bits twice; and four D launches give A's state. D's
    winners equal the plain search's on D's own input state of every
    bounce, bit for bit."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx_c, ctx = uber.make_ctx(ts), uber.make_ctx(ts.to(cuda))
    d, d_bwd = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
    st, st_c = st0.to(cuda), st0
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32))
    for b in range(DEPTH):
        before = d.launches
        st2, kind, idx = d(st, rnd[b].to(cuda), ctx)
        torch.cuda.synchronize()
        assert d.launches == before + 1
        want_kind, want_idx = uber.search_row_plain(st.cpu(), ctx_c)
        assert torch.equal(kind.cpu(), want_kind), b
        assert torch.equal(idx.cpu().long(), want_idx), b
        if b < 2:
            ref2, ref_kind, ref_idx = uber.fused_bounce_plain(st_c, rnd[b],
                                                              ctx_c)
            if b == 0:
                assert torch.equal(kind.cpu(), ref_kind)
                assert torch.equal(idx.cpu(), ref_idx)
            assert_flip_budget(st2[8:11].cpu().numpy().T,
                               ref2[8:11].numpy().T)
            got = K.fused_bounce_backward(st, rnd[b].to(cuda), kind, idx,
                                          ctx, g.to(cuda))
            again = K.fused_bounce_backward(st, rnd[b].to(cuda), kind, idx,
                                            ctx, g.to(cuda))
            want = uber.fused_bounce_bwd_plain(
                st.cpu(), rnd[b], kind.cpu(), idx.cpu(), ctx_c, g)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            assert_scaled_close(got[0].cpu().numpy(), want[0].numpy(), 1e-4,
                                1e-6, axis=0, budget=0.005, what="dst")
            assert rel_l2(got[1].cpu(), want[1]) < 1e-4
            assert rel_l2(got[2].cpu(), want[2]) < 1e-4
            st_c = ref2
        st = st2
    assert d_bwd.launches > 0
    whole = K.trace_kernel(ctx)(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
    assert torch.equal(st, whole)


# ---- the unfused uber bounce: kernels E (csrc/trace_wave.cu), G and G'
# (csrc/split.cu) ---------------------------------------------------------

UNFUSED = (K.select_kernel, K.bounce_planes_live_kernel,
           K.bounce_planes_live_bwd_kernel)


def _unfused_pair(ts):
    """(st [14, 2048], rnd [DEPTH, 15, 2048]): a 1024-ray chunk's
    primaries, then the same rays all dead (a tile with no live ray)."""
    st0, rnd = _inputs(ts)
    dead = st0.clone()
    dead[7] = 0.0
    return torch.cat([st0, dead], 1), torch.cat([rnd, rnd], 2)


def _live_inputs(st, rnd_b, ctx):
    """Kernel G's inputs of the state ``st``: E's plain version's rows and
    winners through ``_tile_planes``, and the tiles' flags."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    selv, kind, _ = uber.select_plain(st, ctx)
    P, mkind, flags = uber._tile_planes(st, rnd_b, selv, ctx)
    return (P, kind, mkind, flags, ctx.lt, ctx.n_lights,
            bounce.live_tiles(st[7]))


def test_unfused_wrappers_refuse_cpu_tensors():
    """Kernels E, G and G' take CUDA tensors only (E no noise scene), and
    their dispatchers refuse other devices; nothing is launched."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    ts = _scene("solid")
    st, rnd = _unfused_pair(ts)
    ctx = uber.make_ctx(ts)
    args = _live_inputs(st, rnd[0], ctx)
    g = torch.zeros((13, st.shape[1]))
    before = [k.launches for k in UNFUSED]
    for call in (lambda: K.select_kernel(st[0:8], ctx),
                 lambda: K.bounce_planes_live_kernel(*args),
                 lambda: K.bounce_planes_live_bwd_kernel(*args, g),
                 lambda: K.bounce_planes_live_bwd_kernel.partials(*args, g)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="no marble"):
        K.select_kernel(st[0:8], uber.make_ctx(_scene("noise")))
    assert [k.launches for k in UNFUSED] == before
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in args]
    with pytest.raises(ValueError, match="unsupported device"):
        uber.select(st[0:8].to("meta"), ctx)
    with pytest.raises(ValueError, match="unsupported device"):
        bounce.bounce_planes_live(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bounce.bounce_planes_live_bwd(*meta, g.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "quad", "flagship"])
def test_unfused_kernels_match_plain_on_card(name, cuda):
    """E, G and G' against their plain versions on the card, on bounces 0
    and 1 of a 1024-ray chunk and a tile of the same rays all dead: E's
    winners equal kernel D's on the same state bit for bit, and its plain
    version's on every lane (both round each product and sum alone), its
    rows equal; G's planes within rtol 1e-5
    of each lane's largest / atol 1e-6, at most 0.5% of the lanes outside
    (F's bounds on the card); G''s dP within rtol 1e-4 / atol 1e-6, at
    most 0.5% outside, dlt within relative L2 1e-4 (B's budget); the dead
    tile passes through (G) and takes the copy's cotangent (G') bit for
    bit; on the live tile G and G' equal F and F' (a null flag array) bit
    for bit; G' the same bits twice; one launch of each a call."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    ts = _scene(name)
    st0, rnd = _unfused_pair(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    st = st0.to(cuda)
    n = st.shape[1]
    live = torch.arange(n, device=cuda) < W * H
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(13, n)).astype(np.float32)).to(cuda)
    for b in range(2):
        rnd_b = rnd[b].to(cuda)
        before = [k.launches for k in UNFUSED]
        selv, kind, idx = K.select_kernel(st[0:8], ctx)
        _, d_kind, d_idx = K.fused_bounce_kernel(ctx)(st, rnd_b, ctx)
        assert torch.equal(kind, d_kind) and torch.equal(idx, d_idx)
        ref_selv, ref_kind, ref_idx = uber.select_plain(st, ctx)
        assert torch.equal(kind, ref_kind) and torch.equal(idx, ref_idx)
        assert torch.equal(selv, ref_selv)
        assert not bool(kind[~live].any()) and not bool(idx[~live].any())
        assert torch.equal(selv[:, ~live],
                           ctx.dflt[:, None].expand(-1, int((~live).sum())))

        P, _, mkind, flags, lt, n_lights, tlive = _live_inputs(st, rnd_b,
                                                               ctx)
        args = (P, kind, mkind, flags, lt, n_lights)
        out = bounce.bounce_planes_live(*args, tlive)
        dP, dlt = bounce.bounce_planes_live_bwd(*args, tlive, g)
        again = K.bounce_planes_live_bwd_kernel(*args, tlive, g)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(UNFUSED, before)] == [1, 1, 2]
        assert torch.equal(dP, again[0]) and torch.equal(dlt, again[1])
        assert_scaled_close(
            out.cpu().numpy(), bounce.bounce_planes_live_plain(
                *args, tlive).cpu().numpy(), 1e-5, 1e-6, axis=0,
            budget=0.005, what="G")
        ref_p, ref_lt = bounce.bounce_planes_live_bwd_plain(*args, tlive, g)
        assert_scaled_close(dP.cpu().numpy(), ref_p.cpu().numpy(), 1e-4,
                            1e-6, axis=0, budget=0.005, what="G' dP")
        assert rel_l2(dlt.cpu().numpy(), ref_lt.cpu().numpy()) <= 1e-4
        through = torch.cat([P[0:6], P[24:30], P[45:46]])
        assert torch.equal(out[:, ~live], through[:, ~live])
        want = torch.zeros_like(dP[:, ~live])
        want[0:6] = g[0:6, ~live]
        want[24:30] = g[6:12, ~live]
        assert torch.equal(dP[:, ~live], want)
        f_out = bounce_planes_kernel(*args)
        f_dP, _ = bounce_planes_bwd_kernel(*args, g)
        assert torch.equal(out[:, live], f_out[:, live])
        assert torch.equal(dP[:, live], f_dP[:, live])
        st = torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])


@pytest.mark.gpu
def test_render_waves_unfused_on_card(cuda, monkeypatch):
    """render_waves and torch.autograd on the card under
    ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0`` go through E and G once a
    bounce and G' in the backward, never D, D', A or B; the image is the
    fused per-chunk route's (D) bit for bit (E's winners are D's, and G
    shades as D does: no library contracts an FMA); the gradients are
    finite and the same bits twice."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    ts = _scene("checker").to(cuda)
    monkeypatch.setenv("RRT_UBER_WAVE", "0")
    off = (K.bounce_uber_kernel, K.bounce_uber_bwd_kernel,
           trace_wave_kernel, trace_wave_bwd_kernel)

    def step():
        params, static = partition(ts)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        img = render_waves(combine(leaves, static), W, 24,
                           rng.key(1, cuda), 0, 2, chunk_size=256)
        img.mean().backward()
        return img.detach(), {k: v.grad for k, v in leaves.items()
                              if v.grad is not None}

    with torch.no_grad():
        ref = render_waves(ts, W, 24, rng.key(1, cuda), 0, 2,
                           chunk_size=256)
    monkeypatch.setenv("RRT_NO_UBER_FUSED", "1")
    before = [k.launches for k in UNFUSED + off]
    img, grads = step()
    torch.cuda.synchronize()
    got = [k.launches - x for k, x in zip(UNFUSED + off, before)]
    assert got == [2 * DEPTH] * 3 + [0] * len(off)
    assert torch.equal(img, ref)
    _, grads2 = step()
    for k, v in grads.items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, grads2[k]), k
    assert grads["tex_color"].abs().max() > 0
