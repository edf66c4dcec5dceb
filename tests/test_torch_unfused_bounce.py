"""The unfused uber bounce (``RRT_NO_UBER_FUSED=1``): phase 1 alone (TPU
kernel E) and the live-tile-gated fused bounce (TPU kernel G) with its
backward (G'), the port's plain versions against the JAX package's
kernels in interpret mode, and the per-chunk route they carry.

The inputs are one 2,048-lane pair of tiles on the solid and checker
scenes of ``tests/test_uber.py``: the bounce-1 state of a 32x32 chunk
(live and dead rays) and the same state with every ray dead, its other
planes kept, so the dead tile's pass-through shows bit for bit. Both
packages get the same arrays as numpy:

  * ``uber.select_plain`` against JAX's E (``_select_call``, cfg as
    ``bounce_uber`` builds it, ``pallas_uber.py:1508-1512``): kind, idx
    and the winners' rows equal. JAX's E sweeps every triangle chunk; the
    port's culls a row's chunks as A and D do, which drops no winner here;
  * :class:`uber.SelectRows`' backward against ``jax.vjp`` of
    ``_select_call``: the sums of the row cotangents within 1e-6 of each
    row's largest (the same terms, added in another order);
  * ``bounce.bounce_planes_live_plain`` and ``_bwd_plain`` against
    ``pallas_bounce.bounce_planes_live`` and ``jax.vjp`` of it, at F's
    bounds (``tests/test_torch_bounce_fused.py``), the dead tile exact;
  * ``SelectRows`` and ``BouncePlanesLive`` (the hand backward) against
    torch autograd straight through the plain forward;
  * the route: the port's per-chunk render under the flag, through
    ``render_waves_sharded`` and through ``render_waves`` with
    ``RRT_UBER_WAVE=0``, against JAX's ``render_waves`` under both flags
    (image and scene gradients), and bitwise against the fused per-chunk
    route on the CPU;
  * the gate: under the flag a noise scene leaves the trace kernel.

Each flag is set with ``monkeypatch`` around the side that reads it; the
route that ran is asserted by spies on the plain versions.
tests/test_torch_gpu.py and chip_smoke.py hold the CUDA kernels against
these plain versions on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import pallas_bounce as pb
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu.ops.integrator import render_waves as jrender
from rust_ray_tracer_tpu_torch.models.scene import combine, partition
from rust_ray_tracer_tpu_torch.ops import bounce
from rust_ray_tracer_tpu_torch.ops import integrator
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.parallel import (make_mesh,
                                                render_waves_sharded)
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_flip_budget, assert_scaled_close,
                                both, rel_l2, torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W = H = 32          # one 1024-ray chunk, then a dead copy of it
RTOL, ATOL = 1e-5, 1e-6     # F's bounds (tests/test_torch_bounce_fused.py)
SCENES = ["solid", "checker"]


def _planes(x):
    """[C, N] -> [C, N / 128, 128], the TPU kernels' plane layout."""
    x = np.asarray(x)
    return jnp.asarray(x.reshape(x.shape[:-1] + (-1, 128)))


def _pair(ts):
    """(st [14, 2048], rnd_b [15, 2048]): bounce 1's input state of the
    port's plain trace from seeded primaries, then the same state with
    every ray dead; bounce 1's randoms for both tiles."""
    st0, rnd = uber.wave_inputs(ts, rng.wave_key(rng.key(7, "cpu"), 0), W,
                                H, 2, W * H)
    st1, _, _ = uber.fused_bounce_plain(st0, rnd[0], uber.make_ctx(ts))
    dead = st1.clone()
    dead[7] = 0.0
    return torch.cat([st1, dead], 1), torch.cat([rnd[1], rnd[1]], 1)


@functools.lru_cache(maxsize=None)
def _jax_select(name):
    """JAX's E (interpret mode) on the pair's state, and ``jax.vjp`` of
    ``_select_call`` in ``uni`` for a seeded cotangent of the rows."""
    mp = pytest.MonkeyPatch()
    try:
        js, ts = both(name, mp)
        st, rnd_b = _pair(ts)
        uni, dflt, (t_off, s_off, q_off), search, lt, cab, ptab = \
            pu.make_ctx(js)
        det_t, u_t, v_t, t_t, dbl_t, sph, quad = search
        st8 = _planes(st[0:8].numpy())
        cr = st8.shape[1]
        tlive = jnp.any(st8[7].reshape(cr // 8, 8, 128) > 0.5,
                        axis=(1, 2)).astype(jnp.int32)
        cfg = (js.tri_v0.shape[0] > 0, js.sph_c0.shape[0] > 0,
               js.quad_q.shape[0] > 0, t_off, s_off, q_off,
               tuple(st8.shape), tuple(uni.shape), tuple(dflt.shape),
               tuple(det_t.shape), tuple(dbl_t.shape), tuple(sph.shape),
               tuple(quad.shape), tuple(tlive.shape))
        tabs = (det_t, u_t, v_t, t_t, dbl_t, sph, quad)
        pim.INTERPRET = True

        def select(u):      # _select_call's forward is _select_impl
            selv, kind, idx = pu._select_call(cfg, tlive, st8, u, dflt,
                                              *tabs)
            return selv, (kind, idx)

        selv, vjp, (kind, idx) = jax.vjp(select, uni, has_aux=True)
        g = np.random.default_rng(8).normal(
            size=(uni.shape[1], st.shape[1])).astype(np.float32)
        (duni,) = vjp(_planes(g))
    finally:
        pim.INTERPRET = False
        mp.undo()
    return {"ts": ts, "st": st, "rnd": rnd_b, "g": g,
            "tlive": np.asarray(tlive),
            "selv": np.array(selv).reshape(uni.shape[1], -1),
            "kind": np.array(kind).reshape(-1),
            "idx": np.array(idx).reshape(-1), "duni": np.array(duni)}


@functools.lru_cache(maxsize=None)
def _jax_live(name):
    """JAX's G and G' (interpret mode) on the port's planes of the pair
    (its E's winners), G' through ``jax.vjp`` for a seeded cotangent."""
    r = dict(_jax_select(name))
    ctx = uber.make_ctx(r["ts"])
    selv, kind, _ = uber.select_plain(r["st"], ctx)
    P, mkind, flags = uber._tile_planes(r["st"], r["rnd"], selv, ctx)
    tlive = bounce.live_tiles(r["st"][7])
    np.testing.assert_array_equal(tlive.numpy(), r["tlive"])
    g = np.random.default_rng(9).normal(
        size=(13, P.shape[1])).astype(np.float32)
    args = [_planes(x.numpy()) for x in (kind, mkind, flags)]
    pim.INTERPRET = True
    try:
        out, vjp = jax.vjp(lambda p, lt: pb.bounce_planes_live(
            p, *args, lt, jnp.asarray(r["tlive"])), _planes(P.numpy()),
            jnp.asarray(ctx.lt.numpy()))
        dP, dlt = vjp(_planes(g))
    finally:
        pim.INTERPRET = False
    r.update(ctx=ctx, P=P, kind=kind, mkind=mkind, flags=flags,
             tlive_t=tlive, g_live=g, out=np.array(out).reshape(13, -1),
             dP=np.array(dP).reshape(P.shape[0], -1), dlt=np.array(dlt))
    return r


def _dead_lanes(r):
    dead = torch.zeros(r["st"].shape[1], dtype=torch.bool)
    dead[W * H:] = True
    return dead


@pytest.mark.parametrize("name", SCENES)
def test_select_plain_matches_jax_select_kernel(name):
    """E's plain version: the winners (kind, idx) and their rows equal
    JAX's E, the dead tile kind 0, idx 0 and the miss default."""
    r = _jax_select(name)
    ctx = uber.make_ctx(r["ts"])
    selv, kind, idx = uber.select_plain(r["st"], ctx)
    assert kind.dtype == idx.dtype == torch.int32
    np.testing.assert_array_equal(kind.numpy(), r["kind"])
    np.testing.assert_array_equal(idx.numpy(), r["idx"])
    np.testing.assert_array_equal(selv.detach().numpy(), r["selv"])
    dead = _dead_lanes(r)
    assert not bool(kind[dead].any()) and not bool(idx[dead].any())
    np.testing.assert_array_equal(
        selv[:, dead].detach().numpy(),
        np.broadcast_to(ctx.dflt.detach().numpy()[:, None],
                        (selv.shape[0], int(dead.sum()))))
    assert bool((kind[~dead] > 0).any()) and bool((kind[~dead] == 0).any())


@pytest.mark.parametrize("name", SCENES)
def test_select_rows_bwd_matches_jax_vjp(name):
    """SelectRows' backward (row sums of the found lanes' cotangents; here
    ``index_add_``) against ``jax.vjp`` of ``_select_call`` in ``uni``:
    each row within 1e-6 of the row's largest value (the same terms added
    in another order), the missed lanes adding nothing."""
    r = _jax_select(name)
    ctx = uber.make_ctx(r["ts"])
    uni = ctx.uni.detach().clone().requires_grad_()
    selv, _, _ = uber.SelectRows.apply(r["st"][0:8], uni,
                                       dataclasses.replace(ctx, uni=uni))
    selv.backward(torch.from_numpy(r["g"]))
    assert_scaled_close(uni.grad.numpy(), r["duni"], 1e-6, 1e-7, axis=1,
                        what="duni")
    assert np.abs(r["duni"]).max() > 0


@pytest.mark.parametrize("name", SCENES)
def test_bounce_planes_live_plain_matches_jax(name):
    """G's plain version against ``bounce_planes_live``: every lane within
    F's rtol 1e-5 of its largest plane / atol 1e-6, the dead tile's o, d,
    L, beta and alive equal to its input planes bit for bit."""
    r = _jax_live(name)
    ctx = r["ctx"]
    out = bounce.bounce_planes_live_plain(
        r["P"], r["kind"], r["mkind"], r["flags"], ctx.lt, ctx.n_lights,
        r["tlive_t"]).detach()
    assert_scaled_close(out.numpy(), r["out"], RTOL, ATOL, axis=0,
                        what="next state")
    dead = _dead_lanes(r)
    P = r["P"].detach()
    through = torch.cat([P[0:6], P[24:30], P[45:46]])[:, dead]
    np.testing.assert_array_equal(out[:, dead].numpy(), through.numpy())
    np.testing.assert_array_equal(r["out"][:, dead.numpy()],
                                  through.numpy())
    assert 0 < r["out"][12, :W * H].mean() < 1     # some paths go on


@pytest.mark.parametrize("name", SCENES)
def test_bounce_planes_live_bwd_plain_matches_jax_vjp(name):
    """G''s plain version against ``jax.vjp`` of ``bounce_planes_live``
    (JAX's G' in interpret mode) for the same seeded cotangent: dP at F''s
    bounds (rtol 1e-5 of the lane's largest / atol 1e-6 on all but 0.5%
    of the lanes, 1e-4 on every lane, or, where a lane is past 1e-4, no
    farther from a float64 replay of the same inputs than JAX's lane is),
    dlt within relative L2 1e-5; on the dead tile dP is the
    pass-through's cotangent exactly. Measured on the checker scene: one
    ray inside the moving glass sphere sits 6.2e-4 of its largest entry
    from float64 in JAX, 4e-7 in the port; the other lanes within 1e-4."""
    r = _jax_live(name)
    ctx = r["ctx"]
    g = torch.from_numpy(r["g_live"])
    args = (r["kind"], r["mkind"], r["flags"])
    dP, dlt = bounce.bounce_planes_live_bwd_plain(
        r["P"].detach(), *args, ctx.lt.detach(), ctx.n_lights, r["tlive_t"],
        g)
    assert_scaled_close(dP.numpy(), r["dP"], RTOL, ATOL, axis=0,
                        budget=0.005, what="dP")
    got, ref = dP.double().numpy(), r["dP"].astype(np.float64)
    scale = np.abs(ref).max(axis=0)
    off = (np.abs(got - ref) > ATOL + 1e-4 * scale).any(axis=0)
    if off.any():
        exact, _ = bounce.bounce_planes_live_bwd_plain(
            r["P"].detach().double(), *args, ctx.lt.detach().double(),
            ctx.n_lights, r["tlive_t"], g.double())
        exact = exact.numpy()
        port = np.abs(got - exact).max(axis=0)
        jax_ = np.abs(ref - exact).max(axis=0)
        assert (port[off] <= jax_[off] + 1e-6 * scale[off]).all(), (
            port[off], jax_[off])
    assert rel_l2(dlt.numpy(), r["dlt"]) <= 1e-5
    dead = _dead_lanes(r)
    want = torch.zeros_like(dP[:, dead])
    want[0:6] = g[0:6, dead]
    want[24:30] = g[6:12, dead]
    np.testing.assert_array_equal(dP[:, dead].numpy(), want.numpy())
    np.testing.assert_array_equal(r["dP"][:, dead.numpy()], want.numpy())
    assert np.abs(r["dP"][9:18]).max() > 0 and np.abs(r["dlt"]).max() > 0


@pytest.mark.parametrize("name", SCENES)
def test_unfused_functions_match_autograd_of_plain(name):
    """The unfused bounce through SelectRows and BouncePlanesLive (their
    hand backward: the row sums, G''s plain version) against torch
    autograd straight through E's and G's plain forward: the gradients of
    the state, ``uni`` and ``lt`` within rtol 1e-5 of each lane's or
    row's largest / atol 1e-6 (one formula, summed in another order), at
    most 0.5% of the state's lanes outside (a branch of the recomputed
    forward forked by an ulp, as in ``FusedBounce``'s test)."""
    ts = torch_scene(name)
    st, rnd_b = _pair(ts)
    ctx = uber.make_ctx(ts)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=tuple(st.shape)).astype(np.float32))
    # the alive plane: through G's copy of a dead tile autograd hands it
    # its cotangent, while G' (as JAX's) gives it none anywhere
    g[7] = 0.0

    def plain(s, c):
        selv, kind, _ = uber.select_plain(s[0:8].detach(), c)
        P, mkind, flags = uber._tile_planes(s, rnd_b, selv, c)
        out = bounce.bounce_planes_live_plain(P, kind, mkind, flags, c.lt,
                                              c.n_lights,
                                              bounce.live_tiles(s[7]))
        return torch.cat([out[0:6], s[6:7], out[12:13], out[6:12]])

    def grads(fn):
        leaves = [st.clone().requires_grad_(),
                  ctx.uni.detach().clone().requires_grad_(),
                  ctx.lt.detach().clone().requires_grad_()]
        c = dataclasses.replace(ctx, uni=leaves[1], lt=leaves[2])
        (fn(leaves[0], c) * g).sum().backward()
        return [x.grad for x in leaves]

    got = grads(lambda s, c: uber.unfused_bounce(s, rnd_b, c))
    ref = grads(plain)
    for a, b, axis, what, budget in zip(got, ref, (0, 1, 1),
                                        ("st", "uni", "lt"),
                                        (0.005, 0.0, 0.0)):
        assert_scaled_close(a.numpy(), b.numpy(), RTOL, ATOL, axis=axis,
                            budget=budget, what=what)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


@pytest.fixture
def route_spy(monkeypatch):
    """Counts the calls of E's and G's plain versions and of D's."""
    calls = {"select": 0, "live": 0, "fused": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    spy(uber, "select_plain", "select")
    spy(bounce, "bounce_planes_live_plain", "live")
    spy(uber, "fused_bounce_plain", "fused")
    return calls


@functools.lru_cache(maxsize=None)
def _jax_unfused_render():
    """JAX's render_waves under ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``
    (E and G a bounce, in interpret mode, ``on_tpu`` True) at
    ``test_per_chunk_render_and_grads_match_jax``'s set-up (16x12, 1 spp,
    chunk 192, depth 4), and ``jax.vjp`` of the image's mean."""
    mp = pytest.MonkeyPatch()
    real_on_tpu = pim.on_tpu
    traced = []
    real_live = pb.bounce_planes_live
    try:
        js, _ = both("solid", mp)
        pim.INTERPRET = True
        pim.on_tpu = lambda: True
        mp.setattr(pb, "bounce_planes_live",
                   lambda *a: traced.append(1) or real_live(*a))
        mp.setenv("RRT_NO_UBER_FUSED", "1")
        mp.setenv("RRT_UBER_WAVE", "0")
        diff, static = jpartition(js)
        img, vjp = jax.vjp(lambda d: jrender(
            jcombine(d, static), 16, 12, jax.random.PRNGKey(2), 0, 1,
            chunk_size=192), diff)
        (g,) = vjp(jnp.full((12, 16, 3), 1.0 / (12 * 16 * 3), jnp.float32))
    finally:
        pim.on_tpu = real_on_tpu
        pim.INTERPRET = False
        mp.undo()
    assert traced, "JAX did not take the unfused bounce"
    return np.asarray(img), g


@pytest.mark.parametrize("entry", ["render_waves_sharded", "render_waves"])
def test_unfused_route_matches_jax(entry, monkeypatch, route_spy):
    """The port's per-chunk render under ``RRT_NO_UBER_FUSED=1``
    (render_chunk -> trace_rays -> E, G a bounce), entered through
    ``render_waves_sharded`` on a one-process mesh or through
    ``render_waves`` with ``RRT_UBER_WAVE=0``, against JAX's
    ``render_waves`` under both flags: the image under the flip budget,
    every scene gradient within rtol 5e-4 / atol 1e-6
    (``tests/test_torch_grad.py``'s bounds). E and G ran each bounce, D
    never."""
    img_ref, g_ref = _jax_unfused_render()
    ts = torch_scene("solid")
    monkeypatch.setenv("RRT_NO_UBER_FUSED", "1")
    params, tstatic = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    sc = combine(leaves, tstatic)
    if entry == "render_waves":
        monkeypatch.setenv("RRT_UBER_WAVE", "0")
        img = integrator.render_waves(sc, 16, 12, rng.key(2, "cpu"), 0, 1,
                                      chunk_size=192)
    else:
        img = render_waves_sharded(sc, 16, 12, rng.key(2, "cpu"), 0, 1,
                                   make_mesh(device="cpu"), chunk_size=192)
    assert route_spy == {"select": 4, "live": 4, "fused": 0}
    assert_flip_budget(img.detach().numpy(), img_ref)
    img.mean().backward()
    nonzero = 0
    for k, v in leaves.items():
        ref = (np.asarray(getattr(g_ref.camera, k.split(".")[1]))
               if k.startswith("camera.") else np.asarray(getattr(g_ref, k)))
        got = np.zeros_like(ref) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-6,
                                   err_msg=k)
        nonzero += bool(np.abs(ref).max(initial=0.0) > 0)
    assert nonzero >= 5


@pytest.mark.parametrize("name", ["solid", "checker", "quad"])
def test_unfused_route_equals_fused_on_cpu(name, monkeypatch, route_spy):
    """On the CPU the unfused per-chunk route (E's and G's plain versions)
    and the fused one (D's) render the same image bit for bit: the same
    search (``_search_block``) and bounce core (``bounce_plane_core``). The
    scene gradients agree within 1e-6 of each leaf's largest (G''s
    backward sums the light table over the lanes, D''s by tile)."""
    ts = torch_scene(name)
    monkeypatch.setenv("RRT_UBER_WAVE", "0")

    def run():
        params, tstatic = partition(ts)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        img = integrator.render_waves(combine(leaves, tstatic), W, 24,
                                      rng.key(1, "cpu"), 0, 2,
                                      chunk_size=256)
        img.mean().backward()
        return img.detach(), {k: v.grad for k, v in leaves.items()
                              if v.grad is not None}

    ref, g_ref = run()
    assert route_spy["fused"] == 8 and route_spy["select"] == 0
    monkeypatch.setenv("RRT_NO_UBER_FUSED", "1")
    got, g_got = run()
    assert route_spy["select"] == route_spy["live"] == 8
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert g_got.keys() == g_ref.keys()
    for k, v in g_ref.items():
        scale = float(v.abs().max())
        assert float((g_got[k] - v).abs().max()) <= 1e-6 * scale, k


def test_unfused_gate_sends_noise_scenes_to_the_split_route(monkeypatch):
    """``tests/test_uber.py:290-317``'s gate in the port: under
    ``RRT_NO_UBER_FUSED=1`` a noise scene is not the trace kernel's (its
    tables are the split route's), the solid and checker scenes stay;
    JAX's ``uber_eligible`` agrees on every scene, with the flag and
    without it."""
    scenes = {n: both(n, monkeypatch) for n in ("solid", "checker",
                                                "noise")}
    for flag in ("", "1"):
        monkeypatch.setenv("RRT_NO_UBER_FUSED", flag)
        for n, (js, ts) in scenes.items():
            want = not (flag and n == "noise")
            assert uber.uber_eligible(ts) is want, (n, flag)
            assert pu.uber_eligible(js) is want, (n, flag)
            prep = integrator.trace_prep(ts)
            assert isinstance(prep, uber.TraceCtx) is want, (n, flag)
    assert "RRT_NO_UBER_FUSED" in uber.ineligible_reason(
        scenes["noise"][1])
    monkeypatch.setenv("RRT_NO_UBER_FUSED", "")
    ctx = uber.make_ctx(scenes["noise"][1])
    with pytest.raises(ValueError, match="marble"):
        uber.unfused_bounce(torch.zeros((14, 1024)), torch.zeros((15, 1024)),
                            ctx)
