"""The byte bounds of the backward kernels against counts made by hand:
B's and D''s (``tools/search_times.bwd_bytes``, which ``chip_smoke.py``
counts with) on a two-bounce input written out ray by ray and on the plain
forward's residuals of a 32x32 wave of the flagship counted one ray-bounce
at a time; F''s (and G''s), H''s and I''s (``bp_bwd_bytes``,
``su_bwd_bytes``, ``shade_bwd_bytes``) and the forward kernels F's, G's,
H's and I's (``bp_fwd_bytes``, ``bp_live_bytes``, ``su_fwd_bytes``,
``shade_fwd_bytes``) on a few hundred lanes of every lane class and
material kind; I's operations by stage (``shade_work``) against its
candidate lights counted light by light; J's and J''s (``hit_bytes``)
plane by plane."""

import pytest
import torch

from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.models.scene import (LIGHT_QUAD,
                                                    LIGHT_SPHERE,
                                                    MAT_LAMBERTIAN)
from rust_ray_tracer_tpu_torch.ops import shade as shade_ops
from rust_ray_tracer_tpu_torch.tools.search_times import (
    OPS_HIT, OPS_HIT_BWD, OPS_LIGHT_DISC, OPS_QUAD_PDF, OPS_SHADE,
    OPS_SPHERE_FULL, OPS_SU_BWD, bp_bwd_bytes, bp_fwd_bytes,
    bp_live_bwd_bytes, bp_live_bytes, bwd_bytes, hit_bytes,
    shade_bwd_bytes, shade_fwd_bytes, shade_work, su_bwd_bytes,
    su_fwd_bytes)
from rust_ray_tracer_tpu_torch.utils import rng
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W_COLS = 17


def _uni(materials):
    """Winner rows [len(materials), W_COLS], the material id in A_COL."""
    uni = torch.zeros((len(materials), W_COLS))
    uni[:, uber.A_COL] = torch.tensor(materials, dtype=torch.float32)
    return uni


def test_bwd_bytes_two_bounces_by_hand():
    """256 rays, 2 bounces, one light. Bounce 0: rays 0-9 live, rays 0-5
    found rows 0, 0, 1, 2, 3, 0 (Lambertian, Lambertian, metal,
    dielectric, light, Lambertian), ray 20 dead with a winner. Bounce 1:
    rays 0-3 live, rays 0-2 found rows 1, 0, 2, ray 3 a miss."""
    depth, n = 2, 256
    hist = torch.zeros((depth, 14, n))
    hist[0, 7, :10] = 1.0
    hist[1, 7, :4] = 1.0
    kind = torch.zeros((depth, n), dtype=torch.int32)
    idx = torch.zeros((depth, n), dtype=torch.int32)
    kind[0, :6] = 1
    kind[0, 20] = 1
    idx[0, :6] = torch.tensor([0, 0, 1, 2, 3, 0], dtype=torch.int32)
    kind[1, :2] = 2
    kind[1, 2] = 3
    idx[1, :3] = torch.tensor([1, 0, 2], dtype=torch.int32)
    uni = _uni([0, 1, 2, 3])
    lt = torch.zeros((2, 14))
    floats = (2 * 256              # every ray-bounce's alive plane
              + 14 * 4             # 14 live: kind and beta
              + 9 * (7 + 1 + 1 + W_COLS)   # 9 found: o, d, time, idx,
                                           # key and row cotangent
              + (6 + 6 + 4 + 1 + 0 + 6)    # bounce 0's randoms
              + (4 + 6 + 1)                # bounce 1's
              + 2 * 14 * 256       # g in, dst out
              + 4 * W_COLS + 2 * 14        # uni, lt
              + 2 * 2 * 14)        # two blocks' light-table partials
    assert floats == 8156
    assert bwd_bytes(hist, kind, idx, uni, lt, 1) == 4 * 8156
    tables = (torch.zeros((256, 3)), torch.zeros((3, 256), dtype=torch.int32))
    assert bwd_bytes(hist, kind, idx, uni, lt, 1, tables) == 4 * (
        8156 + 768 + 768)
    # without lights a Lambertian hit reads 2 randoms, not 6
    lt0 = torch.zeros((1, 14))
    assert bwd_bytes(hist, kind, idx, uni, lt0, 0) == 4 * (
        8156 - 4 * 4 - 14 - 2 * 14)


def test_bwd_bytes_recorded_wave_by_ray():
    """The plain forward's residuals of the flagship's 32x32 wave (depth
    4), counted one ray-bounce at a time."""
    ts = compile_scene(builders.procedural_flagship(), device="cpu")
    st0, rnd = uber.wave_inputs(ts, rng.wave_key(rng.key(7, "cpu"), 0), 32,
                                32, 4, 1024)
    ctx = uber.make_ctx(ts)
    _, hist, kind, idx = uber.trace_wave_plain(st0, rnd, ctx, 4,
                                               residuals=True)
    depth, _, n = hist.shape
    w = ctx.uni.shape[1]
    reads = {0: 6 if ctx.n_lights else 2, 1: 4, 2: 1}
    floats, found = 0, 0
    for b in range(depth):
        for r in range(n):
            floats += 1
            if not hist[b, 7, r] > 0.5:
                continue
            floats += 4
            if kind[b, r] > 0:
                found += 1
                mat = int(ctx.uni[int(idx[b, r]), uber.A_COL])
                floats += 7 + 1 + 1 + w + reads.get(mat, 0)
    floats += (2 * 14 * n + ctx.uni.numel() + ctx.lt.numel()
               + n // 128 * (ctx.n_lights + 1) * 14)
    assert found > 0
    assert bwd_bytes(hist, kind, idx, ctx.uni, ctx.lt,
                     ctx.n_lights) == 4 * floats


# ---- F' (G') and I': the split route's backward kernels ------------------

# randoms a found lane's material adjoint reads, by material id, with a
# light table (csrc/trace_bwd_common.cuh shade_fwd + shade_vjp):
# Lambertian 6, metal 4, dielectric 1, light and isotropic 0
RND_WITH_LIGHTS = (6, 4, 1, 0, 0)
# ... and in the forward shading (csrc/trace_common.cuh shade), without
# and with lights: isotropic reads 4 more (its scatter ball)
RND_FWD = ((2, 4, 1, 0, 4), (6, 4, 1, 0, 4))


def _bp_calls(n, has_checker, seed):
    """Kernel F's arguments on ``n`` lanes with one light: lanes 3k dead,
    3k + 1 live misses, 3k + 2 found (the five material kinds in turn)."""
    gen = torch.Generator().manual_seed(seed)
    P = torch.rand((52 if has_checker else 46, n), generator=gen)
    lane = torch.arange(n)
    P[45] = (lane % 3 != 0).float()
    pkind = torch.where(lane % 3 == 2, 1 + lane % 3, 0).to(torch.int32)
    mkind = (lane // 3 % 5).to(torch.int32)
    flags = (lane % 2).to(torch.int32)
    return P, pkind, mkind, flags, torch.zeros((2, 14)), 1


def _bp_by_hand(P, pkind, mkind, lt):
    """F''s floats counted lane by lane: every lane its alive flag, the 12
    cotangents in and every plane of dP out; a live lane its kind and beta;
    a found lane o, d, time, the window, the pack, tmed, an albedo leaf,
    fuzz, ior, its material kind, flags and randoms; the light table in,
    and each block's partial out and back."""
    n_in, n = P.shape
    floats = 0
    for i in range(n):
        floats += 1 + 12 + n_in
        if P[45, i] > 0.5:
            floats += 4
            if pkind[i] != 0:
                floats += 26 + 2 + RND_WITH_LIGHTS[int(mkind[i])]
    blocks = -(-n // 128)
    return floats + lt.numel() + 2 * lt.numel() * blocks


def _bp_fwd_by_hand(P, pkind, mkind, flags, lt, n_lights):
    """F's floats counted lane by lane: every lane o, d, L, beta, alive in
    and 13 planes out; a live lane its kind; a found lane time, the
    window, the pack, tmed, fuzz, ior and one albedo leaf (the one the
    checker's select picks on a checker lane), its material kind, flags
    and randoms; the table in."""
    floats = 0
    for i in range(P.shape[1]):
        floats += 13 + 13
        if P[45, i] > 0.5:
            floats += 1
            if pkind[i] != 0:
                floats += (15 + 3 + 2
                           + RND_FWD[n_lights > 0][int(mkind[i])])
    return floats + lt.numel()


def _su_calls(n, n_lights, seed):
    """Kernel H's arguments on ``n`` lanes: lanes 3k dead, 3k + 1 live
    misses, 3k + 2 found (the five material kinds in turn)."""
    gen = torch.Generator().manual_seed(seed)
    P = torch.rand((40, n), generator=gen)
    lane = torch.arange(n)
    P[38] = (lane % 3 != 0).float()
    P[39] = (lane % 3 == 2).float()
    mkind = (lane // 3 % 5).to(torch.int32)
    return P, mkind, torch.zeros((n_lights + 1, 14)), n_lights


def _su_by_hand(P, mkind, lt, n_lights):
    """H''s floats counted lane by lane: every lane its alive flag and 13
    cotangents in, 40 planes of dP out; a live lane its hit flag and beta;
    a found lane d, p, n, albedo, fuzz, ior, its material kind and the
    randoms its material's adjoint reads; the table in, its cotangent out,
    each block's partial out and back."""
    n = P.shape[1]
    floats = 0
    for i in range(n):
        floats += 13 + 40
        if P[38, i] > 0.5:
            floats += 4
            if P[39, i] > 0.5:
                rnd = (RND_WITH_LIGHTS if n_lights
                       else (2, 4, 1, 0, 0))[int(mkind[i])]
                floats += 14 + 1 + rnd
    blocks = -(-n // 128)
    return floats + 2 * lt.numel() + 2 * lt.numel() * blocks


def _shade_calls(n, n_lights, seed):
    """Kernel I's arguments on ``n`` lanes: the five material kinds in
    turn, randoms from a seed (random 3 picks the light sample)."""
    gen = torch.Generator().manual_seed(seed)
    data = torch.rand((14, n), generator=gen)
    rng_p = torch.rand((15, n), generator=gen)
    kind = (torch.arange(n) % 5).to(torch.int32)
    return data, rng_p, kind, torch.zeros((n_lights, 14)), n_lights


def _shade_by_hand(data, rng_p, kind, lt, n_lights):
    """I''s floats counted lane by lane: its kind in, 14 cotangents out,
    and what its kind reads (Lambertian n, albedo, randoms 0, 1, weight's
    cotangent; with lights also p, randoms 3, 4, and 5, 6 where it samples
    a light; metal d, n, randoms 7, 9-11, weight's and direction's
    cotangents; dielectric d, n, ior, random 2, direction's; light d, n,
    emitted's; isotropic weight's); the table in, the partials out and
    back, their sum out."""
    per_kind = {0: 3 + 3 + 2 + 3, 1: 3 + 3 + 4 + 3 + 3, 2: 3 + 3 + 1 + 1 + 3,
                3: 3 + 3 + 3, 4: 3}
    n = data.shape[1]
    floats = 0
    for i in range(n):
        k = int(kind[i])
        floats += 1 + 14 + per_kind[k]
        if k == 0 and n_lights:
            floats += 3 + 2 + (2 if rng_p[3, i] >= 0.5 else 0)
    blocks = -(-n // 128)
    return floats + 2 * lt.numel() + 2 * lt.numel() * blocks


@pytest.mark.parametrize("case", [
    ("bp", 300, False), ("bp", 384, True), ("bp_dead", 256, False),
    ("bp_live", 2048, True), ("shade", 300, 9), ("shade", 256, 16),
    ("shade", 130, 0), ("su", 300, 1), ("su", 260, 0), ("su_dead", 256, 8)])
def test_split_bwd_bytes_by_hand(case):
    """F''s byte bound (``bp_bwd_bytes``) with one light, on a few hundred
    live, dead, found and missed lanes (with and without the checker
    leaves, and every lane dead), G''s (``bp_live_bwd_bytes``) on a live
    and a dead 1024-lane tile, I''s (``shade_bwd_bytes``) on the five
    material kinds at 9, 16 and no lights, and H''s (``su_bwd_bytes``) on
    dead, live, missed and found lanes of every material kind at one and
    no light (and every lane dead at 8), against counts made lane by lane;
    a list of calls is the sum of its calls."""
    what, n, arg = case
    if what == "bp_live":
        # tile 0 live (F''s lane classes), tile 1 dead: its lanes read 12
        # cotangents and write every plane, its 8 blocks a zero partial
        P, pkind, mkind, flags, lt, nl = _bp_calls(n, arg, n)
        tlive = torch.tensor([1, 0], dtype=torch.int32)
        nb, ops = bp_live_bwd_bytes((P, pkind, mkind, flags, lt, nl), tlive)
        live = _bp_by_hand(P[:, :1024], pkind[:1024], mkind[:1024], lt)
        dead = 1024 * (12 + P.shape[0]) + 2 + 2 * lt.numel() * 8
        assert nb == 4 * (live + dead)
        found = int(((P[45, :1024] > 0.5) & (pkind[:1024] != 0)).sum())
        assert ops == found * (OPS_HIT_BWD + OPS_SU_BWD)
    elif what.startswith("bp"):
        call = _bp_calls(n, arg, n)
        if what == "bp_dead":
            call[0][45] = 0.0
        P, pkind, mkind, _, lt, _ = call
        nb, ops = bp_bwd_bytes([call])
        assert nb == 4 * _bp_by_hand(P, pkind, mkind, lt)
        found = int(((P[45] > 0.5) & (pkind != 0)).sum())
        assert ops == found * (OPS_HIT_BWD + OPS_SU_BWD)
        assert bp_bwd_bytes([call, call]) == (2 * nb, 2 * ops)
    elif what.startswith("su"):
        call = _su_calls(n, arg, n)
        if what == "su_dead":
            call[0][38] = 0.0
        nb, ops = su_bwd_bytes([call])
        assert nb == 4 * _su_by_hand(*call)
        found = int(((call[0][38] > 0.5) & (call[0][39] > 0.5)).sum())
        assert ops == found * OPS_SU_BWD
        assert su_bwd_bytes([call, call]) == (2 * nb, 2 * ops)
    else:
        call = _shade_calls(n, arg, n)
        nb = shade_bwd_bytes([call])
        assert nb == 4 * _shade_by_hand(*call)
        assert shade_bwd_bytes([call, call]) == 2 * nb


@pytest.mark.parametrize("case", [
    ("bp", 300, False, 1), ("bp", 384, True, 1), ("bp", 330, True, 0),
    ("bp_dead", 256, False, 1), ("bp_live", 2048, True, 1)])
def test_split_fwd_bytes_by_hand(case):
    """F's byte bound (``bp_fwd_bytes``) on a few hundred live, dead,
    found and missed lanes of every material kind, with and without the
    checker leaves (a checker lane counts the one leaf its select picks),
    with one light and none, and every lane dead; G's (``bp_live_bytes``)
    on a live and a dead 1024-lane tile; against counts made lane by lane;
    a list of calls is the sum of its calls."""
    what, n, checker, n_lights = case
    P, pkind, mkind, _, _, _ = _bp_calls(n, checker, n)
    flags = (torch.arange(n) % 4).to(torch.int32)   # FlipFace, checker
    lt = torch.zeros((n_lights + 1, 14))
    call = (P, pkind, mkind, flags, lt, n_lights)
    if what == "bp_dead":
        P[45] = 0.0
    if what == "bp_live":
        # tile 0 live (F's lane classes), tile 1 dead: its lanes read 13
        # planes and write 13
        tlive = torch.tensor([1, 0], dtype=torch.int32)
        nb, ops = bp_live_bytes(call, tlive)
        live = _bp_fwd_by_hand(P[:, :1024], pkind[:1024], mkind[:1024],
                               flags[:1024], lt, n_lights)
        assert nb == 4 * (live + 1024 * 26 + 2)
        found = int(((P[45, :1024] > 0.5) & (pkind[:1024] != 0)).sum())
    else:
        nb, ops = bp_fwd_bytes([call])
        assert nb == 4 * _bp_fwd_by_hand(*call)
        assert bp_fwd_bytes([call, call]) == (2 * nb, 2 * ops)
        found = int(((P[45] > 0.5) & (pkind != 0)).sum())
    assert ops == found * (OPS_HIT + OPS_SHADE)


def _su_fwd_by_hand(P, mkind, lt, n_lights):
    """H's floats counted lane by lane: every lane o, d, L, beta, alive in
    and 13 planes out; a live lane its hit flag; a found lane its material
    kind and what its kind reads (Lambertian p, n, albedo, randoms 0, 1,
    with lights also randoms 3, 4, and 5, 6 where it samples a light;
    metal p, n, albedo, fuzz, randoms 7, 9-11; dielectric p, n, ior,
    random 2; light n, albedo; isotropic p, albedo, randoms 8, 12-14); the
    table in."""
    per_kind = {0: 3 + 3 + 3 + 2, 1: 3 + 3 + 3 + 1 + 4, 2: 3 + 3 + 1 + 1,
                3: 3 + 3, 4: 3 + 3 + 4}
    floats = 0
    for i in range(P.shape[1]):
        floats += 13 + 13
        if P[38, i] > 0.5:
            floats += 1
            if P[39, i] > 0.5:
                k = int(mkind[i])
                floats += 1 + per_kind[k]
                if k == 0 and n_lights:
                    floats += 2 + (2 if P[26, i] >= 0.5 else 0)
    return floats + lt.numel()


def _shade_fwd_by_hand(data, rng_p, kind, lt, n_lights):
    """I's floats counted lane by lane: its kind in, 10 planes out, and
    what its kind reads (Lambertian n, albedo, randoms 0, 1, with lights
    also p, randoms 3, 4, and 5, 6 where it samples a light; metal d, n,
    albedo, fuzz, randoms 7, 9-11; dielectric d, n, ior, random 2; light
    d, n, albedo; isotropic albedo, randoms 8, 12-14); the table in."""
    per_kind = {0: 3 + 3 + 2, 1: 3 + 3 + 3 + 1 + 4, 2: 3 + 3 + 1 + 1,
                3: 3 + 3 + 3, 4: 3 + 4}
    floats = 0
    for i in range(data.shape[1]):
        k = int(kind[i])
        floats += 1 + 10 + per_kind[k]
        if k == 0 and n_lights:
            floats += 3 + 2 + (2 if rng_p[3, i] >= 0.5 else 0)
    return floats + lt.numel()


@pytest.mark.parametrize("case", [
    ("su", 300, 1), ("su", 260, 0), ("su_dead", 256, 8), ("shade", 300, 9),
    ("shade", 256, 16), ("shade", 130, 0)])
def test_su_and_shade_fwd_bytes_by_hand(case):
    """H's byte bound (``su_fwd_bytes``) on dead, live, missed and found
    lanes of every material kind at one and no light (and every lane dead
    at 8), and I's (``shade_fwd_bytes``) on the five material kinds at 9,
    16 and no lights, against counts made lane by lane; H's operations the
    shading of each found lane; a list of calls is the sum of its calls."""
    what, n, n_lights = case
    if what.startswith("su"):
        call = _su_calls(n, n_lights, n)
        if what == "su_dead":
            call[0][38] = 0.0
        nb, ops = su_fwd_bytes([call])
        assert nb == 4 * _su_fwd_by_hand(*call)
        found = int(((call[0][38] > 0.5) & (call[0][39] > 0.5)).sum())
        assert ops == found * OPS_SHADE
        assert su_fwd_bytes([call, call]) == (2 * nb, 2 * ops)
    else:
        call = _shade_calls(n, n_lights, n)
        nb = shade_fwd_bytes([call])
        assert nb == 4 * _shade_fwd_by_hand(*call)
        assert shade_fwd_bytes([call, call]) == 2 * nb


@pytest.mark.parametrize("n_lights", [9, 40])
def test_shade_work_by_stage(n_lights):
    """I's work (``shade_work``) on 320 lanes of the five material kinds
    with sphere lights of radius 0.3 in [-2, 2]^3 and two quad lights:
    each Lambertian lane's candidate lights (a sphere whose discriminant
    against the lane's direction is positive, every quad) counted light
    by light from the plain version's directions; the operations the
    shading of every lane, each sphere's discriminant and each quad's pdf
    a Lambertian lane, and each candidate sphere's full test; the warps'
    most candidates."""
    gen = torch.Generator().manual_seed(n_lights)
    data, rng_p, kind, _, _ = _shade_calls(320, n_lights, n_lights)
    data[3:6] = data[3:6] * 4.0 - 2.0
    lt = torch.zeros((n_lights, 14))
    lt[:, 0] = LIGHT_SPHERE
    lt[:, 1:4] = torch.rand((n_lights, 3), generator=gen) * 4.0 - 2.0
    lt[:, 4] = 0.3
    lt[:2, 0] = LIGHT_QUAD
    lt[:2, 5:14] = torch.rand((2, 9), generator=gen) - 0.5
    call = (data, rng_p, kind, lt, n_lights)
    w = shade_work([call])
    row = w["per_bounce"][0]
    sd = tuple(shade_ops.shade_plane_core(*call)[6:9])
    lam = kind == MAT_LAMBERTIAN
    n_lam = int(lam.sum())
    cand = torch.zeros(320, dtype=torch.int32)
    for l in range(n_lights):
        if l < 2:
            cand += 1
        else:
            disc = shade_ops._sphere_disc(lt, l, tuple(data[3:6]), sd)[0]
            cand += (disc > 0).int()
    cand = torch.where(lam, cand, torch.zeros_like(cand))
    n_cand = int(cand.sum())
    assert row["lambertian"] == n_lam and row["candidates"] == n_cand
    assert n_cand > n_lam * 2       # every quad, and some spheres
    assert row["ops_by_stage"] == {
        "shading": 320 * OPS_SHADE,
        "discriminants": n_lam * (n_lights - 2) * OPS_LIGHT_DISC,
        "full_tests": (n_cand - 2 * n_lam) * OPS_SPHERE_FULL
        + 2 * n_lam * OPS_QUAD_PDF}
    assert row["ops"] == sum(row["ops_by_stage"].values())
    assert w["total"]["ops"] == row["ops"]
    assert row["warp_most_max"] == int(cand.reshape(-1, 32).amax(1).max())
    assert row["mean_candidates"] == n_cand / n_lam


def _hit_by_hand(n, bwd):
    """J's floats on n lanes counted plane by plane: the 19 input planes
    (o, d, time, tmin, tmax, the 9-float pack, tmed), kind and flip in, the
    12 output planes (t, p, n, u, v, the sphere-UV source) out; J' also
    the 12 cotangents in and the 19 input planes' cotangents out (tmin's
    and tmax's zero rows included)."""
    planes_in = 3 + 3 + 1 + 1 + 1 + 9 + 1
    ints_in = 2
    planes_out = 1 + 3 + 3 + 1 + 1 + 3
    if bwd:
        return n * (planes_in + ints_in + planes_out + planes_in)
    return n * (planes_in + ints_in + planes_out)


@pytest.mark.parametrize("case", [(False, 1001), (False, 147_456),
                                  (True, 129), (True, 147_456)])
def test_hit_bytes_by_hand(case):
    """J's and J''s byte bound (``hit_bytes``) against the count plane by
    plane, at odd ray counts and the wave's; OPS_HIT (OPS_HIT_BWD) a lane;
    a list of calls is the sum of its calls. Only the shapes count: J and
    J' read and write every plane of every lane."""
    bwd, n = case
    call = (torch.zeros((19, n)), torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))
    nb, ops = hit_bytes([call], bwd)
    assert nb == 4 * _hit_by_hand(n, bwd)
    assert ops == n * (OPS_HIT_BWD if bwd else OPS_HIT)
    assert hit_bytes([call, call], bwd) == (2 * nb, 2 * ops)
