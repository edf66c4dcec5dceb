"""Chip smoke test: the torch port's forward render and training step on
one CUDA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from ``rust_ray_tracer_tpu_torch/csrc`` (one
nvcc per library, in parallel) and holds each against its plain PyTorch
version on the card and on the CPU: the trace kernel (forward, with and
without the backward's residuals), the backward kernel and its fixed-order
reduction, and the variants of the first two with the marble noise (TPU
kernel C) on four noise scenes; then the split route's kernels — quad
search (TPU kernel O), hit attributes (J) and shade+update (H) — on three
scenes the trace kernel cannot take (final_scene, a Cuboid fog, noise
beside a checker), each kernel on the scene's real bounce-0 inputs and the
route's image against the plain route's, and their backward kernels J' and
H' against their plain versions on the same inputs with a seeded
cotangent; the unified search (TPU kernel M) on the last two and on the
fog scene with solid textures, where the fused bounce (F) and its
backward (F') run too. Then it drives the main paths at
the bench workload's size (512x288, 4 spp, depth 4, chunk 9216), on the
flagship scene and on ``random`` (the JAX package's per-scene bench
workload, a marble-noise ground): the forward render through
``render_waves``, and ``bench.py``'s training step (loss = mean of the
render, scene gradients by ``torch.autograd``) — checking that every wave
went through the kernels and never the plain versions, that the gradients
are finite and bitwise repeatable, and timing both with CUDA events; and
the forward render of final_scene (the book-2 cover: media, 1,408 quads,
a marble sphere) on the split route, with O, J and H launched every
bounce, and ``bench.py``'s training step on final_scene, with O, J, H, J'
and H' launched every bounce (``final_train``); and a 65,536-triangle
mesh (``tests/torch_parity.mesh``, 16x the trace kernel's rows) on the
split route's unified search and fused bounce, forward (``mesh_forward``:
K, M and F launched every bounce on rays the search-order sort permuted,
each held against its plain version on a 128x72 wave's inputs and on a
full-size wave's bounces 0 and 1 (K on all four), the sort's
permutation against the host's, K and M timed a bounce beside their
bounds by stage) and ``bench.py``'s
training step
(``mesh_train``: K, M, F and F' every bounce); and a million-triangle mesh
(``tests/torch_parity.bigmesh``: the same draws written as a u32 ``.gltf``
with an external ``.bin`` and read back, 512 clusters of 2,048), forward
(``bigmesh_forward``: K, M's packed input and F every bounce; the packed
input against the staged one and the plain version on a forward's
recorded calls, the probe of its row assembly on every row) and
``bench.py``'s training step (``bigmesh_train``: gradients bitwise over
two steps and between the two inputs). Then, in a temporary
working directory holding a procedural 1024x512 ``earthmap.jpg`` (the
earlier phases ran without it), the earth-map scenes on the split route:
earth and final_scene at 64x64 against the plain route
(``earth_checks``); random with the map, forward (``random_earth_forward``:
TPU kernel N, the cluster-culled sphere search over its 1,024 sphere rows,
J and H every bounce) and ``bench.py``'s training step
(``random_earth_train``: N, J, H, J', H' every bounce, gradients non-zero
on the image atlas); and random's world with the flagship's 968
triangles (``tri_scene``: K and TPU kernel L, the triangle search alone,
beside N), N, L and K held against their plain versions on every bounce
of a 128x72 wave and of a full-size wave (N on random earth's too, and
against ``ops/sphere.sph_sweep_replay``). Then it runs the
inverse-rendering example for 60 steps and the CLI on the Cornell box,
perlin_spheres and final_scene. Last, with glTF files it writes into a
temporary directory (``tests/torch_parity.write_gltf_flagship``: the
flagship's 968 triangles with 1, 9 or 16 point lights), the glTF scenes:
the single-light ``.glb`` flagship on the trace kernel
(``gltf_flagship_forward``); the 9-light flagship on the split route,
whose light table overflows A, F and H, forward (``gltf_lights_forward``:
K, M, J and TPU kernel I every bounce; I and its backward I' held against
their plain versions on bounces 0 and 1 of a full-size wave at 9 and at
16 lights and with the 9 lights spread to 40 (past one 32-light chunk of
I's candidate mask), I's candidate lights and work by stage, K on every
bounce) and ``bench.py``'s training step
(``gltf_lights_train``: K, M, J, I, J', I' every bounce); a Mesh-boundary
medium at 64x64 (``mesh_medium``); and the CLI's ``-g`` on the 9-light
file (``cli_gltf``). Between the whole-wave phases and final_scene run the
per-chunk path's (TPU kernels D and D': the sharded renderer's body) and
the unfused bounce's (``RRT_NO_UBER_FUSED=1``: TPU kernels E, G and G'
against their plain versions on the flagship's and a checker scene's
full-size bounces, E's winners against D's; the flagship's forward and
training step through ``render_waves`` with ``RRT_UBER_WAVE=0``; a
one-rank ``render_waves_sharded`` and the CLI under the flag). After the
compact wavefront's phases, ``marble_trace`` holds the split route's
marble (torch on CUDA), C (through ``kernels.marble_probe_kernel``) and
J's hit point against A's on random's full-size bounces 0 and 1, and
``parity_gate`` runs the port's parity gate
(``rust_ray_tracer_tpu_torch/tools/verify_gpu_parity.py``: a scene
matrix against the CPU twins and JAX's saved renders) green, then with
its injected shade error red. Each phase prints one JSON line; any
failure raises, so the exit code is non-zero.
Then come
the ``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one CUDA GPU; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.examples import inverse_rendering
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
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import bounce as bounce_ops
from rust_ray_tracer_tpu_torch.ops import bounce_core
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import gather
from rust_ray_tracer_tpu_torch.ops import hit as hit_ops
from rust_ray_tracer_tpu_torch.ops import integrator
from rust_ray_tracer_tpu_torch.ops import intersect as isect
from rust_ray_tracer_tpu_torch.ops import quad as quad_ops
from rust_ray_tracer_tpu_torch.ops import search as search_ops
from rust_ray_tracer_tpu_torch.ops import shade as shade_ops
from rust_ray_tracer_tpu_torch.ops import sphere as sphere_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import (make_split_tables,
                                                      render_waves)
from rust_ray_tracer_tpu_torch.parallel import (load_state, make_mesh,
                                                multihost_init,
                                                render_waves_sharded,
                                                render_with_checkpoints)
from rust_ray_tracer_tpu_torch.tools import search_times
from rust_ray_tracer_tpu_torch.tools.search_times import (
    HIT_ODD_N, OPS_SHADE, bp_bwd_bytes, bp_fwd_bytes, bp_live_bwd_bytes,
    bp_live_bytes, cold_ms, hit_bytes, hit_lanes, hit_ptxas, kernel_ptxas,
    loop_ms, ptxas_report, shade_bwd_bytes, shade_fwd_bytes, shade_work,
    su_bwd_bytes, su_fwd_bytes)
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import rng
from rust_ray_tracer_tpu_torch.utils.image import decode_image
from rust_ray_tracer_tpu_torch.utils.metrics import occupancy_probe

# the split route's dispatcher hooks, shared with the tests (no JAX there)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_parity import mesh as mesh_host  # noqa: E402
from torch_parity import mesh_medium as mesh_medium_host  # noqa: E402
from torch_parity import random_tris as random_tris_host  # noqa: E402
from torch_parity import solid_fog as solid_fog_host  # noqa: E402
from torch_parity import split_cots, split_recorder  # noqa: E402
from torch_parity import spread_lights  # noqa: E402
from torch_parity import write_earth_map  # noqa: E402
from torch_parity import write_gltf_flagship  # noqa: E402

WIDTH, HEIGHT, SPP, DEPTH, CHUNK = 512, 288, 4, 4, 9216
FLIP_ABS = 1e-3          # a pixel "flips" when any channel is off by more
FLIP_BUDGET = 0.005      # fraction of pixels allowed to flip
RTOL, ATOL = 3e-4, 3e-5  # the rest (FMA contraction, division order)
# the backward: a ray's cotangent (dst) within rtol of its largest plane /
# atol, at most FLIP_BUDGET of the rays outside (an FMA can flip a
# recomputed branch: tir, metal_ok, a checker parity); the table
# cotangents (duni, dlt) sum in another order: relative L2 error
BWD_RTOL, BWD_ATOL, BWD_REL_L2 = 1e-4, 1e-6, 1e-4
# the card's published peaks (H100 SXM, 700 W): fp32 non-tensor, HBM3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 operations of the backward per found ray-bounce (the recomputed
# forward plus its adjoint; per live ray-bounce of shading and update
# tools/search_times.OPS_SHADE). M and L count each triangle test by stage
# (tools/search_times.m_work: OPS_M_DET, OPS_M_T, OPS_M_UV), N each
# sphere test (OPS_SPH_DISC, OPS_SPH_ROOT below)
OPS_BWD = 600
# fp32 operations of closest_hit (csrc/trace_wave.cu: A, D, E) by the
# stage of a test that the closest hit needs, counted from the code
# (closest_hit_work counts the stages in the run). A triangle: the
# determinant's dot and the face test (19 + 3) on every swept test; the t
# dot, the division and the window (19 + 8) where the ray sees the face;
# the u and v dots, their products and the barycentric compares (38 + 7)
# only where t lies in the window at or below the ray's closest hit: any
# order of the sweep must rule those out, and the kernel's ascending order
# adds the tests whose t is only below the best so far. A sphere: the
# discriminant (27) on every test, the roots (14) where it is positive. A
# quad: t (21) on every test, the point's coordinates (43) where t lies in
# the window at or below the closest hit. What depends on the ray alone
# (o x d, the determinant's epsilon, |d|^2) or on the quad alone (its
# normal) is not counted per test
OPS_TRI_DET, OPS_TRI_T, OPS_TRI_UV = 22, 27, 45
OPS_SPH_DISC, OPS_SPH_ROOT, OPS_QUAD_T, OPS_QUAD_IN = 27, 14, 21, 43
# fp32 operations of the marble (csrc/trace_common.cuh), counted from the
# code. One octave of noise_row: 3 axes x 8 (floor, offset, Hermite weight
# (4), index, wrap) + 3 scalings of p + 3 (1 - s) + 8 corners x 12 (3
# offsets, a 3-term dot (5), the weight product (2), multiply-add (2)) + 2
# (acc += w * n) = 24 + 3 + 3 + 96 + 2 = 128; the marble = 7 octaves + 25
# (scale * z + 10 |acc|, sinf ~20, 0.5 (1 + .)) = 921 per noise hit of the
# forward. The adjoint per found noise ray-bounce: the recomputed marble
# (921), its first pass (7 x 128 = 896), the second pass 7 x (24 + 3 + 9
# (three s') + 8 x 28 (dot 8, weight 2, three axes x 6) + 7 (three
# accumulations)) = 7 x 267 = 1869, and cosf and the chain rule (~30):
# 921 + 896 + 1869 + 30 = 3716
OPS_MARBLE, OPS_MARBLE_BWD = 921, 3716
# the split route's kernels (csrc/split.cu), counted from the code: O by
# the stage of each test, as closest_hit's quads (OPS_QUAD_T for t on
# every test, OPS_QUAD_IN where t can win: quad_vs_plain counts them from
# ops/quad.quad_sweep_replay); J by tools/search_times.hit_bytes, H by
# OPS_SHADE
SPLIT_KERNELS = (quad_search_kernel, hit_attrs_kernel, shade_update_kernel)
# their backward kernels (csrc/split.cu) count by
# tools/search_times.hit_bytes and OPS_SU_BWD
SPLIT_BWD_KERNELS = (hit_attrs_bwd_kernel, shade_update_bwd_kernel)
WHOLE_WAVE_KERNELS = (trace_wave_kernel, trace_wave_noise_kernel,
                      trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel)
# the split route's search (csrc/search.cu) and fused bounce (csrc/split.cu)
# on triangle meshes and solid or checker scenes: K by stage, counted from
# the code: per live ray its three inverses (|d| < 1e-12, a select and a
# division an axis: OPS_K_RAY), per (live ray, nonempty box) the slab test
# (tools/search_times.OPS_SLAB, which N's box tests count too); M by the
# stage of each triangle test the closest hit needs
# (tools/search_times.m_work); F per found ray the hit attributes and the
# shading, F' their adjoints
OPS_K_RAY = 9
SEARCH_KERNELS = (tile_enter_kernel, fused_search_kernel)
# the profiler's name of M's staged instance (L's too)
M_STAGED = search_times.m_profiler_name(False)
# M's packed input (csrc/search.cu fused_search_kernel<true>) and the probe
# of its row assembly, on the million-triangle mesh
# (tests/torch_parity.bigmesh: 512 clusters of 2,048)
PACKED_KERNELS = (K.fused_search_packed_kernel, K.packed_rows_probe_kernel)
BIGMESH_TRIS, BIGMESH_WIDTH = 1 << 20, 2048
FUSED_KERNELS = (bounce_planes_kernel,)
FUSED_BWD_KERNELS = (bounce_planes_bwd_kernel,)
MESH_W, MESH_H = 128, 72  # the mesh's check against the plain versions
# the per-kind searches of the split route (TPU kernels N: csrc/sphere.cu,
# and L: M's entry point in csrc/search.cu with no sphere or quad rows): N
# by stage (tools/search_times.n_work), L as M
CULL_KERNELS = (sph_search_kernel, tri_search_kernel)
EARTH_W, EARTH_H = 1024, 512  # the procedural earth map of the new phases
# the shading of 9 or more lights (TPU kernels I, I': csrc/shade.cu): I by
# stage (tools/search_times.shade_work: each lane's shading, each light's
# discriminant a Lambertian lane, each candidate light's full test); I'
# twice OPS_SHADE a lane and, for a Lambertian lane, twice OPS_LIGHT_PDF
# per light (its forward's mixture pdf runs every light's whole test: the
# offset, a 3-term dot, the discriminant, a root, the solid angle; its
# adjoint runs it again)
OPS_LIGHT_PDF = 60
# I's check past one chunk of its candidate mask: 40 lights, the 9-light
# flagship's spread by tests/torch_parity.spread_lights
WIDE_LIGHTS = 40
SHADE_KERNELS = (shade_kernel, shade_bwd_kernel)
# the CLI's -g on the 9-light flagship at 128x72, 4 spp: the port's plain
# route on the CPU gives mean radiance 0.979852; the band leaves room for
# paths that fork apart between the card's and the host's float32
CLI_GLTF_LO, CLI_GLTF_HI = 0.93, 1.03
# the per-chunk path of the sharded renderer (TPU kernels D, D': one uber
# bounce a launch and its backward, csrc/trace_wave.cu, trace_wave_bwd.cu)
D_KERNELS = (K.bounce_uber_kernel, K.bounce_uber_noise_kernel)
D_BWD_KERNELS = (K.bounce_uber_bwd_kernel, K.bounce_uber_bwd_noise_kernel)
SHARD_W, SHARD_H, SHARD_CHUNK = 128, 72, 1024   # two ranks, checkpoints
# the unfused uber bounce (RRT_NO_UBER_FUSED=1): TPU kernel E
# (csrc/trace_wave.cu select_kernel, A's search alone) and G, G'
# (csrc/split.cu: F and F' launched with the tiles' liveness flags); the
# profiler names G and G' as F and F', which the path does not run
UNFUSED_KERNELS = (K.select_kernel, K.bounce_planes_live_kernel,
                   K.bounce_planes_live_bwd_kernel)
UNFUSED_NAMES = {"select": "::select_kernel(",
                 "bounce_planes_live": "bounce_planes_kernel",
                 "bounce_planes_live_bwd": "bounce_planes_bwd_kernel"}
UNFUSED_OFF = (WHOLE_WAVE_KERNELS + D_KERNELS + D_BWD_KERNELS
               + FUSED_KERNELS + FUSED_BWD_KERNELS)
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def solid_scene(checker: bool = False) -> S.Scene:
    """Spheres of three materials, a double-sided ground triangle (checker
    textured when ``checker``) and a rect light."""
    cam = cam_ops.make_camera(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], 60.0, 1.0)
    ground = (S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                 (0.1, 0.9, 0.1)))
              if checker else S.Lambertian.from_rgb(0.7, 0.7, 0.7))
    world = [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.Sphere((2.2, 0, -4), 1.0, S.Metal((0.9, 0.8, 0.7), 0.2)),
        S.Triangle((-3, -1.2, -2), (3, -1.2, -2), (0, -1.2, -8), ground,
                   double_sided=True),
        S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                 S.DiffuseLight.from_color((5, 5, 5))),
    ]
    return S.Scene(cam, world, [world[-1]], (0.2, 0.3, 0.5))


def noise_scene() -> S.Scene:
    """tests/test_uber.py's noise scene: a marble-noise ground (r = 100)
    and Lambertian, metal and dielectric spheres."""
    cam = cam_ops.make_camera(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], 60.0, 1.0)
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0, S.Lambertian(S.Noise(0.8))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Metal((0.8, 0.8, 0.9), 0.1)),
        S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
    ], [], (0.7, 0.8, 1.0))


def fog_scene() -> S.Scene:
    """A split-route scene: a rotated Cuboid fog and a sphere-boundary
    medium with a marble albedo, a marble sphere beside a checker ground,
    glass, two quad walls and a rect light."""
    cam = cam_ops.make_camera(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], 60.0, 1.0)
    lamp = S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                    S.DiffuseLight.from_color((5, 5, 5)))
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian(S.Noise(4.0))),
        S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.XYRect(-3.0, 3.0, -1.0, 3.0, -7.0,
                 S.Lambertian.from_rgb(0.73, 0.73, 0.73)),
        S.YZRect(-1.0, 3.0, -7.0, -2.0, -3.0,
                 S.Metal((0.8, 0.85, 0.88), 0.05)),
        S.ConstantMedium.from_color(
            S.Translate(S.RotateY(S.Cuboid((-0.6, -0.6, -0.6),
                                           (0.6, 0.6, 0.6),
                                           S.Dielectric(1.5)), 30.0),
                        (-1.6, 0.0, -3.2)), 0.8, (0.9, 0.9, 0.9)),
        S.ConstantMedium(S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
                         1.5, S.Noise(2.0)),
        lamp,
    ], [lamp], (0.2, 0.3, 0.5))


def noise_checker_scene() -> S.Scene:
    """A marble sphere beside a checker ground: the trace kernel's marble
    does not evaluate a checker's leaves, so it takes the split route."""
    cam = cam_ops.make_camera(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], 60.0, 1.0)
    return S.Scene(cam, [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian(S.Noise(4.0))),
        S.Sphere((0, -101, -4), 100.0, S.Lambertian(
            S.Checker.from_colors((0.9, 0.1, 0.1), (0.1, 0.9, 0.1)))),
    ], [], (0.1, 0.1, 0.1))


def outside_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of the pixels of two [H, W, 3] images with a channel outside
    RTOL / ATOL."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float(((got - ref).abs() > ATOL + RTOL * ref.abs()).any(-1)
                 .float().mean())


def compare(got: torch.Tensor, ref: torch.Tensor, what: str,
            flip_abs: float | None = FLIP_ABS,
            budget: float = FLIP_BUDGET) -> dict:
    """Flip-budget comparison of two [H, W, 3] images; raises on failure.

    A pixel flips (a path forked on a near-tie) when any channel is off by
    more than ``flip_abs``; at most ``budget`` (FLIP_BUDGET unless given) of
    the pixels may flip and the rest must match to RTOL/ATOL.
    ``flip_abs=None`` counts every pixel outside RTOL/ATOL as a flip — for
    full-size images, where a few forked paths carry less than 1e-3 of
    radiance, and for noise scenes, where the marble moves a pixel by less
    than 1e-3 for the last ulp of a normalisation or a transcendental.
    """
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite pixels")
    diff = (got - ref).abs()
    outside = (diff > ATOL + RTOL * ref.abs()).any(-1)
    flips = outside if flip_abs is None else (diff > flip_abs).any(-1)
    frac = float(flips.float().mean())
    if frac > budget:
        raise AssertionError(f"{what}: {frac:.4%} of pixels flipped")
    bad = outside & ~flips
    if bool(bad.any()):
        i = int(torch.nonzero(bad.reshape(-1))[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} pixels outside rtol {RTOL} / atol "
            f"{ATOL}, e.g. {got.reshape(-1, 3)[i].tolist()} vs "
            f"{ref.reshape(-1, 3)[i].tolist()}")
    err = float((diff * ~flips[..., None]).max())
    return {"flip_frac": frac, "max_abs_err": err}


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def lanes_outside(got, ref, rtol, atol):
    """[N] bool: the lanes of [C, N] planes with ``|got - ref| > atol +
    rtol * (largest |ref| of the lane)``, and the errors [C, N]."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().amax(dim=0, keepdim=True)
    err = (got - ref).abs()
    return (err > atol + rtol * scale).any(dim=0), err


def scaled_close(got, ref, rtol, atol, budget, what):
    """Per-lane comparison of [C, N] planes: ``|got - ref| <= atol + rtol
    * (largest |ref| of the lane)``; at most ``budget`` of the lanes may
    fall outside. Returns (share outside, worst error of the rest)."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    bad, err = lanes_outside(got, ref, rtol, atol)
    frac = float(bad.float().mean())
    if frac > budget:
        raise AssertionError(f"{what}: {frac:.4%} of lanes outside rtol "
                             f"{rtol} / atol {atol}")
    return frac, float((err * ~bad).max())


def rel_l2(got, ref, what, limit):
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    r = rel_l2_of(got, ref)
    if r > limit:
        raise AssertionError(f"{what}: relative L2 error {r:.3g} > {limit}")
    return r


def rel_l2_of(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def rows_close(got, ref, what, rtol=BWD_REL_L2, atol=BWD_ATOL) -> float:
    """Each row of a table cotangent [R, C] (a light's, the background's)
    within ``atol`` plus ``rtol`` times the row's largest |ref|, so a
    light's small share is not hidden in the whole table's norm. Returns
    the worst error as a share of its row's largest |ref|."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = ref.abs().amax(dim=1)
    err = (got - ref).abs().amax(dim=1)
    bad = err > atol + rtol * scale
    if bool(bad.any()):
        r = int(torch.nonzero(bad)[0])
        raise AssertionError(f"{what}: row {r} off by {float(err[r]):.3g}, "
                             f"its largest |ref| {float(scale[r]):.3g}")
    return float((err / scale.clamp_min(1e-30)).max())


def check_sphere_light_rows(dlt, ctx, what) -> None:
    """A sphere light's centre and radius columns take a cotangent (its
    pdf adjoint ran), so the rows' check above held something."""
    for li in range(ctx.n_lights):
        if int(ctx.lt[li, 0]) == S.LIGHT_SPHERE and not float(
                dlt[li, 1:5].abs().max()) > 0:
            raise AssertionError(f"{what}: sphere light {li} took no "
                                 "cotangent")


def profile_device(fn, names, top: int = 0) -> dict:
    """Kernel time on the card by ``torch.profiler`` over one call of
    ``fn``: per name, ms per launch and launches; the busy share of the
    span from the first kernel's start to the last one's end; with
    ``top``, the ``top`` kernels of most device time (name cut to 90
    characters: total ms, launches). None where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return {"per_kernel": None, "busy_share": None, "kernels": 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = max(b for _, b in spans) - spans[0][0]
    per = {}
    for n in names:
        ds = [e.time_range.elapsed_us() for e in kern if n in e.name]
        per[n] = {"ms_per_launch": (sum(ds) / len(ds) / 1e3) if ds else None,
                  "launches": len(ds)}
    out = {"per_kernel": per, "busy_share": busy / span,
           "span_ms": span / 1e3, "busy_ms": busy / 1e3,
           "kernels": len(kern)}
    if top:
        by = {}
        for e in kern:
            t = by.setdefault(e.name[:90], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
        out["top_kernels_ms"] = dict(sorted(by.items(), key=lambda x: -x[1][0])
                                     [:top])
    return out


def median(xs):
    return statistics.median(xs)


def closest_hit_work(hist, ctx) -> dict:
    """The tests ``closest_hit`` (A, D, E) needs on the states ``hist``
    [depth, >= 8, N], by stage, and their fp32 operations (``ops``; the
    OPS_* counts above): at each bounce every live ray of a 128-ray row
    tests every triangle of each 512-triangle chunk whose box a live ray
    of the row enters (the kernel's vote: ``tri_tests``), of which it sees
    the face of ``tri_seen``; ``tri_near`` of those have t in the window
    at or below the ray's closest hit (u and v needed); every sphere
    (``sph_tests``), a positive discriminant on ``sph_roots``; every quad
    (``quad_tests``), t in the window at or below the closest hit on
    ``quad_near``. The tables' pad rows need no test."""
    keys = ("tri_tests", "tri_seen", "tri_near", "sph_tests", "sph_roots",
            "quad_tests", "quad_near")
    c = dict.fromkeys(keys, 0)
    nt = ctx.n_tri_chunks * uber.TCC
    for st in hist:
        for i in range(0, st.shape[1], 8192):
            ox, oy, oz, dx, dy, dz, time, alive = st[:8, i:i + 8192]
            live = alive > 0.5
            if not bool(live.any()):
                continue
            tmin = torch.full_like(ox, uber.T_MIN)
            tmax = torch.where(live, torch.inf, -1.0)
            best = torch.full_like(ox, torch.inf)
            n_live = int(live.sum())
            # spheres: the discriminant, the roots where it is positive
            sp = ctx.sph_pack[:ctx.n_sph, :9, None] if ctx.n_sph else None
            if sp is not None:
                frac = (time - sp[:, 6]) * sp[:, 7]
                oc = [o - (sp[:, a] + frac * sp[:, 3 + a])
                      for a, o in enumerate((ox, oy, oz))]
                bq = oc[0] * dx + oc[1] * dy + oc[2] * dz
                cc = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
                      - sp[:, 8] * sp[:, 8])
                disc = bq * bq - (dx * dx + dy * dy + dz * dz) * cc
                c["sph_tests"] += n_live * sp.shape[0]
                c["sph_roots"] += int(((disc > 0) & live).sum())
                best = torch.minimum(best, search_ops.sphere_tests(
                    (ox, oy, oz, dx, dy, dz, time), sp[:, :, 0], tmin,
                    tmax).amin(0))
            if ctx.n_quad:
                qd = ctx.quad_pack[:ctx.n_quad, :9, None]
                wn = torch.linalg.cross(qd[:, 3:6], qd[:, 6:9], dim=1)
                denom = dx * wn[:, 0] + dy * wn[:, 1] + dz * wn[:, 2]
                dsafe = torch.where(denom.abs() < 1e-12, torch.where(
                    denom < 0, -1e-12, 1e-12).to(denom.dtype), denom)
                tq = ((qd[:, 0] - ox) * wn[:, 0] + (qd[:, 1] - oy) * wn[:, 1]
                      + (qd[:, 2] - oz) * wn[:, 2]) / dsafe
                tq_ok = (denom.abs() > 0) & (tq >= tmin) & (tq <= tmax)
                best = torch.minimum(best, search_ops.quad_tests(
                    (ox, oy, oz, dx, dy, dz), qd[:, :, 0], tmin,
                    tmax).amin(0))
            if ctx.n_tri_chunks:
                f = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                     oz * dx - ox * dz, ox * dy - oy * dx,
                     torch.ones_like(ox))
                tabs = uber.tri_cols(ctx.tri_pack[:nt])
                valid, t = search_ops.tri_tests(f, tabs, tmin, tmax)
                dm = tabs[0][:, 0:1] * f[0]
                for k in range(1, 10):
                    dm = dm + tabs[0][:, k:k + 1] * f[k]
                eps = search_ops.TRI_DET_EPS * torch.sqrt(
                    dx * dx + dy * dy + dz * dz)
                seen = (dm > eps) | ((dm < -eps) & (tabs[4] > 0.5))
                # the vote: a chunk is swept for a row when a live ray of
                # the row enters its box; every live ray of the row tests it
                cab = ctx.cab[:ctx.n_tri_chunks]
                inv = [1.0 / torch.where(x.abs() < 1e-30,
                                         torch.full_like(x, 1e-30), x)
                       for x in (dx, dy, dz)]
                o = (ox, oy, oz)
                t0 = [(cab[:, a:a + 1] - o[a]) * inv[a] for a in range(3)]
                t1 = [(cab[:, 3 + a:4 + a] - o[a]) * inv[a]
                      for a in range(3)]
                tn = torch.maximum(
                    torch.maximum(torch.minimum(t0[0], t1[0]),
                                  torch.minimum(t0[1], t1[1])),
                    torch.maximum(torch.minimum(t0[2], t1[2]), tmin))
                tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                                 torch.maximum(t0[1], t1[1])),
                                   torch.maximum(t0[2], t1[2]))
                vote = ((tf >= tn) & live).reshape(cab.shape[0], -1, 128)
                swept = vote.any(2).repeat_interleave(128, dim=1)
                # the pad rows (no coefficients) need no test
                real = tabs[0].ne(0).any(1, keepdim=True)
                tested = (swept.repeat_interleave(uber.TCC, dim=0) & live
                          & real)
                best = torch.minimum(best, torch.where(
                    valid & tested, t, torch.inf).amin(0))
                c["tri_tests"] += int(tested.sum())
                c["tri_seen"] += int((tested & seen).sum())
                c["tri_near"] += int((tested & seen & (t >= tmin)
                                      & (t <= best)).sum())
            if ctx.n_quad:
                c["quad_tests"] += n_live * qd.shape[0]
                c["quad_near"] += int((tq_ok & (tq <= best)).sum())
    c["ops"] = (c["tri_tests"] * OPS_TRI_DET + c["tri_seen"] * OPS_TRI_T
                + c["tri_near"] * OPS_TRI_UV + c["sph_tests"] * OPS_SPH_DISC
                + c["sph_roots"] * OPS_SPH_ROOT
                + c["quad_tests"] * OPS_QUAD_T
                + c["quad_near"] * OPS_QUAD_IN)
    return c


def noise_hits(hist, kind, idx, ctx) -> int:
    """Found ray-bounces whose winner has a Noise texture: the marble
    evaluations of the forward and of the adjoint on these residuals."""
    if not ctx.has_noise:
        return 0
    nz_col = uber.A_COL + uber.mattr_noise_cols(ctx.has_checker)[1]
    found = (hist[:, 7] > 0.5) & (kind > 0)
    return int((ctx.uni[idx[found].long(), nz_col] > 0.5).sum())


class PlainCalls:
    """Counts the plain versions' calls while the main path runs: inside
    ``with``, ``uber.trace_wave_plain``, ``uber.trace_wave_bwd_plain`` and
    the split route's ``_quad_candidates`` (as ``ops/quad`` calls it),
    ``hit_plane_core`` and ``hit_plane_core_vjp`` (``ops/hit``),
    ``su_plane_core``, ``su_plane_core_vjp``, ``bounce_plane_core`` and
    ``bounce_plane_core_vjp`` (``ops/bounce``), ``tile_enter_plain``,
    ``fused_search_plain``, ``assemble_rows`` (M's packed rows assembled)
    and ``tri_search_plain`` (``ops/search``),
    ``sph_search_plain`` (``ops/sphere``), ``shade_plane_core`` and
    ``shade_plane_core_vjp`` (``ops/shade``), ``fused_bounce_plain``,
    ``fused_bounce_bwd_plain`` and ``select_plain`` (``ops/uber``) and
    ``bounce_planes_live_plain`` and ``bounce_planes_live_bwd_plain``
    (``ops/bounce``) record their names in ``calls``; ``real``,
    ``real_bwd``, ``real_fused``, ``real_fused_bwd``, ``real_select``,
    ``real_live`` and ``real_live_bwd`` stay the uncounted functions."""

    real = uber.trace_wave_plain
    real_bwd = uber.trace_wave_bwd_plain
    real_fused = uber.fused_bounce_plain
    real_fused_bwd = uber.fused_bounce_bwd_plain
    real_select = uber.select_plain
    real_live = bounce_ops.bounce_planes_live_plain
    real_live_bwd = bounce_ops.bounce_planes_live_bwd_plain
    SITES = ((uber, "trace_wave_plain"), (uber, "trace_wave_bwd_plain"),
             (quad_ops, "_quad_candidates"), (hit_ops, "hit_plane_core"),
             (bounce_ops, "su_plane_core"), (hit_ops, "hit_plane_core_vjp"),
             (bounce_ops, "su_plane_core_vjp"),
             (search_ops, "tile_enter_plain"),
             (search_ops, "fused_search_plain"),
             (search_ops, "assemble_rows"),
             (bounce_ops, "bounce_plane_core"),
             (bounce_ops, "bounce_plane_core_vjp"),
             (sphere_ops, "sph_search_plain"),
             (search_ops, "tri_search_plain"),
             (shade_ops, "shade_plane_core"),
             (shade_ops, "shade_plane_core_vjp"),
             (uber, "fused_bounce_plain"), (uber, "fused_bounce_bwd_plain"),
             (uber, "select_plain"), (bounce_ops, "bounce_planes_live_plain"),
             (bounce_ops, "bounce_planes_live_bwd_plain"))

    def __init__(self):
        self.calls = []

    def _counting(self, fn):
        def wrapped(*args, **kwargs):
            self.calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        self._saved = [getattr(m, n) for m, n in self.SITES]
        for (m, n), f in zip(self.SITES, self._saved):
            setattr(m, n, self._counting(f))
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.SITES, self._saved):
            setattr(m, n, f)


class RowSumCalls:
    """Records every call of ``ops/gather.row_sums`` (the backward of the
    glue's row gathers: ``reduce_order`` + ``bwd_reduce_kernel`` on the
    card) as (idx, g, n_rows, result) while the block is open."""

    def __enter__(self):
        self.calls = []
        self._real = gather.row_sums

        def recorded(g, idx, n_rows):
            out = self._real(g, idx, n_rows)
            self.calls.append((idx, g, n_rows, out))
            return out
        gather.row_sums = recorded
        return self

    def __exit__(self, *exc):
        gather.row_sums = self._real


def replay_equal(got, args, what) -> None:
    """B''s (duni, dlt) ``got`` on ``args`` (contrib, sorted keys, perm,
    rows, partials) equal bit for bit to ``ops/uber.bwd_reduce_replay``,
    its order of operations in torch on the same card."""
    want = uber.bwd_reduce_replay(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        bad = int((got[0] != want[0]).any(1).sum())
        raise AssertionError(f"{what}: {bad} rows differ from the order "
                             "replay")


def within_float64(got, idx, g, n_rows, what) -> float:
    """B''s row sums ``got`` [n_rows, W] of the terms ``g`` [N, W] by row
    ``idx`` [N] against a float64 ``index_add_``: within 1e-5 of the sum of
    the terms' magnitudes, entry by entry. Returns the worst error in
    those units."""
    g64 = g.double()
    ref = torch.zeros((n_rows, g.shape[1]), dtype=torch.float64,
                      device=g.device).index_add_(0, idx, g64)
    mag = torch.zeros_like(ref).index_add_(0, idx, g64.abs())
    err = (got.double() - ref).abs()
    if not bool((err <= 1e-5 * mag).all()):
        raise AssertionError(f"{what}: off by {float(err.max())} of the "
                             "float64 sum")
    return float((err / mag.clamp_min(1e-300)).max())


def row_sums_vs_float64(calls) -> dict:
    """Each recorded ``row_sums`` result against a float64 ``index_add_``
    of the same cotangent rows: within 1e-5 of the sum of the terms'
    magnitudes, entry by entry (the bound ``tests/test_torch_gpu.py::
    test_row_sums_on_card`` derives: B''s fixed order rounds a term at most
    ~120 times at float32's 6e-8), and bit for bit the order replay's
    (``ops/uber.bwd_reduce_replay``). Returns the worst error in those
    units, the calls' widths and sizes, and the largest share of one
    call's rows that went to one row (a wave's miss lanes read row 0)."""
    if not calls:
        raise AssertionError("no row sums recorded on the training path")
    worst, widths, ns, top_share = 0.0, set(), set(), 0.0
    for idx, g, n_rows, got in calls:
        what = f"row_sums [{g.shape[0]}, {g.shape[1]}] into {n_rows} rows"
        worst = max(worst, within_float64(got, idx, g, n_rows, what))
        keys, perm = K.reduce_order(idx.to(torch.int32))
        replay_equal((got,), (g.contiguous(), keys, perm, n_rows,
                              torch.empty((0, 0), device=g.device)), what)
        widths.add(int(g.shape[1]))
        ns.add(int(g.shape[0]))
        top_share = max(top_share, float(torch.bincount(
            idx, minlength=n_rows).max()) / max(int(idx.numel()), 1))
    return {"calls": len(calls), "widths": sorted(widths),
            "terms": sorted(ns), "largest_row_share": top_share,
            "worst_err_over_magnitude": worst, "budget": 1e-5,
            "replay_bitwise": True}


def row_sums_bound(calls, light_parts=()) -> dict:
    """B''s bound on these recorded calls of ``ops/gather.row_sums`` (a
    one-wave step's) and light-table sums (``light_parts``: the partials'
    shapes): per row sum the cotangent rows, their sorted keys and order
    read once and the table's cotangent [rows, W] written once, empty rows
    included (the gradient is the whole table); per light sum the partials
    read and the row written. Bytes over HBM's rate: B' does one add a
    term, far below the fp32 rate."""
    nb = sum((g.numel() + 2 * idx.numel() + n_rows * g.shape[1]) * 4
             for idx, g, n_rows, _ in calls)
    nb += sum((blocks * ltn + ltn) * 4 for blocks, ltn in light_parts)
    launches = len(calls) + len(light_parts)
    ms = nb / PEAK_BYTES * 1e3
    return {"launches": launches, "bytes": nb, "bound_ms": ms,
            "bound_ms_per_launch": ms / max(launches, 1),
            "table_rows": sum(n for _, _, n, _ in calls)}


def row_sum_times(calls, light_parts) -> dict:
    """B' on these recorded row sums of a one-wave step (``calls``) and
    on the light-table sums of ``light_parts`` (partials of those shapes)
    beside ``index_add_``: ``tools/search_times.reduce_report``."""
    dev = calls[0][1].device
    return search_times.reduce_report(
        [(g, idx, n_rows) for idx, g, n_rows, _ in calls],
        [torch.randn(sh, device=dev) for sh in light_parts])


def hit_vs_plain(P, kind, flip, label):
    """J against its plain version on one call: inf on every miss lane,
    the planes within RTOL / ATOL of each lane's largest value (the sphere
    UV source on sphere lanes, where the epilogue reads it). Returns (share
    outside, worst error)."""
    got = hit_attrs_kernel(P, kind, flip)
    ref = hit_ops.hit_plane_core(P, kind, flip)
    miss = kind == isect.KIND_NONE
    if not bool(torch.isinf(got[0, miss]).all()):
        raise AssertionError(f"{label}: hit_attrs found a hit on a miss lane")
    got[0, miss] = ref[0, miss] = 0.0
    sph = kind == isect.KIND_SPH
    a = scaled_close(got[:9], ref[:9], RTOL, ATOL, 0.0,
                     f"{label}: hit_attrs")
    b = scaled_close(got[9:, sph], ref[9:, sph], RTOL, ATOL, 0.0,
                     f"{label}: hit_attrs sphere UV source") \
        if bool(sph.any()) else (0.0, 0.0)
    return max(a[0], b[0]), max(a[1], b[1])


def split_kernels_vs_plain(calls, label) -> dict:
    """O, J and H (where the route ran it) against their plain versions on
    the card, on the first recorded call of each (bounce 0 of a wave):
    O's winners and t equal;
    J's planes within RTOL / ATOL of each lane's largest value (the sphere
    UV source on sphere lanes, where the epilogue reads it), on the call
    and on ``hit_lanes`` of it for each odd n of HIT_ODD_N; H's within
    the same, at most FLIP_BUDGET of the lanes outside (the card's
    transcendentals in torch and in the kernel may round a branch's input
    apart). K, M, F and F' by ``search_fused_vs_plain`` where the route
    ran them. Returns each kernel's share outside and worst error."""
    out = {}
    if calls["quad"]:
        sc, o, d, t_min, t_max = calls["quad"][0][:5]
        got_t, got_i = quad_search_kernel(
            torch.cat([o, d, t_min[:, None], t_max[:, None]], 1).contiguous(),
            quad_ops.quad_table(sc), sc.quad_cluster_min.contiguous(),
            sc.quad_cluster_max.contiguous())
        ref_t, ref_i = quad_ops._quad_candidates(sc, o, d, t_min, t_max)
        if not (torch.equal(got_i.long(), ref_i) and torch.equal(got_t,
                                                                 ref_t)):
            bad = int(((got_i.long() != ref_i) | (got_t != ref_t)).sum())
            raise AssertionError(f"{label}: quad_search winners differ from "
                                 f"the plain version's on {bad} rays")
        out["quad_search"] = {"lanes_outside": 0.0, "max_abs_err": 0.0,
                              "winners_equal": True,
                              "hits": float(torch.isfinite(ref_t).float()
                                            .mean())}
    out.update(search_fused_vs_plain(calls, label))
    if not calls["hit"]:
        return out
    P, kind, flip = calls["hit"][0]
    frac, err = hit_vs_plain(P, kind, flip, label)
    odd = [hit_vs_plain(*hit_lanes(calls["hit"][0], m), f"{label} {m} rays")
           for m in HIT_ODD_N]
    out["hit_attrs"] = {"lanes_outside": max([frac] + [o[0] for o in odd]),
                        "max_abs_err": max([err] + [o[1] for o in odd]),
                        "odd_n": dict(zip(HIT_ODD_N, odd)),
                        "kinds": torch.bincount(kind.long(), minlength=5)
                        .tolist()}
    if not calls["su"]:                  # the I route: no H
        return out
    S_, mkind, lt, n_lights = calls["su"][0]
    frac, err = scaled_close(shade_update_kernel(S_, mkind, lt, n_lights),
                             bounce_ops.su_plane_core(S_, mkind, lt,
                                                      n_lights),
                             RTOL, ATOL, FLIP_BUDGET, f"{label}: shade_update")
    out["shade_update"] = {"lanes_outside": frac, "max_abs_err": err}
    out.update(split_bwd_vs_plain(calls["hit"][0], calls["su"][0], label))
    return out


def enter_vs_plain(args, label, b) -> dict:
    """K against its plain version on the card on one recorded call
    ``args`` (bounce ``b``): the surviving (tile, cluster) pairs equal and
    each entry within 1 ulp; whether every entry has the plain version's
    bits; two runs bit for bit."""
    got = tile_enter_kernel(*args)
    again = tile_enter_kernel(*args)
    ref = search_ops.tile_enter_plain(*args)
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{label}: two runs of tile_enter differ at "
                             f"bounce {b}")
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{label}: tile_enter's surviving (tile, "
                             f"cluster) pairs differ at bounce {b}")
    ulps = int((got[fin].view(torch.int32).long()
                - ref[fin].view(torch.int32).long()).abs().max()) \
        if bool(fin.any()) else 0
    if ulps > 1:
        raise AssertionError(f"{label}: tile_enter off by {ulps} ulps at "
                             f"bounce {b}")
    return {"lanes_outside": 0.0,
            "max_abs_err": float((got[fin] - ref[fin]).abs().max())
            if bool(fin.any()) else 0.0, "max_ulps": float(ulps),
            "bitwise": bool(torch.equal(got.view(torch.int32),
                                        ref.view(torch.int32))),
            "bitwise_repeat": True,
            "survivor_share": float(fin.float().mean())}


def enter_every_bounce(calls, label) -> dict:
    """:func:`enter_vs_plain` on every recorded call of K: the worst of
    the bounces, and whether all were bitwise."""
    rows = [enter_vs_plain(a, label, b) for b, a in enumerate(calls["enter"])]
    if not rows:
        return {}
    return {"tile_enter": {
        "lanes_outside": 0.0,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_ulps": max(r["max_ulps"] for r in rows),
        "bitwise": all(r["bitwise"] for r in rows), "bitwise_repeat": True,
        "bounces": len(rows)}}


def search_fused_vs_plain(calls, label, bounces=(0, 1)) -> dict:
    """K, M, F and F' against their plain versions on the card, on the
    recorded calls of ``bounces`` (bounce 0 and 1 of a wave): K's entries
    finite where the plain version's are and within 1 ulp, whether they
    are bitwise, two runs bit for bit (:func:`enter_vs_plain`); M's kinds,
    indices and t equal (the instance of the tables' input); F's planes
    within RTOL / ATOL of each lane's largest value, at most FLIP_BUDGET
    of the lanes outside (a checker
    parity or a shading branch rounded apart, as H's); F' with a seeded
    cotangent (normal draws, seed 5 + bounce) within B's budget (dP per
    lane within BWD_RTOL of its largest plane / BWD_ATOL, at most
    FLIP_BUDGET of the lanes outside; the light-table cotangent within
    relative L2 BWD_REL_L2 and each row within BWD_REL_L2 of its largest
    entry), two runs bit for bit. Returns each kernel's worst share
    outside and error."""
    out = {}

    def merge(name, **r):
        prev = out.get(name)
        out[name] = r if prev is None else {
            k: (max(prev[k], v) if isinstance(v, float) else
                (prev[k] and v) if isinstance(v, bool) else v)
            for k, v in r.items()}

    for b in bounces:
        if b < len(calls["enter"]):
            merge("tile_enter", **enter_vs_plain(calls["enter"][b], label, b))
        if b < len(calls["search"]):
            args = calls["search"][b]
            m = K.search_kernel(args[2])
            got = m(*args)
            ref = search_ops.fused_search_plain(*args)
            bad = ((got[1] != ref[1]) | (got[2] != ref[2])
                   | ((got[0] != ref[0]) & ~(torch.isinf(got[0])
                                              & torch.isinf(ref[0]))))
            if bool(bad.any()):
                raise AssertionError(f"{label}: {m.name} differs from "
                                     f"its plain version on "
                                     f"{int(bad.sum())} rays at bounce {b}")
            merge(m.name, lanes_outside=0.0, max_abs_err=0.0,
                  winners_equal=True,
                  kinds=torch.bincount(ref[1].long(), minlength=4).tolist())
        if b < len(calls["bp"]):
            P, pk, mk, fl, lt, nl = calls["bp"][b]
            chk = P.shape[0] > bounce_core.N_IN_B
            frac, err = scaled_close(
                bounce_planes_kernel(P, pk, mk, fl, lt, nl),
                bounce_core.bounce_plane_core(P, pk, mk, fl, lt, nl, chk),
                RTOL, ATOL, FLIP_BUDGET, f"{label}: bounce_planes b{b}")
            merge("bounce_planes", lanes_outside=frac, max_abs_err=err)
            g = torch.from_numpy(np.random.default_rng(5 + b).normal(
                size=(13, P.shape[1])).astype(np.float32)).to(P.device)
            d1, l1 = bounce_planes_bwd_kernel(P, pk, mk, fl, lt, nl, g)
            d2, l2 = bounce_planes_bwd_kernel(P, pk, mk, fl, lt, nl, g)
            torch.cuda.synchronize()
            if not (torch.equal(d1, d2) and torch.equal(l1, l2)):
                raise AssertionError(f"{label}: two runs of F' differ")
            rd, rl = bounce_core.bounce_plane_core_vjp(P, pk, mk, fl, lt, nl,
                                                       chk, g)
            frac, err = scaled_close(d1, rd, BWD_RTOL, BWD_ATOL, FLIP_BUDGET,
                                     f"{label}: bounce_planes_bwd dP b{b}")
            merge("bounce_planes_bwd", lanes_outside=frac, max_abs_err=err,
                  dlt_rel_l2=rel_l2(l1, rl, f"{label}: F' dlt", BWD_REL_L2),
                  dlt_rows_err=rows_close(l1, rl, f"{label}: F' dlt rows"),
                  bitwise_repeat=True)
    return out


def split_bwd_vs_plain(hit_call, su_call, label, seed=5) -> dict:
    """J' and H' against their plain versions on the card on one recorded
    call of J and of H (the same inputs) with seeded cotangents, B's
    budget: dP per lane within BWD_RTOL of its largest plane / BWD_ATOL, at
    most FLIP_BUDGET of the lanes outside; H''s light-table cotangent
    within relative L2 BWD_REL_L2 and each row within BWD_REL_L2 of its
    largest entry. Each runs twice and must give the same bits; J' also on
    ``hit_lanes`` of the call for each odd n of HIT_ODD_N. The cotangents
    are ``torch_parity.split_cots``' (the sphere-UV source's on sphere
    lanes only)."""
    P, kind, flip = hit_call
    S_, mkind, lt, n_lights = su_call
    gh, gs = split_cots(kind, S_.shape[1], seed)
    got = hit_attrs_bwd_kernel(P, kind, flip, gh)
    got_s, got_lt = shade_update_bwd_kernel(S_, mkind, lt, n_lights, gs)
    again = hit_attrs_bwd_kernel(P, kind, flip, gh)
    again_s, again_lt = shade_update_bwd_kernel(S_, mkind, lt, n_lights, gs)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got_s, again_s)
            and torch.equal(got_lt, again_lt)):
        raise AssertionError(f"{label}: two runs of J' or H' differ")
    frac_j, err_j = scaled_close(got, hit_ops.hit_plane_core_vjp(
        P, kind, flip, gh), BWD_RTOL, BWD_ATOL, FLIP_BUDGET,
        f"{label}: hit_attrs_bwd dP")
    odd = {}
    for m in HIT_ODD_N:                 # J' at an odd ray count, twice
        a = hit_lanes(hit_call, m)
        a += (split_cots(a[1], 1, seed)[0],)
        got_m = hit_attrs_bwd_kernel(*a)
        if not torch.equal(got_m, hit_attrs_bwd_kernel(*a)):
            raise AssertionError(f"{label}: two runs of J' at {m} rays "
                                 "differ")
        odd[m] = scaled_close(got_m, hit_ops.hit_plane_core_vjp(*a),
                              BWD_RTOL, BWD_ATOL, FLIP_BUDGET,
                              f"{label}: hit_attrs_bwd dP at {m} rays")
    frac_j = max([frac_j] + [o[0] for o in odd.values()])
    err_j = max([err_j] + [o[1] for o in odd.values()])
    ref_s, ref_lt = bounce_ops.su_plane_core_vjp(S_, mkind, lt, n_lights, gs)
    frac_h, err_h = scaled_close(got_s, ref_s, BWD_RTOL, BWD_ATOL,
                                 FLIP_BUDGET, f"{label}: shade_update_bwd dP")
    return {"hit_attrs_bwd": {"lanes_outside": frac_j, "max_abs_err": err_j,
                              "odd_n": odd, "bitwise_repeat": True},
            "shade_update_bwd": {
                "lanes_outside": frac_h, "max_abs_err": err_h,
                "dlt_rel_l2": rel_l2(got_lt, ref_lt, f"{label}: H' dlt",
                                     BWD_REL_L2),
                "dlt_rows_err": rows_close(got_lt, ref_lt,
                                           f"{label}: H' dlt rows"),
                "bitwise_repeat": True}}


def split_scene_checks(dev) -> dict:
    """Phase 3b: the split route on 64x64 scenes the trace kernel cannot
    take — final_scene (O, J, H), the Cuboid-fog scene and noise beside a
    checker (M, J, H), and the fog scene with solid textures (M, F).
    Each kernel against its plain version on the scene's real bounce-0
    inputs (``split_kernels_vs_plain``; K, M, F, F' on bounces 0 and 1 too),
    and the kernel route's image
    against the plain route's on the card and on the CPU (all three have
    marble noise: every pixel outside RTOL / ATOL counts as a flip, and
    against the host the kernels may be as far off as the card's plain
    route is, plus the budget). Returns the worst error per kernel."""
    worst = {k.name: {"lanes_outside": 0.0, "max_abs_err": 0.0}
             for k in (SPLIT_KERNELS + SPLIT_BWD_KERNELS + SEARCH_KERNELS
                       + FUSED_KERNELS + FUSED_BWD_KERNELS)}
    w = h = 64
    chunk = 4096
    for label, host in (("final_scene", builders.final_scene(1.0)),
                        ("fog", fog_scene()),
                        ("noise_checker", noise_checker_scene()),
                        ("solid_fog", solid_fog_host(S, cam_ops))):
        sd = compile_scene(host, device="cpu")
        sg = sd.to(dev)
        if uber.uber_eligible(sd):
            raise AssertionError(f"{label} is not a split-route scene")
        with torch.no_grad():
            with split_recorder() as rec:
                img_k = render_waves(sg, w, h, rng.key(0, dev), 0, 1,
                                     depth=DEPTH, chunk_size=chunk)
            with split_recorder(plain=True):
                img_pg = render_waves(sg, w, h, rng.key(0, dev), 0, 1,
                                      depth=DEPTH, chunk_size=chunk)
            img_pc = render_waves(sd, w, h, rng.key(0, "cpu"), 0, 1,
                                  depth=DEPTH, chunk_size=chunk)
            torch.cuda.synchronize()
            kern = split_kernels_vs_plain(rec, label)
        for name, r in kern.items():
            worst[name] = {k: max(worst[name][k], r[k]) for k in worst[name]}
        routes = {k: len(v) for k, v in rec.items()}
        vs_gpu = compare(img_k, img_pg, f"{label}: split kernels vs plain "
                         "(cuda)", flip_abs=None)
        host_vs_card = outside_share(img_pg, img_pc)
        vs_cpu = compare(img_k, img_pc, f"{label}: split kernels vs plain "
                         "(cpu)", flip_abs=None,
                         budget=FLIP_BUDGET + host_vs_card)
        emit({"phase": "split_vs_plain", "scene": label,
              "shape": [h, w, 1, DEPTH], "calls": routes, "kernels": kern,
              "image_vs_plain_cuda": vs_gpu, "image_vs_plain_cpu": vs_cpu,
              "plain_cuda_vs_plain_cpu_outside": host_vs_card,
              "mean": float(img_k.mean()),
              "budget": {"flip": "any channel outside rtol/atol",
                         "flip_frac": FLIP_BUDGET, "rtol": RTOL,
                         "atol": ATOL, "vs_cpu": "flip_frac + "
                         "plain_cuda_vs_plain_cpu_outside",
                         "hit_attrs_lanes_outside": 0.0,
                         "shade_update_lanes_outside": FLIP_BUDGET,
                         "quad_search": "winners and t equal",
                         "bwd": {"dP_rtol_of_lane_max": BWD_RTOL,
                                 "dP_atol": BWD_ATOL,
                                 "dP_lanes_outside": FLIP_BUDGET,
                                 "dlt_rel_l2": BWD_REL_L2,
                                 "cotangent": "normal draws, seed 5"}}})
    return worst


def small_scene_checks(dev) -> dict:
    """Phase 3: each kernel against its plain version (on the card and on
    the CPU) on 64x64 scenes; returns the worst errors per kernel
    variant."""
    worst = {v: {"flip_frac": 0.0, "max_abs_err": 0.0}
             for v in ("plain", "noise")}
    worst_b = {v: {"dst_outside": 0.0, "dst_err": 0.0, "duni_rel_l2": 0.0,
                   "dlt_rel_l2": 0.0, "reduce_err": 0.0}
               for v in ("plain", "noise")}
    key = rng.key(0, "cpu")
    for label, host in (("solid", solid_scene()),
                        ("solid_checker", solid_scene(checker=True)),
                        ("cornell_box", builders.cornell_box(1.0)),
                        ("flagship", builders.procedural_flagship()),
                        ("noise", noise_scene()),
                        ("perlin_spheres", builders.perlin_spheres(1.0)),
                        ("rect_light", builders.rect_light(1.0)),
                        ("random", builders.random_scene(1.0))):
        w = h = 64
        chunk = 4096
        sd = compile_scene(host, device="cpu")
        st0, rnd = uber.wave_inputs(sd, rng.wave_key(key, 0), w, h, DEPTH,
                                    chunk)
        ctx_cpu = uber.make_ctx(sd)
        ctx_gpu = uber.make_ctx(sd.to(dev))
        kern_a, kern_b = K.trace_kernel(ctx_gpu), K.trace_bwd_kernel(ctx_gpu)
        var = "noise" if ctx_gpu.has_noise else "plain"

        def image(stf):
            rows = uber.wave_radiance(stf, w, h, chunk)[:w * h]
            return cam_ops.image_from_positions(rows.cpu(), w, h)

        st0_g, rnd_g = st0.to(dev), rnd.to(dev)
        img_k = image(kern_a(st0_g, rnd_g, ctx_gpu, DEPTH))
        img_pg = image(uber.trace_wave_plain(st0_g, rnd_g, ctx_gpu, DEPTH))
        img_pc = image(uber.trace_wave_plain(st0, rnd, ctx_cpu, DEPTH))
        torch.cuda.synchronize()
        budget = {"flip_abs": FLIP_ABS, "flip_frac": FLIP_BUDGET,
                  "rtol": RTOL, "atol": ATOL}
        host_vs_card = None
        if ctx_gpu.has_noise:
            # the marble moves ~50 per unit of the hit point, so the last
            # ulp of a normalisation or a transcendental that two versions
            # round otherwise moves a pixel by less than FLIP_ABS but more
            # than RTOL: every pixel outside RTOL/ATOL counts as a flip, as
            # at full size. Against the host's plain version (the card's
            # sinf/cosf/expf/logf are not the host's) the kernel may be as
            # far off as the card's plain version is, plus the budget
            vs_gpu = compare(img_k, img_pg, f"{label}: kernel vs plain (cuda)",
                             flip_abs=None)
            budget["flip_abs"] = None
            host_vs_card = outside_share(img_pg, img_pc)
            vs_cpu = compare(img_k, img_pc, f"{label}: kernel vs plain (cpu)",
                             flip_abs=None,
                             budget=FLIP_BUDGET + host_vs_card)
            budget["vs_cpu"] = ("pixels outside rtol/atol <= flip_frac + "
                                "plain_cuda_vs_plain_cpu_outside")
        else:
            vs_gpu = compare(img_k, img_pg, f"{label}: kernel vs plain (cuda)")
            vs_cpu = compare(img_k, img_pc, f"{label}: kernel vs plain (cpu)")
        for r in (vs_gpu, vs_cpu):
            worst[var] = {k: max(worst[var][k], r[k]) for k in worst[var]}
        emit({"phase": "kernel_vs_plain", "scene": label,
              "kernel": kern_a.name, "shape": [h, w, 1, DEPTH],
              "vs_plain_cuda": vs_gpu, "vs_plain_cpu": vs_cpu,
              "plain_cuda_vs_plain_cpu_outside": host_vs_card,
              "mean": float(img_k.mean()), "budget": budget})

        # the forward with residuals, then B + bwd_reduce, against the
        # plain versions fed the same residuals and cotangent
        stf_r, hist, kind, idx = kern_a(st0_g, rnd_g, ctx_gpu, DEPTH,
                                        residuals=True)
        _, p_hist, p_kind, p_idx = uber.trace_wave_plain(
            st0_g, rnd_g, ctx_gpu, DEPTH, residuals=True)
        if not torch.equal(stf_r, kern_a(st0_g, rnd_g, ctx_gpu, DEPTH)):
            raise AssertionError(f"{label}: the residual writes changed the "
                                 "forward's result")
        if not (torch.equal(kind[0], p_kind[0])
                and torch.equal(idx[0], p_idx[0])):
            raise AssertionError(f"{label}: bounce-0 winners differ from "
                                 "the plain forward's")
        hist_out = max(scaled_close(hist[b], p_hist[b], RTOL, ATOL,
                                    FLIP_BUDGET, f"{label}: hist[{b}]")[0]
                       for b in range(DEPTH))
        g = torch.from_numpy(np.random.default_rng(5).normal(
            size=tuple(st0.shape)).astype(np.float32)).to(dev)
        got = uber.trace_wave_bwd(hist, rnd_g, kind, idx, ctx_gpu, g)
        again = uber.trace_wave_bwd(hist, rnd_g, kind, idx, ctx_gpu, g)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bitwise:
            raise AssertionError(f"{label}: two backward runs differ")
        ref_g = uber.trace_wave_bwd_plain(hist, rnd_g, kind, idx, ctx_gpu, g)
        ref_c = uber.trace_wave_bwd_plain(hist.cpu(), rnd, kind.cpu(),
                                          idx.cpu(), ctx_cpu, g.cpu())
        # the marble's float32 adjoint is ill-conditioned (on random's
        # r = 1000 ground half of the rays sit beyond 1e-4 of a float64
        # replay), so any rounding that torch's ops on the card do
        # otherwise than on the host is amplified: on a noise scene the
        # kernel may be as far from the host's plain version as the card's
        # plain version is, plus the budget
        host = {"dst_outside": 0.0, "duni_rel_l2": 0.0, "dlt_rel_l2": 0.0,
                "dlt_rows_err": 0.0}
        if ctx_gpu.has_noise:
            host = {"dst_outside": float(lanes_outside(
                        ref_g[0], ref_c[0], BWD_RTOL, BWD_ATOL)[0]
                        .float().mean()),
                    "duni_rel_l2": rel_l2_of(ref_g[1], ref_c[1]),
                    "dlt_rel_l2": rel_l2_of(ref_g[2], ref_c[2]),
                    "dlt_rows_err": rows_close(ref_g[2], ref_c[2],
                                               "plain: card vs host",
                                               rtol=1.0)}
        rows = {}
        for where_, ref in (("cuda", ref_g), ("cpu", ref_c)):
            extra = host if where_ == "cpu" else {k: 0.0 for k in host}
            out, err = scaled_close(got[0], ref[0], BWD_RTOL, BWD_ATOL,
                                    FLIP_BUDGET + extra["dst_outside"],
                                    f"{label}: dst ({where_})")
            rows[where_] = {
                "dst_outside": out, "dst_err": err,
                "duni_rel_l2": rel_l2(got[1], ref[1], f"{label}: duni",
                                      BWD_REL_L2 + extra["duni_rel_l2"]),
                "dlt_rel_l2": rel_l2(got[2], ref[2], f"{label}: dlt",
                                     BWD_REL_L2 + extra["dlt_rel_l2"]),
                "dlt_rows_err": rows_close(
                    got[2], ref[2], f"{label}: dlt rows ({where_})",
                    rtol=BWD_REL_L2 + extra["dlt_rows_err"])}
            worst_b[var] = {k: max(worst_b[var][k], rows[where_].get(k, 0.0))
                            for k in worst_b[var]}
        # bwd_reduce alone against its plain version on the same inputs
        _, contrib, keys, part = kern_b(hist, rnd_g, kind, idx, ctx_gpu, g)
        red_args = (contrib,) + K.reduce_order(keys) + (
            ctx_gpu.uni.shape[0], part)
        red = bwd_reduce_kernel(*red_args)
        red_p = uber.bwd_reduce_plain(*red_args)
        replay_equal(red, red_args, f"{label}: bwd_reduce")
        rel_l2(red[0], red_p[0], f"{label}: bwd_reduce duni", BWD_REL_L2)
        rel_l2(red[1], red_p[1], f"{label}: bwd_reduce dlt", BWD_REL_L2)
        red_err = max(float((a - b).abs().max()) for a, b in zip(red, red_p))
        worst_b[var]["reduce_err"] = max(worst_b[var]["reduce_err"], red_err)
        if not float(got[1].abs().max()) > 0:
            raise AssertionError(f"{label}: duni is all zero")
        scale_grad = None
        if ctx_gpu.has_noise:
            sc = uber.A_COL + uber.mattr_noise_cols(ctx_gpu.has_checker)[0]
            scale_grad = float(got[1][:, sc].abs().max())
            if not scale_grad > 0:
                raise AssertionError(f"{label}: duni's scale column is zero")
        check_sphere_light_rows(ref_c[2], ctx_cpu, label)
        emit({"phase": "bwd_vs_plain", "scene": label,
              "kernel": kern_b.name, "shape": [h, w, 1, DEPTH],
              "hist_lanes_outside": hist_out, "vs_plain": rows,
              "plain_cuda_vs_plain_cpu": host if ctx_gpu.has_noise else None,
              "bwd_reduce_max_abs_err": red_err, "bitwise_repeat": bitwise,
              "duni_scale_col_max_abs": scale_grad,
              "budget": {"dst_rtol_of_lane_max": BWD_RTOL,
                         "dst_atol": BWD_ATOL,
                         "dst_lanes_outside": FLIP_BUDGET,
                         "table_rel_l2": BWD_REL_L2,
                         "table_row_rtol_of_row_max": BWD_REL_L2,
                         "table_row_atol": BWD_ATOL,
                         "vs_cpu_noise": "each budget plus the same measure "
                                         "of plain_cuda_vs_plain_cpu"}})
    return {"fwd": worst, "bwd": worst_b}


def forward_phase(label, host_fn, dev, smi, tris=None) -> dict:
    """The forward render of ``host_fn()`` at full size through
    ``render_waves``: SPP launches of its trace-kernel variant, no plain
    call, a finite image; the glue bitwise against the CPU; the kernel
    against its plain version on one full-size wave; sweep, kernel, glue
    and plain times. With ``tris``, the scene must hold that many
    triangles. Emits ``<label>_forward`` with the scene's triangle and
    sphere counts; returns what the training phase and the kernel rows
    need."""
    scene = compile_scene(host_fn(), device=dev)
    # triangles: the rows with an edge (the pad rows have none)
    tables = {"triangles": int((scene.tri_e1.ne(0).any(1)
                                | scene.tri_e2.ne(0).any(1)).sum()),
              "triangle_rows": scene.n_tris,
              "double_sided": int(scene.tri_double.sum()),
              "spheres": scene.n_spheres, "lights": scene.n_lights}
    if tris is not None and tables["triangles"] != tris:
        raise AssertionError(f"{label}: {tables['triangles']} triangles, "
                             f"expected {tris}")
    key = rng.key(0, dev)
    ctx = uber.make_ctx(scene)
    kern = K.trace_kernel(ctx)
    with PlainCalls() as plain:
        for k in (trace_wave_kernel, trace_wave_noise_kernel):
            k.launches = 0
        with torch.no_grad():
            img = render_waves(scene, WIDTH, HEIGHT, key, 0, SPP,
                               depth=DEPTH, chunk_size=CHUNK)
        torch.cuda.synchronize()
        launches = kern.launches
        other = (trace_wave_noise_kernel if kern is trace_wave_kernel
                 else trace_wave_kernel).launches
    if launches != SPP or other:
        raise AssertionError(f"{launches} launches of {kern.name} and "
                             f"{other} of the other variant, expected {SPP}")
    if plain.calls:
        raise AssertionError("the plain version ran on the main path")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label} image has non-finite pixels")

    # the glue's rays and draws on the card are the CPU's, bit for bit
    st0, rnd = uber.wave_inputs(scene, rng.wave_key(key, 0), WIDTH, HEIGHT,
                                DEPTH, CHUNK)
    st0_c, rnd_c = uber.wave_inputs(
        compile_scene(host_fn(), device="cpu"),
        rng.wave_key(rng.key(0, "cpu"), 0), WIDTH, HEIGHT, DEPTH, CHUNK)
    if not (torch.equal(st0.cpu(), st0_c) and torch.equal(rnd.cpu(), rnd_c)):
        raise AssertionError("camera rays or random draws differ between "
                             "the card and the CPU")

    # the kernel against its plain version at the main path's shape
    full = compare(
        cam_ops.image_from_positions(uber.wave_radiance(
            kern(st0, rnd, ctx, DEPTH), WIDTH, HEIGHT,
            CHUNK)[:WIDTH * HEIGHT], WIDTH, HEIGHT),
        cam_ops.image_from_positions(uber.wave_radiance(
            PlainCalls.real(st0, rnd, ctx, DEPTH), WIDTH, HEIGHT,
            CHUNK)[:WIDTH * HEIGHT], WIDTH, HEIGHT),
        f"{label}: kernel vs plain (cuda)", flip_abs=None)

    with torch.no_grad():
        sweeps = cuda_ms(lambda: render_waves(
            scene, WIDTH, HEIGHT, key, 0, SPP, depth=DEPTH,
            chunk_size=CHUNK), 7)
    kernel_ms = cuda_ms(lambda: kern(st0, rnd, ctx, DEPTH), 10)
    glue_ms = cuda_ms(lambda: uber.wave_inputs(
        scene, rng.wave_key(key, 0), WIDTH, HEIGHT, DEPTH, CHUNK), 10)
    plain_ms = cuda_ms(lambda: PlainCalls.real(st0, rnd, ctx, DEPTH), 3)
    med = median(sweeps)
    lane_bounces = WIDTH * HEIGHT * SPP * DEPTH
    k_med = median(kernel_ms)
    p_med = median(plain_ms)
    emit({"phase": f"{label}_forward", "card": smi, "kernel": kern.name,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "tables": tables,
          "kernel_launches": launches, "plain_calls": len(plain.calls),
          "image_mean": float(img.mean()) / SPP,
          "glue_bitwise_vs_cpu": True, "kernel_vs_plain": full,
          "kernel_vs_plain_budget": {
              "flip": "any channel outside rtol/atol",
              "flip_frac": FLIP_BUDGET, "rtol": RTOL, "atol": ATOL},
          "sweep_ms_median": med, "sweep_ms_min": min(sweeps),
          "sweep_ms_max": max(sweeps), "sweeps": len(sweeps),
          "fwd_mrays_per_s": lane_bounces / (med / 1e3) / 1e6,
          "kernel_ms_per_wave_median": k_med,
          "kernel_ms_per_wave_min": min(kernel_ms),
          "kernel_ms_per_wave_max": max(kernel_ms),
          "glue_ms_per_wave_median": median(glue_ms),
          "plain_ms_per_wave_median": p_med,
          "plain_ms_per_wave_min": min(plain_ms),
          "plain_ms_per_wave_max": max(plain_ms)})
    return {"scene": scene, "key": key, "ctx": ctx, "st0": st0, "rnd": rnd,
            "full": full, "k_med": k_med, "p_med": p_med}


def train_phase(label, fwd, dev, smi, nonzero_keys, any_keys,
                zero_keys=()) -> dict:
    """``bench.py``'s training step on the forward phase's scene: SPP
    launches each of A, B and bwd_reduce (their variants for the scene),
    no plain call, finite gradients bitwise equal over two steps, non-zero
    at every ``nonzero_keys`` and somewhere among ``any_keys``, absent or
    zero at ``zero_keys``; step times, the per-wave parts, a profiler
    window, and B + bwd_reduce against the plain backward on one
    full-size wave. Emits ``<label>_train``; returns the kernel rows'
    inputs."""
    scene, key, ctx = fwd["scene"], fwd["key"], fwd["ctx"]
    st0, rnd = fwd["st0"], fwd["rnd"]
    kern_a, kern_b = K.trace_kernel(ctx), K.trace_bwd_kernel(ctx)
    params, static = partition(scene)

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0,
                            SPP, depth=DEPTH, chunk_size=CHUNK).mean()
        loss.backward()
        return loss, {k: v.grad for k, v in leaves.items()}

    kernels = (trace_wave_kernel, trace_wave_noise_kernel,
               trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel,
               bwd_reduce_kernel)
    with PlainCalls() as plain:
        for k in kernels:
            k.launches = 0
        loss, grads = step()
        torch.cuda.synchronize()
        all_launches = {k.name: k.launches for k in kernels}
        _, grads2 = step()
        torch.cuda.synchronize()
    train_launches = {k.name: all_launches.pop(k.name)
                      for k in (kern_a, kern_b, bwd_reduce_kernel)}
    if train_launches != {kern_a.name: SPP, kern_b.name: SPP,
                          "bwd_reduce": SPP} or any(all_launches.values()):
        raise AssertionError(f"training launches {train_launches}, other "
                             f"variants {all_launches}")
    if plain.calls:
        raise AssertionError(f"plain versions ran on the training path: "
                             f"{plain.calls}")
    for k in zero_keys:
        if grads[k] is not None and bool(grads[k].any()):
            raise AssertionError(f"{k} took a gradient")
    grads = {k: v for k, v in grads.items() if v is not None}
    for k, v in grads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite gradient of {k}")
        if not torch.equal(v, grads2[k]):
            raise AssertionError(f"gradient of {k} differs between steps")
    some = {k: float(grads[k].abs().max()) for k in any_keys if k in grads}
    nonzero = {k: float(grads[k].abs().max()) for k in nonzero_keys
               if k in grads}
    if len(nonzero) < len(nonzero_keys) or min(nonzero.values()) <= 0 or \
            not any(v > 0 for v in some.values()):
        raise AssertionError(f"zero gradients: {nonzero} {some}")

    torch.cuda.reset_peak_memory_stats(dev)
    steps_ms = cuda_ms(step, 7)
    peak = torch.cuda.max_memory_allocated(dev)
    step_med = median(steps_ms)
    # per-wave parts at the same shapes
    g_st = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32)).to(dev)
    _, hist, kind, idx = kern_a(st0, rnd, ctx, DEPTH, residuals=True)
    a_res_ms = loop_ms(lambda: kern_a(st0, rnd, ctx, DEPTH, residuals=True),
                       5)
    b_ms = loop_ms(lambda: kern_b(hist, rnd, kind, idx, ctx, g_st))
    with torch.no_grad():
        b_cold = cold_ms(lambda: kern_b(hist, rnd, kind, idx, ctx, g_st))
    _, contrib, keys, part = kern_b(hist, rnd, kind, idx, ctx, g_st)
    p_rows = ctx.uni.shape[0]
    order_ms = loop_ms(lambda: K.reduce_order(keys))
    skeys, perm = K.reduce_order(keys)
    red_args = (contrib, skeys, perm, p_rows, part)
    red_ms = loop_ms(lambda: bwd_reduce_kernel(*red_args))
    red_plain_ms = loop_ms(lambda: uber.bwd_reduce_plain(*red_args))
    found = skeys < p_rows
    m_found = int(found.sum())
    found_rows = skeys[found].long()
    found_contrib = contrib.reshape(-1, contrib.shape[-1])[
        perm[found].long()]
    lib_red_ms = loop_ms(lambda: torch.zeros_like(ctx.uni).index_add_(
        0, found_rows, found_contrib))
    # the profiler's names: the template instances of the noise variants
    names = (("trace_wave_kernel<true>", "trace_wave_bwd_kernel<true>")
             if ctx.has_noise else
             ("trace_wave_kernel", "trace_wave_bwd_kernel"))
    prof = profile_device(step, names + ("bwd_reduce_kernel",))
    red = bwd_reduce_kernel(*red_args)
    red_p = uber.bwd_reduce_plain(*red_args)
    replay_equal(red, red_args, f"{label}: bwd_reduce")
    red_vs_f64 = within_float64(red[0], found_rows, found_contrib, p_rows,
                                f"{label}: bwd_reduce")
    red_full_err = max(float((a - b).abs().max()) for a, b in zip(red, red_p))
    rel_l2(red[0], red_p[0], f"{label}: bwd_reduce duni", BWD_REL_L2)
    rel_l2(red[1], red_p[1], f"{label}: bwd_reduce dlt", BWD_REL_L2)
    bwd_k = K.trace_backward(hist, rnd, kind, idx, ctx, g_st)
    bwd_p = PlainCalls.real_bwd(hist, rnd, kind, idx, ctx, g_st)
    full_b_out, full_b_err = scaled_close(bwd_k[0], bwd_p[0], BWD_RTOL,
                                          BWD_ATOL, FLIP_BUDGET,
                                          f"{label}: dst")
    full_b_l2 = rel_l2(bwd_k[1], bwd_p[1], f"{label}: duni", BWD_REL_L2)
    full_dlt_l2 = rel_l2(bwd_k[2], bwd_p[2], f"{label}: dlt", BWD_REL_L2)
    full_dlt_rows = rows_close(bwd_k[2], bwd_p[2], f"{label}: dlt rows")
    check_sphere_light_rows(bwd_p[2], ctx, label)
    bwd_plain_ms = cuda_ms(lambda: PlainCalls.real_bwd(hist, rnd, kind, idx,
                                                       ctx, g_st), 2)
    a_res_med, b_med, red_med = (median(x) for x in (a_res_ms, b_ms, red_ms))
    order_med = median(order_ms)
    glue_wave = step_med / SPP - (a_res_med + b_med + order_med + red_med)
    lane_bounces = WIDTH * HEIGHT * SPP * DEPTH
    emit({"phase": f"{label}_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "loss": float(loss.detach()), "launches": train_launches,
          "plain_calls": len(plain.calls), "grads_finite": True,
          "grads_bitwise_repeat": True, "grad_max_abs": nonzero,
          "some_grad_max_abs": some,
          "no_grad": {k: None for k in zero_keys},
          "step_ms_median": step_med, "step_ms_min": min(steps_ms),
          "step_ms_max": max(steps_ms), "steps": len(steps_ms),
          "fwd_bwd_mrays_per_s": lane_bounces / (step_med / 1e3) / 1e6,
          "peak_memory_bytes": peak,
          "ms_per_wave": {
              kern_a.name: fwd["k_med"],
              f"{kern_a.name}_with_residuals": a_res_med,
              kern_b.name: b_med,
              f"{kern_b.name}_l2_flushed": median(b_cold),
              "reduce_order_sort": order_med,
              "bwd_reduce": red_med, "bwd_reduce_plain": median(red_plain_ms),
              "index_add_yardstick": median(lib_red_ms),
              "glue_rest_of_step": glue_wave,
              "trace_wave_bwd_plain": median(bwd_plain_ms)},
          "bwd_vs_plain": {"dst_outside": full_b_out, "dst_err": full_b_err,
                           "duni_rel_l2": full_b_l2,
                           "dlt_rel_l2": full_dlt_l2,
                           "dlt_rows_err": full_dlt_rows,
                           "dlt_rows": bwd_k[2].tolist(),
                           "bwd_reduce_max_abs_err": red_full_err,
                           "bwd_reduce_replay_bitwise": True,
                           "bwd_reduce_err_over_float64_magnitude":
                               red_vs_f64},
          "profiled_step": prof,
          "found_ray_bounces": m_found,
          "noise_ray_bounces": noise_hits(hist, kind, idx, ctx),
          "largest_row_contributions": int(torch.bincount(
              found_rows, minlength=p_rows).max())})
    return {"launches": train_launches, "prof": prof, "hist": hist,
            "kind": kind, "idx": idx, "part": part,
            "m_found": m_found, "a_res_med": a_res_med, "b_med": b_med,
            "b_cold": median(b_cold),
            "red_med": red_med, "red_plain_ms": median(red_plain_ms),
            "lib_red_ms": median(lib_red_ms),
            "bwd_plain_ms": median(bwd_plain_ms), "full_b_err": full_b_err,
            "red_full_err": red_full_err, "names": names}


def quad_vs_plain(calls, label) -> dict:
    """Kernel O on every recorded call (each bounce of a wave): winners and
    t equal to ``_quad_candidates``' and to ``ops/quad.quad_sweep_replay``'s
    (its sweep replayed in torch on the card) on every lane. Returns the
    replay's work summed over the calls: the live rays, the warps that
    sweep and their (warp, cluster) pairs, ``tests`` / ``ab_tests`` (a
    live ray's tests under its warp's vote, and those where t could win:
    what the kernel makes) and ``ray_tests`` / ``ray_ab_tests`` (each ray
    alone testing the clusters it enters: what the data needs)."""
    work = {}
    for b, (sc, o, d, t_min, t_max) in enumerate(c[:5] for c in calls):
        rays = torch.cat([o, d, t_min[:, None], t_max[:, None]],
                         1).contiguous()
        tab = quad_ops.quad_table(sc)
        lo = sc.quad_cluster_min.contiguous()
        hi = sc.quad_cluster_max.contiguous()
        got_t, got_i = quad_search_kernel(rays, tab, lo, hi)
        ref_t, ref_i = quad_ops._quad_candidates(sc, o, d, t_min, t_max)
        rep_t, rep_i, w = quad_ops.quad_sweep_replay(rays, tab, lo, hi)
        for what, t_, i_ in (("plain version's", ref_t, ref_i),
                             ("sweep replay's", rep_t, rep_i)):
            if not (torch.equal(got_i.long(), i_) and torch.equal(got_t,
                                                                 t_)):
                bad = int(((got_i.long() != i_) | (got_t != t_)).sum())
                raise AssertionError(f"{label} bounce {b}: quad_search "
                                     f"differs from the {what} on {bad} "
                                     "rays")
        for k, v in w.items():
            work[k] = work.get(k, 0) + v
    return work


def split_rows(fwd, worst_small) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of O, J and H from the final_scene
    forward: launches on the main path; device ms per launch with the
    inputs out of L2 (``cold_ms``; ``ms_in_path`` is the profiler's, where
    the glue has just written them), plain ms, both averaged over the
    wave's bounces on their recorded inputs; and the bound of one launch
    averaged over the same bounces."""
    calls, n_w = fwd["calls"], DEPTH
    o_bytes = sum((c[1].shape[0] * (8 + 2) + c[0].n_quads * 9
                   + c[0].quad_cluster_min.numel() * 2) * 4
                  for c in calls["quad"])
    qw = fwd["quad_work"]
    j_bytes, j_ops = hit_bytes(calls["hit"])
    h_bytes, h_ops = su_fwd_bytes(calls["su"])
    src = "rust_ray_tracer_tpu_torch/csrc/split.cu"
    spec = (("quad_search", "rust_ray_tracer_tpu/ops/pallas_quad.py:121",
             o_bytes, qw["ray_tests"] * OPS_QUAD_T
             + qw["ray_ab_tests"] * OPS_QUAD_IN),
            ("hit_attrs", "rust_ray_tracer_tpu/ops/pallas_hit.py:218",
             j_bytes, j_ops),
            ("shade_update", "rust_ray_tracer_tpu/ops/pallas_bounce.py:678",
             h_bytes, h_ops))
    rows = []
    for name, repl, nb, ops in spec:
        b_ms, b_by = bound(nb / n_w, ops / n_w)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": fwd["launches"][name],
                     "max_abs_err": max(worst_small[name]["max_abs_err"],
                                        fwd["full"][name]["max_abs_err"]),
                     "ms": fwd["ms"][name],
                     "ms_in_path": fwd["ms_in_path"][name],
                     "plain_ms": fwd["plain_ms"][name],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "bytes_per_launch": nb / n_w,
                     "operations_per_launch": ops / n_w})
    rows[0]["work_per_launch"] = {k: v / n_w for k, v in qw.items()}
    rows[1]["ptxas"] = hit_ptxas("hit_attrs_kernel",
                                 calls["hit"][0][0].shape[1])
    rows[2]["ptxas"] = kernel_ptxas("shade_update_kernel")
    rows[0]["bound_ms_per_warp_vote"] = bound(
        o_bytes / n_w, (qw["tests"] * OPS_QUAD_T
                        + qw["ab_tests"] * OPS_QUAD_IN) / n_w)[0]
    return rows


# ---- the split route's phases: one skeleton for the forward and one for
# bench.py's training step, shared by final_scene, the mesh, random with the
# earth map and the 9-light glTF flagship -----------------------------------

def main_path_forward(label, render, on_path, off_path, per_kernel=None):
    """The main path's forward: the counts of ``on_path`` and ``off_path``
    set to 0 just before ``render(SPP)`` runs under :class:`PlainCalls`
    and read just after. Fails unless each kernel of ``on_path`` launched
    ``per_kernel`` (default SPP * DEPTH) times and none of ``off_path``
    did, no plain version ran, and the image is finite and of the bench
    shape. Returns (image, launches, plain calls)."""
    watched = on_path + off_path
    with PlainCalls() as plain:
        for k in watched:
            k.launches = 0
        img = render(SPP)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
    want = {k.name: 0 for k in off_path}
    want.update({k.name: per_kernel or SPP * DEPTH for k in on_path})
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    if plain.calls:
        raise AssertionError(f"plain versions ran on the main path: "
                             f"{sorted(set(plain.calls))}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"{label} image: wrong shape or non-finite")
    return img, launches, len(plain.calls)


def rate_fields(prefix, times_ms) -> dict:
    """Median, min and max of per-call ``times_ms`` of SPP waves, and the
    Mrays/s (ray-bounces a second) of each."""
    lane_bounces = WIDTH * HEIGHT * SPP * DEPTH
    med = median(times_ms)
    return {f"{prefix}_ms_median": med, f"{prefix}_ms_min": min(times_ms),
            f"{prefix}_ms_max": max(times_ms),
            f"{prefix}s": len(times_ms),
            "mrays": lane_bounces / (med / 1e3) / 1e6,
            "mrays_min": lane_bounces / (max(times_ms) / 1e3) / 1e6,
            "mrays_max": lane_bounces / (min(times_ms) / 1e3) / 1e6}


def forward_timing(render, names, reps, dev) -> dict:
    """``reps`` sweeps of ``render(SPP)`` timed by CUDA events, their peak
    memory, and one profiled wave: per kernel (``names``: row name ->
    profiler name) ms per launch and per wave, the glue's ms a wave (the
    wave less its kernels; None where the profiler saw no launch of one)
    and its share, the busy share. Returns the phase's fields and the
    in-path ms per launch."""
    torch.cuda.reset_peak_memory_stats(dev)
    sweeps = cuda_ms(lambda: render(SPP), reps)
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profile_device(lambda: render(1), tuple(names.values()), top=10)
    per = prof["per_kernel"] or {}
    in_path = {n: (per.get(k) or {}).get("ms_per_launch")
               for n, k in names.items()}
    r = rate_fields("sweep", sweeps)
    wave_ms = r["sweep_ms_median"] / SPP
    kern_wave = (None if None in in_path.values()
                 else sum(in_path[n] * DEPTH for n in names))
    glue = None if kern_wave is None else wave_ms - kern_wave
    return {"fields": {
        **{k: v for k, v in r.items() if k.startswith("sweep")},
        "fwd_mrays_per_s": r["mrays"], "fwd_mrays_per_s_min": r["mrays_min"],
        "fwd_mrays_per_s_max": r["mrays_max"], "peak_memory_bytes": peak,
        "ms_per_wave": {**{n: None if in_path[n] is None
                           else in_path[n] * DEPTH for n in names},
                        "glue": glue, "wave": wave_ms},
        "glue_share": None if glue is None else glue / wave_ms,
        "ms_per_launch_profiler": in_path, "profiled_wave": prof},
        "in_path": in_path}


def bounce_times(pairs, plain_reps=3, loop=False) -> dict:
    """Device ms per launch of a kernel and of its plain version on each
    recorded bounce (``pairs``: (kernel, plain) callables; a plain of None
    is not timed): the kernel out of L2 (``cold``), in a back-to-back
    loop with ``loop``, the plain version over ``plain_reps`` calls."""
    with torch.no_grad():
        out = {"cold": [median(cold_ms(k)) for k, _ in pairs]}
        if loop:
            out["loop"] = [median(loop_ms(k)) for k, _ in pairs]
        out["plain"] = [median(cuda_ms(p, plain_reps)) for _, p in pairs
                        if p is not None]
    return out


def light_sum_call(part):
    """A call of B' (``bwd_reduce``) on a backward kernel's light-table
    partials ``part`` alone, its empty row inputs made once."""
    dev = part.device
    none = torch.empty((0,), dtype=torch.int32, device=dev)
    rows = torch.empty((0, 1), dtype=torch.float32, device=dev)
    return lambda: bwd_reduce_kernel(rows, none, none, 0, part)


def main_path_train(label, scene, key, on_path, off_path, nonzero_keys,
                    names, fwd_names, bwd_names, reps, dev, compact=False,
                    per_kernel=None, splits=3) -> dict:
    """``bench.py``'s training step on ``scene`` at the bench shape: ``loss
    = mean(render_waves(...))``, ``backward()`` over every float leaf of
    ``partition`` (through the compact wavefront with ``compact``). The
    counts set to 0 just before the first of two steps under
    :class:`PlainCalls` and read just after it: ``per_kernel`` (default
    SPP * DEPTH) launches of each kernel of ``on_path``, none of
    ``off_path``, B' (``bwd_reduce``) more than that (the backward
    kernels' light-table partials and the glue's row sums), no plain call;
    gradients finite, bitwise equal over the two steps, non-zero on
    ``nonzero_keys``. Then ``reps`` timed steps and their peak memory,
    ``splits`` steps' forward and backward apart, and a profiled one-wave
    step
    (``names``: row name -> profiler name; the glue's ms a wave in the
    forward and the backward from the kernels of ``fwd_names`` and
    ``bwd_names`` and B'). Returns the phase's fields, the in-path ms per
    launch, the gradients and the step."""
    params, static = partition(scene)

    def run(n_waves):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0,
                            n_waves, depth=DEPTH, chunk_size=CHUNK,
                            compact=compact).mean()
        return loss, leaves

    def step(n_waves=SPP):
        loss, leaves = run(n_waves)
        loss.backward()
        return loss, {k: v.grad for k, v in leaves.items()}

    watched = on_path + off_path + (bwd_reduce_kernel,)
    with PlainCalls() as plain:
        for k in watched:
            k.launches = 0
        loss, grads = step()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
        _, grads2 = step()
        torch.cuda.synchronize()
    per_kernel = per_kernel or SPP * DEPTH
    want = {k.name: 0 for k in off_path}
    want.update({k.name: per_kernel for k in on_path})
    want["bwd_reduce"] = launches["bwd_reduce"]
    if launches != want or launches["bwd_reduce"] <= per_kernel:
        raise AssertionError(f"{label} training launches {launches}, "
                             f"expected {want}")
    if plain.calls:
        raise AssertionError(f"plain versions ran on the training path: "
                             f"{sorted(set(plain.calls))}")
    grads = {k: v for k, v in grads.items() if v is not None}
    for k, v in grads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite gradient of {k}")
        if not torch.equal(v, grads2[k]):
            raise AssertionError(f"gradient of {k} differs between steps")
    nonzero = {k: float(grads[k].abs().max()) for k in nonzero_keys}
    if min(nonzero.values()) <= 0:
        raise AssertionError(f"zero gradients: {nonzero}")

    torch.cuda.reset_peak_memory_stats(dev)
    steps_ms = cuda_ms(step, reps)
    peak = torch.cuda.max_memory_allocated(dev)
    # the forward (with the graph) and the backward of a step, apart
    fwd_ms, bwd_ms = [], []
    for _ in range(splits):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss_t, _ = run(SPP)
        e[1].record()
        loss_t.backward()
        e[2].record()
        torch.cuda.synchronize()
        fwd_ms.append(e[0].elapsed_time(e[1]))
        bwd_ms.append(e[1].elapsed_time(e[2]))
        del loss_t
    names = {**names, "bwd_reduce": "bwd_reduce_kernel"}
    prof = profile_device(lambda: step(1), tuple(names.values()), top=15)
    per = prof["per_kernel"] or {}
    in_path = {n: (per.get(k) or {}).get("ms_per_launch")
               for n, k in names.items()}
    red = per.get("bwd_reduce_kernel") or {}
    red_wave = (None if red.get("ms_per_launch") is None
                else red["ms_per_launch"] * red["launches"])
    wave_k = {n: None if in_path[n] is None else in_path[n] * DEPTH
              for n in names if n != "bwd_reduce"}
    fwd_wave, bwd_wave = median(fwd_ms) / SPP, median(bwd_ms) / SPP
    fwd_k = [wave_k[n] for n in fwd_names]
    bwd_k = [wave_k[n] for n in bwd_names] + [red_wave]
    r = rate_fields("step", steps_ms)
    fields = {
        "loss": float(loss.detach()), "launches": launches,
        "plain_calls": len(plain.calls), "grads_finite": True,
        "grads_bitwise_repeat": True, "grad_max_abs": nonzero,
        "leaves_with_grad": sorted(k for k, v in grads.items()
                                   if bool(v.any())),
        **{k: v for k, v in r.items() if k.startswith("step")},
        "fwd_bwd_mrays_per_s": r["mrays"],
        "fwd_bwd_mrays_per_s_min": r["mrays_min"],
        "fwd_bwd_mrays_per_s_max": r["mrays_max"],
        "peak_memory_bytes": peak,
        "ms_per_wave": {
            "forward": fwd_wave, "backward": bwd_wave,
            "glue_forward": None if None in fwd_k else fwd_wave - sum(fwd_k),
            "glue_backward": None if None in bwd_k
            else bwd_wave - sum(bwd_k),
            **wave_k, "bwd_reduce": red_wave},
        "ms_per_launch_profiler": in_path, "profiled_one_wave_step": prof}
    return {"fields": fields, "in_path": in_path, "launches": launches,
            "grads": grads, "step": step}


def final_forward(dev, smi) -> dict:
    """The serving path on the split route: final_scene at the bench shape
    through ``render_waves`` — DEPTH launches each of O, J and H a wave,
    none of the trace kernel, no plain call, a finite image; then one
    full-size wave against the plain route on the card and each kernel
    against its plain version on that wave's bounce-0 inputs; sweep times;
    per-wave kernel and glue ms and the busy share from the profiler; each
    kernel's ms per launch with its inputs out of L2, in a loop and in
    the wave, and its plain version's, on every bounce's recorded inputs.
    Emits ``final_forward``; returns what the kernel rows need."""
    scene = compile_scene(builders.final_scene(WIDTH / HEIGHT), device=dev)
    key = rng.key(0, dev)

    def render(n_waves):
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, n_waves,
                                depth=DEPTH, chunk_size=CHUNK)

    img, launches, n_plain = main_path_forward(
        "final_scene", render, SPLIT_KERNELS,
        (trace_wave_kernel, trace_wave_noise_kernel))

    # one full-size wave: kernels against the plain route on the card, and
    # each kernel against its plain version on the wave's bounce-0 inputs
    with split_recorder() as rec:
        wave_k = render(1)
    with split_recorder(plain=True):
        wave_p = render(1)
    full_img = compare(wave_k, wave_p, "final_scene: split kernels vs plain "
                       "(cuda)", flip_abs=None)
    with torch.no_grad():
        full = split_kernels_vs_plain(rec, "final_scene full size")
        quad_work = quad_vs_plain(rec["quad"], "final_scene full size")

    timing = forward_timing(render, {n: f"{n}_kernel" for n in (
        "quad_search", "hit_attrs", "shade_update")}, 7, dev)
    # each kernel and its plain version on every bounce's recorded inputs
    qtab = quad_ops.quad_table(scene)
    cl_min = scene.quad_cluster_min.contiguous()
    cl_max = scene.quad_cluster_max.contiguous()

    def quad_runs(c):
        rays = torch.cat([c[1], c[2], c[3][:, None], c[4][:, None]],
                         1).contiguous()
        return (lambda: quad_search_kernel(rays, qtab, cl_min, cl_max),
                lambda: quad_ops._quad_candidates(*c[:5]))

    runs = {"quad_search": [quad_runs(c) for c in rec["quad"]],
            "hit_attrs": [((lambda c=c: hit_attrs_kernel(*c)),
                           (lambda c=c: hit_ops.hit_plane_core(*c)))
                          for c in rec["hit"]],
            "shade_update": [((lambda c=c: shade_update_kernel(*c)),
                              (lambda c=c: bounce_ops.su_plane_core(*c)))
                             for c in rec["su"]]}
    times = {n: bounce_times(pairs, loop=True) for n, pairs in runs.items()}
    ms = {n: statistics.fmean(t["cold"]) for n, t in times.items()}
    plain_ms = {n: statistics.fmean(t["plain"]) for n, t in times.items()}
    emit({"phase": "final_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "tables": {"spheres": scene.n_spheres, "quads": scene.n_quads,
                     "quad_clusters": scene.quad_cluster_min.shape[0],
                     "media": scene.n_media, "lights": scene.n_lights},
          "launches": launches, "launches_per_wave": {
              k.name: launches[k.name] / SPP for k in SPLIT_KERNELS},
          "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "wave_vs_plain_route": full_img, "kernels_vs_plain": full,
          "kernel_vs_plain_budget": {
              "image_flip": "any channel outside rtol/atol",
              "flip_frac": FLIP_BUDGET, "rtol": RTOL, "atol": ATOL,
              "quad_search": "winners and t equal",
              "hit_attrs_lanes_outside": 0.0,
              "shade_update_lanes_outside": FLIP_BUDGET},
          **timing["fields"],
          "ms_per_launch_looped_events": {
              n: statistics.fmean(t["loop"]) for n, t in times.items()},
          "ms_per_launch_l2_flushed": ms,
          "plain_ms_per_launch": plain_ms,
          "quad_search_every_bounce": {
              "winners_equal_plain_and_replay": True, "work": quad_work}})
    return {"launches": launches, "full": full, "ms": ms,
            "quad_work": quad_work,
            "ms_in_path": timing["in_path"], "plain_ms": plain_ms,
            "calls": rec, "scene": scene, "key": key}


def final_train(dev, smi, fwd) -> dict:
    """``bench.py``'s training step on final_scene at the bench shape on
    the split route (:func:`main_path_train`): per step SPP * DEPTH
    launches each of O, J, H, J' and H', none of A or B, B'
    (``bwd_reduce``) once for each H' (its light-table partials) and for
    the row sums of the glue's gathers (``ops/gather.rows``), no plain
    call; gradients finite, bitwise equal over two steps, non-zero on
    ``tex_color`` and ``background`` (JAX's at this scene's size); the
    step's rate (7 timed steps), its forward and backward apart, a
    profiled one-wave step, the peak memory; every row sum of a one-wave
    step's glue gathers against float64 (``row_sums_vs_float64``); then J'
    and H' on every bounce's recorded inputs of one wave with seeded
    cotangents, against their plain versions, timed out of L2 and in a
    loop, H' also without its light-table sum and that sum alone. Emits
    ``final_train``; returns the rows' inputs."""
    scene, key = fwd["scene"], fwd["key"]
    fwd_names = ("quad_search", "hit_attrs", "shade_update")
    bwd_names = ("hit_attrs_bwd", "shade_update_bwd")
    t = main_path_train(
        "final_scene", scene, key, SPLIT_KERNELS + SPLIT_BWD_KERNELS,
        WHOLE_WAVE_KERNELS, ("tex_color", "background"),
        {n: f"{n}_kernel" for n in fwd_names + bwd_names}, fwd_names,
        bwd_names, 7, dev)
    launches = t["launches"]
    # B' at the shapes the path gives it: every row sum of a one-wave
    # step's glue gathers against float64
    with RowSumCalls() as sums:
        t["step"](1)
        torch.cuda.synchronize()
    row_sums = row_sums_vs_float64(sums.calls)
    # B''s bound for a one-wave step: the glue's row sums and a light-table
    # sum of H''s partials a bounce
    n = WIDTH * HEIGHT
    light = [(-(-n // 128), (scene.n_lights + 1) * bounce_ops.LT_COLS)
             ] * DEPTH
    red_bound = row_sums_bound(sums.calls, light)
    red_times = row_sum_times(sums.calls, light)
    del sums

    # J' and H' on every bounce's recorded inputs of one full-size wave
    with split_recorder() as rec, torch.no_grad():
        render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                     chunk_size=CHUNK)
    full = {}
    pairs = {"hit_attrs_bwd": [], "shade_update_bwd": []}
    # H' alone, and B''s sum of its light-table partials alone
    h_parts = {"kernel": [], "light_table_sum": []}
    for b, (hc, sc) in enumerate(zip(rec["hit"], rec["su"])):
        r = split_bwd_vs_plain(hc, sc, f"final_scene bounce {b}", seed=11 + b)
        for n_, v in r.items():
            full[n_] = {k: max(full.get(n_, {}).get(k, 0.0), v[k])
                        for k in ("lanes_outside", "max_abs_err")}
        gh, gs = split_cots(hc[1], sc[0].shape[1], 11 + b)
        pairs["hit_attrs_bwd"].append(
            (lambda hc=hc, gh=gh: hit_attrs_bwd_kernel(*hc, gh),
             lambda hc=hc, gh=gh: hit_ops.hit_plane_core_vjp(*hc, gh)))
        pairs["shade_update_bwd"].append(
            (lambda sc=sc, gs=gs: shade_update_bwd_kernel(*sc, gs),
             lambda sc=sc, gs=gs: bounce_ops.su_plane_core_vjp(*sc, gs)))
        part = shade_update_bwd_kernel.partials(*sc, gs)[1]
        h_parts["kernel"].append(
            (lambda sc=sc, gs=gs: shade_update_bwd_kernel.partials(*sc, gs),
             None))
        h_parts["light_table_sum"].append(
            (light_sum_call(part), None))
    times = {n: bounce_times(ps, loop=True) for n, ps in pairs.items()}
    cold = {n: statistics.fmean(v["cold"]) for n, v in times.items()}
    plain_ms = {n: statistics.fmean(v["plain"]) for n, v in times.items()}
    h_cold = {n: statistics.fmean(bounce_times(fs)["cold"])
              for n, fs in h_parts.items()}
    emit({"phase": "final_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          **t["fields"],
          "bwd_reduce_launches": {
              "shade_update_bwd_light_table": SPP * DEPTH,
              "glue_row_sums": launches["bwd_reduce"] - SPP * DEPTH},
          "row_sums_vs_float64": row_sums,
          "bwd_reduce_bound_one_wave_step": red_bound,
          "bwd_reduce_one_wave_step": red_times,
          "bwd_ms_per_launch_l2_flushed": cold,
          "shade_update_bwd_parts_ms_l2_flushed": h_cold,
          "bwd_ms_per_launch_looped_events": {
              n: statistics.fmean(v["loop"]) for n, v in times.items()},
          "bwd_plain_ms_per_launch": plain_ms,
          "bwd_kernels_vs_plain_full_size": full})
    return {"launches": launches, "ms": cold, "ms_in_path": t["in_path"],
            "plain_ms": plain_ms, "full": full, "calls": rec,
            "h_parts": h_cold, "red": {**red_times, **red_bound}}


def split_bwd_rows(train, worst_small) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of J' and H' from the final_scene
    training step: launches on the main path; device ms per launch out of
    L2 (``ms``; H''s with B''s sum of its light-table partials, which the
    plain version's time includes too) and in the step (``ms_in_path``,
    the profiler's; H''s without that sum, None where the profiler saw no
    launch), plain ms, each averaged over a wave's bounces on their
    recorded inputs; and the bound of one launch averaged over the same
    bounces."""
    calls, n_w = train["calls"], DEPTH
    j_bytes, j_ops = hit_bytes(calls["hit"], bwd=True)
    h_bytes, h_ops = su_bwd_bytes(calls["su"])
    src = "rust_ray_tracer_tpu_torch/csrc/split.cu"
    rows = []
    for name, repl, nb, ops in (
            ("hit_attrs_bwd", "rust_ray_tracer_tpu/ops/pallas_hit.py:245",
             j_bytes, j_ops),
            ("shade_update_bwd",
             "rust_ray_tracer_tpu/ops/pallas_bounce.py:705", h_bytes,
             h_ops)):
        b_ms, b_by = bound(nb / n_w, ops / n_w)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": train["launches"][name],
                     "max_abs_err": max(worst_small[name]["max_abs_err"],
                                        train["full"][name]["max_abs_err"]),
                     "ms": train["ms"][name],
                     "ms_in_path": train["ms_in_path"][name],
                     "plain_ms": train["plain_ms"][name],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "bytes_per_launch": nb / n_w,
                     "operations_per_launch": ops / n_w})
    rows[0]["ptxas"] = hit_ptxas("hit_attrs_bwd_kernel",
                                 calls["hit"][0][0].shape[1])
    rows[1]["ms_parts"] = train["h_parts"]
    return rows


def search_work(calls) -> dict:
    """What kernels K and M must do on these recorded calls (one launch
    each a bounce), counted from the data: K's by stage (the live rays'
    inverses, then the (live ray, nonempty box) slab tests) and bytes (the
    rays, through the permutation where the route sorted them, the boxes,
    the entries written once), with its bound per bounce; M's by
    ``tools/search_times.m_work`` on the kernel's winners (which the
    checks hold to the plain version's): per live ray the triangles of
    its tile's entered clusters whose entry is at most its final t, by
    stage, K's full-cull count beside them, the operations and bytes.
    ``per_bounce`` holds each call's counts."""
    w = {"box_tests": 0, "k_live_rays": 0, "k_per_bounce": [],
         "k_bytes": 0, "tri_tests": 0, "t_tests": 0,
         "uv_tests": 0, "full_cull_tests": 0, "sph_tests": 0,
         "quad_tests": 0, "m_ops": 0, "m_bytes": 0, "per_bounce": []}
    for e_args, s_args in zip(calls["enter"], calls["search"]):
        rays, cl_min = e_args[0], e_args[1]
        tabs = s_args[2]
        n = rays.shape[1]
        n_live = int((rays[8] > rays[7]).sum())
        nonempty = int((cl_min <= e_args[2]).all(1).sum())
        w["box_tests"] += n_live * nonempty
        w["k_live_rays"] += n_live
        k_bytes = (8 * n + 6 * cl_min.shape[0] + s_args[1].numel()
                   ) * 4 + (8 * n if len(e_args) > 4 else 0)
        w["k_bytes"] += k_bytes
        w["k_per_bounce"].append({
            "live_rays": n_live, "box_tests": n_live * nonempty,
            "bound_ms": bound(k_bytes, n_live * OPS_K_RAY
                              + n_live * nonempty
                              * search_times.OPS_SLAB)[0]})
        mw = search_times.m_work(s_args,
                                 K.search_kernel(tabs)(*s_args)[0])
        w["tri_tests"] += mw["tests"]
        for k in ("t_tests", "uv_tests", "full_cull_tests"):
            w[k] += mw[k]
        w["sph_tests"] += n_live * tabs.sph.shape[0]
        w["quad_tests"] += n_live * tabs.quad.shape[0]
        w["m_ops"] += mw["ops"]
        w["m_bytes"] += mw["bytes"]
        w["per_bounce"].append(mw)
    w["k_ops"] = (w["k_live_rays"] * OPS_K_RAY
                  + w["box_tests"] * search_times.OPS_SLAB)
    return w


def mesh_forward(dev, smi) -> dict:
    """The mesh workload (``tests/torch_parity.mesh``: 65,536 double-sided
    triangles, 512 clusters of 128, and the flagship's sphere lamp: 16x the
    trace kernel's 4,096 rows) forward on the split route at the bench
    shape: SPP * DEPTH launches each of K, M (the input the gate picks:
    packed from ``ops/search.PACKED_MIN_TRIS``, the mesh's size) and F,
    none of M's other input, A, O, J or H, no plain call, a finite image;
    K, M, F and F' against their plain versions on every bounce's recorded
    inputs of a MESH_W x MESH_H wave and the route's image against the
    plain route's on the card, and on a full-size wave's bounces 0 and 1;
    the sort's permutation on the card against the host's (bounce 1); sweep
    ms, the profiler's per-kernel ms, the glue per wave and the busy share
    of a profiled wave; each kernel's ms per launch out of L2 and its plain
    version's on the full-size wave's recorded inputs; per bounce M out of
    L2 and in the path, the sort's ms, the live rays and tiles, the (tile,
    cluster) pairs K lets through, M's tests by stage and its bound, K's
    full-cull count; ptxas' registers and spills of library ``search``; the
    peak memory of the sweeps. Emits ``mesh_forward``."""
    t0 = time.perf_counter()
    scene = compile_scene(mesh_host(S, cam_ops), device=dev)
    compile_s = time.perf_counter() - t0
    key = rng.key(0, dev)
    if uber.uber_eligible(scene) or scene.n_tris != 65536:
        raise AssertionError("the mesh is not a 65,536-triangle split-route "
                             "scene")
    m_on, m_off = m_variants(scene.n_tris)

    def render(n_waves, w=WIDTH, h=HEIGHT):
        with torch.no_grad():
            return render_waves(scene, w, h, key, 0, n_waves, depth=DEPTH,
                                chunk_size=CHUNK)

    img, launches, n_plain = main_path_forward(
        "mesh", render, (tile_enter_kernel, m_on) + FUSED_KERNELS,
        SPLIT_KERNELS + (m_off, trace_wave_kernel, trace_wave_noise_kernel))

    # every bounce of a small wave: each kernel against its plain version,
    # and the route against the plain route
    with split_recorder() as rec_s:
        small_k = render(1, MESH_W, MESH_H)
    with split_recorder(plain=True):
        small_p = render(1, MESH_W, MESH_H)
    small_img = compare(small_k, small_p, "mesh: kernels vs plain route "
                        f"({MESH_W}x{MESH_H})", flip_abs=None)
    with torch.no_grad():
        small = search_fused_vs_plain(rec_s, "mesh small",
                                      bounces=range(DEPTH))
    # one full-size wave's bounces 0 and 1; the sort's permutation on the
    # card against the host's on bounce 1's rays
    with split_recorder() as rec:
        render(1)
    with torch.no_grad():
        full = search_fused_vs_plain(rec, "mesh full size", bounces=(0, 1))
        full.update(enter_every_bounce(rec, "mesh full size"))
        rays, tabs, chunk = rec["order"][1]
        host = dataclasses.replace(tabs, cl_min=tabs.cl_min.cpu(),
                                   cl_max=tabs.cl_max.cpu())
        perm_equal = torch.equal(
            search_ops.search_order(rays, tabs, chunk).cpu(),
            search_ops.search_order(rays.cpu(), host, chunk))
    if not perm_equal or len(rec["order"]) != DEPTH:
        raise AssertionError("mesh: the sort's permutation on the card "
                             "differs from the host's, or a bounce was not "
                             "sorted")

    m_prof = search_times.m_profiler_name(m_on.packed)
    timing = forward_timing(render, {"tile_enter": "tile_enter_kernel",
                                     m_on.name: m_prof,
                                     "bounce_planes": "bounce_planes_kernel"},
                            5, dev)
    runs = {"tile_enter": [((lambda c=c: tile_enter_kernel(*c)),
                            (lambda c=c: search_ops.tile_enter_plain(*c)))
                           for c in rec["enter"]],
            m_on.name: [((lambda c=c: m_on(*c)),
                         (lambda c=c: search_ops.fused_search_plain(*c)))
                        for c in rec["search"]],
            "bounce_planes": [
                ((lambda c=c: bounce_planes_kernel(*c)),
                 (lambda c=c: bounce_core.bounce_plane_core(
                     *c, c[0].shape[0] > bounce_core.N_IN_B)))
                for c in rec["bp"]]}
    # the plain M takes seconds a full-size bounce: one run each
    times = {n: bounce_times(pairs, 1 if n == m_on.name else 3)
             for n, pairs in runs.items()}
    by_bounce = {n: t["cold"] for n, t in times.items()}
    ms = {n: statistics.fmean(v) for n, v in by_bounce.items()}
    plain_ms = {n: statistics.fmean(t["plain"]) for n, t in times.items()}
    # per bounce: M in the path (the profiler's launches in bounce order),
    # the sort (plain torch, charged to the glue), M's work by stage
    m_path = search_times.device_ms_in_order(lambda: render(1), m_prof)
    with torch.no_grad():
        sort_ms = [median(loop_ms(lambda a=a: search_ops.search_order(*a)))
                   for a in rec["order"]]
        work = search_work(rec)
    per_bounce = [{"live_rays": b["live_rays"], "live_tiles": b["live_tiles"],
                   "tiles_entered": b["pairs"], "tri_tests": b["tests"],
                   "t_tests": b["t_tests"], "uv_tests": b["uv_tests"],
                   "full_cull_tests": b["full_cull_tests"],
                   "m_bound_ms": bound(b["bytes"], b["ops"])[0],
                   "m_ms_l2_flushed": c, "m_ms_in_path": p, "sort_ms": t,
                   "k_box_tests": kb["box_tests"],
                   "k_bound_ms": kb["bound_ms"], "k_ms_l2_flushed": kc}
                  for b, c, p, t, kb, kc in zip(
                      work["per_bounce"], by_bounce[m_on.name], m_path,
                      sort_ms, work["k_per_bounce"], by_bounce["tile_enter"])]
    emit({"phase": "mesh_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "compile_scene_s": compile_s,
          "tables": {"triangles": scene.n_tris,
                     "clusters": scene.tri_cluster_min.shape[0],
                     "spheres": scene.n_spheres, "quads": scene.n_quads,
                     "lights": scene.n_lights,
                     "input": "packed" if m_on.packed else "staged"},
          "launches": launches, "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "small_wave_vs_plain_route": small_img,
          "kernels_vs_plain_small": small,
          "kernels_vs_plain_full_size": full,
          "kernel_vs_plain_budget": {
              "tile_enter": "survivors equal, <= 1 ulp",
              m_on.name: "kinds, indices and t equal",
              "bounce_planes_lanes_outside": FLIP_BUDGET,
              "bwd": {"dP_rtol_of_lane_max": BWD_RTOL, "dP_atol": BWD_ATOL,
                      "dP_lanes_outside": FLIP_BUDGET,
                      "dlt_rel_l2": BWD_REL_L2,
                      "cotangent": "normal draws, seed 5 + bounce"}},
          **timing["fields"],
          "ms_per_launch_l2_flushed": ms,
          "ms_per_bounce_l2_flushed": by_bounce,
          "plain_ms_per_launch": plain_ms,
          "work_per_wave": {k: v for k, v in work.items()
                            if k != "per_bounce"},
          "search_per_bounce": per_bounce,
          "sort_permutation_card_equals_host": perm_equal,
          "ptxas_search": ptxas_report(K.build("search").log)})
    return {"launches": launches, "small": small, "full": full, "ms": ms,
            "ms_per_bounce": by_bounce,
            "ms_in_path": timing["in_path"], "plain_ms": plain_ms,
            "calls": rec, "work": work, "scene": scene, "key": key,
            "sort_ms": statistics.fmean(sort_ms), "m": m_on}


def mesh_train(dev, smi, fwd) -> dict:
    """``bench.py``'s training step on the mesh at the bench shape
    (:func:`main_path_train`): per step SPP * DEPTH launches each of K, M
    (the gate's input), F and F', none of M's other input, A, B, O, J, H,
    J' or H', B' (``bwd_reduce``) once
    for each F' (its light-table partials) and for the glue's row sums, no
    plain call; gradients finite, bitwise equal over two steps, non-zero
    on ``tri_v0``, ``tex_color`` and ``light_c``; the step's rate, its
    forward and backward apart, a profiled one-wave step, the peak memory;
    F' on every bounce's recorded inputs of a full-size wave with a seeded
    cotangent against its plain version, timed out of L2. Emits
    ``mesh_train``."""
    m_on, m_off = m_variants(fwd["scene"].n_tris)
    fwd_names = ("tile_enter", m_on.name, "bounce_planes")
    t = main_path_train(
        "mesh", fwd["scene"], fwd["key"],
        (tile_enter_kernel, m_on) + FUSED_KERNELS + FUSED_BWD_KERNELS,
        SPLIT_KERNELS + SPLIT_BWD_KERNELS + WHOLE_WAVE_KERNELS + (m_off,),
        ("tri_v0", "tex_color", "light_c"),
        {"tile_enter": "tile_enter_kernel",
         m_on.name: search_times.m_profiler_name(m_on.packed),
         "bounce_planes": "bounce_planes_kernel",
         "bounce_planes_bwd": "bounce_planes_bwd_kernel"},
        fwd_names, ("bounce_planes_bwd",), 5, dev)

    # F' on every bounce's recorded inputs of one full-size wave
    calls = fwd["calls"]["bp"]
    pairs = []
    for b, c in enumerate(calls):
        g = torch.from_numpy(np.random.default_rng(11 + b).normal(
            size=(13, c[0].shape[1])).astype(np.float32)).to(dev)
        pairs.append((lambda c=c, g=g: bounce_planes_bwd_kernel(*c, g),
                      lambda c=c, g=g: bounce_core.bounce_plane_core_vjp(
                          *c, c[0].shape[0] > bounce_core.N_IN_B, g)))
    times = bounce_times(pairs)
    with torch.no_grad():
        full = search_fused_vs_plain({"enter": [], "search": [],
                                      "bp": calls}, "mesh full size F'",
                                     bounces=range(len(calls)))
    emit({"phase": "mesh_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          **t["fields"],
          "bounce_planes_bwd_ms_l2_flushed": statistics.fmean(times["cold"]),
          "bounce_planes_bwd_plain_ms": statistics.fmean(times["plain"]),
          "bounce_planes_bwd_vs_plain_full_size": full})
    return {"launches": t["launches"], "ms": statistics.fmean(times["cold"]),
            "ms_in_path": t["in_path"]["bounce_planes_bwd"],
            "plain_ms": statistics.fmean(times["plain"]), "full": full}


def mesh_rows(fwd, train, worst_small) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of K, M (the input the gate gives the
    mesh), F (the mesh forward) and F' (its training step): launches on
    the main path; device ms per launch
    out of L2 (``ms``) and in the path (``ms_in_path``, the profiler's),
    plain ms, each averaged over a full-size wave's bounces on their
    recorded inputs; the bound of one launch averaged over the same
    bounces, from the work this run's data needs."""
    n_w = DEPTH
    work = fwd["work"]
    f_bytes, f_ops = bp_fwd_bytes(fwd["calls"]["bp"])
    fb_bytes, fb_ops = bp_bwd_bytes(fwd["calls"]["bp"])
    src_s = "rust_ray_tracer_tpu_torch/csrc/search.cu"
    src_f = "rust_ray_tracer_tpu_torch/csrc/split.cu"
    spec = (("tile_enter", src_s,
             "rust_ray_tracer_tpu/ops/pallas_intersect.py:262",
             work["k_bytes"], work["k_ops"], fwd),
            (fwd["m"].name, src_s,
             "rust_ray_tracer_tpu/ops/pallas_intersect.py:959",
             work["m_bytes"], work["m_ops"], fwd),
            ("bounce_planes", src_f,
             "rust_ray_tracer_tpu/ops/pallas_bounce.py:337", f_bytes, f_ops,
             fwd),
            ("bounce_planes_bwd", src_f,
             "rust_ray_tracer_tpu/ops/pallas_bounce.py:369", fb_bytes,
             fb_ops, train))
    rows = []
    for name, src, repl, nb, ops, ph in spec:
        b_ms, b_by = bound(nb / n_w, ops / n_w)
        errs = [worst_small[name]["max_abs_err"]] if name in worst_small \
            else []
        for part in ("small", "full"):
            if name in ph.get(part, {}):
                errs.append(ph[part][name]["max_abs_err"])
        ms = ph["ms"][name] if isinstance(ph["ms"], dict) else ph["ms"]
        in_path = (ph["ms_in_path"][name] if isinstance(ph["ms_in_path"],
                                                        dict)
                   else ph["ms_in_path"])
        plain = (ph["plain_ms"][name] if isinstance(ph["plain_ms"], dict)
                 else ph["plain_ms"])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": ph["launches"][name],
                     "max_abs_err": max(errs), "ms": ms,
                     "ms_in_path": in_path, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "bytes_per_launch": nb / n_w,
                     "operations_per_launch": ops / n_w})
    rows[1]["also_replaces"] = ("rust_ray_tracer_tpu/ops/"
                                "pallas_intersect.py:1019")
    rows[1]["tests_per_launch"] = {
        k: work[k] / n_w for k in ("tri_tests", "t_tests", "uv_tests",
                                   "full_cull_tests", "sph_tests",
                                   "quad_tests")}
    rows[1]["sort_ms_per_bounce"] = fwd["sort_ms"]
    if fwd["m"].packed:
        rows[1].update(m_packed_fields())
    rows[0]["box_tests_per_launch"] = work["box_tests"] / n_w
    rows[0]["ms_per_bounce"] = fwd["ms_per_bounce"]["tile_enter"]
    rows[0]["bound_ms_per_bounce"] = [b["bound_ms"]
                                      for b in work["k_per_bounce"]]
    rows[0]["live_rays_per_bounce"] = [b["live_rays"]
                                       for b in work["k_per_bounce"]]
    rows[0]["bitwise"] = all(fwd[p]["tile_enter"]["bitwise"]
                             for p in ("small", "full"))
    return rows


# ---- the million-triangle mesh: M's packed input, clusters of 2,048 -------

def m_variants(n_tris):
    """(M's wrapper the packed input's gate picks for ``n_tris``
    triangles, the other one)."""
    if search_ops.packed_input(n_tris):
        return K.fused_search_packed_kernel, fused_search_kernel
    return fused_search_kernel, K.fused_search_packed_kernel


def chunk_call(args, c=0):
    """A recorded call of M, ``args`` = (rays, ent, tabs, chunk, perm), cut
    to its chunk ``c``: the rays of wave positions [c * chunk, (c + 1) *
    chunk), their tiles' entries and the permutation's segment (the sort
    is segmented by chunk, so it stays inside the chunk)."""
    rays, ent, tabs, chunk, perm = args
    tpc = -(-chunk // search_ops.BC)
    sl = slice(c * chunk, (c + 1) * chunk)
    return (rays[:, sl].contiguous(), ent[c * tpc:(c + 1) * tpc].contiguous(),
            tabs, chunk, (perm[sl] - c * chunk).contiguous())


def winners_differing(got, ref) -> int:
    """Lanes whose (t, kind, index) differ, t by its bits."""
    return int(((got[0].view(torch.int32) != ref[0].view(torch.int32))
                | (got[1] != ref[1]) | (got[2] != ref[2])).sum())


def timed_once(fn):
    """(``fn()``, its device ms by CUDA events): one call, no warm-up."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def table_build(scene, packed, dev) -> dict:
    """The split route's search tables of ``scene`` built with the packed
    or the staged input (``ops/search.search_tables``, the glue of every
    render): ms by CUDA events (median of 3 after a warm-up) and the
    device memory the build takes at its peak above what was allocated."""
    ms = median(cuda_ms(lambda: search_ops.search_tables(scene, packed), 3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tabs = search_ops.search_tables(scene, packed)
    torch.cuda.synchronize()
    return {"ms": ms, "peak_bytes_above": torch.cuda.max_memory_allocated(
        dev) - base, "table_bytes": tabs.tri.numel() * 4}


def bigmesh_forward(dev, smi) -> dict:
    """The million-triangle mesh (``tests/torch_parity.bigmesh``: the mesh
    workload's draws at 1,048,576 single-sided triangles, written as a
    u32 ``.gltf`` with an external ``.bin`` into a temporary directory and
    read back by ``load_gltf_scene``; 512 clusters of 2,048, so each
    cluster is 16 of M's stages) forward on the split route at the bench
    shape: the host seconds to write, load and compile; SPP * DEPTH
    launches each of K, M's packed input (the gate's, from ``ops/search.
    PACKED_MIN_TRIS``) and F, none of the staged input, A, O, J, H or L,
    no plain call, a finite image. On every one of a forward's 16
    recorded calls of M, the packed input's (t, kind, index) against the
    staged input's on every lane, and against the plain version: every
    lane of wave 0's four calls and, for the other twelve, every lane of
    their first chunk (9,216 rays, 36 tiles; the plain sweep of a
    million triangles takes seconds a full call). The probe's rows against
    ``compact_rows(_tri_coeffs(...))`` on the card on all 1,048,576 rows
    (and the host's assembly's rows that differ, counted). The search
    tables' build with each input (ms, memory). Sweep ms, the profiler's
    per-kernel ms, glue per wave, busy share and peak memory; M out of L2
    with each input (in turns) and in the path, a bounce of wave 0; M's
    tests by stage and each input's bound. Emits ``bigmesh_forward``."""
    with tempfile.TemporaryDirectory() as tmp:
        scene, host_s = search_times.bigmesh_scene(dev, BIGMESH_TRIS, tmp)
    k = scene.tri_cluster_min.shape[0]
    if (uber.uber_eligible(scene) or scene.n_tris != BIGMESH_TRIS
            or scene.n_tris // k != BIGMESH_WIDTH):
        raise AssertionError(f"the big mesh: {scene.n_tris} triangles in "
                             f"{k} clusters, not {BIGMESH_TRIS} of "
                             f"{BIGMESH_WIDTH} on the split route")
    key = rng.key(0, dev)
    m_on, m_off = m_variants(scene.n_tris)
    if not m_on.packed:
        raise AssertionError("the big mesh does not take M's packed input")

    def render(n_waves, w=WIDTH, h=HEIGHT):
        with torch.no_grad():
            return render_waves(scene, w, h, key, 0, n_waves, depth=DEPTH,
                                chunk_size=CHUNK)

    img, launches, n_plain = main_path_forward(
        "bigmesh", render, (tile_enter_kernel, m_on) + FUSED_KERNELS,
        SPLIT_KERNELS + (m_off, tri_search_kernel, trace_wave_kernel,
                         trace_wave_noise_kernel))
    with split_recorder() as rec:
        render(SPP)
    calls = rec["search"]
    if len(calls) != SPP * DEPTH or not all(len(a) == 5 for a in calls):
        raise AssertionError("bigmesh: a forward's M calls are not 16 "
                             "sorted ones")
    tables = {"staged": table_build(scene, False, dev),
              "packed": table_build(scene, True, dev)}
    staged = search_ops.search_tables(scene, False)
    packed = search_ops.search_tables(scene, True)
    checks, plain_ms, err = [], [], 0.0
    with torch.no_grad():
        for i, a in enumerate(calls):
            a_s, a_p = a[:2] + (staged,) + a[3:], a[:2] + (packed,) + a[3:]
            gs = fused_search_kernel(*a_s)
            gp = K.fused_search_packed_kernel(*a_p)
            full = i < DEPTH
            sub = a_p if full else chunk_call(a_p)
            got = gp if full else K.fused_search_packed_kernel(*sub)
            ref, p_ms = timed_once(
                lambda sub=sub: search_ops.fused_search_plain(*sub))
            if full:
                plain_ms.append(p_ms)
            fin = torch.isfinite(ref[0])
            if bool(fin.any()):
                err = max(err, float((got[0][fin] - ref[0][fin]).abs().max()))
            checks.append({"call": i, "vs_staged": winners_differing(gp, gs),
                           "vs_plain": winners_differing(got, ref),
                           "plain_lanes": int(got[0].numel()),
                           "hits": int((gp[1] > 0).sum())})
    bad = [c for c in checks if c["vs_staged"] or c["vs_plain"]]
    if bad:
        raise AssertionError(f"bigmesh: M's packed input differs: {bad}")
    # the probe: M's stage copy and assembly on every row
    rows = K.packed_rows_probe_kernel(packed.tri)
    with torch.no_grad():
        ref_rows = search_ops.compact_rows(isect._tri_coeffs(
            scene.tri_v0, scene.tri_e1, scene.tri_e2), scene.tri_double)
    torch.cuda.synchronize()
    probe = {"rows": int(rows.shape[0]),
             "vs_compact_rows": int((rows.view(torch.int32)
                                     != ref_rows.view(torch.int32)).any(1)
                                    .sum()),
             "vs_staged_table": int((rows.view(torch.int32)
                                     != staged.tri.view(torch.int32)).any(1)
                                    .sum()),
             "host_assembly_rows_differing": int(
                 (search_ops.assemble_rows(packed.tri.cpu()).view(torch.int32)
                  != rows.cpu().view(torch.int32)).any(1).sum())}
    if probe["vs_compact_rows"] or probe["vs_staged_table"]:
        raise AssertionError(f"bigmesh: the probe's rows differ: {probe}")

    m_prof = search_times.m_profiler_name(True)
    timing = forward_timing(render, {"tile_enter": "tile_enter_kernel",
                                     m_on.name: m_prof,
                                     "bounce_planes": "bounce_planes_kernel"},
                            3, dev)
    # wave 0's bounces: M with each input out of L2 in turns, in the path,
    # its work by stage
    pairs = [search_times.m_pair_times(
        lambda a=a[:2] + (staged,) + a[3:]: fused_search_kernel(*a),
        lambda a=a[:2] + (packed,) + a[3:]: K.fused_search_packed_kernel(*a))
        for a in calls[:DEPTH]]
    m_path = search_times.device_ms_in_order(lambda: render(1), m_prof)
    work = {"staged": [], "packed": []}
    with torch.no_grad():
        for a in calls[:DEPTH]:
            a_s = a[:2] + (staged,) + a[3:]
            w = search_times.m_work(a_s, fused_search_kernel(*a_s)[0])
            work["staged"].append(w)
            work["packed"].append(search_times.packed_work(w, staged,
                                                           packed))
    per_bounce = [{
        "live_rays": ws["live_rays"], "live_tiles": ws["live_tiles"],
        "tiles_entered": ws["pairs"], "tri_tests": ws["tests"],
        "t_tests": ws["t_tests"], "uv_tests": ws["uv_tests"],
        "full_cull_tests": ws["full_cull_tests"],
        "assemble_ops": wp["assemble_ops"],
        "m_ms_l2_flushed": {x: t[x]["cold"] for x in ("staged", "packed")},
        "m_ms_loop": {x: t[x]["loop"] for x in ("staged", "packed")},
        "m_ms_in_path": p, "plain_ms": pm,
        "bound_ms": {x: {"bytes": bound(w["bytes"], 0)[0],
                         "operations": bound(0, w["ops"])[0]}
                     for x, w in (("staged", ws), ("packed", wp))}}
        for ws, wp, t, p, pm in zip(work["staged"], work["packed"], pairs,
                                    m_path, plain_ms)]
    emit({"phase": "bigmesh_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "host_seconds": host_s,
          "tables": {"triangles": scene.n_tris, "clusters": k,
                     "cluster_width": scene.n_tris // k,
                     "double_sided": int(scene.tri_double.sum()),
                     "spheres": scene.n_spheres, "lights": scene.n_lights,
                     "packed_min_tris": search_ops.PACKED_MIN_TRIS},
          "launches": launches, "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "m_checks": checks,
          "m_vs_plain": "wave 0's calls on every lane, the others' first "
                        f"chunk ({CHUNK} rays)",
          "m_max_abs_err": err, "probe": probe,
          "search_tables_build": tables,
          **timing["fields"],
          "search_per_bounce": per_bounce})
    return {"launches": launches, "scene": scene, "key": key,
            "name": m_on.name, "err": err, "pairs": pairs,
            "in_path": timing["in_path"][m_on.name], "plain_ms": plain_ms,
            "work": work, "host_s": host_s}


def bigmesh_train(dev, smi, fwd) -> dict:
    """``bench.py``'s training step on the million-triangle mesh
    (:func:`main_path_train`): per step SPP * DEPTH launches each of K, M
    (the gate's input), F and F', none of M's other input, A, B, O, J, H,
    J' or H', B' for F''s light-table partials and the glue's row sums,
    no plain call; gradients over every float leaf finite, bitwise equal
    over two steps and non-zero on ``tri_v0``, ``tex_color`` and
    ``light_c``; then one step with M's other input
    (``tools/search_times.pack_gate``): its SPP * DEPTH launches of that
    input and every gradient bitwise the gate's. Step ms, forward and
    backward apart, a profiled one-wave step, peak memory. Emits
    ``bigmesh_train``."""
    scene = fwd["scene"]
    m_on, m_off = m_variants(scene.n_tris)
    fwd_names = ("tile_enter", m_on.name, "bounce_planes")
    t = main_path_train(
        "bigmesh", scene, fwd["key"],
        (tile_enter_kernel, m_on) + FUSED_KERNELS + FUSED_BWD_KERNELS,
        SPLIT_KERNELS + SPLIT_BWD_KERNELS + WHOLE_WAVE_KERNELS + (m_off,),
        ("tri_v0", "tex_color", "light_c"),
        {"tile_enter": "tile_enter_kernel",
         m_on.name: search_times.m_profiler_name(m_on.packed),
         "bounce_planes": "bounce_planes_kernel",
         "bounce_planes_bwd": "bounce_planes_bwd_kernel"},
        fwd_names, ("bounce_planes_bwd",), 2, dev, splits=1)
    before = m_off.launches
    with search_times.pack_gate(not m_on.packed):
        _, grads_o = t["step"]()
    torch.cuda.synchronize()
    other = m_off.launches - before
    differ = [k for k, v in t["grads"].items()
              if not torch.equal(v, grads_o[k])]
    if other != SPP * DEPTH or differ:
        raise AssertionError(f"bigmesh: the step with M's other input "
                             f"launched it {other} times; gradients differ "
                             f"on {differ}")
    emit({"phase": "bigmesh_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          **t["fields"], "other_input": m_off.name,
          "other_input_launches": other,
          "grads_bitwise_other_input": True})
    return {"launches": t["launches"]}


def bigmesh_rows(fwd, train) -> list[dict]:
    """The ``{"kernels": [...]}`` row of M's packed input (the big mesh's
    forward): launches on the main path; device ms per launch out of L2
    (``ms``; the staged input's beside it, timed in turns) and in the
    path, the plain version's, each averaged over wave 0's four calls;
    the bound of one launch over the same calls from this run's data,
    the in-kernel assembly's operations included."""
    n_w = DEPTH
    wp = fwd["work"]["packed"]
    nb = sum(w["bytes"] for w in wp) / n_w
    ops = sum(w["ops"] for w in wp) / n_w
    b_ms, b_by = bound(nb, ops)
    name = K.fused_search_packed_kernel.name
    return [{"name": name, "route": "cuda",
             "source": "rust_ray_tracer_tpu_torch/csrc/search.cu",
             "replaces": "rust_ray_tracer_tpu/ops/pallas_intersect.py:959",
             "also_replaces": "rust_ray_tracer_tpu/ops/pallas_intersect.py:"
                              "1019",
             **m_packed_fields(),
             "launches": fwd["launches"][name],
             "launches_train": train["launches"][name],
             "max_abs_err": fwd["err"],
             "ms": statistics.fmean(p["packed"]["cold"]
                                    for p in fwd["pairs"]),
             "ms_staged_input": statistics.fmean(p["staged"]["cold"]
                                                 for p in fwd["pairs"]),
             "ms_in_path": fwd["in_path"],
             "plain_ms": statistics.fmean(fwd["plain_ms"]),
             "bound_ms": b_ms, "bound_by": b_by,
             "bound_ms_bytes": bound(nb, 0)[0],
             "bound_ms_operations": bound(0, ops)[0],
             "library_ms": None, "bytes_per_launch": nb,
             "operations_per_launch": ops,
             "assemble_ops_per_launch": sum(w["assemble_ops"]
                                            for w in wp) / n_w}]


def m_packed_fields() -> dict:
    """What a kernels row of M's packed input adds: the JAX variant it
    ports and the ptxas lines of its instance and of the probe."""
    return {"variant": "packed=True: _coeffs_from_pack, "
                       "rust_ray_tracer_tpu/ops/pallas_intersect.py:394",
            "ptxas": [r for r in ptxas_report(K.build("search").log)
                      if "ILb1E" in r["function"]
                      or "packed_rows_probe" in r["function"]]}


@contextlib.contextmanager
def earth_map_dir():
    """A temporary working directory holding a procedural EARTH_W x
    EARTH_H ``earthmap.jpg`` (``tests/torch_parity.earth_map``; its bytes
    a PNG from the port's ``encode_png``: the decoders know a format by
    its bytes, as the reference's ``image`` crate does), entered for the
    earth-map phases only and left in a ``finally``, so the earlier phases
    compile random, earth and final_scene without it (solid yellow, on
    their old routes) and no map is left behind. Yields the host's seconds
    to write the map and to decode it, and which decoder ran."""

    try:
        import PIL  # noqa: F401
        decoder = "PIL"
    except ImportError:
        decoder = "rust_ray_tracer_tpu_torch/utils/image.decode_image"
    prev = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_earth_map(tmp, EARTH_W, EARTH_H)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = S.ImageTexture(path=path).load()
        decode_s = time.perf_counter() - t0
        if img is None or img.shape != (EARTH_H, EARTH_W, 3):
            raise AssertionError("the earth map does not decode")
        # the port's own decoder, which ImageTexture takes without PIL
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            own = decode_image(f.read())
        own_s = time.perf_counter() - t0
        if not np.array_equal(own.astype(np.float32) / 255.0, img):
            raise AssertionError("utils/image.decode_image and the "
                                 "texture's decoder disagree")
        os.chdir(tmp)
        try:
            yield {"map": [EARTH_H, EARTH_W], "bytes": os.path.getsize(path),
                   "decoder": decoder, "write_s": write_s,
                   "decode_s": decode_s, "decode_image_s": own_s}
        finally:
            os.chdir(prev)


def cull_vs_plain(calls, label, bounces) -> dict:
    """N and L against their plain versions on the card, on the recorded
    calls (``split_recorder``'s ``sph`` and ``tri``) of ``bounces``: the
    winners' indices equal and t bitwise (inf on the same rays); N also
    against ``ops/sphere.sph_sweep_replay`` (the same) and twice for the
    same bits. Returns each kernel's worst error (0) and the share of rays
    that hit."""
    out = {}
    for key, kern, plain in (
            ("sph", sph_search_kernel, sphere_ops.sph_search_plain),
            ("tri", tri_search_kernel, search_ops.tri_search_plain)):
        for b in bounces:
            if b >= len(calls[key]):
                continue
            got_t, got_i = kern(*calls[key][b])
            refs = [plain(*calls[key][b])]
            if key == "sph":
                refs.append(sphere_ops.sph_sweep_replay(*calls[key][b])[:2])
                again = kern(*calls[key][b])
                if not (torch.equal(again[0].view(torch.int32),
                                    got_t.view(torch.int32))
                        and torch.equal(again[1], got_i)):
                    raise AssertionError(f"{label}: two runs of "
                                         f"{kern.name} differ at bounce {b}")
            for what, (ref_t, ref_i) in zip(("plain version", "replay"),
                                            refs):
                bad = (got_i.long() != ref_i.long()) | (
                    got_t.view(torch.int32) != ref_t.view(torch.int32))
                if bool(bad.any()):
                    raise AssertionError(
                        f"{label}: {kern.name} differs from its {what} on "
                        f"{int(bad.sum())} rays at bounce {b}")
            r = out.setdefault(kern.name, {
                "lanes_outside": 0.0, "max_abs_err": 0.0,
                "winners_equal": True, "t_bitwise": True, "bounces": 0,
                "hit_share": []})
            r["bounces"] += 1
            r["hit_share"].append(float(torch.isfinite(refs[0][0]).float()
                                        .mean()))
            if key == "sph":
                r["replay_equal"] = r["bitwise_repeat"] = True
    return out


def cull_work(calls) -> dict:
    """What N and L must do on these recorded calls (one launch each a
    bounce), counted from the data: N's by stage as
    ``tools/search_times.n_work`` counts them on the replay of its sweep
    (per bounce the live rays; each ray's own box tests, sphere tests and
    positive discriminants, which give the bound; beside them the tile's
    and the warps' votes, the tests the kernel makes and those where a
    lane of the warp has a positive discriminant, which give the warp
    vote's bound, and the per-tile cull's tests), and L's ray-triangle
    tests and operations (``search_work``'s stage count on L's winners,
    no sphere or quad rows; K's full-cull count beside it), and each
    kernel's bytes (the ray planes, the tables and the boxes read once, t
    and the index written once)."""
    sums = ("tests", "root_tests", "box_tests", "tile_tests", "ray_tests",
            "ray_box_tests", "ray_root_tests", "live_rays", "bytes", "ops",
            "warp_ops")
    w = {**{f"n_{k}": 0 for k in sums}, "n_per_bounce": [], "tri_tests": 0,
         "l_bytes": 0, "l_ops": 0, "full_cull_tri_tests": 0}
    for args in calls["sph"]:
        work = search_times.n_work(args)[2]
        for k in sums:
            w[f"n_{k}"] += work[k]
        w["n_per_bounce"].append(work)
    for args in calls["tri"]:
        lw = search_times.m_work(
            (args[0], args[1], search_ops.tri_only(args[2]), args[3]),
            tri_search_kernel(*args)[0])
        w["tri_tests"] += lw["tests"]
        w["l_bytes"] += lw["bytes"]
        w["l_ops"] += lw["ops"]
        w["full_cull_tri_tests"] += lw["full_cull_tests"]
    return w


def earth_checks(dev) -> dict:
    """earth and final_scene with the earth map at 64x64 on the split
    route (the image leaf: J, ``texture_value``, H; final_scene's quads
    by O), the kernel route's image against the plain route's on the card
    (every pixel outside RTOL / ATOL a flip), each kernel against its
    plain version on the scene's bounce-0 inputs. Emits ``earth_checks``
    per scene; returns the worst error per kernel."""
    worst = {}
    w = h = 64
    for label in ("earth", "final_scene"):
        t0 = time.perf_counter()
        sg = compile_scene(builders.get_scene(label, 1.0), device=dev)
        compile_s = time.perf_counter() - t0
        if uber.uber_eligible(sg) or not sg.img_data.shape[0]:
            raise AssertionError(f"{label} does not take the split route "
                                 "with its earth map")
        with torch.no_grad():
            with split_recorder() as rec:
                img_k = render_waves(sg, w, h, rng.key(0, dev), 0, 1,
                                     depth=DEPTH, chunk_size=4096)
            with split_recorder(plain=True):
                img_p = render_waves(sg, w, h, rng.key(0, dev), 0, 1,
                                     depth=DEPTH, chunk_size=4096)
            torch.cuda.synchronize()
            kern = split_kernels_vs_plain(rec, f"{label} earth map")
            kern.update(cull_vs_plain(rec, f"{label} earth map", (0,)))
        for name, r in kern.items():
            worst[name] = {k: max(worst.get(name, {}).get(k, 0.0), r[k])
                           for k in ("lanes_outside", "max_abs_err")}
        emit({"phase": "earth_checks", "scene": label,
              "shape": [h, w, 1, DEPTH], "compile_scene_s": compile_s,
              "images": list(sg.img_data.shape),
              "calls": {k: len(v) for k, v in rec.items()},
              "image_vs_plain_cuda": compare(
                  img_k, img_p, f"{label}: earth map, kernels vs plain",
                  flip_abs=None),
              "kernels": kern, "mean": float(img_k.mean())})
    return worst


def random_earth_forward(dev, smi) -> dict:
    """random with the earth map at the bench shape on the split route
    (its image leaf keeps it off the trace kernel, as in JAX): per wave
    DEPTH launches each of N (1,024 sphere rows, the per-kind branch), J
    and H, none of A, K, M, L, O or F, no plain call, a finite image; N
    against its plain version and ``ops/sphere.sph_sweep_replay`` on
    every bounce of a MESH_W x MESH_H wave and of a full-size wave
    (indices equal, t bitwise, two runs bit for bit), J and H on bounce
    0, the route's images against the plain route's; sweep ms (median,
    min, max of 7), per-wave kernel and glue ms and the busy share by the
    profiler; N's ms per launch out of L2 on every bounce's recorded
    inputs of the full-size wave, in the path, and its plain version's;
    N's work and bound by stage on each bounce. Emits
    ``random_earth_forward``."""
    t0 = time.perf_counter()
    scene = compile_scene(builders.random_scene(WIDTH / HEIGHT), device=dev)
    compile_s = time.perf_counter() - t0
    key = rng.key(0, dev)
    if (uber.uber_eligible(scene) or scene.n_spheres < S.CLUSTER
            or not scene.img_data.shape[0]):
        raise AssertionError("random with the earth map is not an N-route "
                             "scene")

    def render(n_waves, w=WIDTH, h=HEIGHT):
        with torch.no_grad():
            return render_waves(scene, w, h, key, 0, n_waves, depth=DEPTH,
                                chunk_size=CHUNK)

    img, launches, n_plain = main_path_forward(
        "random earth", render,
        (sph_search_kernel, hit_attrs_kernel, shade_update_kernel),
        (tri_search_kernel, quad_search_kernel) + SEARCH_KERNELS
        + FUSED_KERNELS + (trace_wave_kernel, trace_wave_noise_kernel))

    with split_recorder() as rec_s:
        small_k = render(1, MESH_W, MESH_H)
    with split_recorder(plain=True):
        small_p = render(1, MESH_W, MESH_H)
    small_img = compare(small_k, small_p, "random earth: kernels vs plain "
                        f"route ({MESH_W}x{MESH_H})", flip_abs=None)
    with torch.no_grad():
        small = cull_vs_plain(rec_s, "random earth small", range(DEPTH))
    with split_recorder() as rec:
        wave_k = render(1)
    with split_recorder(plain=True):
        wave_p = render(1)
    full_img = compare(wave_k, wave_p, "random earth: kernels vs plain "
                       "route (full size)", flip_abs=None)
    with torch.no_grad():
        full = cull_vs_plain(rec, "random earth full size", range(DEPTH))
        full.update(split_kernels_vs_plain(rec, "random earth full size"))

    timing = forward_timing(render, {n: f"{n}_kernel" for n in (
        "sph_search", "hit_attrs", "shade_update")}, 7, dev)
    times = bounce_times([
        (lambda c=c: sph_search_kernel(*c),
         lambda c=c: sphere_ops.sph_search_plain(*c)) for c in rec["sph"]])
    with torch.no_grad():
        work = cull_work(rec)
    emit({"phase": "random_earth_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "compile_scene_s": compile_s,
          "tables": {"spheres": scene.n_spheres,
                     "sphere_clusters": scene.sph_cluster_min.shape[0],
                     "images": list(scene.img_data.shape)},
          "launches": launches, "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "small_wave_vs_plain_route": small_img,
          "wave_vs_plain_route": full_img,
          "kernels_vs_plain_small": small,
          "kernels_vs_plain_full_size": full,
          "kernel_vs_plain_budget": {
              "sph_search": "indices equal, t bitwise",
              "hit_attrs_lanes_outside": 0.0,
              "shade_update_lanes_outside": FLIP_BUDGET,
              "image_flip": "any channel outside rtol/atol",
              "flip_frac": FLIP_BUDGET, "rtol": RTOL, "atol": ATOL},
          **timing["fields"],
          "sph_search_ms_per_bounce_l2_flushed": times["cold"],
          "sph_search_plain_ms_per_bounce": times["plain"],
          "work_per_wave": work})
    return {"launches": launches, "small": small, "full": full,
            "ms": statistics.fmean(times["cold"]),
            "ms_per_bounce": times["cold"],
            "ms_in_path": timing["in_path"],
            "plain_ms": statistics.fmean(times["plain"]), "work": work,
            "scene": scene, "key": key}


def random_earth_train(dev, smi, fwd) -> dict:
    """``bench.py``'s training step on random with the earth map at the
    bench shape (:func:`main_path_train`): per step SPP * DEPTH launches
    each of N, J, H, J' and H', none of A, B, K, M, L, O, F or F', B'
    (``bwd_reduce``) for H''s partials and the glue's row sums (the
    texels' among them), no plain call; gradients finite, bitwise equal
    over two steps, non-zero on ``img_data``, ``tex_color`` and
    ``sph_c0``; the step's rate (median, min, max of 7), its forward and
    backward apart, a profiled one-wave step (per-kernel ms, busy share),
    the peak memory. Emits ``random_earth_train``."""
    fwd_names = ("sph_search", "hit_attrs", "shade_update")
    bwd_names = ("hit_attrs_bwd", "shade_update_bwd")
    t = main_path_train(
        "random earth", fwd["scene"], fwd["key"],
        (sph_search_kernel, hit_attrs_kernel, shade_update_kernel)
        + SPLIT_BWD_KERNELS,
        (tri_search_kernel, quad_search_kernel) + SEARCH_KERNELS
        + FUSED_KERNELS + FUSED_BWD_KERNELS + WHOLE_WAVE_KERNELS,
        ("img_data", "tex_color", "sph_c0"),
        {n: f"{n}_kernel" for n in fwd_names + bwd_names}, fwd_names,
        bwd_names, 7, dev)
    texels = int((t["grads"]["img_data"].abs().sum(-1) > 0).sum())
    # B''s bound for a one-wave step (the atlas's row sums among them)
    with RowSumCalls() as sums:
        t["step"](1)
        torch.cuda.synchronize()
    light = [(-(-WIDTH * HEIGHT // 128),
              (fwd["scene"].n_lights + 1) * bounce_ops.LT_COLS)] * DEPTH
    red_bound = row_sums_bound(sums.calls, light)
    row_sums = row_sums_vs_float64(sums.calls)
    red_times = row_sum_times(sums.calls, light)
    del sums
    emit({"phase": "random_earth_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          **t["fields"], "img_data_texels_with_grad": texels,
          "row_sums_vs_float64": row_sums,
          "bwd_reduce_bound_one_wave_step": red_bound,
          "bwd_reduce_one_wave_step": red_times})
    return {"launches": t["launches"], "ms_in_path": t["in_path"],
            "red": {**red_times, **red_bound}}


def tri_scene_phase(dev, smi) -> dict:
    """The L check scene (``tests/torch_parity.random_tris``: random's
    world with the earth map and the flagship's 968 triangles, 1,024
    rows, beside its 1,024 sphere rows): the split route's per-kind
    branch, K and L for the triangles and N for the spheres. One
    full-size wave (1 spp) through ``render_waves``: DEPTH launches each
    of K, L, N, J and H, none of M, O, F or A, no plain call; the share of
    primaries whose first hit is a triangle; N, L and K against their
    plain versions on every bounce of a MESH_W x MESH_H wave and of the
    full-size wave (M's check on bounces 0 and 1 of the small one), the
    route's small image against the plain route's; L's ms per launch
    out of L2 on every bounce's recorded inputs, in the path (the
    profiler names it ``fused_search_kernel``: L is M's entry point),
    and its plain version's; the work for L's bound. Emits
    ``tri_scene``."""
    t0 = time.perf_counter()
    scene = compile_scene(random_tris_host(S, builders, WIDTH / HEIGHT),
                          device=dev)
    compile_s = time.perf_counter() - t0
    key = rng.key(0, dev)
    if search_ops.unified(scene) or not scene.n_tris:
        raise AssertionError("the L check scene takes the unified search")

    def render(n_waves, w=WIDTH, h=HEIGHT):
        with torch.no_grad():
            return render_waves(scene, w, h, key, 0, n_waves, depth=DEPTH,
                                chunk_size=CHUNK)

    watched = (CULL_KERNELS + SPLIT_KERNELS + SEARCH_KERNELS + FUSED_KERNELS
               + (trace_wave_kernel, trace_wave_noise_kernel))
    with PlainCalls() as plain, split_recorder() as rec:
        for k in watched:
            k.launches = 0
        img = render(1)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
    want = {k.name: 0 for k in watched}
    want.update({k.name: DEPTH for k in CULL_KERNELS + (
        tile_enter_kernel, hit_attrs_kernel, shade_update_kernel)})
    if launches != want:
        raise AssertionError(f"L scene launches {launches}, expected {want}")
    if plain.calls:
        raise AssertionError(f"plain versions ran on the main path: "
                             f"{sorted(set(plain.calls))}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("L scene image: non-finite pixels")
    tri_share = float((rec["hit"][0][1] == isect.KIND_TRI).float().mean())
    if tri_share < 0.05:
        raise AssertionError(f"{tri_share:.2%} of primaries hit triangles")

    with split_recorder() as rec_s:
        small_k = render(1, MESH_W, MESH_H)
    with split_recorder(plain=True):
        small_p = render(1, MESH_W, MESH_H)
    small_img = compare(small_k, small_p, "L scene: kernels vs plain route "
                        f"({MESH_W}x{MESH_H})", flip_abs=None)
    with torch.no_grad():
        small = cull_vs_plain(rec_s, "L scene small", range(DEPTH))
        small.update(search_fused_vs_plain(rec_s, "L scene small"))
        small.update(enter_every_bounce(rec_s, "L scene small"))
        full = cull_vs_plain(rec, "L scene full size", range(DEPTH))
        full.update(enter_every_bounce(rec, "L scene full size"))
    names = {"tile_enter": "tile_enter_kernel",
             "tri_search": M_STAGED,
             "sph_search": "sph_search_kernel",
             "hit_attrs": "hit_attrs_kernel",
             "shade_update": "shade_update_kernel"}
    prof = profile_device(lambda: render(1), tuple(names.values()), top=10)
    per = prof["per_kernel"] or {}
    in_path = {n: (per.get(k) or {}).get("ms_per_launch")
               for n, k in names.items()}
    l_path = search_times.device_ms_in_order(lambda: render(1),
                                             M_STAGED)
    with torch.no_grad():
        l_cold = [median(cold_ms(lambda c=c: tri_search_kernel(*c)))
                  for c in rec["tri"]]
        l_plain = [median(cuda_ms(
            lambda c=c: search_ops.tri_search_plain(*c), 1))
            for c in rec["tri"]]
        work = cull_work(rec)
    emit({"phase": "tri_scene", "card": smi,
          "shape": [HEIGHT, WIDTH, 1, DEPTH], "chunk_size": CHUNK,
          "compile_scene_s": compile_s,
          "tables": {"triangles": scene.n_tris,
                     "triangle_clusters": scene.tri_cluster_min.shape[0],
                     "spheres": scene.n_spheres},
          "launches": launches, "plain_calls": len(plain.calls),
          "primary_triangle_share": tri_share,
          "image_mean": float(img.mean()),
          "small_wave_vs_plain_route": small_img,
          "kernels_vs_plain_small": small,
          "kernels_vs_plain_full_size": full,
          "ms_per_launch_profiler": in_path,
          "tri_search_ms_per_bounce_l2_flushed": l_cold,
          "tri_search_ms_per_bounce_in_path": l_path,
          "tri_search_plain_ms_per_bounce": l_plain,
          "work_per_wave": work,
          "profiled_wave": prof})
    return {"launches": launches, "small": small, "full": full,
            "ms": statistics.fmean(l_cold), "ms_in_path": in_path,
            "plain_ms": statistics.fmean(l_plain), "work": work}


def cull_rows(rand, tri) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of N (random with the earth map,
    forward) and L (the L check scene's full-size wave): launches on that
    main path; device ms per launch out of L2 (``ms``) and in the path
    (``ms_in_path``, the profiler's), plain ms, each averaged over the
    wave's bounces on their recorded inputs, and N's and its bound per
    bounce; the bound of one launch from the tests this run's cull leaves
    (N and L by stage) and the bytes, averaged over the same bounces."""
    rows = []
    for name, ph, repl, src, nb, ops in (
            ("sph_search", rand,
             "rust_ray_tracer_tpu/ops/pallas_sphere.py:139",
             "rust_ray_tracer_tpu_torch/csrc/sphere.cu",
             rand["work"]["n_bytes"], rand["work"]["n_ops"]),
            ("tri_search", tri,
             "rust_ray_tracer_tpu/ops/pallas_intersect.py:326",
             "rust_ray_tracer_tpu_torch/csrc/search.cu",
             tri["work"]["l_bytes"], tri["work"]["l_ops"])):
        b_ms, b_by = bound(nb / DEPTH, ops / DEPTH)
        errs = [r[name]["max_abs_err"] for r in (ph["small"], ph["full"])]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": ph["launches"][name],
                     "max_abs_err": max(errs), "ms": ph["ms"],
                     "ms_in_path": ph["ms_in_path"][name],
                     "plain_ms": ph["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "bytes_per_launch": nb / DEPTH,
                     "operations_per_launch": ops / DEPTH})
    rw = rand["work"]
    nb = rw["n_per_bounce"]
    rows[0]["sphere_tests_per_launch"] = rw["n_ray_tests"] / DEPTH
    rows[0]["sphere_tests_per_launch_warp_vote"] = rw["n_tests"] / DEPTH
    rows[0]["bound_ms_per_warp_vote"] = bound(
        rw["n_bytes"] / DEPTH, rw["n_warp_ops"] / DEPTH)[0]
    rows[0]["ms_per_bounce"] = rand["ms_per_bounce"]
    rows[0]["bound_ms_per_bounce"] = [b["bound_ms"] for b in nb]
    rows[0]["work_per_bounce"] = [
        {k: b[k] for k in ("live_rays", "cluster_tests", "ray_box_tests",
                           "ray_tests", "ray_root_tests", "box_tests",
                           "tests", "root_tests", "tile_tests",
                           "warp_bound_ms")} for b in nb]
    rows[1]["triangle_tests_per_launch"] = tri["work"]["tri_tests"] / DEPTH
    rows[1]["kernel"] = ("fused_search_kernel launched with no sphere or "
                         "quad rows (M's triangle test is L's)")
    return rows


# ---- glTF scenes: the 9-light flagship on the split route (TPU kernels I,
# I'), the single-light flagship on A, a Mesh-boundary medium, the CLI -g --

@contextlib.contextmanager
def gltf_dir():
    """A temporary directory holding the glTF files of the new phases
    (``tests/torch_parity.write_gltf_flagship``): the flagship's 968
    triangles with 9 point lights (``f9.gltf``, a data-URI buffer), with
    16 (``f16.gltf``) and with its one lamp as a point light
    (``f1.glb``). Yields {name: path}; the directory is removed after."""

    with tempfile.TemporaryDirectory() as tmp:
        yield {"f9": write_gltf_flagship(os.path.join(tmp, "f9.gltf"), 9),
               "f16": write_gltf_flagship(os.path.join(tmp, "f16.gltf"), 16),
               "f1": write_gltf_flagship(os.path.join(tmp, "f1.glb"), 1,
                                         "glb")}


def shade_cots(n, seed):
    """Seeded normal cotangents [9, n] of kernel I's emitted, weight and
    direction planes, on the card."""
    g = np.random.default_rng(seed).normal(size=(9, n)).astype(np.float32)
    return torch.from_numpy(g).to("cuda")


def shade_vs_plain(calls, label, bounces=(0, 1), seed=21) -> dict:
    """I and I' against their plain versions on the card, on the recorded
    calls (``split_recorder``'s ``shade``) of ``bounces``: I's planes
    within RTOL / ATOL of each lane's largest value, at most FLIP_BUDGET
    of the lanes outside (as H is held); I' with B's budget (d_data per
    lane within BWD_RTOL of its largest plane / BWD_ATOL, at most
    FLIP_BUDGET of the lanes outside; the light table's cotangent within
    relative L2 BWD_REL_L2 and each row within BWD_REL_L2 of its largest
    entry) for a seeded cotangent, run twice for the same bits. Returns
    each kernel's share outside and worst error."""
    out = {"shade": {"lanes_outside": 0.0, "max_abs_err": 0.0},
           "shade_bwd": {"lanes_outside": 0.0, "max_abs_err": 0.0,
                         "dlt_rel_l2": 0.0, "dlt_rows_err": 0.0,
                         "bitwise_repeat": True}}
    for b in bounces:
        data, rng_p, kind, lt, n_lights = calls["shade"][b]
        what = f"{label} bounce {b}"
        got = shade_kernel(data, rng_p, kind, lt, n_lights)
        ref = shade_ops.shade_plane_core(data, rng_p, kind, lt, n_lights)
        if not torch.equal(got[9], ref[9]):
            raise AssertionError(f"{what}: shade's alive plane differs on "
                                 f"{int((got[9] != ref[9]).sum())} lanes")
        f, e = scaled_close(got, ref, RTOL, ATOL, FLIP_BUDGET,
                            f"{what}: shade")
        g = shade_cots(data.shape[1], seed + b)
        got_d, got_lt = shade_bwd_kernel(data, rng_p, kind, lt, n_lights, g)
        again_d, again_lt = shade_bwd_kernel(data, rng_p, kind, lt,
                                             n_lights, g)
        torch.cuda.synchronize()
        if not (torch.equal(got_d, again_d) and torch.equal(got_lt,
                                                            again_lt)):
            raise AssertionError(f"{what}: two runs of I' differ")
        ref_d, ref_lt = shade_ops.shade_plane_core_vjp(data, rng_p, kind, lt,
                                                       n_lights, g)
        fb, eb = scaled_close(got_d, ref_d, BWD_RTOL, BWD_ATOL, FLIP_BUDGET,
                              f"{what}: shade_bwd d_data")
        r = {"lanes_outside": fb, "max_abs_err": eb,
             "dlt_rel_l2": rel_l2(got_lt, ref_lt, f"{what}: I' dlt",
                                  BWD_REL_L2),
             "dlt_rows_err": rows_close(got_lt, ref_lt,
                                        f"{what}: I' dlt rows")}
        sph = lt[:, 0] == S.LIGHT_SPHERE
        if not float(got_lt[sph][:, 1:5].abs().amax(1).min()) > 0:
            raise AssertionError(f"{what}: a sphere light took no cotangent")
        for k, v in (("lanes_outside", f), ("max_abs_err", e)):
            out["shade"][k] = max(out["shade"][k], v)
        for k, v in r.items():
            out["shade_bwd"][k] = max(out["shade_bwd"][k], v)
    return out


def shade_bwd_ops(calls) -> int:
    """fp32 operations of kernel I' on these calls: twice OPS_SHADE a lane
    and, for a Lambertian lane, twice OPS_LIGHT_PDF for each light of the
    mixture pdf (its forward and its adjoint each run every light's
    test)."""
    total = 0
    for data, _, kind, _, n_lights in calls:
        lam = int((kind == S.MAT_LAMBERTIAN).sum())
        total += data.shape[1] * OPS_SHADE + lam * n_lights * OPS_LIGHT_PDF
    return 2 * total


def gltf_scene(path, dev):
    return compile_scene(load_gltf_scene(path, WIDTH / HEIGHT), device=dev)


def gltf_lights_forward(dev, smi, paths) -> dict:
    """The 9-light glTF flagship at the bench shape on the split route
    (the light table overflows A, F and H): per wave DEPTH launches each
    of K, M (the unified search: 968 triangles, 9 spheres), J and I, none
    of A, H, F, O, L, N, no plain call, a finite image; one full-size
    wave against the plain route; I and I' against their plain versions
    on the full-size wave's bounces 0 and 1, on the 16-light file's and
    on the 9-light inputs with WIDE_LIGHTS lights (past one 32-light chunk
    of I's candidate mask); I's work by stage and candidate lights a
    bounce (``tools/search_times.shade_work``);
    sweep ms, per-wave kernel and glue ms and the busy share by the
    profiler; I's ms per launch out of L2 and in a loop on every bounce's
    recorded inputs, in the path, and its plain version's; M's (K's and
    M's winners held by ``split_kernels_vs_plain`` on bounces 0 and 1) out
    of L2 and in the path on every bounce, beside its bound by stage. Emits
    ``gltf_lights_forward``; returns what the rows and the training phase
    need."""
    scene = gltf_scene(paths["f9"], dev)
    key = rng.key(0, dev)
    tables = make_split_tables(scene)
    if (scene.n_lights != 9 or uber.uber_eligible(scene) or tables.fused
            or tables.su or not tables.unified):
        raise AssertionError("the 9-light flagship is not on the I route")

    def render(n_waves, sc=scene):
        with torch.no_grad():
            return render_waves(sc, WIDTH, HEIGHT, key, 0, n_waves,
                                depth=DEPTH, chunk_size=CHUNK)

    img, launches, n_plain = main_path_forward(
        "9-light", render, SEARCH_KERNELS + (hit_attrs_kernel, shade_kernel),
        (shade_update_kernel, quad_search_kernel) + FUSED_KERNELS
        + CULL_KERNELS + (trace_wave_kernel, trace_wave_noise_kernel))

    with split_recorder() as rec:
        wave_k = render(1)
    with split_recorder(plain=True):
        wave_p = render(1)
    full_img = compare(wave_k, wave_p, "9 lights: kernels vs plain route",
                       flip_abs=None)
    with torch.no_grad():
        full = shade_vs_plain(rec, "9 lights full size")
        full.update(split_kernels_vs_plain(rec, "9 lights full size"))
        full.update(enter_every_bounce(rec, "9 lights full size"))
    scene16 = gltf_scene(paths["f16"], dev)
    with split_recorder() as rec16:
        render(1, scene16)
    if scene16.n_lights != 16 or len(rec16["shade"]) != DEPTH:
        raise AssertionError("the 16-light flagship did not run I")
    # I past one chunk of its candidate mask: the 9-light wave's inputs of
    # bounces 0 and 1 with the lights spread to WIDE_LIGHTS
    wide = {"shade": [c[:3] + (spread_lights(c[3], WIDE_LIGHTS),
                               WIDE_LIGHTS) for c in rec["shade"][:2]]}
    with torch.no_grad():
        full16 = shade_vs_plain(rec16, "16 lights full size")
        full_wide = shade_vs_plain(wide, f"{WIDE_LIGHTS} lights full size")
    # I and I' out of L2 at 16 lights: the mixture pdf's loops (and I''s
    # light-major steps) grow with the lights, I''s shared memory a block
    # by the table's 56 bytes a light; I at WIDE_LIGHTS on bounces 0 and 1
    calls16 = rec16["shade"]
    cots16 = [shade_cots(c[0].shape[1], 41 + b) for b, c in enumerate(calls16)]
    ms16 = {"shade": bounce_times([(lambda c=c: shade_kernel(*c), None)
                                   for c in calls16])["cold"],
            "shade_bwd": bounce_times([
                (lambda c=c, g=g: shade_bwd_kernel(*c, g), None)
                for c, g in zip(calls16, cots16)])["cold"]}
    ms_wide = bounce_times([(lambda c=c: shade_kernel(*c), None)
                            for c in wide["shade"]])["cold"]
    with torch.no_grad():
        work16 = shade_work(calls16)
        work_wide = shade_work(wide["shade"])
    del rec16, calls16, cots16, wide

    timing = forward_timing(render, {
        **{n: f"{n}_kernel" for n in ("tile_enter", "hit_attrs", "shade")},
        "fused_search": M_STAGED}, 5, dev)
    # M on every bounce's recorded inputs out of L2 and in the path (the
    # profiler's launches in bounce order), its work by stage
    m_times = bounce_times([
        (lambda c=c: fused_search_kernel(*c),
         lambda c=c: search_ops.fused_search_plain(*c))
        for c in rec["search"]], 1)
    m_cold = m_times["cold"]
    m_path = search_times.device_ms_in_order(lambda: render(1),
                                             M_STAGED)
    with torch.no_grad():
        m_work = search_work(rec)
    calls = rec["shade"]
    times = bounce_times([(lambda c=c: shade_kernel(*c),
                           lambda c=c: shade_ops.shade_plane_core(*c))
                          for c in calls], loop=True)
    with torch.no_grad():
        work = shade_work(calls)
    emit({"phase": "gltf_lights_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "tables": {"triangles": scene.n_tris, "spheres": scene.n_spheres,
                     "lights": scene.n_lights},
          "launches": launches, "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "wave_vs_plain_route": full_img,
          "kernels_vs_plain_9_lights": full,
          "kernels_vs_plain_16_lights": full16,
          f"kernels_vs_plain_{WIDE_LIGHTS}_lights": full_wide,
          "ms_per_bounce_16_lights_l2_flushed": ms16,
          f"shade_ms_bounces_0_1_{WIDE_LIGHTS}_lights_l2_flushed": ms_wide,
          "shade_work_per_bounce": work["per_bounce"],
          "shade_work_per_bounce_16_lights": work16["per_bounce"],
          f"shade_work_bounces_0_1_{WIDE_LIGHTS}_lights":
              work_wide["per_bounce"],
          "kernel_vs_plain_budget": {
              "shade_lanes_outside": FLIP_BUDGET, "rtol": RTOL,
              "atol": ATOL, "shade_bwd": [BWD_RTOL, BWD_ATOL, BWD_REL_L2],
              "image_flip": "any channel outside rtol/atol",
              "flip_frac": FLIP_BUDGET},
          **timing["fields"],
          "shade_ms_per_bounce_l2_flushed": times["cold"],
          "shade_ms_per_bounce_looped": times["loop"],
          "shade_plain_ms_per_bounce": times["plain"],
          "shade_lanes_per_bounce": [c[0].shape[1] for c in calls],
          "fused_search_ms_per_bounce_l2_flushed": m_cold,
          "fused_search_ms_per_bounce_in_path": m_path,
          "fused_search_bound_ms_per_bounce": [
              bound(b["bytes"], b["ops"])[0] for b in m_work["per_bounce"]],
          "fused_search_tests_per_bounce": [
              {k: b[k] for k in ("live_rays", "pairs", "tests", "t_tests",
                                 "uv_tests", "full_cull_tests")}
              for b in m_work["per_bounce"]]})
    return {"launches": launches, "full": full, "full16": full16,
            "full_wide": full_wide, "work": work,
            "ms": statistics.fmean(times["cold"]),
            "ms_in_path": timing["in_path"]["shade"],
            "plain_ms": statistics.fmean(times["plain"]), "calls": calls,
            "scene": scene, "key": key,
            "m": {"work": m_work, "ms": statistics.fmean(m_cold),
                  "ms_in_path": timing["in_path"]["fused_search"],
                  "plain_ms": statistics.fmean(m_times["plain"])}}


def gltf_lights_train(dev, smi, fwd) -> dict:
    """``bench.py``'s training step on the 9-light glTF flagship at the
    bench shape (:func:`main_path_train`): per step SPP * DEPTH launches
    each of K, M, J, I, J' and I', none of A, B, H, H', F, F', B' once for
    each I' (its light-table partials) and for the glue's row sums, no
    plain call; gradients finite, bitwise equal over two steps and
    non-zero on ``tri_v0``, ``tex_color``, ``light_c``, ``light_r`` and
    ``camera.c2w``; the step's rate (5 timed steps), its forward and
    backward apart, a profiled one-wave step, the peak memory; then I' on
    every bounce's recorded inputs of one wave with seeded cotangents,
    timed out of L2 (with B''s sum of its partials, and apart) and in a
    loop, beside its plain version. Emits ``gltf_lights_train``."""
    fwd_names = ("tile_enter", "fused_search", "hit_attrs", "shade")
    bwd_names = ("hit_attrs_bwd", "shade_bwd")
    t = main_path_train(
        "9-light", fwd["scene"], fwd["key"],
        SEARCH_KERNELS + (hit_attrs_kernel, shade_kernel,
                          hit_attrs_bwd_kernel, shade_bwd_kernel),
        WHOLE_WAVE_KERNELS + FUSED_KERNELS + FUSED_BWD_KERNELS
        + (shade_update_kernel, shade_update_bwd_kernel),
        ("tri_v0", "tex_color", "light_c", "light_r", "camera.c2w"),
        {**{n: f"{n}_kernel" for n in fwd_names + bwd_names},
         "fused_search": M_STAGED}, fwd_names,
        bwd_names, 5, dev)

    # I' on every bounce's recorded inputs of one wave, seeded cotangents
    pairs, parts = [], {"kernel": [], "light_table_sum": []}
    for b, c in enumerate(fwd["calls"]):
        g = shade_cots(c[0].shape[1], 31 + b)
        pairs.append((lambda c=c, g=g: shade_bwd_kernel(*c, g),
                      lambda c=c, g=g: shade_ops.shade_plane_core_vjp(*c, g)))
        part = shade_bwd_kernel.partials(*c, g)[1]
        parts["kernel"].append(
            (lambda c=c, g=g: shade_bwd_kernel.partials(*c, g), None))
        parts["light_table_sum"].append((light_sum_call(part), None))
    times = bounce_times(pairs, loop=True)
    part_ms = {n: bounce_times(fs)["cold"] for n, fs in parts.items()}
    emit({"phase": "gltf_lights_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          **t["fields"],
          "shade_bwd_ms_per_bounce_l2_flushed": times["cold"],
          "shade_bwd_ms_per_bounce_looped": times["loop"],
          "shade_bwd_plain_ms_per_bounce": times["plain"],
          "shade_bwd_parts_ms_l2_flushed": part_ms})
    return {"launches": t["launches"], "ms": statistics.fmean(times["cold"]),
            "ms_in_path": t["in_path"]["shade_bwd"],
            "plain_ms": statistics.fmean(times["plain"]),
            "parts": {n: statistics.fmean(v) for n, v in part_ms.items()}}


def staged_m_row(fwd, train) -> list[dict]:
    """The ``{"kernels": [...]}`` row of M's staged input from the 9-light
    flagship's forward (968 triangles, 9 spheres: below the packed
    input's gate) and training step: launches on the main path; device ms
    per launch out of L2 and in the path, plain ms, each averaged over a
    wave's bounces on their recorded inputs; the bound of one launch over
    the same bounces from this run's data (``tools/search_times.
    m_work``)."""
    m, n_w = fwd["m"], DEPTH
    b_ms, b_by = bound(m["work"]["m_bytes"] / n_w, m["work"]["m_ops"] / n_w)
    return [{"name": "fused_search", "route": "cuda",
             "source": "rust_ray_tracer_tpu_torch/csrc/search.cu",
             "replaces": "rust_ray_tracer_tpu/ops/pallas_intersect.py:959",
             "also_replaces": "rust_ray_tracer_tpu/ops/pallas_intersect.py:"
                              "1019",
             "launches": fwd["launches"]["fused_search"],
             "launches_train": train["launches"]["fused_search"],
             "max_abs_err": fwd["full"]["fused_search"]["max_abs_err"],
             "ms": m["ms"], "ms_in_path": m["ms_in_path"],
             "plain_ms": m["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None,
             "bytes_per_launch": m["work"]["m_bytes"] / n_w,
             "operations_per_launch": m["work"]["m_ops"] / n_w,
             "tests_per_launch": {
                 k: m["work"][k] / n_w for k in (
                     "tri_tests", "t_tests", "uv_tests", "full_cull_tests",
                     "sph_tests", "quad_tests")}}]


def shade_rows(fwd, train) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of I and I' from the 9-light
    flagship's forward and training step: launches on the main path;
    device ms per launch out of L2 (``ms``; I''s with B''s sum of its
    partials, which its plain version's time includes too) and in the
    path (``ms_in_path``, the profiler's), plain ms, each averaged over a
    wave's bounces on their recorded inputs; the bound of one launch
    averaged over the same bounces (I's operations by stage from its
    candidate lights, ``shade_work``; I''s by ``shade_bwd_ops``); I's
    ptxas line and resident blocks. No single PyTorch call computes the
    material mixture: ``library_ms`` is null."""
    calls = fwd["calls"]
    n_w = len(calls)
    err = {k: max(fwd[f][k]["max_abs_err"] for f in ("full", "full16",
                                                     "full_wide"))
           for k in ("shade", "shade_bwd")}
    work = fwd["work"]
    rows = []
    for name, repl, nb, nops, src in (
            ("shade", "rust_ray_tracer_tpu/ops/pallas_shade.py:442",
             shade_fwd_bytes(calls), work["total"]["ops"], fwd),
            ("shade_bwd", "rust_ray_tracer_tpu/ops/pallas_shade.py:491",
             shade_bwd_bytes(calls), shade_bwd_ops(calls), train)):
        b_ms, b_by = bound(nb / n_w, nops / n_w)
        launches = (fwd if name == "shade" else train)["launches"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "rust_ray_tracer_tpu_torch/csrc/shade.cu",
                     "replaces": repl, "launches": launches,
                     "max_abs_err": err[name], "ms": src["ms"],
                     "ms_in_path": src["ms_in_path"],
                     "plain_ms": src["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "bytes_per_launch": nb / n_w,
                     "operations_per_launch": nops / n_w})
    rows[0]["ptxas"] = kernel_ptxas("shade_kernel", 9)
    rows[0]["work_per_bounce"] = work["per_bounce"]
    rows[1]["ms_parts"] = train["parts"]
    return rows


def mesh_medium_phase(dev, smi) -> dict:
    """A Mesh-boundary medium on the split route at 64x64, 2 spp: the
    compile (``MED_MESH``, 12 ``med_tri`` rows), the image against the
    plain route on the card and on the CPU, and one training step with
    finite gradients, non-zero on ``med_neg_inv_d`` and bitwise equal over
    two runs. Emits ``mesh_medium``."""
    w = h = 64
    scene = compile_scene(mesh_medium_host(S, cam_ops), device=dev)
    if (scene.med_kind.tolist() != [S.MED_MESH]
            or tuple(scene.med_tri.shape) != (1, 12, 10)):
        raise AssertionError("the Mesh boundary did not compile to MED_MESH")
    key = rng.key(0, dev)

    def render(sc=scene, k=key, plain=False):
        with torch.no_grad(), split_recorder(plain=plain):
            return render_waves(sc, w, h, k, 0, 2, depth=DEPTH,
                                chunk_size=w * h)

    img = render()
    ref = render(plain=True)
    cpu = render(compile_scene(mesh_medium_host(S, cam_ops), device="cpu"),
                 rng.key(0, "cpu"))
    vs_plain = compare(img, ref, "mesh medium: kernels vs plain route",
                       flip_abs=None)
    vs_cpu = compare(img, cpu, "mesh medium: card vs CPU")
    params, static = partition(scene)

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        render_waves(combine(leaves, static), w, h, key, 0, 1, depth=DEPTH,
                     chunk_size=w * h).mean().backward()
        return {k: v.grad for k, v in leaves.items() if v.grad is not None}

    g1, g2 = step(), step()
    for k, v in g1.items():
        if not bool(torch.isfinite(v).all()) or not torch.equal(v, g2[k]):
            raise AssertionError(f"mesh medium: gradient of {k} non-finite "
                                 "or not repeatable")
    if not float(g1["med_neg_inv_d"].abs().max()) > 0:
        raise AssertionError("mesh medium: no gradient of the density")
    emit({"phase": "mesh_medium", "card": smi, "shape": [h, w, 2, DEPTH],
          "image_mean": float(img.mean()) / 2, "vs_plain_route": vs_plain,
          "vs_cpu": vs_cpu, "grads_finite": True,
          "grads_bitwise_repeat": True,
          "grad_med_neg_inv_d": float(g1["med_neg_inv_d"].abs().max())})
    return {"vs_plain": vs_plain}


def cli_gltf_phase(path, height, spp, lo, hi) -> dict:
    """The CLI's ``-g`` on the card: a PNG of the glTF file written and a
    finite mean radiance in [lo, hi]."""
    os.makedirs("output", exist_ok=True)
    out_png = os.path.join("output", "gltf_torch.png")
    buf = io.StringIO()
    # a fresh checkpoint, so that every wave renders on the card
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(buf):
        rc = cli.main([str(height), str(spp), "-g", path, "-a",
                       str(WIDTH / HEIGHT), "-o", out_png, "--device",
                       "cuda", "--checkpoint", os.path.join(td, "g.ckpt")])
    line = buf.getvalue().strip()
    if rc != 0:
        raise AssertionError(f"CLI -g exited {rc}: {line}")
    if f"wave {spp}/{spp}" not in line:
        raise AssertionError(f"CLI -g rendered no wave: {line}")
    m = re.search(r"mean radiance ([0-9.eE+-]+|nan|inf), finite (\w+)", line)
    if not m or m.group(2) != "True":
        raise AssertionError(f"CLI -g image not finite: {line}")
    mean = float(m.group(1))
    if not lo <= mean <= hi:
        raise AssertionError(f"implausible glTF mean radiance {mean}")
    return {"file": os.path.basename(path), "output": out_png,
            "mean_radiance": mean, "stdout": line}


def bound(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def trace_costs(ctx, hist, kind, idx) -> dict:
    """What the trace kernels need for the residuals ``hist`` [depth, 14,
    N], ``kind``, ``idx`` [depth, N] of ``depth`` bounces: A's bytes and
    fp32 operations (with the residuals' bytes apart) and B's, as the
    kernel rows count them; with depth 1, D's and D''s."""
    depth, _, n = hist.shape
    tables = sum(x.numel() * 4 for x in (ctx.uni, ctx.tri_pack,
                                         ctx.sph_pack, ctx.quad_pack,
                                         ctx.cab, ctx.lt,
                                         ctx.perlin.vec, ctx.perlin.perm))
    alive = hist[:, 7] > 0.5
    n_live = int(alive.sum())
    n_noise = noise_hits(hist, kind, idx, ctx)
    # A: st0 + rnd in, stf out (+ the residuals when training); the
    # stages of the ray tests the closest hit needs (closest_hit_work), the
    # shading of each live ray-bounce and the marble of each noise hit
    a_bytes = (14 * n * 2 + depth * 15 * n) * 4 + tables
    a_res_bytes = a_bytes + (depth * 14 * n + 2 * depth * n) * 4
    work = closest_hit_work(hist, ctx)
    a_ops = work["ops"] + n_live * OPS_SHADE + n_noise * OPS_MARBLE
    # B: what this run's residuals need (tools/search_times.bwd_bytes)
    m_found = int((alive & (kind > 0)).sum())
    b_bytes = search_times.bwd_bytes(hist, kind, idx, ctx.uni, ctx.lt,
                                     ctx.n_lights,
                                     (ctx.perlin.vec, ctx.perlin.perm))
    b_ops = m_found * OPS_BWD + n_noise * OPS_MARBLE_BWD
    return {"a_bytes": a_bytes, "a_res_bytes": a_res_bytes, "a_ops": a_ops,
            "b_bytes": b_bytes, "b_ops": b_ops, "live": n_live,
            "found": m_found, "noise": n_noise, "search": work}


def bwd_ptxas(kernel, ctx) -> dict:
    """The ptxas line (registers, stack frame, spills) of ``kernel`` (B's
    or D''s template name) in the instance of ``ctx``'s variant."""
    inst = "ILb1E" if ctx.has_noise else "ILb0E"
    for r in ptxas_report(K.build("trace_wave_bwd").log):
        if kernel in r["function"] and inst in r["function"]:
            return r
    raise AssertionError(f"no ptxas line of {kernel} ({inst})")


def kernel_rows(fwd, train, small, variant) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of one variant's A and B (and, for
    the variant without noise, bwd_reduce) from its scene's main path:
    launches and device times from the training step, the bound from this
    run's residuals."""
    ctx, st0 = fwd["ctx"], fwd["st0"]
    hist, kind, idx = train["hist"], train["kind"], train["idx"]
    part, m_found = train["part"], train["m_found"]
    n = st0.shape[1]
    w_cols = ctx.uni.shape[1]
    c = trace_costs(ctx, hist, kind, idx)
    a_bytes, a_res_bytes, a_ops = c["a_bytes"], c["a_res_bytes"], c["a_ops"]
    b_bytes, b_ops = c["b_bytes"], c["b_ops"]
    n_live, n_noise = c["live"], c["noise"]
    # bwd_reduce: the found cotangents with their sorted keys and order
    # and the partials in; duni (every row) and dlt out; one add per value
    r_bytes = (m_found * (w_cols + 2) + part.numel() + ctx.uni.numel()
               + ctx.lt.numel()) * 4
    r_ops = m_found * w_cols + part.numel()
    per = train["prof"]["per_kernel"] or {}
    names = train["names"]

    def device_ms(kernel_name, fallback):
        """The profiler's device time per launch in the training step, or
        the CUDA-event time per call where the profiler saw none."""
        got = (per.get(kernel_name) or {}).get("ms_per_launch")
        return fallback if got is None else got

    a_name, b_name = K.trace_kernel(ctx).name, K.trace_bwd_kernel(ctx).name
    a_src = "rust_ray_tracer_tpu_torch/csrc/trace_wave.cu"
    b_src = "rust_ray_tracer_tpu_torch/csrc/trace_wave_bwd.cu"
    spec = [(a_name, a_src, "rust_ray_tracer_tpu/ops/pallas_uber.py:876",
             train["launches"][a_name],
             max(small["fwd"][variant]["max_abs_err"],
                 fwd["full"]["max_abs_err"]),
             device_ms(names[0], train["a_res_med"]), fwd["p_med"],
             a_res_bytes, a_ops, None),
            (b_name, b_src, "rust_ray_tracer_tpu/ops/pallas_uber.py:926",
             train["launches"][b_name],
             max(small["bwd"][variant]["dst_err"], train["full_b_err"]),
             device_ms(names[1], train["b_med"]), train["bwd_plain_ms"],
             b_bytes, b_ops, None)]
    if variant == "plain":
        spec.append(("bwd_reduce", b_src,
                     "rust_ray_tracer_tpu/ops/pallas_uber.py:979",
                     train["launches"]["bwd_reduce"],
                     max(small["bwd"]["plain"]["reduce_err"],
                         small["bwd"]["noise"]["reduce_err"],
                         train["red_full_err"]),
                     device_ms("bwd_reduce_kernel", train["red_med"]),
                     train["red_plain_ms"], r_bytes, r_ops,
                     train["lib_red_ms"]))
    rows = []
    for kname, src, repl, kl, err, ms, pms, nb, ops, lib in spec:
        b_ms_, b_by = bound(nb, ops)
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": repl, "launches": kl, "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": b_ms_,
                     "bound_by": b_by, "library_ms": lib,
                     "bytes": nb, "operations": ops})
    rows[1]["ray_bounces"] = {"all": DEPTH * n, "live": n_live,
                              "found": m_found, "noise": n_noise}
    rows[1]["ms_l2_flushed"] = train["b_cold"]
    rows[1]["ms_loop"] = train["b_med"]
    rows[1]["ptxas"] = bwd_ptxas("trace_wave_bwd_kernel", ctx)
    rows[0]["search_tests"] = c["search"]
    rows[0]["ms_without_residuals"] = fwd["k_med"]
    rows[0]["bound_ms_without_residuals"] = bound(a_bytes, a_ops)[0]
    if variant == "noise":
        rows[0]["contains"] = rows[1]["contains"] = (
            "TPU kernel C: rust_ray_tracer_tpu/ops/pallas_bounce.py:125 "
            "_noise_row, :166 _marble_row")
    return rows


# ---- the per-chunk path: kernels D and D', the sharded renderer, two
# ranks, checkpoints ---------------------------------------------------------

def search_chain_checks(label, fwd, train) -> dict:
    """Kernels D and E against A on the full-size wave
    (``tools/search_times.search_report``): on each bounce's input state
    among A's residuals (the training phase's wave 0), D's winners (the
    scene's variant) and E's equal A's residual winners on every lane.
    Per bounce: the live rays and the share of live lanes among the warps
    that sweep, without and with the row's compaction; A's times with and
    without residuals, D's on bounces 0 and 1 and E's on every bounce, out
    of L2 and in a loop; the resident blocks per SM of A, D and E and
    their registers. Emits ``<label>_search_checks``."""
    ctx = fwd["ctx"]
    rep = search_times.search_report(
        ctx, fwd["st0"], fwd["rnd"],
        residuals=(train["hist"], train["kind"], train["idx"]))
    for row in rep["bounces"]:
        for who, n_diff in row["winners_differing"].items():
            if n_diff:
                raise AssertionError(f"{label}: bounce {row['bounce']}: "
                                     f"{n_diff} winners of {who} differ "
                                     "from A's")
    lib = K.trace_kernel(ctx).library
    out = {"phase": f"{label}_search_checks", **rep, "library": lib,
           "sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "ptxas": [r for r in ptxas_report(K.build(lib).log)
                     if any(f in r["function"] for f in (
                         "select_kernel", "trace_wave_kernel",
                         "fused_bounce_kernel"))]}
    emit(out)
    return out


def d_profiler_names(ctx):
    """The profiler's names of kernels D and D' (template instances)."""
    v = "true" if ctx.has_noise else "false"
    return (f"fused_bounce_kernel<{v}>", f"fused_bounce_bwd_kernel<{v}>")


def fused_bounce_checks(label, fwd, seed=31) -> dict:
    """Kernels D and D' (the scene's variants) against
    ``fused_bounce_plain`` / ``fused_bounce_bwd_plain`` on the card, on the
    recorded inputs of bounces 0 and 1 of the forward phase's full-size
    wave (D's own output feeds bounce 1): D's winners equal the plain
    version's on every lane (both round each product and sum alone) and
    its state within RTOL / ATOL of each lane's largest plane, FLIP_BUDGET
    outside (CUDA's sinf/cosf/expf/logf against torch's);
    D' with a seeded cotangent within B's budget; each the same bits over
    two launches. Per bounce: ms out of L2 (D' alone and with the sort and
    B''s sums), the plain versions' ms, the work. Emits
    ``<label>_fused_bounce_checks``."""
    ctx, st, rnd = fwd["ctx"], fwd["st0"], fwd["rnd"]
    d, dp = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
    n = st.shape[1]
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(14, n)).astype(np.float32)).to(st.device)
    bounces, pairs_d, pairs_dp, pairs_sum = [], [], [], []
    for b in (0, 1):
        rb = rnd[b]
        with torch.no_grad():
            st2, kind, idx = d(st, rb, ctx)
            again = d(st, rb, ctx)
            ref2, ref_kind, ref_idx = PlainCalls.real_fused(st, rb, ctx)
        if not all(torch.equal(x, y) for x, y in zip((st2, kind, idx),
                                                     again)):
            raise AssertionError(f"{label}: {d.name} differs between runs")
        forked = int(((kind != ref_kind) | (idx != ref_idx)).sum())
        if forked:
            raise AssertionError(f"{label}: {forked} winners of {d.name} "
                                 "differ from the plain version's")
        st_out, st_err = scaled_close(st2, ref2, RTOL, ATOL, FLIP_BUDGET,
                                      f"{label}: {d.name} state")
        bk = K.fused_bounce_backward(st, rb, kind, idx, ctx, g)
        bk2 = K.fused_bounce_backward(st, rb, kind, idx, ctx, g)
        if not all(torch.equal(x, y) for x, y in zip(bk, bk2)):
            raise AssertionError(f"{label}: {dp.name} differs between runs")
        bp = PlainCalls.real_fused_bwd(st, rb, kind, idx, ctx, g)
        dst_out, dst_err = scaled_close(bk[0], bp[0], BWD_RTOL, BWD_ATOL,
                                        FLIP_BUDGET, f"{label}: {dp.name} dst")
        costs = trace_costs(ctx, st[None], kind[None], idx[None])
        bounces.append({
            "bounce": b, "winners_forked": forked, "state_outside": st_out,
            "state_err": st_err, "dst_outside": dst_out, "dst_err": dst_err,
            "duni_rel_l2": rel_l2(bk[1], bp[1], f"{label}: duni",
                                  BWD_REL_L2),
            "dlt_rel_l2": rel_l2(bk[2], bp[2], f"{label}: dlt", BWD_REL_L2),
            "dlt_rows_err": rows_close(bk[2], bp[2], f"{label}: dlt rows"),
            "live": costs["live"], "found": costs["found"],
            "noise_hits": costs["noise"],
            "d_bytes": costs["a_bytes"] + 2 * n * 4,
            "d_ops": costs["a_ops"], "search_tests": costs["search"],
            "dp_bytes": costs["b_bytes"],
            "dp_ops": costs["b_ops"]})
        args = (st, rb, kind, idx, ctx, g)
        pairs_d.append((lambda a=(st, rb, ctx): d(*a),
                        lambda a=(st, rb, ctx): PlainCalls.real_fused(*a)))
        pairs_dp.append((lambda a=args: dp(*a),
                         lambda a=args: PlainCalls.real_fused_bwd(*a)))
        pairs_sum.append((lambda a=args: K.fused_bounce_backward(*a), None))
        st = st2
    t_d = bounce_times(pairs_d, plain_reps=2)
    t_dp = bounce_times(pairs_dp, plain_reps=2)
    t_sum = bounce_times(pairs_sum)
    regs = [r for lib in (d.library, dp.library)
            for r in ptxas_report(K.build(lib).log)
            if "fused_bounce" in r["function"]]
    out = {"phase": f"{label}_fused_bounce_checks", "kernels": [d.name,
                                                                dp.name],
           "rays": n, "bounces": bounces,
           "ms_per_launch_l2_flushed": {d.name: t_d["cold"],
                                        dp.name: t_dp["cold"],
                                        f"{dp.name}+sort+bwd_reduce":
                                            t_sum["cold"]},
           "plain_ms_per_launch": {d.name: t_d["plain"],
                                   dp.name: t_dp["plain"]},
           "budget": {"state": [RTOL, ATOL, FLIP_BUDGET],
                      "dst": [BWD_RTOL, BWD_ATOL, FLIP_BUDGET],
                      "tables_rel_l2": BWD_REL_L2},
           "ptxas": regs}
    emit(out)
    return {"ctx": ctx, "bounces": bounces, "t_d": t_d, "t_dp": t_dp,
            "t_sum": t_sum}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_forward(label, fwd, mesh, dev, smi) -> dict:
    """The forward render through ``render_waves_sharded`` on ``mesh`` at
    the bench shape: the counts of A, B, D and D' (both variants) set to 0
    just before it runs under :class:`PlainCalls` and read just after —
    SPP * DEPTH launches of the scene's D and none of the others, no plain
    call; the image equal to ``render_waves``' (A) on the same key bit for
    bit (one library, one device function for both); sweep ms,
    the profiled wave (D in the path, glue, busy share), peak memory.
    Emits ``sharded_<label>_forward``."""
    scene, key, ctx = fwd["scene"], fwd["key"], fwd["ctx"]
    d = K.fused_bounce_kernel(ctx)
    watched = ((trace_wave_kernel, trace_wave_noise_kernel,
                trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel)
               + D_KERNELS + D_BWD_KERNELS)

    def render(n_waves):
        with torch.no_grad():
            return render_waves_sharded(scene, WIDTH, HEIGHT, key, 0,
                                        n_waves, mesh, DEPTH, CHUNK)

    with PlainCalls() as plain:
        for k in watched:
            k.launches = 0
        img = render(SPP)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
    want = {k.name: 0 for k in watched}
    want[d.name] = SPP * DEPTH
    if launches != want:
        raise AssertionError(f"sharded {label} launches {launches}, "
                             f"expected {want}")
    if plain.calls:
        raise AssertionError(f"plain versions ran: {sorted(set(plain.calls))}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"sharded {label} image: shape or non-finite")
    with torch.no_grad():
        ref = render_waves(scene, WIDTH, HEIGHT, key, 0, SPP, depth=DEPTH,
                           chunk_size=CHUNK)
    bitwise = torch.equal(img, ref)
    differ = int((img != ref).any(-1).sum())
    if not bitwise:
        raise AssertionError(f"sharded {label} image differs from A's on "
                             f"{differ} pixels")
    vs_a = compare(img, ref, f"sharded {label} vs render_waves (A)",
                   flip_abs=None)
    t = forward_timing(render, {d.name: d_profiler_names(ctx)[0]}, 7, dev)
    emit({"phase": f"sharded_{label}_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "world": mesh.size, "backend": mesh.backend, "launches": launches,
          "plain_calls": len(plain.calls), "image_mean": float(img.mean())
          / SPP, "bitwise_vs_whole_wave": bitwise,
          "pixels_differing_from_whole_wave": differ,
          "vs_whole_wave": vs_a, **t["fields"]})
    return {"launches": launches, "in_path": t["in_path"]}


def sharded_train(label, fwd, mesh, dev, smi, nonzero_keys) -> dict:
    """``bench.py``'s training step through ``render_waves_sharded`` on
    ``mesh``: the counts set to 0 just before the first of two steps under
    :class:`PlainCalls` and read just after it — SPP * DEPTH launches each
    of the scene's D and D' and of B' (one sum of D''s rows and light
    partials a bounce), none of A, B or the other variants, no plain call;
    gradients finite, bitwise over the two steps, non-zero on
    ``nonzero_keys``, and within B's budget (per leaf BWD_ATOL + BWD_RTOL
    of its largest entry) of the whole-wave route's (A and B) gradients;
    step times, a profiled step, peak memory. Emits
    ``sharded_<label>_train``."""
    scene, key, ctx = fwd["scene"], fwd["key"], fwd["ctx"]
    d, dp = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
    params, static = partition(scene)

    def step(sharded=True):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        sc = combine(leaves, static)
        img = (render_waves_sharded(sc, WIDTH, HEIGHT, key, 0, SPP, mesh,
                                    DEPTH, CHUNK) if sharded else
               render_waves(sc, WIDTH, HEIGHT, key, 0, SPP, depth=DEPTH,
                            chunk_size=CHUNK))
        loss = img.mean()
        loss.backward()
        return loss, {k: v.grad for k, v in leaves.items()
                      if v.grad is not None}

    watched = ((trace_wave_kernel, trace_wave_noise_kernel,
                trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel,
                bwd_reduce_kernel) + D_KERNELS + D_BWD_KERNELS)
    with PlainCalls() as plain:
        for k in watched:
            k.launches = 0
        loss, grads = step()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
        _, grads2 = step()
        torch.cuda.synchronize()
    want = {k.name: 0 for k in watched}
    for k in (d, dp, bwd_reduce_kernel):
        want[k.name] = SPP * DEPTH
    if launches != want:
        raise AssertionError(f"sharded {label} training launches "
                             f"{launches}, expected {want}")
    if plain.calls:
        raise AssertionError(f"plain versions ran: {sorted(set(plain.calls))}")
    for k, v in grads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite gradient of {k}")
        if not torch.equal(v, grads2[k]):
            raise AssertionError(f"gradient of {k} differs between steps")
    nonzero = {k: float(grads[k].abs().max()) for k in nonzero_keys}
    if min(nonzero.values()) <= 0:
        raise AssertionError(f"zero gradients: {nonzero}")
    _, ref = step(sharded=False)
    worst, worst_key = 0.0, None
    for k, r in ref.items():
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((grads[k] - r).abs().max()) if r.numel() else 0.0
        if err > BWD_ATOL + BWD_RTOL * scale:
            raise AssertionError(f"sharded {label}: gradient of {k} off the "
                                 f"whole-wave route's by {err:.3g} (its "
                                 f"largest {scale:.3g})")
        if scale > 0 and err / scale > worst:
            worst, worst_key = err / scale, k
    torch.cuda.reset_peak_memory_stats(dev)
    steps_ms = cuda_ms(step, 7)
    peak = torch.cuda.max_memory_allocated(dev)
    names = d_profiler_names(ctx)
    prof = profile_device(step, names + ("bwd_reduce_kernel",), top=10)
    per = prof["per_kernel"] or {}
    in_path = {k.name: (per.get(nm) or {}).get("ms_per_launch")
               for k, nm in zip((d, dp, bwd_reduce_kernel),
                                names + ("bwd_reduce_kernel",))}
    r = rate_fields("step", steps_ms)
    wave = r["step_ms_median"] / SPP
    kern = (None if None in in_path.values()
            else DEPTH * sum(in_path.values()))
    emit({"phase": f"sharded_{label}_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "world": mesh.size, "backend": mesh.backend, "launches": launches,
          "plain_calls": len(plain.calls), "loss": float(loss.detach()),
          "grads_finite": True, "grads_bitwise_repeat": True,
          "grad_max_abs": nonzero,
          "grads_vs_whole_wave_worst": {"leaf": worst_key,
                                        "err_over_largest": worst,
                                        "budget": [BWD_RTOL, BWD_ATOL]},
          **{k: v for k, v in r.items() if k.startswith("step")},
          "fwd_bwd_mrays_per_s": r["mrays"],
          "fwd_bwd_mrays_per_s_min": r["mrays_min"],
          "fwd_bwd_mrays_per_s_max": r["mrays_max"],
          "peak_memory_bytes": peak, "ms_per_launch_profiler": in_path,
          "ms_per_wave": {"step": wave, "kernels": kern,
                          "glue": None if kern is None else wave - kern},
          "profiled_step": prof})
    return {"launches": launches, "in_path": in_path}


def sharded_two_ranks(dev, smi) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU;
    gloo's collectives go through the host, ``parallel/render.py``), each a
    process of ``python -m rust_ray_tracer_tpu_torch.parallel.dryrun``:
    the flagship at SHARD_W x SHARD_H, 2 spp, depth DEPTH, chunk
    SHARD_CHUNK (9 chunks, padded to 10, 5 a rank), the image, one
    training step and an SGD step, then (``--also-compact``) all three again
    through the compact wavefront, each rank compacting its own chunks.
    On each route both ranks' images must equal the one-rank render
    bitwise, their gradients must be equal to each other and within B's
    budget of the one-rank gradients (not twice them), the loss after the
    step finite. Emits ``sharded_two_ranks``."""

    from rust_ray_tracer_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "rank.pt")
        addr = f"127.0.0.1:{free_port()}"
        env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        cmd = [sys.executable, "-m", "rust_ray_tracer_tpu_torch.parallel."
               "dryrun", "--device", dev.type, "--backend", "gloo", "--scene",
               "flagship", "--width", str(SHARD_W), "--height",
               str(SHARD_H), "--spp", "2", "--depth", str(DEPTH),
               "--chunk-size", str(SHARD_CHUNK), "--also-compact", "--out",
               out, "--coordinator", addr, "--num-processes", "2"]
        procs = []
        try:
            for r in (0, 1):
                procs.append(subprocess.Popen(
                    cmd + ["--process-id", str(r)], env=env, cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a rank exited {p.returncode}:\n"
                                     f"{log[-3000:]}")
        ranks = [torch.load(os.path.join(td, f"rank.{r}.pt"))
                 for r in (0, 1)]
    ranks_s = time.perf_counter() - t0
    out = {"phase": "sharded_two_ranks", "card": smi, "backend": "gloo",
           "world": 2, "shape": [SHARD_H, SHARD_W, 2, DEPTH],
           "chunk_size": SHARD_CHUNK, "ranks_seconds": ranks_s}
    for compact in (False, True):
        one = dryrun.run(make_mesh(device=dev), "flagship", SHARD_W,
                         SHARD_H, 2, DEPTH, SHARD_CHUNK, compact=compact)
        rs = [r["compact"] if compact else r for r in ranks]
        what = "compact" if compact else "per-chunk"
        for r in rs:
            if not torch.equal(r["image"], one["image"]):
                raise AssertionError(f"rank {r['rank']}'s {what} image "
                                     "differs from the one-rank render")
        worst = 0.0
        for k, ref in one["grads"].items():
            a, b = rs[0]["grads"][k], rs[1]["grads"][k]
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: gradient of {k} differs "
                                     "between ranks")
            if not ref.numel():
                continue
            scale = float(ref.abs().max())
            err = float((a - ref).abs().max())
            if err > BWD_ATOL + BWD_RTOL * scale:
                raise AssertionError(f"two ranks, {what}: gradient of {k} "
                                     f"off the one-rank one by {err:.3g} "
                                     f"(largest {scale:.3g})")
            worst = max(worst, err / scale if scale else 0.0)
        if not bool(torch.isfinite(rs[0]["loss_after_step"])):
            raise AssertionError(f"two ranks, {what}: non-finite loss "
                                 "after the step")
        out["compact" if compact else "per_chunk"] = {
            "images_bitwise_vs_one_rank": True,
            "grads_equal_across_ranks": True,
            "grads_vs_one_rank_worst_err_over_largest": worst,
            "loss": float(rs[0]["loss"]),
            "loss_after_step": float(rs[0]["loss_after_step"])}
    emit(out)
    return out


def checkpoint_resume(dev, smi) -> dict:
    """``render_with_checkpoints`` at SHARD_W x SHARD_H, 4 spp,
    ``ckpt_every=2`` on a one-rank mesh (D a bounce), stopped after its
    first segment and resumed: equal to the monolithic sharded render
    bitwise. Then the CLI with ``--checkpoint`` twice on the card: the
    second run renders no wave and writes the same PNG. Emits
    ``checkpoint_resume``."""

    scene = compile_scene(builders.procedural_flagship(), device=dev)
    mesh = make_mesh(device=dev)
    d = K.bounce_uber_kernel

    class Stop(Exception):
        pass

    def stop(done, total):
        raise Stop

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "r.ckpt")
        kw = dict(ckpt_every=2, depth=DEPTH, chunk_size=SHARD_CHUNK,
                  mesh=mesh)
        d.launches = 0
        try:
            render_with_checkpoints(scene, SHARD_W, SHARD_H, 4, 0, path,
                                    progress=stop, **kw)
        except Stop:
            pass
        first = load_state(path).waves_done
        seen = []
        img = render_with_checkpoints(scene, SHARD_W, SHARD_H, 4, 0, path,
                                      progress=lambda a, b: seen.append(a),
                                      **kw)
        torch.cuda.synchronize()
        launches = d.launches
        with torch.no_grad():
            ref = render_waves_sharded(scene, SHARD_W, SHARD_H,
                                       rng.key(0, dev), 0, 4, mesh, DEPTH,
                                       SHARD_CHUNK) / 4
        if first != 2 or seen != [4] or not torch.equal(img, ref):
            raise AssertionError(f"resume: first segment {first}, then "
                                 f"{seen}, bitwise {torch.equal(img, ref)}")
        if launches != 4 * DEPTH:
            raise AssertionError(f"{launches} launches of {d.name} in the "
                                 "checkpointed render")
        png, ckpt = os.path.join(td, "c.png"), os.path.join(td, "c.ckpt")
        runs = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["72", "4", "--scene", "cornell_box", "-a",
                               "1.0", "-o", png, "--device", dev.type,
                               "--checkpoint", ckpt, "--ckpt-every", "2"])
            with open(png, "rb") as f:
                runs.append((rc, buf.getvalue(), f.read(),
                             os.stat(ckpt).st_mtime_ns))
        (rc1, log1, png1, m1), (rc2, log2, png2, m2) = runs
        if rc1 or rc2 or "wave 4/4" not in log1 or "wave" in log2 or \
                png1 != png2 or m1 != m2:
            raise AssertionError(f"CLI restart: exits {rc1}, {rc2}; "
                                 f"{log1!r} / {log2!r}")
    out = {"phase": "checkpoint_resume", "card": smi,
           "shape": [SHARD_H, SHARD_W, 4, DEPTH], "ckpt_every": 2,
           "chunk_size": SHARD_CHUNK, "resumed_bitwise": True,
           "d_launches": launches, "cli_second_run_noop": True,
           "cli_stdout": log1.strip().splitlines()[-1]}
    emit(out)
    return out


def fused_rows(checks, trains) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of D, D-noise, D' and D'-noise: the
    launches of the sharded training step (flagship, random); ms out of L2
    and plain ms averaged over bounces 0 and 1 of the full-size wave; the
    bound from those bounces' data, as A's and B's rows count it; the
    profiler's in-path ms beside them."""
    rows = []
    src = "rust_ray_tracer_tpu_torch/csrc/"
    for variant in ("plain", "noise"):
        c, tr = checks[variant], trains[variant]
        ctx = c["ctx"]
        d, dp = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
        bs = c["bounces"]
        for k, file, line, ms, pms, nb, ops, err, extra in (
                (d, "trace_wave.cu", 724, c["t_d"]["cold"],
                 c["t_d"]["plain"], "d_bytes", "d_ops",
                 max(b["state_err"] for b in bs), {}),
                (dp, "trace_wave_bwd.cu", 802, c["t_dp"]["cold"],
                 c["t_dp"]["plain"], "dp_bytes", "dp_ops",
                 max(b["dst_err"] for b in bs),
                 {"ms_with_sort_and_bwd_reduce": statistics.mean(
                     c["t_sum"]["cold"]),
                  "ptxas": bwd_ptxas("fused_bounce_bwd_kernel", ctx)})):
            bounds = [bound(b[nb], b[ops]) for b in bs]
            row = {"name": k.name, "route": "cuda", "source": src + file,
                   "replaces": f"rust_ray_tracer_tpu/ops/pallas_uber.py:"
                               f"{line}",
                   "launches": tr["launches"][k.name], "max_abs_err": err,
                   "ms": statistics.mean(ms), "plain_ms": statistics.mean(
                       pms),
                   "bound_ms": statistics.mean(x[0] for x in bounds),
                   "bound_by": bounds[0][1], "library_ms": None,
                   "ms_in_path": tr["in_path"].get(k.name),
                   "ms_per_bounce": ms, "bound_ms_per_bounce": [
                       x[0] for x in bounds],
                   "bytes_per_bounce": [b[nb] for b in bs],
                   "operations_per_bounce": [b[ops] for b in bs], **extra}
            if variant == "noise":
                row["contains"] = ("TPU kernel C: rust_ray_tracer_tpu/ops/"
                                   "pallas_bounce.py:125 _noise_row, :166 "
                                   "_marble_row")
            rows.append(row)
    return rows


# ---- the unfused uber bounce (RRT_NO_UBER_FUSED=1): kernels E, G, G' -----

@contextlib.contextmanager
def route_env(**env):
    """The route flags ``env`` set in ``os.environ`` inside ``with``, the
    earlier values restored after it, so later phases keep their routes."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wave_setup(label, host_fn, dev) -> dict:
    """A scene at the bench shape and its first wave's inputs: what
    ``forward_phase`` returns for the checks of one bounce, without its
    render."""
    scene = compile_scene(host_fn(), device=dev)
    key = rng.key(0, dev)
    st0, rnd = uber.wave_inputs(scene, rng.wave_key(key, 0), WIDTH, HEIGHT,
                                DEPTH, CHUNK)
    return {"label": label, "scene": scene, "key": key,
            "ctx": uber.make_ctx(scene), "st0": st0, "rnd": rnd}


def select_costs(ctx, st) -> tuple[int, int]:
    """(bytes, operations) of kernel E on the state ``st`` [14, N]: every
    lane reads 8 state planes and writes its row (W planes) and its two
    winner words, the tables once; the ray tests this state's rays make
    (A's search for one bounce, ``closest_hit_work``)."""
    n, w = st.shape[1], ctx.uni.shape[1]
    tables = sum(x.numel() * 4 for x in (ctx.uni, ctx.dflt, ctx.tri_pack,
                                         ctx.sph_pack, ctx.quad_pack,
                                         ctx.cab))
    return (8 + w + 2) * n * 4 + tables, closest_hit_work(st[None], ctx)["ops"]


def unfused_bounce_checks(label, fwd, seed=41) -> dict:
    """Kernels E, G and G' against ``select_plain``,
    ``bounce_planes_live_plain`` and ``bounce_planes_live_bwd_plain`` on
    the card, on bounces 0 and 1 of the scene's full-size wave (G's own
    output feeds bounce 1): E's winners equal kernel D's on the same state
    bit for bit and the plain version's on every lane, its rows equal; G
    within RTOL / ATOL of each lane's largest plane, FLIP_BUDGET outside;
    E then G equal to D's next state bit for bit (no library contracts an
    FMA, and G shades with D's device functions); G' with B''s sum
    within B's budget for a seeded cotangent; a dead tile's lanes passed
    through (G) and given the copy's cotangent and zero light-table
    partials (G') bit for bit; a live tile's equal to F's and F''s (a null
    flag array) bit for bit; each the same bits over two launches. Per
    bounce: ms out of L2 (G' alone, B' on its partials, G' with B'), the
    plain versions' ms, the work. Emits ``<label>_unfused_bounce_checks``."""
    ctx, st, rnd = fwd["ctx"], fwd["st0"], fwd["rnd"]
    e, g_k, gp_k = UNFUSED_KERNELS
    d = K.fused_bounce_kernel(ctx)
    n = st.shape[1]
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(13, n)).astype(np.float32)).to(st.device)
    bounces, pairs = [], {k: [] for k in ("e", "g", "gp", "sum", "red")}
    for b in (0, 1):
        rb = rnd[b]
        st8 = st[0:8]
        with torch.no_grad():
            selv, kind, idx = e(st8, ctx)
            again = e(st8, ctx)
            d_st2, d_kind, d_idx = d(st, rb, ctx)
            ref_selv, ref_kind, ref_idx = PlainCalls.real_select(st, ctx)
        if not all(torch.equal(x, y) for x, y in zip((selv, kind, idx),
                                                     again)):
            raise AssertionError(f"{label}: {e.name} differs between runs")
        if not (torch.equal(kind, d_kind) and torch.equal(idx, d_idx)):
            raise AssertionError(f"{label}: {e.name}'s winners differ from "
                                 f"{d.name}'s on the same state")
        forked = int(((kind != ref_kind) | (idx != ref_idx)).sum())
        if forked:
            raise AssertionError(f"{label}: {forked} winners of {e.name} "
                                 "differ from the plain version's")
        if not torch.equal(selv, ref_selv):
            raise AssertionError(f"{label}: {e.name}'s rows differ")
        tlive = bounce_ops.live_tiles(st[7])
        P, mkind, flags = uber._tile_planes(st, rb, selv, ctx)
        args = (P, kind, mkind, flags, ctx.lt, ctx.n_lights)
        with torch.no_grad():
            out, out2 = g_k(*args, tlive), g_k(*args, tlive)
            ref = PlainCalls.real_live(*args, tlive)
            dP, part = gp_k.partials(*args, tlive, g)
            bk, bk2 = gp_k(*args, tlive, g), gp_k(*args, tlive, g)
            bp = PlainCalls.real_live_bwd(*args, tlive, g)
            f_out = bounce_planes_kernel(*args)
            f_dP, _ = bounce_planes_bwd_kernel(*args, g)
        if not (torch.equal(out, out2) and torch.equal(bk[0], bk2[0])
                and torch.equal(bk[1], bk2[1])
                and torch.equal(dP, bk[0])):
            raise AssertionError(f"{label}: {g_k.name} or {gp_k.name} "
                                 "differs between runs")
        st_out, st_err = scaled_close(out, ref, RTOL, ATOL, FLIP_BUDGET,
                                      f"{label}: {g_k.name}")
        dst_out, dst_err = scaled_close(bk[0], bp[0], BWD_RTOL, BWD_ATOL,
                                        FLIP_BUDGET, f"{label}: {gp_k.name}")
        live = torch.repeat_interleave(tlive > 0, bounce_ops.LIVE_TILE)
        through = torch.cat([P[0:6], P[24:30], P[45:46]])
        cot = torch.zeros_like(dP)
        cot[0:6], cot[24:30] = g[0:6], g[6:12]
        dead_parts = part.reshape(-1, 8, part.shape[1])[tlive == 0]
        if not (torch.equal(out[:, ~live], through[:, ~live])
                and torch.equal(dP[:, ~live], cot[:, ~live])
                and not bool(dead_parts.any())):
            raise AssertionError(f"{label}: a dead tile did not pass "
                                 "through")
        if not (torch.equal(out[:, live], f_out[:, live])
                and torch.equal(dP[:, live], f_dP[:, live])):
            raise AssertionError(f"{label}: G, G' differ from F, F' on a "
                                 "live tile")
        st2 = torch.cat([out[0:6], st[6:7], out[12:13], out[6:12]])
        vs_d = int((st2 != d_st2).any(0).sum())
        if vs_d:
            raise AssertionError(f"{label}: E + G differ from D on {vs_d} "
                                 "lanes")
        e_cost = select_costs(ctx, st)
        g_cost = bp_live_bytes(args, tlive)
        gp_cost = bp_live_bwd_bytes(args, tlive)
        bounces.append({
            "bounce": b, "live": int((st[7] > 0.5).sum()),
            "found": int((kind > 0).sum()),
            "tiles": tlive.numel(), "dead_tiles": int((tlive == 0).sum()),
            "winners_equal_fused_bounce": True,
            "winners_forked_vs_plain": forked, "state_outside": st_out,
            "state_err": st_err, "state_lanes_differing_from_fused": vs_d,
            "dst_outside": dst_out, "dst_err": dst_err,
            "dlt_rel_l2": rel_l2(bk[1], bp[1], f"{label}: dlt", BWD_REL_L2),
            "dlt_rows_err": rows_close(bk[1], bp[1], f"{label}: dlt rows"),
            "e_bytes": e_cost[0], "e_ops": e_cost[1],
            "g_bytes": g_cost[0], "g_ops": g_cost[1],
            "gp_bytes": gp_cost[0], "gp_ops": gp_cost[1]})
        pairs["e"].append((lambda a=(st8, ctx): e(*a),
                           lambda a=(st, ctx): PlainCalls.real_select(*a)))
        pairs["g"].append((lambda a=args + (tlive,): g_k(*a),
                           lambda a=args + (tlive,): PlainCalls.real_live(
                               *a)))
        pairs["gp"].append((
            lambda a=args + (tlive, g): gp_k.partials(*a),
            lambda a=args + (tlive, g): PlainCalls.real_live_bwd(*a)))
        pairs["sum"].append((lambda a=args + (tlive, g): gp_k(*a), None))
        pairs["red"].append((light_sum_call(part), None))
        st = st2
    t = {k: bounce_times(v, plain_reps=2) for k, v in pairs.items()}
    regs = [r for lib in (e.library, g_k.library)
            for r in ptxas_report(K.build(lib).log)
            if any(f in r["function"] for f in (
                "select_kernel", "trace_wave_kernel", "fused_bounce_kernel",
                "bounce_planes_kernel", "bounce_planes_bwd_kernel"))]
    emit({"phase": f"{label}_unfused_bounce_checks",
          "kernels": [k.name for k in UNFUSED_KERNELS], "rays": n,
          "has_checker": ctx.has_checker, "bounces": bounces,
          "ms_per_launch_l2_flushed": {
              e.name: t["e"]["cold"], g_k.name: t["g"]["cold"],
              gp_k.name: t["gp"]["cold"],
              "bwd_reduce (its partials)": t["red"]["cold"],
              f"{gp_k.name}+bwd_reduce": t["sum"]["cold"]},
          "plain_ms_per_launch": {e.name: t["e"]["plain"],
                                  g_k.name: t["g"]["plain"],
                                  gp_k.name: t["gp"]["plain"]},
          "budget": {"state": [RTOL, ATOL, FLIP_BUDGET],
                     "dst": [BWD_RTOL, BWD_ATOL, FLIP_BUDGET],
                     "tables_rel_l2": BWD_REL_L2},
          "ptxas": regs})
    return {"bounces": bounces, "t": t}


def unfused_forward(fwd, dev, smi) -> dict:
    """The flagship's forward render at the bench shape through
    ``render_waves`` under ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0`` (the
    per-chunk path, E and G a bounce): the counts set to 0 just before it
    and read just after (SPP * DEPTH launches of E and G, none of A, B, D,
    D', F, F', G', no plain call); the image equal to the fused per-chunk
    route's (``RRT_UBER_WAVE=0`` alone: D) bit for bit; 7 sweeps, the
    profiled wave (E, G in the
    path, glue, busy share), peak memory. Emits
    ``unfused_flagship_forward``."""
    scene, key = fwd["scene"], fwd["key"]
    e, g_k, gp_k = UNFUSED_KERNELS

    def render(n_waves):
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, n_waves,
                                depth=DEPTH, chunk_size=CHUNK)

    with route_env(RRT_NO_UBER_FUSED="1", RRT_UBER_WAVE="0"):
        img, launches, n_plain = main_path_forward(
            "unfused flagship", render, (e, g_k), UNFUSED_OFF + (gp_k,))
        t = forward_timing(render, {e.name: UNFUSED_NAMES[e.name],
                                    g_k.name: UNFUSED_NAMES[g_k.name]}, 7,
                           dev)
    with route_env(RRT_UBER_WAVE="0"):
        ref = render(SPP)
    differ = int((img != ref).any(-1).sum())
    if differ:
        raise AssertionError(f"the unfused flagship image differs from the "
                             f"fused per-chunk one on {differ} pixels")
    vs_d = compare(img, ref, "unfused vs fused per-chunk flagship",
                   flip_abs=None)
    emit({"phase": "unfused_flagship_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "env": {"RRT_NO_UBER_FUSED": "1", "RRT_UBER_WAVE": "0"},
          "launches": launches, "plain_calls": n_plain,
          "image_mean": float(img.mean()) / SPP,
          "pixels_differing_from_fused": differ,
          "vs_fused_per_chunk": vs_d, **t["fields"]})
    return {"launches": launches, "in_path": t["in_path"]}


def unfused_train(fwd, dev, smi) -> dict:
    """``bench.py``'s training step on the flagship under
    ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0`` (``main_path_train``): SPP *
    DEPTH launches each of E, G and G', B' twice a bounce (G''s light-table
    partials, E's row sums), none of A, B, D, D', F, F', no plain call;
    gradients finite, bitwise over two steps, non-zero on tri_v0,
    tex_color and camera.c2w; 7 timed steps, forward and backward apart,
    the profiled one-wave step (E, G, G', B' in the path), peak memory.
    Emits ``unfused_flagship_train``."""
    with route_env(RRT_NO_UBER_FUSED="1", RRT_UBER_WAVE="0"):
        r = main_path_train(
            "unfused flagship", fwd["scene"], fwd["key"], UNFUSED_KERNELS,
            UNFUSED_OFF, ("tri_v0", "tex_color", "camera.c2w"),
            UNFUSED_NAMES, ("select", "bounce_planes_live"),
            ("bounce_planes_live_bwd",), 7, dev)
    emit({"phase": "unfused_flagship_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "env": {"RRT_NO_UBER_FUSED": "1", "RRT_UBER_WAVE": "0"},
          **r["fields"]})
    return {"launches": r["launches"], "in_path": r["in_path"]}


def unfused_sharded(fwd, mesh, smi) -> dict:
    """``render_waves_sharded`` on the one-rank world at 128x72, SPP spp,
    under ``RRT_NO_UBER_FUSED=1``: SPP * DEPTH launches of E and G, none of
    D; its image equal bit for bit to ``render_waves``' under
    ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``. Emits ``unfused_sharded``."""
    scene, key = fwd["scene"], fwd["key"]
    e, g_k, _ = UNFUSED_KERNELS
    watched = (e, g_k) + D_KERNELS
    with route_env(RRT_NO_UBER_FUSED="1"), torch.no_grad():
        for k in watched:
            k.launches = 0
        img = render_waves_sharded(scene, SHARD_W, SHARD_H, key, 0, SPP,
                                   mesh, DEPTH, SHARD_CHUNK)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in watched}
        with route_env(RRT_UBER_WAVE="0"):
            ref = render_waves(scene, SHARD_W, SHARD_H, key, 0, SPP,
                               depth=DEPTH, chunk_size=SHARD_CHUNK)
    want = {k.name: 0 for k in watched}
    want[e.name] = want[g_k.name] = SPP * DEPTH
    if launches != want:
        raise AssertionError(f"unfused sharded launches {launches}, "
                             f"expected {want}")
    if not torch.equal(img, ref):
        raise AssertionError("unfused sharded image differs from "
                             "render_waves'")
    out = {"phase": "unfused_sharded", "card": smi,
           "shape": [SHARD_H, SHARD_W, SPP, DEPTH],
           "chunk_size": SHARD_CHUNK, "world": mesh.size,
           "backend": mesh.backend, "launches": launches,
           "bitwise_vs_render_waves": True}
    emit(out)
    return out


def unfused_cli(smi) -> dict:
    """The CLI on the card under ``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``
    (the Cornell box, 72x72, 2 spp, a fresh checkpoint): E and G launched
    DEPTH times a wave, no D; a finite image. Emits ``unfused_cli``."""
    e, g_k, _ = UNFUSED_KERNELS
    watched = (e, g_k) + D_KERNELS + WHOLE_WAVE_KERNELS
    buf = io.StringIO()
    with route_env(RRT_NO_UBER_FUSED="1", RRT_UBER_WAVE="0"), \
            tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(buf):
        for k in watched:
            k.launches = 0
        rc = cli.main(["72", "2", "--scene", "cornell_box", "-a", "1.0",
                       "-o", os.path.join(td, "c.png"), "--device", "cuda",
                       "--devices", "1", "--checkpoint",
                       os.path.join(td, "c.ckpt")])
        launches = {k.name: k.launches for k in watched}
    line = buf.getvalue().strip()
    want = {k.name: 0 for k in watched}
    want[e.name] = want[g_k.name] = 2 * DEPTH
    if rc != 0 or "finite True" not in line or launches != want:
        raise AssertionError(f"unfused CLI: exit {rc}, launches {launches}"
                             f", expected {want}: {line}")
    out = {"phase": "unfused_cli", "card": smi, "launches": launches,
           "stdout": line.splitlines()[-1]}
    emit(out)
    return out


def unfused_rows(checks, fwd, train) -> list[dict]:
    """The ``{"kernels": [...]}`` rows of E, G and G': the launches of the
    unfused training step; ms out of L2 and plain ms averaged over the
    flagship's bounces 0 and 1, the bound from those bounces' data; the
    profiler's in-path ms (E and G in the forward, G' in the step)."""
    c = checks["flagship"]
    bs, t = c["bounces"], c["t"]
    src = "rust_ray_tracer_tpu_torch/csrc/"
    rows = []
    for k, file, repl, key, err, in_path, extra in (
            (K.select_kernel, "trace_wave.cu", "pallas_uber.py:392", "e",
             0.0, fwd["in_path"].get("select"),
             {"winners_forked_vs_plain": [b["winners_forked_vs_plain"]
                                          for b in bs]}),
            (K.bounce_planes_live_kernel, "split.cu", "pallas_bounce.py:497",
             "g", max(b["state_err"] for b in bs),
             fwd["in_path"].get("bounce_planes_live"), {}),
            (K.bounce_planes_live_bwd_kernel, "split.cu",
             "pallas_bounce.py:532", "gp", max(b["dst_err"] for b in bs),
             train["in_path"].get("bounce_planes_live_bwd"),
             {"ms_with_bwd_reduce": statistics.mean(t["sum"]["cold"])})):
        bounds = [bound(b[f"{key}_bytes"], b[f"{key}_ops"]) for b in bs]
        rows.append({
            "name": k.name, "route": "cuda", "source": src + file,
            "replaces": f"rust_ray_tracer_tpu/ops/{repl}",
            "launches": train["launches"][k.name], "max_abs_err": err,
            "ms": statistics.mean(t[key]["cold"]),
            "plain_ms": statistics.mean(t[key]["plain"]),
            "bound_ms": statistics.mean(x[0] for x in bounds),
            "bound_by": bounds[0][1], "library_ms": None,
            "ms_in_path": in_path, "ms_per_bounce": t[key]["cold"],
            "bound_ms_per_bounce": [x[0] for x in bounds],
            "bytes_per_bounce": [b[f"{key}_bytes"] for b in bs],
            "operations_per_bounce": [b[f"{key}_ops"] for b in bs],
            **extra})
    return rows


# ---------------------------------------------------------------------------
# the compact wavefront (render_waves(compact=True), the CLI's --compact):
# every scene on the split route's kernels, each bounce on the live rays
# ---------------------------------------------------------------------------

COMPACT_FWD_ALL = (SPLIT_KERNELS + SEARCH_KERNELS + FUSED_KERNELS
                   + CULL_KERNELS + (shade_kernel,))
COMPACT_BWD_ALL = SPLIT_BWD_KERNELS + FUSED_BWD_KERNELS + (shade_bwd_kernel,)
COMPACT_OFF = (WHOLE_WAVE_KERNELS + D_KERNELS + D_BWD_KERNELS
               + UNFUSED_KERNELS)
# scene -> (forward kernels a bounce, backward kernels a bounce, leaves whose
# gradient must be non-zero): what bounce_split runs on each
COMPACT_ROUTES = {
    "flagship": ((tile_enter_kernel, fused_search_kernel,
                  bounce_planes_kernel), FUSED_BWD_KERNELS,
                 ("tri_v0", "tex_color", "camera.c2w")),
    "random": ((sph_search_kernel, hit_attrs_kernel, shade_update_kernel),
               SPLIT_BWD_KERNELS, ("tex_scale", "sph_c0", "tex_color")),
    "final_scene": ((quad_search_kernel, hit_attrs_kernel,
                     shade_update_kernel), SPLIT_BWD_KERNELS,
                    ("tex_color", "background")),
    "random_earth": ((sph_search_kernel, hit_attrs_kernel,
                      shade_update_kernel), SPLIT_BWD_KERNELS,
                     ("img_data", "tex_color", "sph_c0")),
}
# rounds of the compact route's forward sweep and step timed in turns
# with the scene's own route's (alternate_ms)
COMPACT_REPS = 2


class CompactStats:
    """Inside ``with``, each wave ``render_waves`` sends through
    ``ops/integrator.trace_wave_compact`` records its bounces' live rays,
    lanes and host sync (the function's ``stats``) in ``waves``, a list a
    wave."""

    def __enter__(self):
        self.waves = []
        self._real = integrator.trace_wave_compact

        def recorded(*args, **kw):
            self.waves.append([])
            return self._real(*args, **kw, stats=self.waves[-1])
        integrator.trace_wave_compact = recorded
        return self

    def __exit__(self, *exc):
        integrator.trace_wave_compact = self._real

    def bounces_run(self) -> int:
        return sum(1 for w in self.waves for b in w if b["n_alive"])


def recorded_lanes(rec) -> dict:
    """The rays each recorded dispatcher call covered
    (``split_recorder``'s lists): {key: [rays a call]}."""
    return {key: [int(c[1].shape[0]) if key == "quad" else
                  int(c[0].shape[-1]) for c in calls]
            for key, calls in rec.items() if calls and key != "order"}


def alternate_ms(fns, reps) -> list[list[float]]:
    """Device ms of each of ``fns`` by CUDA events, ``reps`` rounds
    calling them in turn (the callers have run each before: no
    warm-up)."""
    torch.cuda.synchronize()
    out = [[] for _ in fns]
    for _ in range(reps):
        for f, times in zip(fns, out):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
    return out


def compact_phase(label, host_fn, dev, smi, probe=False) -> dict:
    """``render_waves(compact=True)`` on ``label``'s scene at the bench
    shape: the split route's kernels (``COMPACT_ROUTES``) on every bounce
    that has a live ray, none of the others, no plain call; the image
    finite, the same bits twice, against the same scene's render on its
    own route (the trace kernel A on the flagship and random) bit for
    bit;
    on one recorded wave each kernel against its plain version on the
    compacted inputs of bounces 0 and 1 (K, M, F, F', N) and of bounce 1
    (O, J, H, J', H'), and every launch covering the live prefix only
    (its rays equal the bounce's lanes, ``ceil(n_alive / CHUNK) * CHUNK``);
    forward and step ms against the route's own in turns (CUDA events),
    each bounce's live rays and host sync, a profiled wave;
    ``bench.py``'s training step through it (:func:`main_path_train`:
    gradients finite, bitwise over two steps, non-zero on the route's
    leaves; peak memory), the gradients' relative L2 distance from the
    route's own; with ``probe`` (the flagship and random), B' on the
    one-wave step's row sums against float64 and the order replay, and
    ``utils/metrics.occupancy_probe`` of wave 0 against the compact
    wave's live counts. Emits ``compact_<label>``."""
    fwd_k, bwd_k, nonzero = COMPACT_ROUTES[label]
    scene = compile_scene(host_fn(), device=dev)
    key = rng.key(0, dev)
    tables = make_split_tables(scene)
    route = {"trace_kernel_scene": uber.uber_eligible(scene),
             "fused": tables.fused, "su": tables.su,
             "unified": tables.unified, "sphere_kernel": tables.sph
             is not None, "auto_compact": integrator.auto_compact(scene)}

    def render(n_waves, compact=True):
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, n_waves,
                                depth=DEPTH, chunk_size=CHUNK,
                                compact=compact)

    watched = COMPACT_FWD_ALL + COMPACT_BWD_ALL + COMPACT_OFF
    with CompactStats() as warm:
        render(SPP)
    runs = warm.bounces_run()
    img, launches, n_plain = main_path_forward(
        f"{label} compact", render, fwd_k,
        tuple(k for k in watched if k not in fwd_k) + (bwd_reduce_kernel,),
        per_kernel=runs)
    if not torch.equal(img, render(SPP)):
        raise AssertionError(f"{label}: two compact renders differ")
    own = render(SPP, compact=False)
    vs_own = compare(img, own, f"{label}: compact vs its own route",
                     flip_abs=None)
    vs_own.update(bitwise=bool(torch.equal(img, own)),
                  pixels_differing=int((img != own).any(-1).sum()),
                  budget={"flip_frac": FLIP_BUDGET, "rtol": RTOL,
                          "atol": ATOL})
    # every scene's compact image is its own route's bit for bit, random's
    # since the split route's marble sums its corner dots in C's order
    # (marble_trace)
    if not vs_own["bitwise"]:
        raise AssertionError(f"{label}: the compact image differs from its "
                             f"own route's on {vs_own['pixels_differing']} "
                             "pixels")

    with torch.no_grad(), split_recorder() as rec, CompactStats() as one:
        wave = render(1)
    stats = one.waves[0]
    ran = [b["lanes"] for b in stats if b["n_alive"]]
    lanes = recorded_lanes(rec)
    for k, v in lanes.items():
        if v != ran:
            raise AssertionError(f"{label}: {k} launches covered {v} rays, "
                                 f"the live prefixes are {ran}")
    with torch.no_grad():
        checks = split_kernels_vs_plain({k: v[1:] for k, v in rec.items()},
                                        f"{label} compact bounce 1")
        checks.update(search_fused_vs_plain(rec, f"{label} compact"))
        checks.update(cull_vs_plain(rec, f"{label} compact", (0, 1)))
    del rec
    names = {k.name: f"{k.name}_kernel" for k in fwd_k}
    timing = forward_timing(render, names, 1, dev)
    fwd_c, fwd_own = alternate_ms(
        [lambda: render(SPP), lambda: render(SPP, compact=False)],
        COMPACT_REPS)
    prof_own = profile_device(lambda: render(1, compact=False), ())

    bwd_names = tuple(k.name for k in bwd_k)
    t = main_path_train(
        f"{label} compact", scene, key, fwd_k + bwd_k,
        tuple(k for k in watched if k not in fwd_k + bwd_k),
        nonzero, {**names, **{n: f"{n}_kernel" for n in bwd_names}},
        tuple(names), bwd_names, 1, dev, compact=True, per_kernel=runs,
        splits=1)
    params, static = partition(scene)

    def step_own():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0, SPP,
                     depth=DEPTH, chunk_size=CHUNK).mean().backward()
        return {k: v.grad for k, v in leaves.items()}

    g_own = step_own()
    step_c, step_own_ms = alternate_ms([t["step"], step_own], COMPACT_REPS)
    row_sums = None
    if probe:
        with RowSumCalls() as sums:
            t["step"](1)
            torch.cuda.synchronize()
        row_sums = row_sums_vs_float64(sums.calls)
        del sums
    out = {"phase": f"compact_{label}", "card": smi,
           "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
           "route": route, "launches": launches, "plain_calls": n_plain,
           "bounces_run": runs, "image_mean": float(img.mean()) / SPP,
           "vs_own_route": vs_own, "wave_finite": bool(
               torch.isfinite(wave).all()),
           "live_rays_per_bounce": [b["n_alive"] for b in stats],
           "lanes_per_bounce": [b["lanes"] for b in stats],
           "sync_ms_per_bounce": [b["sync_ms"] for b in stats],
           "lanes_per_launch": lanes, "kernels_vs_plain": checks,
           **timing["fields"],
           "fwd_ms_compact": fwd_c, "fwd_ms_own_route": fwd_own,
           "fwd_mrays_per_s_compact": rate_fields("x", fwd_c)["mrays"],
           "fwd_mrays_per_s_own_route": rate_fields("x", fwd_own)["mrays"],
           "busy_share_own_route_wave": prof_own["busy_share"],
           "train": t["fields"], "step_ms_compact": step_c,
           "step_ms_own_route": step_own_ms,
           "step_mrays_per_s_compact": rate_fields("x", step_c)["mrays"],
           "step_mrays_per_s_own_route": rate_fields("x",
                                                     step_own_ms)["mrays"],
           "grad_rel_l2_vs_own_route": {
               k: rel_l2_of(v, g_own[k]) for k, v in t["grads"].items()
               if g_own.get(k) is not None and bool(g_own[k].any())},
           "row_sums_vs_float64": row_sums}
    if probe:
        occ = occupancy_probe(scene, WIDTH, HEIGHT, key, DEPTH, CHUNK)
        total = -(-WIDTH * HEIGHT // CHUNK) * CHUNK
        counts = np.rint(occ.occupancy * total).astype(int).tolist()
        if counts[:len(stats)] != [b["n_alive"] for b in stats]:
            raise AssertionError(f"{label}: occupancy_probe {counts} vs the "
                                 f"compact wave's live rays {stats}")
        out["occupancy_probe"] = {
            "occupancy": occ.occupancy.tolist(),
            "depth_histogram": occ.depth_histogram.tolist(),
            "wall_s": occ.wall_s, "equals_compact_live_rays": True}
    emit(out)
    return {"launches": t["launches"], "forward_launches": launches,
            "label": label}


def _differ(got, ref) -> dict:
    """Lanes where two float tensors of the same shape differ (any entry
    of a lane's last axis for 2-D tensors), and the largest |difference|."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    diff = (got - ref).abs()
    lane = diff.reshape(diff.shape[0], -1).amax(1) if diff.dim() > 1 \
        else diff
    return {"differ": int((lane > 0).sum()), "max_abs": float(lane.max())
            if lane.numel() else 0.0}


def _noise_reduced(perlin_vec, px, py, pz, p):
    """``ops/perlin.noise`` with its corner dot as torch's reduction
    ``(grad * weight).sum(-1)``, the form it had: on CUDA that reduction
    adds the three terms in another order than C's ``(a + b) + c``."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    perm = (px.long(), py.long(), pz.long())
    h = [[perm[a][((ijk[..., a] + d) & 255).long()] for d in (0, 1)]
         for a in range(3)]
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                g = perlin_vec[(h[0][di] ^ h[1][dj] ^ h[2][dk]).long()]
                weight = uvw - torch.tensor([di, dj, dk], dtype=p.dtype,
                                            device=p.device)
                w = ((di * s[..., 0] + (1 - di) * (1 - s[..., 0]))
                     * (dj * s[..., 1] + (1 - dj) * (1 - s[..., 1]))
                     * (dk * s[..., 2] + (1 - dk) * (1 - s[..., 2])))
                acc = acc + w * (g * weight).sum(-1)
    return acc


# marble_trace's pairs that must be equal bit for bit on every lane
MARBLE_EQUAL = ("next_state_differ", "j_p_vs_d_origin",
                "texture_value_cuda_vs_c", "plain_marble_cuda_vs_c",
                "turb_acc_cuda_vs_c", "turb_cuda_vs_c_abs",
                "turb_acc_cpu_vs_c")


def marble_trace(dev, smi) -> dict:
    """Random's compact image against A-noise's on the card (it differed
    below RTOL / ATOL on ~5% of a full-size render's pixels while the two
    are bitwise equal on the CPU), traced to its operation. Three places
    could differ: the split route's marble (``ops/texture._leaf_value``
    over ``perlin.turb``, torch ops on CUDA) against C
    (``csrc/trace_common.cuh`` ``marble``, inside A-noise), ``torch.sin``
    on CUDA against C's ``sinf``, and J's hit point against A's. On a
    full-size wave's bounces 0 and 1 the split route's bounce
    (``bounce_split``: N, J, ``texture_value``, H) and D-noise (A's body
    launched for one bounce) take the same state and randoms. Per bounce:
    the next states' lanes that differ, J's hit point against D's next
    origin on the lanes both keep alive, and on the noise hits the marble
    of ``texture_value`` and of ``perlin.marble`` (C's plain version) on
    CUDA and on the CPU against C itself (the probe
    ``kernels.marble_probe_kernel``), the signed octave sums, every octave
    of ``perlin.noise`` against ``perlin._noise_row``, against itself on
    the CPU and against its old corner dot (:func:`_noise_reduced`), and
    ``torch.sin`` of the marble's argument on both devices. The pairs of
    :data:`MARBLE_EQUAL` must be equal on every lane; the CPU's marble
    differs from C's by the host's ``sinf``. Emits ``marble_trace``."""
    from rust_ray_tracer_tpu_torch.ops import perlin, texture
    t0 = time.perf_counter()
    scene = compile_scene(builders.random_scene(WIDTH / HEIGHT), device=dev)
    cpu = scene.to("cpu")
    ctx = uber.make_ctx(scene)
    tables = make_split_tables(scene)
    tab_cpu = perlin.PerlinTables(ctx.perlin.vec.cpu(),
                                  ctx.perlin.perm.cpu())
    tabs = (scene.perlin_vec, scene.perlin_px, scene.perlin_py,
            scene.perlin_pz)
    tabs_cpu = (cpu.perlin_vec, cpu.perlin_px, cpu.perlin_py, cpu.perlin_pz)
    st, rnd = uber.wave_inputs(scene, rng.wave_key(rng.key(0, dev), 0),
                               WIDTH, HEIGHT, DEPTH, CHUNK)
    d_kernel = K.fused_bounce_kernel(ctx)
    rec = {}
    real_tex = integrator.texture_value

    def tex_hook(sc, tid, u, v, p):
        out = real_tex(sc, tid, u, v, p)
        rec["tex"] = (tid, u, v, p, out)
        return out

    out = {"phase": "marble_trace", "card": smi, "bounces": []}
    launches0 = K.marble_probe_kernel.launches
    for b in (0, 1):
        rnd_b = rnd[b].contiguous()
        integrator.texture_value = tex_hook
        try:
            with torch.no_grad():
                st_split = integrator.bounce_split(scene, st, rnd_b, tables,
                                                   CHUNK)
        finally:
            integrator.texture_value = real_tex
        st_d, _, _ = d_kernel(st, rnd_b, ctx)
        torch.cuda.synchronize()
        both = (st_split[7] > 0.5) & (st_d[7] > 0.5)
        tid, u, v, p, alb = rec["tex"]
        noise = scene.tex_kind[tid] == S.TEX_NOISE
        pn = p[noise].contiguous()
        scale = scene.tex_scale[tid[noise]].contiguous()
        pc = pn.cpu()
        px, py, pz = pn[:, 0], pn[:, 1], pn[:, 2]
        cx, cy, cz = pc[:, 0], pc[:, 1], pc[:, 2]
        alb_cpu = texture.texture_value(cpu, tid.cpu(), u.cpu(), v.cpu(),
                                        p.cpu())
        probe_acc, probe = K.marble_probe_kernel(pn, scale, ctx.perlin)
        turb_cuda = perlin.turb(*tabs, pn)
        octaves = []
        for o in range(perlin.OCTAVES):
            q = pn * float(2 ** o)
            n_cuda = perlin.noise(*tabs, q)
            octaves.append({
                "noise_vs_noise_row_cuda": _differ(n_cuda, perlin._noise_row(
                    ctx.perlin, q[:, 0], q[:, 1], q[:, 2])),
                "noise_cuda_vs_cpu": _differ(n_cuda,
                                             perlin.noise(*tabs_cpu, q.cpu())),
                "sum_reduce_vs_noise_cuda": _differ(
                    _noise_reduced(*tabs, q), n_cuda)})
        arg = scale * pz + 10.0 * turb_cuda
        row = {
            "bounce": b, "lanes": int(st.shape[1]),
            "next_state_differ": _differ(st_split.T, st_d.T),
            "alive_both": int(both.sum()),
            "j_p_vs_d_origin": _differ(p[both], st_d[0:3].T[both]),
            "noise_hits": int(noise.sum()),
            "texture_value_cuda_vs_c": _differ(alb[noise, 0], probe),
            "texture_value_cpu_vs_c": _differ(alb_cpu[noise.cpu(), 0],
                                              probe),
            "plain_marble_cuda_vs_c": _differ(perlin.marble(
                ctx.perlin, px, py, pz, scale), probe),
            "plain_marble_cpu_vs_c": _differ(perlin.marble(
                tab_cpu, cx, cy, cz, scale.cpu()), probe),
            "turb_acc_cuda_vs_c": _differ(perlin._turb_acc(
                ctx.perlin, px, py, pz), probe_acc),
            "turb_acc_cpu_vs_c": _differ(perlin._turb_acc(
                tab_cpu, cx, cy, cz), probe_acc),
            "turb_cuda_vs_c_abs": _differ(turb_cuda, probe_acc.abs()),
            "sin_cuda_vs_cpu_same_arg": _differ(torch.sin(arg),
                                                torch.sin(arg.cpu())),
            "octaves": octaves}
        out["bounces"].append(row)
        bad = [k for k in MARBLE_EQUAL if row[k]["differ"]] + [
            f"octave {i}" for i, o in enumerate(octaves)
            if o["noise_vs_noise_row_cuda"]["differ"]
            or o["noise_cuda_vs_cpu"]["differ"]]
        if bad or not bool(torch.isfinite(probe).all()):
            raise AssertionError(f"marble_trace bounce {b}: {bad}: {row}")
        st = st_split
    out["probe_launches"] = K.marble_probe_kernel.launches - launches0
    if out["probe_launches"] != 2:
        raise AssertionError(f"marble_trace: {out['probe_launches']} probe "
                             "launches")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def compact_cli(smi, paths) -> dict:
    """The CLI's ``--compact`` on the card at 128x72, 2 spp: ``auto`` (the
    default) off on random (kernel A) and on final_scene (its own split
    route), as ``auto_compact`` answers on the card, the decision printed
    and the kernels launched accordingly; ``--compact on --devices 1`` on
    the single-light glTF
    flagship (``paths["f1"]``: K, M, F, no A); then final_scene's auto run
    again in a new process with ``--cache-dir`` at a copy of this run's
    build directory: the same PNG, no library rebuilt (the copy's files
    and times unchanged). Emits ``compact_cli``."""
    watched = (COMPACT_FWD_ALL + COMPACT_BWD_ALL + COMPACT_OFF
               + (bwd_reduce_kernel,))
    out = {"phase": "compact_cli", "card": smi}
    with tempfile.TemporaryDirectory() as td:
        # (name, arguments, extra, the auto decision, a trace-kernel scene)
        cases = (("random", ["--scene", "random"], [], "off", True),
                 ("final_scene", ["--scene", "final_scene"], [], "off",
                  False),
                 ("flagship", ["-g", paths["f1"]],
                  ["--compact", "on", "--devices", "1"], None, True))
        for name, scene_args, extra, decision, trace_scene in cases:
            buf = io.StringIO()
            png = os.path.join(td, f"{name}.png")
            with contextlib.redirect_stdout(buf):
                for k in watched:
                    k.launches = 0
                rc = cli.main(["72", "2", *scene_args, "-o", png,
                               "--device", "cuda", *extra])
                launches = {k.name: k.launches for k in watched
                            if k.launches}
            text = buf.getvalue()
            m = re.search(r"compact=auto -> (on|off)", text)
            got = m.group(1) if m else None
            if rc != 0 or "finite True" not in text or got != decision:
                raise AssertionError(f"compact CLI on {name}: exit {rc}, "
                                     f"decision {got}: {text}")
            on = decision != "off"
            a_ran = any(launches.get(k.name) for k in WHOLE_WAVE_KERNELS)
            if a_ran != (trace_scene and not on) or (on and not any(
                    launches.get(k.name) for k in COMPACT_FWD_ALL)):
                raise AssertionError(f"compact CLI on {name}: launches "
                                     f"{launches}")
            out[name] = {"decision": got or "on", "launches": launches,
                         "stdout": text.strip().splitlines()[-1]}
        cache = os.path.join(td, "kernels")
        shutil.copytree(K.BUILD_DIR, cache)
        before = {f: os.stat(os.path.join(cache, f)).st_mtime_ns
                  for f in os.listdir(cache)}
        env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        png = os.path.join(td, "final_cache.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rust_ray_tracer_tpu_torch", "72", "2",
             "--scene", "final_scene", "-o", png, "--device", "cuda",
             "--cache-dir", cache], capture_output=True, text=True,
            timeout=300, env=env, cwd=td)
        seconds = time.perf_counter() - t0
        after = {f: os.stat(os.path.join(cache, f)).st_mtime_ns
                 for f in os.listdir(cache)}
        if proc.returncode != 0 or after != before:
            raise AssertionError(f"--cache-dir: exit {proc.returncode}, "
                                 f"files {sorted(set(after) ^ set(before))}"
                                 f": {proc.stderr[-2000:]}")
        with open(png, "rb") as f, open(os.path.join(
                td, "final_scene.png"), "rb") as g:
            same = f.read() == g.read()
        if not same:
            raise AssertionError("--cache-dir: final_scene's PNG differs")
        out["cache_dir"] = {"libraries": len(before), "rebuilt": 0,
                            "png_equal": True, "process_seconds": seconds,
                            "stdout": proc.stdout.strip().splitlines()[-1]}
    emit(out)
    return out


GATE = "rust_ray_tracer_tpu_torch.tools.verify_gpu_parity"
GATE_KEYS = ("bitwise", "maxabs", "flip_rate", "rel_mean", "bias",
             "worst_leaf", "worst_rel_l2", "seconds", "error")


def parity_gate(smi) -> dict:
    """The port's parity gate (``python -m`` :data:`GATE`) in two new
    processes: the whole matrix must exit 0 with every row green; then
    ``--inject`` (the same CPU twins, kept in a temporary directory
    between the runs) must exit non-zero with every row that must fail
    red by its numbers, not by an exception, and every row it does not
    perturb (compact, sharded, unfused) still green. Emits
    ``parity_gate`` with each row's numbers and both runs' seconds."""
    t_phase = time.perf_counter()
    out = {"phase": "parity_gate", "card": smi}
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    from rust_ray_tracer_tpu_torch.tools.verify_gpu_parity import SCENES
    with tempfile.TemporaryDirectory() as td:
        # --inject perturbs no row of the card-only scenes (CARD_SCENES:
        # the big mesh, the card against itself): the injected run leaves
        # them out
        for label, extra in (("plain", []),
                             ("inject", ["--inject", *SCENES])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", GATE, "--twin-cache", td, *extra],
                capture_output=True, text=True, timeout=600, env=env,
                cwd=ROOT)
            lines = [json.loads(x) for x in proc.stdout.splitlines()
                     if x.startswith("{")]
            rows = [x for x in lines if "row" in x]
            gate = lines[-1] if lines else {}
            out[label] = {
                "exit": proc.returncode,
                "seconds": time.perf_counter() - t0,
                "gate": gate,
                "rows": [{"scene": r["scene"], "row": r["row"],
                          "ok": r["ok"], "must_fail": r["must_fail"],
                          **{k: r[k] for k in GATE_KEYS if k in r}}
                         for r in rows]}
            if gate.get("gate") != "gpu_parity_matrix" or any(
                    "row" not in x and "gate" not in x for x in lines):
                raise AssertionError(f"parity gate ({label}): exit "
                                     f"{proc.returncode}: "
                                     f"{proc.stdout[-3000:]}"
                                     f"{proc.stderr[-3000:]}")
    plain, inj = out["plain"], out["inject"]
    red = [r for r in plain["rows"] if not r["ok"]]
    if plain["exit"] != 0 or red or not plain["gate"]["ok"]:
        raise AssertionError(f"parity gate: exit {plain['exit']}, red rows "
                             f"{red}")
    missed = [r for r in inj["rows"] if r["must_fail"]
              and (r["ok"] or "error" in r)]
    moved = [r for r in inj["rows"]
             if r["row"] in ("compact", "sharded", "unfused") and not r["ok"]]
    must = sum(r["must_fail"] for r in inj["rows"])
    if inj["exit"] == 0 or missed or moved or not must:
        raise AssertionError(f"parity gate --inject: exit {inj['exit']}, "
                             f"rows not red {missed}, unperturbed rows red "
                             f"{moved}")
    out["rows"] = len(plain["rows"])
    out["inject_red_rows"] = sum(not r["ok"] for r in inj["rows"])
    out["inject_must_fail_rows"] = must
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def cli_phase(scene, height, spp, lo, hi) -> dict:
    """The CLI on the card through the per-chunk route (``--compact off``
    named, so that the CLI's default cannot change what this phase
    drives; ``compact_cli`` drives ``auto``): a PNG written and a finite
    mean radiance in [lo, hi]."""
    os.makedirs("output", exist_ok=True)
    out_png = os.path.join("output", f"{scene}_torch.png")
    buf = io.StringIO()
    # a fresh checkpoint, so that every wave renders on the card
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(buf):
        rc = cli.main([str(height), str(spp), "--scene", scene, "-a", "1.0",
                       "-o", out_png, "--device", "cuda", "--compact",
                       "off", "--checkpoint", os.path.join(td, "c.ckpt")])
    line = buf.getvalue().strip()
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {line}")
    if f"wave {spp}/{spp}" not in line:
        raise AssertionError(f"CLI rendered no wave: {line}")
    m = re.search(r"mean radiance ([0-9.eE+-]+|nan|inf), finite (\w+)", line)
    if not m or m.group(2) != "True":
        raise AssertionError(f"CLI image not finite: {line}")
    mean = float(m.group(1))
    if not lo <= mean <= hi:
        raise AssertionError(f"implausible {scene} mean radiance {mean}")
    if not os.path.getsize(out_png):
        raise AssertionError(f"{out_png} is empty")
    return {"scene": scene, "output": out_png, "mean_radiance": mean,
            "stdout": line}


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = torch.device("cuda", 0)

    # ---- 2. build: every library, one nvcc each, in parallel --------------
    t0 = time.perf_counter()
    builds = K.build_all()
    for k in ((trace_wave_kernel, trace_wave_noise_kernel,
               trace_wave_bwd_kernel, trace_wave_bwd_noise_kernel,
               bwd_reduce_kernel) + SPLIT_KERNELS + SPLIT_BWD_KERNELS
              + SEARCH_KERNELS + PACKED_KERNELS + FUSED_KERNELS
              + FUSED_BWD_KERNELS + CULL_KERNELS + SHADE_KERNELS + D_KERNELS
              + D_BWD_KERNELS + UNFUSED_KERNELS):
        k.load()
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0,
          "shade_max_lights": K.shade_max_lights(),
          "libraries": {n: {"file": b.path.name, "nvcc_seconds": b.seconds,
                            "ptxas": ptxas_report(b.log)}
                        for n, b in builds.items()}})

    # ---- 3. kernels vs plain on small scenes -----------------------------
    small = small_scene_checks(dev)
    small_split = split_scene_checks(dev)

    # ---- 4, 5. flagship forward and training step at full size -----------
    # the procedural flagship whether or not the reference's assets are
    # on the machine (builders.flagship() would load suzanne.gltf there)
    flag_fwd = forward_phase("flagship", builders.procedural_flagship, dev,
                             smi, tris=968)
    flag_train = train_phase("flagship", flag_fwd, dev, smi,
                             ("tri_v0", "tex_color", "camera.c2w"),
                             ("sph_c0", "sph_r", "light_c", "light_r"))

    # ---- 6, 7. random (marble-noise ground): forward, training step ------
    rand_fwd = forward_phase(
        "random", lambda: builders.random_scene(WIDTH / HEIGHT), dev, smi)
    rand_train = train_phase("random", rand_fwd, dev, smi,
                             ("tex_scale", "sph_c0", "sph_r", "tex_color"),
                             ("background", "camera.c2w"), ("perlin_vec",))

    # ---- 7a. the search of A, D and E (closest_hit): D's and E's winners
    # against A's residual winners on every bounce of both scenes' full-size
    # wave, the live lanes, the occupancy
    search_checks = {"plain": search_chain_checks("flagship", flag_fwd,
                                                  flag_train),
                     "noise": search_chain_checks("random", rand_fwd,
                                                  rand_train)}

    # ---- 7b. the per-chunk path (the sharded renderer's body): kernels D
    # and D' against their plain versions on a full-size wave's bounces 0
    # and 1; the sharded forward and training step of the flagship and of
    # random on a one-rank NCCL world; two gloo ranks on the one card;
    # checkpoint / resume and the CLI's restart
    t0 = time.perf_counter()
    d_checks = {"plain": fused_bounce_checks("flagship", flag_fwd),
                "noise": fused_bounce_checks("random", rand_fwd)}
    # ---- 7c. the unfused bounce (RRT_NO_UBER_FUSED=1): E, G and G' against
    # their plain versions on the full-size bounces 0 and 1 of the flagship
    # and of the checker-ground scene of phase 3 (triangles, spheres of
    # three materials, a rect light), the flagship's forward and training
    # step
    # through render_waves with RRT_UBER_WAVE=0; each phase restores the
    # environment, so the later phases keep their routes
    t1 = time.perf_counter()
    chk = wave_setup("solid_checker", lambda: solid_scene(checker=True),
                     dev)
    u_checks = {"flagship": unfused_bounce_checks("flagship", flag_fwd),
                "solid_checker": unfused_bounce_checks("solid_checker",
                                                       chk)}
    if not sum(b["dead_tiles"] for b in u_checks["flagship"]["bounces"]):
        raise AssertionError("no dead tile on the flagship's bounces")
    u_fwd = unfused_forward(flag_fwd, dev, smi)
    u_train = unfused_train(flag_fwd, dev, smi)
    u_seconds = time.perf_counter() - t1
    multihost_init(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        mesh = make_mesh(device=dev)
        if mesh.backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"mesh {mesh}")
        d_trains = {}
        for variant, fwd, keys in (
                ("plain", flag_fwd, ("tri_v0", "tex_color", "camera.c2w")),
                ("noise", rand_fwd, ("tex_scale", "sph_c0", "tex_color"))):
            label = "flagship" if variant == "plain" else "random"
            sharded_forward(label, fwd, mesh, dev, smi)
            d_trains[variant] = sharded_train(label, fwd, mesh, dev, smi,
                                              keys)
        t1 = time.perf_counter()
        unfused_sharded(flag_fwd, mesh, smi)
        u_seconds += time.perf_counter() - t1
    finally:
        torch.distributed.destroy_process_group()
    t1 = time.perf_counter()
    unfused_cli(smi)
    u_seconds += time.perf_counter() - t1
    sharded_two_ranks(dev, smi)
    checkpoint_resume(dev, smi)
    emit({"phase": "per_chunk_phases", "seconds": time.perf_counter() - t0,
          "unfused_seconds": u_seconds})

    # ---- 8. final_scene (media, the split route): forward, training step -
    final_fwd = final_forward(dev, smi)
    final_tr = final_train(dev, smi, final_fwd)

    # ---- 9. the mesh (65,536 triangles, the split route's K, M, F, F') --
    mesh_fwd = mesh_forward(dev, smi)
    mesh_tr = mesh_train(dev, smi, mesh_fwd)

    # ---- 9a. the million-triangle mesh (512 clusters of 2,048): K, M's
    # packed input and F forward, F' in training; the packed input held
    # against the staged one and the plain version, the probe's rows
    t0 = time.perf_counter()
    big_fwd = bigmesh_forward(dev, smi)
    big_tr = bigmesh_train(dev, smi, big_fwd)
    big_row, = bigmesh_rows(big_fwd, big_tr)
    del big_fwd
    torch.cuda.empty_cache()
    emit({"phase": "bigmesh_phases", "seconds": time.perf_counter() - t0})

    # ---- 10. the earth map (image textures): earth and final_scene at
    # 64x64, random's N path at full size (forward, training step), the
    # L check scene; the map lives in a temporary working directory
    t0 = time.perf_counter()
    with earth_map_dir() as emap:
        emit({"phase": "earth_map", **emap})
        earth_checks(dev)
        rand_e_fwd = random_earth_forward(dev, smi)
        rand_e_tr = random_earth_train(dev, smi, rand_e_fwd)
        tri = tri_scene_phase(dev, smi)
    if os.path.exists("earthmap.jpg"):
        raise AssertionError("an earthmap.jpg was left in the working "
                             "directory")
    emit({"phase": "earth_map_phases", "seconds": time.perf_counter() - t0})

    # ---- 11. the inverse-rendering example on the card -------------------
    t0 = time.perf_counter()
    inv = inverse_rendering.run(steps=60, device=dev, log=lambda _: None)
    inv_s = time.perf_counter() - t0
    if not inv["max_albedo_err"] < 0.1:
        raise AssertionError(f"inverse rendering: albedo error "
                             f"{inv['max_albedo_err']}")
    emit({"phase": "inverse_rendering", "seconds": inv_s,
          "loss_every_10": inv["losses"][::10] + inv["losses"][-1:],
          "albedo": inv["albedo"], "target": inv["target"],
          "max_albedo_err": inv["max_albedo_err"]})

    # ---- 12. CLI ---------------------------------------------------------
    emit({"phase": "cli", **cli_phase("cornell_box", 256, 16, 0.05, 0.4)})
    emit({"phase": "cli", **cli_phase("perlin_spheres", 128, 4, 0.05, 5.0)})
    # final_scene 128x128, 4 spp: the JAX package's render_image on the
    # CPU gives mean radiance 0.22553 at this size and seed (the port's
    # plain route on the CPU 0.22754): paths that fork onto the lamp in one
    # package's float32 and not the other's. Against a float64 replay the
    # two are equally far (tests/test_torch_final_scene.py: 59 pixels each
    # over eight seeds at 64x36, 2 spp), so the band holds either
    emit({"phase": "cli", **cli_phase("final_scene", 128, 4, 0.203, 0.248)})

    # ---- 13. glTF scenes, the files in a temporary directory: the
    # single-light flagship on A, the 9-light flagship on the split route
    # through I and I' (forward, training step; I and I' against their
    # plain versions at 9 and 16 lights), a Mesh-boundary medium, CLI -g
    t0 = time.perf_counter()
    with gltf_dir() as paths:
        forward_phase("gltf_flagship",
                      lambda: load_gltf_scene(paths["f1"], 16 / 9), dev, smi,
                      tris=968)
        gltf_fwd = gltf_lights_forward(dev, smi, paths)
        gltf_tr = gltf_lights_train(dev, smi, gltf_fwd)
        mesh_medium_phase(dev, smi)
        emit({"phase": "cli_gltf",
              **cli_gltf_phase(paths["f9"], 72, 4, CLI_GLTF_LO, CLI_GLTF_HI)})
    emit({"phase": "gltf_phases", "seconds": time.perf_counter() - t0})

    # ---- 14. the compact wavefront (render_waves(compact=True), the CLI's
    # default --compact auto): the flagship, random, final_scene and random
    # with the earth map on the split route's kernels, each bounce on its
    # live rays only; the CLI's --compact and --cache-dir
    t0 = time.perf_counter()
    compact = [
        compact_phase("flagship", builders.procedural_flagship, dev, smi,
                      probe=True),
        compact_phase("random", lambda: builders.random_scene(WIDTH / HEIGHT),
                      dev, smi, probe=True),
        compact_phase("final_scene", lambda: builders.get_scene(
            "final_scene", WIDTH / HEIGHT), dev, smi)]
    with earth_map_dir():
        compact.append(compact_phase(
            "random_earth", lambda: builders.random_scene(WIDTH / HEIGHT),
            dev, smi))
    with gltf_dir() as paths:
        compact_cli(smi, paths)
    emit({"phase": "compact_phases", "seconds": time.perf_counter() - t0})

    # ---- 15. where random's compact image left A-noise's: the split
    # route's marble (torch on CUDA), C and J's hit point against A's on
    # one wave's bounces 0 and 1
    marble_trace(dev, smi)

    # ---- 16. the parity gate: the scene matrix against the CPU twins and
    # JAX's saved renders, then with the injected shade error
    parity_gate(smi)

    # ---- result ----------------------------------------------------------
    rows = (kernel_rows(flag_fwd, flag_train, small, "plain")
            + kernel_rows(rand_fwd, rand_train, small, "noise")
            + split_rows(final_fwd, small_split)
            + split_bwd_rows(final_tr, small_split)
            + mesh_rows(mesh_fwd, mesh_tr, small_split)
            + cull_rows(rand_e_fwd, tri)
            + shade_rows(gltf_fwd, gltf_tr) + staged_m_row(gltf_fwd, gltf_tr)
            + fused_rows(d_checks, d_trains)
            + unfused_rows(u_checks, u_fwd, u_train))
    # M's packed input: the mesh's row (the gate takes it from 65,536
    # triangles) with the big mesh's beside it
    next(r for r in rows if r["name"] == big_row["name"])["bigmesh"] = big_row
    # the compact route's launches a training step, by scene
    for c in compact:
        for r in rows:
            if r["name"] in c["launches"] and c["launches"][r["name"]]:
                r.setdefault("launches_compact", {})[c["label"]] = \
                    c["launches"][r["name"]]
    # B' on the other cells' one-wave steps: the row sums and light sums
    for r in rows:
        if r["name"] == "bwd_reduce":
            r["cells"] = {"final_scene": final_tr["red"],
                          "random_earth": rand_e_tr["red"]}
    # the resident blocks per SM of A, D and E (closest_hit's kernels)
    for variant, funcs in (
            ("plain", {"trace_wave": "trace_wave_kernel",
                       "fused_bounce": "fused_bounce_kernel",
                       "select": "select_kernel"}),
            ("noise", {"trace_wave_noise": "trace_wave_kernel",
                       "fused_bounce_noise": "fused_bounce_kernel"})):
        for r in rows:
            if r["name"] in funcs:
                r["blocks_per_sm"] = search_checks[variant][
                    "blocks_per_sm"][funcs[r["name"]]]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
