"""Build and bind the package's hand-written CUDA kernels (``csrc/``).

Every library of :data:`LIBRARIES` is compiled at first use from its
``csrc/*.cu`` with ``nvcc`` for Hopper (``-gencode
arch=compute_90a,code=sm_90a``, no fast-math) into a shared library with
plain C entry points, one ``nvcc`` per library, all started together,
under ``build/torch_kernels/`` at the root of the checkout, keyed by a
hash of the source (headers included) and flags so an edit rebuilds
them. They are loaded with ctypes; pointers come from
``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. Importing this module needs
no ``nvcc`` and no GPU.

Kernels (each wrapper counts its launches in ``launches``):
  * ``trace_wave_kernel`` — ``csrc/trace_wave.cu``, the whole-wave bounce
    loop, optionally writing the backward's residuals (replaces
    ``rust_ray_tracer_tpu/ops/pallas_uber.py`` ``_make_trace_kernel``);
    plain version ``ops/uber.trace_wave_plain``. It, D and E search the
    packed tables ``TraceCtx.tri_pack``, ``sph_pack`` and ``quad_pack``
    (16-byte aligned; :func:`trace_wave_occupancy` gives their resident
    blocks);
  * ``trace_wave_bwd_kernel`` — ``csrc/trace_wave_bwd.cu``, the adjoint
    of the bounce loop replayed from the residuals (replaces
    ``_make_trace_bwd_kernel``); ``bwd_reduce_kernel`` — the same file,
    the fixed-order sums of the winner-row and light-table cotangents
    (the in-kernel accumulation of ``pallas_uber.py:979-1012``; plain
    version ``ops/uber.bwd_reduce_plain``, its order replayed by
    ``bwd_reduce_replay``).
    :func:`trace_backward` chains them; its plain version is
    ``ops/uber.trace_wave_bwd_plain``;
  * ``trace_wave_noise_kernel`` and ``trace_wave_bwd_noise_kernel`` — the
    variants of the first two, from the same sources, for scenes with
    Noise textures: they also evaluate the marble (TPU kernel C,
    ``pallas_bounce._noise_row`` / ``_marble_row``) and its adjoint.
    :func:`trace_kernel` and :func:`trace_bwd_kernel` pick the variant for
    a ``TraceCtx``; each wrapper refuses a context of the other kind;
  * ``bounce_uber_kernel`` and ``bounce_uber_noise_kernel`` (names
    ``fused_bounce``, ``fused_bounce_noise``) — kernel D, the same body as
    A launched for one bounce with its winners (replaces ``pallas_uber.py``
    ``_make_fused_kernel``; plain version ``ops/uber.fused_bounce_plain``),
    in A's libraries; ``bounce_uber_bwd_kernel`` and
    ``bounce_uber_bwd_noise_kernel`` (``fused_bounce_bwd``,
    ``fused_bounce_bwd_noise``) — kernel D', B's body for one bounce
    (replaces ``_make_fused_bwd_kernel``; plain version
    ``ops/uber.fused_bounce_bwd_plain``), whose sums ``bwd_reduce_kernel``
    takes. :func:`fused_bounce_kernel` and :func:`fused_bounce_bwd_kernel`
    pick the variant; :func:`fused_bounce_backward` chains D' and B';
  * ``marble_probe_kernel`` — TPU kernel C launched alone on a list of
    points, in the noise variant's library: a probe that holds C against
    ``ops/perlin.marble`` on the card (no render launches it);
  * ``select_kernel`` (name ``select``) — kernel E, A's phase 1 launched
    alone with the winners' rows fetched, for the unfused uber bounce
    (replaces ``pallas_uber.py`` ``_make_select_kernel``, :346, launched
    by ``_select_impl``, :392; plain version ``ops/uber.select_plain``), in
    A's library without noise; its backward is the glue's row sums
    (``ops/gather.row_sums``, B');
  * the split route's kernels, ``csrc/split.cu`` (library ``split``):
    ``quad_search_kernel`` (TPU kernel O, ``pallas_quad.py`` ``_kernel``;
    plain version ``ops/quad._quad_candidates``, its sweep replayed by
    ``quad_sweep_replay``),
    ``hit_attrs_kernel`` (TPU kernel J, ``pallas_hit.py`` ``_kernel``;
    plain version ``ops/hit_core.hit_plane_core``) and
    ``shade_update_kernel`` (TPU kernel H, ``pallas_bounce.py``
    ``_make_su_kernel``; plain version ``ops/bounce.su_plane_core``); and
    their backward kernels, the adjoints of the last two:
    ``hit_attrs_bwd_kernel`` (TPU kernel J', ``pallas_hit.py``
    ``_bwd_kernel``; plain version ``ops/hit_core.hit_plane_core_vjp``)
    and ``shade_update_bwd_kernel`` (TPU kernel H', ``pallas_bounce.py``
    ``_make_su_bwd_kernel``; plain version
    ``ops/bounce.su_plane_core_vjp``), whose light-table partials
    ``bwd_reduce_kernel`` sums; the fused bounce of solid and checker
    scenes, ``bounce_planes_kernel`` (TPU kernel F, ``pallas_bounce.py``
    ``_make_kernel``; plain version ``ops/bounce_core.bounce_plane_core``)
    and its adjoint ``bounce_planes_bwd_kernel`` (TPU kernel F',
    ``_make_bwd_kernel``; plain version ``bounce_plane_core_vjp``), whose
    light-table partials ``bwd_reduce_kernel`` sums too; and F and F'
    launched with a liveness flag per 1024-lane tile for the unfused uber
    bounce, ``bounce_planes_live_kernel`` (TPU kernel G,
    ``pallas_bounce.py`` ``_make_kernel_live``, :420, launched by
    ``bounce_planes_live``, :497; plain version
    ``ops/bounce.bounce_planes_live_plain``) and
    ``bounce_planes_live_bwd_kernel`` (TPU kernel G',
    ``_make_bwd_kernel_live``, :444, launched by ``_bpl_bwd``, :532; plain
    version ``bounce_planes_live_bwd_plain``), whose partials
    ``_light_sum`` (B') sums;
  * the split route's triangle search, ``csrc/search.cu`` (library
    ``search``): ``tile_enter_kernel`` (TPU kernel K,
    ``pallas_intersect.py`` ``_mask_kernel``; plain version
    ``ops/search.tile_enter_plain``) and ``fused_search_kernel`` (TPU
    kernel M, ``_make_fused_kernel`` and ``_make_pair_kernel``; plain
    version ``ops/search.fused_search_plain``), both reading the rays
    through ``ops/search.search_order``'s permutation where one is given,
    M reading the compact triangle rows (``ops/search.compact_rows``);
    ``fused_search_packed_kernel`` (M's packed input, the same sites with
    ``packed=True``: ``_coeffs_from_pack``), M's body reading the packed
    vertex rows (``ops/search.packed_rows``) and assembling the compact
    rows of each stage in shared memory (plain version ``ops/search.
    fused_search_plain``, the rows by ``assemble_rows``);
    :func:`search_kernel` picks M's variant for a table;
    ``packed_rows_probe_kernel``, the packed variant's stage copy and
    assembly launched alone: a probe that holds the assembled rows against
    ``compact_rows(_tri_coeffs(...))`` on the card (no render launches
    it); ``tri_search_kernel``
    (TPU kernel L, ``pallas_intersect.py`` ``_kernel``, the triangle
    search alone: M's entry point launched with no sphere or quad rows,
    whose triangle test is L's; plain version
    ``ops/search.tri_search_plain``);
  * the cluster-culled sphere search, ``csrc/sphere.cu`` (library
    ``sphere``): ``sph_search_kernel`` (TPU kernel N, ``pallas_sphere.py``
    ``_kernel``; plain version ``ops/sphere.sph_search_plain``);
  * the split route's shading for 9 or more lights, ``csrc/shade.cu``
    (library ``shade``): ``shade_kernel`` (TPU kernel I,
    ``pallas_shade.py`` ``_make_kernel``; plain version
    ``ops/shade_core.plane_core``) and ``shade_bwd_kernel`` (TPU kernel
    I', ``_make_bwd_kernel``; plain version ``plane_core_vjp``), whose
    per-block light-table partials ``bwd_reduce_kernel`` sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from rust_ray_tracer_tpu_torch.ops.bounce import N_SU, N_SU_OUT
from rust_ray_tracer_tpu_torch.ops.bounce_core import N_CHK, N_IN_B
from rust_ray_tracer_tpu_torch.ops.hit_core import N_IN as HIT_IN
from rust_ray_tracer_tpu_torch.ops.hit_core import N_OUT as HIT_OUT
from rust_ray_tracer_tpu_torch.ops.quad import QUAD_ROW
from rust_ray_tracer_tpu_torch.ops.search import (N_RAY, PACK_ROW, TRI_ROW,
                                                  tile_count, tri_only)
from rust_ray_tracer_tpu_torch.ops.shade import N_OUT as SHADE_OUT
from rust_ray_tracer_tpu_torch.ops.shade_core import LT_COLS, N_DATA, N_RNG
from rust_ray_tracer_tpu_torch.ops.sphere import SPH_ROW, SUB_ROWS
from rust_ray_tracer_tpu_torch.ops.uber import (A_COL, N_RND, N_STATE, TCC,
                                                PRIM_PACK, REDUCE_PIECE,
                                                TILE, TRI_PACK)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library -> (source in csrc/, extra nvcc flags). Every library is built
# without a*b+c contraction (--fmad=false), so each product and sum rounds
# as its plain version's (torch elementwise ops) does:
#   * the searches (A, D and E in trace_wave and trace_wave_noise, K, M,
#     L, N, O) find their plain versions' winners, and E's are D's and A's;
#   * the whole-wave forward shades as the split route's kernels G, F and H
#     do, so the unfused bounce's image (E, then G) is the fused one's (D);
#   * the marble's albedo moves ~50 per unit of the hit point, so an FMA's
#     last-ulp change of a far hit point (|p| ~ 1000 on a noise ground)
#     would move a pixel by more than the comparison's 1e-3; free-flight
#     distances go through log;
#   * the backward's recomputed forward and adjoint of an ill-conditioned
#     hit (a ray grazing a large sphere) stay within the comparison's
#     budget.
# The searches are bound by instruction issue (trace_wave.cu's note), the
# backward kernels by memory, so the unfused instructions cost little.
# trace_wave_noise is trace_wave's source with -DTRACE_WAVE_NOISE=1: the
# kernels' instantiation with the marble.
LIBRARIES = {
    "trace_wave": ("trace_wave", ("--fmad=false",)),
    "trace_wave_noise": ("trace_wave", ("--fmad=false",
                                        "-DTRACE_WAVE_NOISE=1")),
    "trace_wave_bwd": ("trace_wave_bwd", ("--fmad=false",)),
    "split": ("split", ("--fmad=false",)),
    "search": ("search", ("--fmad=false",)),
    "sphere": ("sphere", ("--fmad=false",)),
    "shade": ("shade", ("--fmad=false",)),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc / ptxas output (registers, spills), kept
                        # beside the library as <name>.log


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def _library(name: str) -> Path:
    source, extra = LIBRARIES[name]
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + extra)
    digest = hashlib.sha256((CSRC / f"{source}.cu").read_bytes() + headers
                            + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


_BUILDS: dict[str, Build] = {}


def set_build_dir(path) -> None:
    """Build and load the libraries in the directory ``path`` from now on
    (the CLI's ``--cache-dir``; default ``build/torch_kernels/`` beside
    the package). A library already found there for these sources and
    flags is loaded, not rebuilt; kernels already bound keep theirs."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()


def build_all() -> dict[str, Build]:
    """Compile every library of :data:`LIBRARIES` that does not exist yet
    for these sources and flags, one ``nvcc`` each, all at once; raises if
    any fails."""
    todo = {}
    for name, (source, extra) in LIBRARIES.items():
        out = _library(name)
        if name in _BUILDS and _BUILDS[name].path == out:
            continue
        if out.exists():
            log = out.with_suffix(".log")
            _BUILDS[name] = Build(out, 0.0, log.read_text()
                                  if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        todo[name] = (out, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (out, tmp, cmd, t0, proc) in todo.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        _BUILDS[name] = Build(out, seconds, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return dict(_BUILDS)


def build(name: str) -> Build:
    """The library ``name`` of :data:`LIBRARIES` (building every library
    first)."""
    return build_all()[name]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t, device, shape=None, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


class _Kernel:
    """A ctypes-bound C entry point ``entry`` of the library ``library``
    of :data:`LIBRARIES`; ``argtypes`` precede the stream argument.
    ``launches`` counts the kernel launches this wrapper has made."""

    name = library = entry = ""
    argtypes: tuple = ()

    def __init__(self):
        self.launches = 0
        self.build_info: Build | None = None
        self._fn = None

    def load(self) -> Build:
        """Build (if needed) and bind the library; returns the build."""
        if self._fn is None:
            self.build_info = build(self.library)
            fn = getattr(ctypes.CDLL(str(self.build_info.path)), self.entry)
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self.build_info

    def _launch(self, dev, *args):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int


def _attr_cols(ctx) -> int:
    """Winner-row columns the kernels read: the material attrs up to the
    albedo, the checker leaves and flag, then the noise scale and flag."""
    return A_COL + (13 if ctx.has_checker else 6) + (2 if ctx.has_noise
                                                     else 0)


def _perlin_args(ctx, dev, noise: bool):
    """(vec, perm, has_noise) arguments of a launch; null tables for the
    variant without noise."""
    if not noise:
        return ctypes.c_void_p(None), ctypes.c_void_p(None), 0
    vec, perm = ctx.perlin
    _check("perlin vec", vec, dev, (256, 3))
    _check("perlin perm", perm, dev, (3, 256), torch.int32)
    return _ptr(vec), _ptr(perm), 1


def _check_trace(kernel, st, st_name, rnd, rnd_lead, ctx):
    """The device of a launch of kernel A or D after checking the state
    planes ``st`` [14, N] (N % 128 == 0), the randoms ``rnd`` [*rnd_lead,
    N] and the tables of ``ctx`` (an ``ops.uber.TraceCtx``)."""
    dev = st.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel.name} kernel needs CUDA tensors, got "
                         f"{dev}")
    n = st.shape[1] if st.dim() == 2 else -1
    if n < 0 or n % 128:
        raise ValueError(f"{st_name} must be [{N_STATE}, N] with N % 128 == "
                         f"0, got {tuple(st.shape)}")
    _check_variant(kernel, ctx)
    _check(st_name, st, dev, (N_STATE, n))
    _check("rnd", rnd, dev, tuple(rnd_lead) + (n,))
    _check_search_tables(ctx, dev)
    _check("lt", ctx.lt, dev, (ctx.n_lights + 1, LT_COLS))
    return dev


def _check_search_tables(ctx, dev):
    """Check the winner rows and the search tables of ``ctx`` (an
    ``ops.uber.TraceCtx``) for a launch of kernel A, D or E on ``dev``."""
    w_min = _attr_cols(ctx)
    _check("uni", ctx.uni, dev)
    if ctx.uni.dim() != 2 or ctx.uni.shape[1] < w_min:
        raise ValueError(f"uni must be [P, >= {w_min}], got "
                         f"{tuple(ctx.uni.shape)}")
    tp = ctx.tri_pack.shape[0]
    _check("tri_pack", ctx.tri_pack, dev, (tp, TRI_PACK))
    if ctx.n_tri_chunks * TCC > tp:
        raise ValueError("triangle tables shorter than the chunk count")
    _check("sph_pack", ctx.sph_pack, dev, (ctx.sph_pack.shape[0], PRIM_PACK))
    _check("quad_pack", ctx.quad_pack, dev,
           (ctx.quad_pack.shape[0], PRIM_PACK))
    for nm in ("tri_pack", "sph_pack", "quad_pack"):
        if getattr(ctx, nm).data_ptr() % 16:
            raise ValueError(f"{nm} must be 16-byte aligned (the kernels "
                             "read it as float4)")
    _check("cab", ctx.cab, dev, (max(1, -(-tp // TCC)), 8))


def _trace_tables(ctx):
    """(table pointers, counts) of a launch of kernel A or D: uni, the
    packed triangle, sphere and quad tables, cab and lt; then w, the
    triangle chunks, the sphere and quad rows, the three offsets, the
    lights and the checker flag."""
    tables = tuple(_ptr(x) for x in (ctx.uni, ctx.tri_pack, ctx.sph_pack,
                                     ctx.quad_pack, ctx.cab, ctx.lt))
    counts = (ctx.uni.shape[1], ctx.n_tri_chunks,
              ctx.sph_pack.shape[0] if ctx.n_sph else 0,
              ctx.quad_pack.shape[0] if ctx.n_quad else 0, ctx.t_off,
              ctx.s_off,
              ctx.q_off, ctx.n_lights, int(ctx.has_checker))
    return tables, counts


def _check_variant(kernel, ctx):
    if ctx.has_noise != kernel.noise:
        which = "with" if kernel.noise else "without"
        has = "has" if ctx.has_noise else "has no"
        raise ValueError(f"{kernel.name} is the variant {which} marble "
                         f"noise, the scene {has} noise textures")


class TraceWaveKernel(_Kernel):
    """ctypes wrapper of ``trace_wave_launch`` (kernel A), the variant
    without noise."""

    name = library = "trace_wave"
    entry = "trace_wave_launch"
    argtypes = (_P,) * 12 + (_I,) * 11 + (_P, _P, _I)
    noise = False

    def __call__(self, st0: torch.Tensor, rnd: torch.Tensor, ctx,
                 depth: int, residuals: bool = False):
        """Final state [14, N] of ``depth`` bounces from ``st0`` [14, N]
        with randoms ``rnd`` [depth, 15, N] over the tables of ``ctx``
        (an ``ops.uber.TraceCtx``), all on one CUDA device; with
        ``residuals`` also (hist [depth, 14, N], kind, idx [depth, N]
        int32), as ``ops.uber.trace_wave_plain`` returns them."""
        dev = _check_trace(self, st0, "st0", rnd, (depth, N_RND), ctx)
        n = st0.shape[1]
        perlin = _perlin_args(ctx, dev, self.noise)
        self.load()
        stf = torch.empty_like(st0)
        null = ctypes.c_void_p(None)
        hist = kind = idx = None
        if residuals:
            hist = torch.empty((depth, N_STATE, n), dtype=torch.float32,
                               device=dev)
            kind = torch.empty((depth, n), dtype=torch.int32, device=dev)
            idx = torch.empty_like(kind)
        tables, counts = _trace_tables(ctx)
        self._launch(
            dev, _ptr(st0), _ptr(rnd), *tables, _ptr(stf),
            _ptr(hist) if residuals else null,
            _ptr(kind) if residuals else null,
            _ptr(idx) if residuals else null, n, depth, *counts, *perlin)
        return (stf, hist, kind, idx) if residuals else stf


class TraceWaveNoiseKernel(TraceWaveKernel):
    """Kernel A's variant with the marble noise of TPU kernel C, for a
    scene with Noise textures: the same source and entry point, built into
    its own library without FMA contraction."""

    name = library = "trace_wave_noise"
    noise = True


trace_wave_kernel = TraceWaveKernel()
trace_wave_noise_kernel = TraceWaveNoiseKernel()


def _check_trace_bwd(kernel, st, st_name, lead, rnd, kind, idx, ctx, g):
    """(device, N, light-table entries) of a launch of kernel B or D'
    after checking the cotangent ``g`` [14, N] (N % 1024 == 0), the input
    states ``st`` [*lead, 14, N], randoms [*lead, 15, N], winners [*lead,
    N] int32 and the tables of ``ctx``."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel.name} kernel needs CUDA tensors, got "
                         f"{dev}")
    n = g.shape[1] if g.dim() == 2 else -1
    if n < 0 or n % TILE:
        raise ValueError(f"g must be [{N_STATE}, N] with N % {TILE} == 0, "
                         f"got {tuple(g.shape)}")
    ltn = (ctx.n_lights + 1) * LT_COLS
    if ltn > 128:
        raise ValueError(f"{ctx.n_lights} lights exceed the kernel's light "
                         "table")
    lead = tuple(lead)
    _check("g", g, dev, (N_STATE, n))
    _check(st_name, st, dev, lead + (N_STATE, n))
    _check("rnd", rnd, dev, lead + (N_RND, n))
    _check("kind", kind, dev, lead + (n,), torch.int32)
    _check("idx", idx, dev, lead + (n,), torch.int32)
    _check_variant(kernel, ctx)
    _check("uni", ctx.uni, dev)
    if ctx.uni.shape[1] < _attr_cols(ctx):
        raise ValueError(f"uni has {ctx.uni.shape[1]} columns")
    _check("lt", ctx.lt, dev, (ctx.n_lights + 1, LT_COLS))
    return dev, n, ltn


class TraceWaveBwdKernel(_Kernel):
    """ctypes wrapper of ``trace_wave_bwd_launch`` (kernel B), the variant
    without noise: the adjoint of every bounce of a wave, replayed from
    the forward's residuals. Returns dst [14, N], the per-(bounce, ray)
    winner-row cotangents ``contrib`` [depth, N, W] with their winner rows
    ``keys`` [depth, N] int32 (P where the ray found none: that row of
    ``contrib`` is scratch), and the per-block light-table partials
    [N / 128, (n_lights + 1) * 14]."""

    name = library = "trace_wave_bwd"
    entry = "trace_wave_bwd_launch"
    argtypes = (_P,) * 11 + (_I,) * 6 + (_P, _P, _I)
    noise = False

    def __call__(self, hist, rnd, kind, idx, ctx, g):
        depth = hist.shape[0]
        dev, n, ltn = _check_trace_bwd(self, hist, "hist", (depth,), rnd,
                                       kind, idx, ctx, g)
        p_rows, w = ctx.uni.shape
        perlin = _perlin_args(ctx, dev, self.noise)
        self.load()
        dst = torch.empty_like(g)
        contrib = torch.empty((depth, n, w), dtype=torch.float32, device=dev)
        keys = torch.empty((depth, n), dtype=torch.int32, device=dev)
        part = torch.empty((n // 128, ltn), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(hist), _ptr(rnd), _ptr(kind), _ptr(idx),
                     _ptr(g), _ptr(ctx.uni), _ptr(ctx.lt), _ptr(dst),
                     _ptr(contrib), _ptr(keys), _ptr(part), n, depth, w,
                     p_rows, ctx.n_lights, int(ctx.has_checker), *perlin)
        return dst, contrib, keys, part


class TraceWaveBwdNoiseKernel(TraceWaveBwdKernel):
    """Kernel B's variant with the adjoint of the marble noise (TPU kernel
    C), for a scene with Noise textures."""

    name = "trace_wave_bwd_noise"
    noise = True


class FusedBounceKernel(_Kernel):
    """ctypes wrapper of ``fused_bounce_launch`` (kernel D), the variant
    without noise: one uber bounce of the lanes of one or more whole
    chunks, with its winners."""

    name = "fused_bounce"
    library = "trace_wave"
    entry = "fused_bounce_launch"
    argtypes = (_P,) * 11 + (_I,) * 10 + (_P, _P, _I)
    noise = False

    def __call__(self, st: torch.Tensor, rnd_b: torch.Tensor, ctx):
        """(st2 [14, N], kind, idx [N] int32) of one bounce from ``st``
        [14, N] with this bounce's randoms ``rnd_b`` [15, N] over the
        tables of ``ctx``, all on one CUDA device, as
        ``ops.uber.fused_bounce_plain`` returns them."""
        dev = _check_trace(self, st, "st", rnd_b, (N_RND,), ctx)
        n = st.shape[1]
        perlin = _perlin_args(ctx, dev, self.noise)
        self.load()
        st2 = torch.empty_like(st)
        kind = torch.empty((n,), dtype=torch.int32, device=dev)
        idx = torch.empty_like(kind)
        tables, counts = _trace_tables(ctx)
        self._launch(dev, _ptr(st), _ptr(rnd_b), *tables, _ptr(st2),
                     _ptr(kind), _ptr(idx), n, *counts, *perlin)
        return st2, kind, idx


class FusedBounceNoiseKernel(FusedBounceKernel):
    """Kernel D's variant with the marble noise of TPU kernel C: A's
    noise library, the same entry point."""

    name = "fused_bounce_noise"
    library = "trace_wave_noise"
    noise = True


class SelectKernel(_Kernel):
    """ctypes wrapper of ``select_launch`` (kernel E): phase 1 alone and
    the winners' rows, for the unfused uber bounce. In A's library without
    noise, so its winners are kernel D's bit for bit; it refuses a context
    with noise, which takes the split route under ``RRT_NO_UBER_FUSED=1``."""

    name = "select"
    library = "trace_wave"
    entry = "select_launch"
    argtypes = (_P,) * 10 + (_I,) * 8

    def __call__(self, st: torch.Tensor, ctx):
        """(selv [W, N] float32, kind, idx [N] int32) of the lanes of
        ``st`` [8, N] (o, d, time, alive; N % 128 == 0) over the tables of
        ``ctx``, W = ``ctx.uni``'s columns, as ``ops.uber.select_plain``
        returns them."""
        if ctx.has_noise:
            raise ValueError("kernel E has no marble: under "
                             "RRT_NO_UBER_FUSED=1 a noise scene takes the "
                             "split route")
        dev = st.device
        if dev.type != "cuda":
            raise ValueError(f"select kernel needs CUDA tensors, got {dev}")
        n = st.shape[1] if st.dim() == 2 else -1
        if n < 0 or n % 128:
            raise ValueError(f"st must be [8, N] with N % 128 == 0, got "
                             f"{tuple(st.shape)}")
        _check("st", st, dev, (8, n))
        _check_search_tables(ctx, dev)
        w = ctx.uni.shape[1]
        _check("dflt", ctx.dflt, dev, (w,))
        self.load()
        selv = torch.empty((w, n), dtype=torch.float32, device=dev)
        kind = torch.empty((n,), dtype=torch.int32, device=dev)
        idx = torch.empty_like(kind)
        tables, counts = _trace_tables(ctx)
        self._launch(dev, _ptr(st), _ptr(ctx.uni), _ptr(ctx.dflt),
                     *tables[1:5], _ptr(selv), _ptr(kind), _ptr(idx), n,
                     *counts[:7])
        return selv, kind, idx


class MarbleProbeKernel(_Kernel):
    """ctypes wrapper of ``marble_probe_launch``: TPU kernel C (the marble
    of A-noise, B-noise and D-noise) launched alone on a list of points,
    to hold it against ``ops/perlin.marble`` on the card. No render calls
    it; ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` do."""

    name = "marble_probe"
    library = "trace_wave_noise"
    entry = "marble_probe_launch"
    argtypes = (_P,) * 6 + (_I,)

    def __call__(self, p: torch.Tensor, scale: torch.Tensor, perlin):
        """(acc [N], marble [N]): the signed octave sum and the marble at
        the points ``p`` [N, 3] with scales ``scale`` [N], over the Perlin
        tables ``perlin`` (``ops/perlin.PerlinTables``), on one CUDA
        device."""
        dev = p.device
        if dev.type != "cuda":
            raise ValueError(f"marble_probe needs CUDA tensors, got {dev}")
        n = p.shape[0]
        planes = p.T.contiguous()
        _check("p", planes, dev, (3, n))
        _check("scale", scale, dev, (n,))
        vec, perm = perlin
        _check("perlin vec", vec, dev, (256, 3))
        _check("perlin perm", perm, dev, (3, 256), torch.int32)
        self.load()
        acc = torch.empty((n,), dtype=torch.float32, device=dev)
        value = torch.empty_like(acc)
        self._launch(dev, _ptr(planes), _ptr(scale), _ptr(vec), _ptr(perm),
                     _ptr(acc), _ptr(value), n)
        return acc, value


class FusedBounceBwdKernel(_Kernel):
    """ctypes wrapper of ``fused_bounce_bwd_launch`` (kernel D'), the
    variant without noise: the adjoint of one uber bounce from kernel D's
    input state and winners. Returns dst [14, N], the per-ray winner-row
    cotangents ``contrib`` [N, W] with their rows ``keys`` [N] int32 (P
    where the ray found none: that row of ``contrib`` is scratch), and the
    per-block light-table partials [N / 128, (n_lights + 1) * 14], which
    ``bwd_reduce_kernel`` sums."""

    name = "fused_bounce_bwd"
    library = "trace_wave_bwd"
    entry = "fused_bounce_bwd_launch"
    argtypes = (_P,) * 11 + (_I,) * 5 + (_P, _P, _I)
    noise = False

    def __call__(self, st, rnd_b, kind, idx, ctx, g):
        dev, n, ltn = _check_trace_bwd(self, st, "st", (), rnd_b, kind, idx,
                                       ctx, g)
        p_rows, w = ctx.uni.shape
        perlin = _perlin_args(ctx, dev, self.noise)
        self.load()
        dst = torch.empty_like(g)
        contrib = torch.empty((n, w), dtype=torch.float32, device=dev)
        keys = torch.empty((n,), dtype=torch.int32, device=dev)
        part = torch.empty((n // 128, ltn), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(st), _ptr(rnd_b), _ptr(kind), _ptr(idx),
                     _ptr(g), _ptr(ctx.uni), _ptr(ctx.lt), _ptr(dst),
                     _ptr(contrib), _ptr(keys), _ptr(part), n, w, p_rows,
                     ctx.n_lights, int(ctx.has_checker), *perlin)
        return dst, contrib, keys, part


class FusedBounceBwdNoiseKernel(FusedBounceBwdKernel):
    """Kernel D''s variant with the adjoint of the marble noise (TPU
    kernel C)."""

    name = "fused_bounce_bwd_noise"
    noise = True


select_kernel = SelectKernel()
bounce_uber_kernel = FusedBounceKernel()
bounce_uber_noise_kernel = FusedBounceNoiseKernel()
bounce_uber_bwd_kernel = FusedBounceBwdKernel()
bounce_uber_bwd_noise_kernel = FusedBounceBwdNoiseKernel()
marble_probe_kernel = MarbleProbeKernel()


W_MAX = 32       # columns B' takes


class BwdReduceKernel(_Kernel):
    """ctypes wrapper of ``bwd_reduce_launch`` (B'): duni [P, W] with row
    r the sum of the terms whose sorted key is r, from ``keys`` and
    ``perm`` as :func:`reduce_order` returns them (a key >= P names no
    row), and dlt [(n_lights + 1) * 14] the sums of the per-block
    partials. One block per ``REDUCE_PIECE`` sorted terms, so the cost
    follows the terms, not P; every row no term names is zero. The sums'
    order is fixed by the positions alone (``ops/uber.bwd_reduce_replay``
    replays it); no float atomics, so they repeat bit for bit."""

    name = "bwd_reduce"
    library = "trace_wave_bwd"
    entry = "bwd_reduce_launch"
    argtypes = (_P,) * 3 + (_I,) * 3 + (_P,) * 3 + (_I,) * 2 + (_P,)

    def __call__(self, contrib, keys, perm, p_rows: int, part):
        dev = contrib.device
        if dev.type != "cuda":
            raise ValueError(f"bwd_reduce kernel needs CUDA tensors, got "
                             f"{dev}")
        w = contrib.shape[-1]
        if w > W_MAX:
            raise ValueError(f"{w} columns exceed the reduction's {W_MAX}")
        m = keys.numel()
        _check("contrib", contrib, dev)
        if contrib.numel() != m * w:
            raise ValueError(f"contrib holds {contrib.numel()} values, "
                             f"expected {m} terms of {w}")
        _check("keys", keys, dev, (m,), torch.int32)
        _check("perm", perm, dev, (m,), torch.int32)
        _check("part", part, dev)
        n_part, ltn = part.shape
        self.load()
        pieces = -(-m // REDUCE_PIECE)
        partial = torch.empty((pieces, 2, w), dtype=torch.float32,
                              device=dev)
        # duni, then the pieces' int32 counters: the launch zeroes both
        # with one memset
        out = torch.empty((p_rows * w + pieces,), dtype=torch.float32,
                          device=dev)
        dlt = torch.empty((ltn,), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(contrib), _ptr(keys), _ptr(perm), m, p_rows,
                     w, _ptr(partial), _ptr(out), _ptr(part), n_part, ltn,
                     _ptr(dlt))
        return out[:p_rows * w].view(p_rows, w), dlt


trace_wave_bwd_kernel = TraceWaveBwdKernel()
trace_wave_bwd_noise_kernel = TraceWaveBwdNoiseKernel()
bwd_reduce_kernel = BwdReduceKernel()


QCL = 128        # quads per cull cluster (models/scene.CLUSTER)


class QuadSearchKernel(_Kernel):
    """ctypes wrapper of ``quad_search_launch`` (kernel O): the closest
    quad hit of each ray, (best_t [N] float32, inf for none; best_i [N]
    int32, 0 for none), as ``ops/quad._quad_candidates`` returns
    them."""

    name = "quad_search"
    library = "split"
    entry = "quad_search_launch"
    argtypes = (_P,) * 4 + (_I,) * 3 + (_P, _P)

    def __call__(self, rays, quads, cl_min, cl_max):
        """``rays`` [N, 8] (o, d, tmin, tmax), ``quads`` [Q, 16]
        (``ops/quad.quad_table``: q, u, v, n, 1 / |n|^2, zeros), the
        cluster boxes ``cl_min`` / ``cl_max`` [ceil(Q / 128), 3]; rays
        and quads 16-byte aligned."""
        dev = rays.device
        if dev.type != "cuda":
            raise ValueError(f"quad_search kernel needs CUDA tensors, got "
                             f"{dev}")
        n, q = rays.shape[0], quads.shape[0]
        k = -(-q // QCL)
        if q == 0:
            raise ValueError("quad_search needs at least one quad")
        _check("rays", rays, dev, (n, 8))
        _check("quads", quads, dev, (q, QUAD_ROW))
        _check("cl_min", cl_min, dev, (k, 3))
        _check("cl_max", cl_max, dev, (k, 3))
        if rays.data_ptr() % 16 or quads.data_ptr() % 16:
            raise ValueError("rays and quads must be 16-byte aligned")
        self.load()
        best_t = torch.empty((n,), dtype=torch.float32, device=dev)
        best_i = torch.empty((n,), dtype=torch.int32, device=dev)
        self._launch(dev, _ptr(rays), _ptr(quads), _ptr(cl_min),
                     _ptr(cl_max), n, q, k, _ptr(best_t), _ptr(best_i))
        return best_t, best_i


class HitAttrsKernel(_Kernel):
    """ctypes wrapper of ``hit_attrs_launch`` (kernel J): [12, N] hit
    attribute planes of [19, N] input planes and the int32 ``kind`` and
    ``flip`` [N], as ``ops/hit_core.hit_plane_core`` returns them."""

    name = "hit_attrs"
    library = "split"
    entry = "hit_attrs_launch"
    argtypes = (_P,) * 4 + (_I,)

    def __call__(self, planes, kind, flip):
        dev = planes.device
        if dev.type != "cuda":
            raise ValueError(f"hit_attrs kernel needs CUDA tensors, got "
                             f"{dev}")
        n = planes.shape[1] if planes.dim() == 2 else -1
        _check("planes", planes, dev, (HIT_IN, n))
        _check("kind", kind, dev, (n,), torch.int32)
        _check("flip", flip, dev, (n,), torch.int32)
        self.load()
        out = torch.empty((HIT_OUT, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(kind), _ptr(flip), _ptr(out),
                     n)
        return out


class ShadeUpdateKernel(_Kernel):
    """ctypes wrapper of ``shade_update_launch`` (kernel H): [13, N] next
    state planes (o, d, L, beta, alive) of [40, N] input planes, the int32
    material kinds ``mkind`` [N] and the light table ``lt`` [n_lights + 1,
    LT_COLS] (last row the background), as ``ops/bounce.su_plane_core``
    returns them."""

    name = "shade_update"
    library = "split"
    entry = "shade_update_launch"
    argtypes = (_P, _P, _P, _I, _P, _I)

    def __call__(self, planes, mkind, lt, n_lights: int):
        dev = planes.device
        if dev.type != "cuda":
            raise ValueError(f"shade_update kernel needs CUDA tensors, got "
                             f"{dev}")
        n = planes.shape[1] if planes.dim() == 2 else -1
        if (n_lights + 1) * LT_COLS > 128:
            raise ValueError(f"{n_lights} lights exceed the kernel's light "
                             "table")
        _check("planes", planes, dev, (N_SU, n))
        _check("mkind", mkind, dev, (n,), torch.int32)
        _check("lt", lt, dev, (n_lights + 1, LT_COLS))
        self.load()
        out = torch.empty((N_SU_OUT, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(mkind), _ptr(lt), n_lights,
                     _ptr(out), n)
        return out


class HitAttrsBwdKernel(_Kernel):
    """ctypes wrapper of ``hit_attrs_bwd_launch`` (kernel J'): the
    cotangent [19, N] of kernel J's input planes for the cotangents ``g``
    [12, N] of its outputs, as ``ops/hit_core.hit_plane_core_vjp`` returns
    it (tmin and tmax take none)."""

    name = "hit_attrs_bwd"
    library = "split"
    entry = "hit_attrs_bwd_launch"
    argtypes = (_P,) * 5 + (_I,)

    def __call__(self, planes, kind, flip, g):
        dev = planes.device
        if dev.type != "cuda":
            raise ValueError(f"hit_attrs_bwd kernel needs CUDA tensors, got "
                             f"{dev}")
        n = planes.shape[1] if planes.dim() == 2 else -1
        _check("planes", planes, dev, (HIT_IN, n))
        _check("kind", kind, dev, (n,), torch.int32)
        _check("flip", flip, dev, (n,), torch.int32)
        _check("g", g, dev, (HIT_OUT, n))
        self.load()
        d_planes = torch.empty((HIT_IN, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(kind), _ptr(flip), _ptr(g),
                     _ptr(d_planes), n)
        return d_planes


class ShadeUpdateBwdKernel(_Kernel):
    """ctypes wrapper of ``shade_update_bwd_launch`` (kernel H'): for the
    cotangents ``g`` [13, N] of kernel H's outputs, the cotangents of its
    input planes [40, N] and of the light table [n_lights + 1, LT_COLS], as
    ``ops/bounce.su_plane_core_vjp`` returns them. H' leaves the table's
    as one partial a block (:meth:`partials`), which ``bwd_reduce_kernel``
    (B') sums in block order, as it sums kernel B's: no float atomics, the
    same bits in every run."""

    name = "shade_update_bwd"
    library = "split"
    entry = "shade_update_bwd_launch"
    argtypes = (_P, _P, _P, _I) + (_P,) * 3 + (_I,)

    def partials(self, planes, mkind, lt, n_lights: int, g):
        """Kernel H' alone: (dP [40, N], the blocks' light-table partials
        [ceil(N / 128), (n_lights + 1) * LT_COLS])."""
        dev = planes.device
        if dev.type != "cuda":
            raise ValueError(f"shade_update_bwd kernel needs CUDA tensors, "
                             f"got {dev}")
        n = planes.shape[1] if planes.dim() == 2 else -1
        ltn = (n_lights + 1) * LT_COLS
        if ltn > 128:
            raise ValueError(f"{n_lights} lights exceed the kernel's light "
                             "table")
        _check("planes", planes, dev, (N_SU, n))
        _check("mkind", mkind, dev, (n,), torch.int32)
        _check("lt", lt, dev, (n_lights + 1, LT_COLS))
        _check("g", g, dev, (N_SU_OUT, n))
        self.load()
        d_planes = torch.empty((N_SU, n), dtype=torch.float32, device=dev)
        part = torch.empty((-(-n // 128), ltn), dtype=torch.float32,
                           device=dev)
        self._launch(dev, _ptr(planes), _ptr(mkind), _ptr(lt), n_lights,
                     _ptr(g), _ptr(d_planes), _ptr(part), n)
        return d_planes, part

    def __call__(self, planes, mkind, lt, n_lights: int, g):
        """(dP [40, N], dlt like ``lt``): H', then B''s light-table sum of
        its partials (none for N = 0)."""
        d_planes, part = self.partials(planes, mkind, lt, n_lights, g)
        return d_planes, _light_sum(part, lt)


def _light_sum(part, lt):
    """B''s sum of a backward kernel's light-table partials ``part``
    [blocks, (n_lights + 1) * LT_COLS], shaped like ``lt`` (zeros for no
    block or no light)."""
    dev = part.device
    if part.numel() == 0:
        return torch.zeros_like(lt)
    rows = torch.empty((0, 1), dtype=torch.float32, device=dev)
    none = torch.empty((0,), dtype=torch.int32, device=dev)
    _, dlt = bwd_reduce_kernel(rows, none, none, 0, part)
    return dlt.reshape(lt.shape)


def _check_bounce_planes(name, planes, pkind, mkind, flags, lt, n_lights,
                         g=None):
    """(device, N, plane count) of a launch of kernel F, F', G or G' after
    checking its planes [46 or 52, N], the int32 ``pkind``, ``mkind``,
    ``flags`` [N], ``lt`` and, for a backward, ``g`` [13, N]."""
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    n = planes.shape[1] if planes.dim() == 2 else -1
    n_in = planes.shape[0]
    if n_in not in (N_IN_B, N_IN_B + N_CHK):
        raise ValueError(f"planes must be [{N_IN_B} or {N_IN_B + N_CHK}, N], "
                         f"got {tuple(planes.shape)}")
    if (n_lights + 1) * LT_COLS > 128:
        raise ValueError(f"{n_lights} lights exceed the kernel's light table")
    _check("planes", planes, dev, (n_in, n))
    for nm, t in (("pkind", pkind), ("mkind", mkind), ("flags", flags)):
        _check(nm, t, dev, (n,), torch.int32)
    _check("lt", lt, dev, (n_lights + 1, LT_COLS))
    if g is not None:
        _check("g", g, dev, (N_SU_OUT, n))
    return dev, n, n_in


class BouncePlanesKernel(_Kernel):
    """ctypes wrapper of ``bounce_planes_launch`` (kernel F): [13, N] next
    state planes (o, d, L, beta, alive) of [46, N] input planes (52 with
    the checker leaves), the int32 primitive kinds ``pkind``, material
    kinds ``mkind`` and ``flags`` [N] and the light table ``lt``
    [n_lights + 1, LT_COLS] (last row the background), as
    ``ops/bounce_core.bounce_plane_core`` returns them."""

    name = "bounce_planes"
    library = "split"
    entry = "bounce_planes_launch"
    argtypes = (_P,) * 5 + (_I, _I, _P, _I)

    def __call__(self, planes, pkind, mkind, flags, lt, n_lights: int):
        dev, n, n_in = _check_bounce_planes(self.name, planes, pkind, mkind,
                                            flags, lt, n_lights)
        self.load()
        out = torch.empty((N_SU_OUT, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(pkind), _ptr(mkind),
                     _ptr(flags), _ptr(lt), n_lights, int(n_in > N_IN_B),
                     _ptr(out), n)
        return out


class BouncePlanesBwdKernel(_Kernel):
    """ctypes wrapper of ``bounce_planes_bwd_launch`` (kernel F'): for the
    cotangents ``g`` [13, N] of kernel F's outputs, the cotangents of its
    input planes (like ``planes``) and of the light table (like ``lt``),
    as ``ops/bounce_core.bounce_plane_core_vjp`` returns them. F' leaves
    the table's as one partial a block (:meth:`partials`), which
    ``bwd_reduce_kernel`` (B') sums in block order: no float atomics."""

    name = "bounce_planes_bwd"
    library = "split"
    entry = "bounce_planes_bwd_launch"
    argtypes = (_P,) * 5 + (_I, _I) + (_P,) * 3 + (_I,)

    def partials(self, planes, pkind, mkind, flags, lt, n_lights: int, g):
        """Kernel F' alone: (dP like ``planes``, the blocks' light-table
        partials [ceil(N / 128), (n_lights + 1) * LT_COLS])."""
        dev, n, n_in = _check_bounce_planes(self.name, planes, pkind, mkind,
                                            flags, lt, n_lights, g)
        self.load()
        d_planes = torch.empty((n_in, n), dtype=torch.float32, device=dev)
        part = torch.empty((-(-n // 128), (n_lights + 1) * LT_COLS),
                           dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(pkind), _ptr(mkind),
                     _ptr(flags), _ptr(lt), n_lights, int(n_in > N_IN_B),
                     _ptr(g), _ptr(d_planes), _ptr(part), n)
        return d_planes, part

    def __call__(self, planes, pkind, mkind, flags, lt, n_lights: int, g):
        """(dP like ``planes``, dlt like ``lt``): F', then B''s sum of its
        light-table partials."""
        d_planes, part = self.partials(planes, pkind, mkind, flags, lt,
                                       n_lights, g)
        return d_planes, _light_sum(part, lt)


def _check_tlive(tlive, dev, n):
    """Check G's and G''s liveness flags: [N / 1024] int32, N whole tiles."""
    if n % TILE:
        raise ValueError(f"{n} lanes are not whole {TILE}-lane tiles")
    _check("tlive", tlive, dev, (n // TILE,), torch.int32)


class BouncePlanesLiveKernel(BouncePlanesKernel):
    """ctypes wrapper of ``bounce_planes_live_launch`` (kernel G): kernel F
    with ``tlive`` [N / 1024] int32, one flag a 1024-lane tile; a tile
    whose flag is 0 copies o, d, L, beta and alive through, as
    ``ops/bounce.bounce_planes_live_plain`` returns them."""

    name = "bounce_planes_live"
    entry = "bounce_planes_live_launch"
    argtypes = (_P,) * 6 + (_I, _I, _P, _I)

    def __call__(self, planes, pkind, mkind, flags, lt, n_lights: int,
                 tlive):
        dev, n, n_in = _check_bounce_planes(self.name, planes, pkind, mkind,
                                            flags, lt, n_lights)
        _check_tlive(tlive, dev, n)
        self.load()
        out = torch.empty((N_SU_OUT, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(pkind), _ptr(mkind),
                     _ptr(flags), _ptr(tlive), _ptr(lt), n_lights,
                     int(n_in > N_IN_B), _ptr(out), n)
        return out


class BouncePlanesLiveBwdKernel(BouncePlanesBwdKernel):
    """ctypes wrapper of ``bounce_planes_live_bwd_launch`` (kernel G'):
    kernel F' with G's ``tlive``; a dead tile's lanes take the
    pass-through's cotangent and its blocks a zero light-table partial, as
    ``ops/bounce.bounce_planes_live_bwd_plain`` returns them. The partials
    are summed by B' (``_light_sum``)."""

    name = "bounce_planes_live_bwd"
    entry = "bounce_planes_live_bwd_launch"
    argtypes = (_P,) * 6 + (_I, _I) + (_P,) * 3 + (_I,)

    def partials(self, planes, pkind, mkind, flags, lt, n_lights: int, tlive,
                 g):
        """Kernel G' alone: (dP like ``planes``, the blocks' light-table
        partials [N / 128, (n_lights + 1) * LT_COLS])."""
        dev, n, n_in = _check_bounce_planes(self.name, planes, pkind, mkind,
                                            flags, lt, n_lights, g)
        _check_tlive(tlive, dev, n)
        self.load()
        d_planes = torch.empty((n_in, n), dtype=torch.float32, device=dev)
        part = torch.empty((n // 128, (n_lights + 1) * LT_COLS),
                           dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(planes), _ptr(pkind), _ptr(mkind),
                     _ptr(flags), _ptr(tlive), _ptr(lt), n_lights,
                     int(n_in > N_IN_B), _ptr(g), _ptr(d_planes), _ptr(part),
                     n)
        return d_planes, part

    def __call__(self, planes, pkind, mkind, flags, lt, n_lights: int, tlive,
                 g):
        """(dP like ``planes``, dlt like ``lt``): G', then B''s sum of its
        light-table partials."""
        d_planes, part = self.partials(planes, pkind, mkind, flags, lt,
                                       n_lights, tlive, g)
        return d_planes, _light_sum(part, lt)


def _check_perm(perm, dev, n):
    """Check a ray permutation ``perm`` [n] int64 (``ops/search.
    search_order``) for a launch of kernel K or M on ``dev``."""
    if perm is not None:
        _check("perm", perm, dev, (n,), torch.int64)


STAGE = 128      # triangle rows M stages at a time (csrc/search.cu)


def _check_unified_tables(tabs, dev, k, packed=False):
    """Check the tables of kernel M (an ``ops/search.SearchTables``) for a
    launch on ``dev`` with ``k`` entry columns: the compact triangle rows
    [T, 20] (``packed``: the packed rows [T, 10], and ``tabs.packed``
    set) 16-byte aligned (M copies them in 16-byte pieces), ``k``
    clusters of ``width`` rows, ``width`` whole 128-row stages; the
    sphere and quad rows [*, 9], at most 128 each."""
    t_n, s_n, q_n = (tabs.tri.shape[0], tabs.sph.shape[0],
                     tabs.quad.shape[0])
    if tabs.packed != packed:
        raise ValueError(f"{'packed' if tabs.packed else 'staged'} tables "
                         f"for M's {'packed' if packed else 'staged'} "
                         "input (kernels.search_kernel picks the variant)")
    _check("tri", tabs.tri, dev, (t_n, PACK_ROW if packed else TRI_ROW))
    _check("sph", tabs.sph, dev, (s_n, 9))
    _check("quad", tabs.quad, dev, (q_n, 9))
    if s_n > 128 or q_n > 128:
        raise ValueError(f"{s_n} spheres, {q_n} quads: the small tables "
                         "hold 128 rows")
    if t_n:
        if t_n != k * tabs.width or tabs.width % STAGE:
            raise ValueError(f"{t_n} triangles are not {k} clusters of "
                             f"{tabs.width} (whole {STAGE}-row stages)")
        if tabs.tri.data_ptr() % 16:
            raise ValueError("tri must be 16-byte aligned (M copies its "
                             "rows in 16-byte pieces)")


class TileEnterKernel(_Kernel):
    """ctypes wrapper of ``tile_enter_launch`` (kernel K): [n_tiles, K]
    float32, the smallest entry distance of any ray of each 256-ray tile
    (tiles restart at each chunk) into each cluster box, +inf where none
    enters, as ``ops/search.tile_enter_plain`` returns it."""

    name = "tile_enter"
    library = "search"
    entry = "tile_enter_launch"
    argtypes = (_P,) * 4 + (_I,) * 3 + (_P,)

    def __call__(self, rays, cl_min, cl_max, chunk=None, perm=None):
        """``rays`` [9, N] planes (o, d, time, t_min, t_max), the boxes
        ``cl_min`` / ``cl_max`` [K, 3], ``chunk`` rays a chunk (None: N),
        ``perm`` [N] int64 (``ops/search.search_order``; None: the rays'
        own order): tile position j holds the ray ``perm[j]``."""
        dev = rays.device
        if dev.type != "cuda":
            raise ValueError(f"tile_enter kernel needs CUDA tensors, got "
                             f"{dev}")
        n = rays.shape[1] if rays.dim() == 2 else -1
        chunk = n if chunk is None else chunk
        k = cl_min.shape[0]
        _check("rays", rays, dev, (N_RAY, n))
        _check_perm(perm, dev, n)
        _check("cl_min", cl_min, dev, (k, 3))
        _check("cl_max", cl_max, dev, (k, 3))
        tiles = tile_count(n, chunk)
        self.load()
        ent = torch.empty((tiles, k), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(rays), _ptr_or_null(perm), _ptr(cl_min),
                     _ptr(cl_max), n, chunk, k, _ptr(ent))
        return ent


def _ptr_or_null(t):
    return ctypes.c_void_p(None) if t is None else _ptr(t)


class FusedSearchKernel(_Kernel):
    """ctypes wrapper of ``fused_search_launch`` (kernel M): (best t [N]
    float32, inf for none; kind [N] int32, 0 for none; index [N] int32
    within its kind's table), as ``ops/search.fused_search_plain`` returns
    them. M sweeps each tile's entered clusters in the order this wrapper
    gives it, a stable ``torch.argsort`` of ``ent``'s rows (ascending
    entry)."""

    name = "fused_search"
    library = "search"
    entry = "fused_search_launch"
    argtypes = (_P,) * 7 + (_I,) * 7 + (_P,) * 4
    packed = False

    def __call__(self, rays, ent, tabs, chunk=None, perm=None):
        """``rays`` [9, N] planes, ``ent`` [n_tiles, K] (kernel K's, or one
        +inf column without triangles), ``tabs`` an
        ``ops/search.SearchTables``, ``chunk`` rays a chunk (None: N),
        ``perm`` [N] int64 as kernel K's (the winners are written at each
        ray's own index)."""
        dev = rays.device
        if dev.type != "cuda":
            raise ValueError(f"fused_search kernel needs CUDA tensors, got "
                             f"{dev}")
        n = rays.shape[1] if rays.dim() == 2 else -1
        chunk = n if chunk is None else chunk
        k = ent.shape[1] if ent.dim() == 2 else -1
        _check("rays", rays, dev, (N_RAY, n))
        _check_perm(perm, dev, n)
        _check("ent", ent, dev, (tile_count(n, chunk), k))
        _check_unified_tables(tabs, dev, k, self.packed)
        self.load()
        order = merge = None
        if tabs.tri.shape[0]:
            order = torch.argsort(ent, dim=1, stable=True)
            # the parts' meeting words: each ray's least (t, row), each
            # tile's count of finished parts; all ones
            merge = torch.full((n + ent.shape[0],), -1, dtype=torch.int64,
                               device=dev)
        best_t = torch.empty((n,), dtype=torch.float32, device=dev)
        best_k = torch.empty((n,), dtype=torch.int32, device=dev)
        best_i = torch.empty((n,), dtype=torch.int32, device=dev)
        self._launch(dev, _ptr(rays), _ptr(ent), _ptr_or_null(order),
                     _ptr_or_null(perm), _ptr(tabs.tri), _ptr(tabs.sph),
                     _ptr(tabs.quad), n, chunk, k, tabs.width,
                     tabs.tri.shape[0], tabs.sph.shape[0],
                     tabs.quad.shape[0], _ptr(best_t), _ptr(best_k),
                     _ptr(best_i), _ptr_or_null(merge))
        return best_t, best_k, best_i


class FusedSearchPackedKernel(FusedSearchKernel):
    """ctypes wrapper of ``fused_search_packed_launch``: kernel M's packed
    input (``fused_search_kernel<true>``), the same call and results as
    :class:`FusedSearchKernel`'s on tables whose triangles are packed
    rows (``ops/search.search_tables(..., packed=True)``); it counts its
    own launches."""

    name = "fused_search_packed"
    entry = "fused_search_packed_launch"
    packed = True


class PackedRowsProbeKernel(_Kernel):
    """ctypes wrapper of ``packed_rows_probe_launch``: M's packed stage
    copy and row assembly launched alone on a packed table, to hold the
    rows M sweeps against ``ops/search.compact_rows(_tri_coeffs(...))`` on
    the card. No render calls it; ``chip_smoke.py`` and
    ``tests/test_torch_gpu.py`` do."""

    name = "packed_rows_probe"
    library = "search"
    entry = "packed_rows_probe_launch"
    argtypes = (_P, _I, _P)

    def __call__(self, pack: torch.Tensor) -> torch.Tensor:
        """[T, 20] compact rows assembled from the packed rows ``pack``
        [T, 10] (T a multiple of 128), on one CUDA device."""
        dev = pack.device
        if dev.type != "cuda":
            raise ValueError(f"packed_rows_probe needs CUDA tensors, got "
                             f"{dev}")
        n = pack.shape[0]
        _check("pack", pack, dev, (n, PACK_ROW))
        if n % STAGE or pack.data_ptr() % 16:
            raise ValueError(f"{n} packed rows: whole {STAGE}-row stages, "
                             "16-byte aligned")
        self.load()
        out = torch.empty((n, TRI_ROW), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(pack), n, _ptr(out))
        return out


class TriSearchKernel(FusedSearchKernel):
    """Kernel L: the closest triangle of each ray alone, (best t [N]
    float32, inf for none; best index [N] int32, 0 for none), as
    ``ops/search.tri_search_plain`` returns them. L's body is M's
    triangle test over K's tile entries, so this launches M's entry point
    with empty sphere and quad tables; it counts its own launches."""

    name = "tri_search"

    def __call__(self, rays, ent, tabs, chunk=None):
        """``rays`` [9, N] planes, ``ent`` [n_tiles, K] (kernel K's),
        ``tabs`` an ``ops/search.SearchTables`` (its triangle rows),
        ``chunk`` rays a chunk (None: N)."""
        if rays.device.type != "cuda":
            raise ValueError(f"tri_search kernel needs CUDA tensors, got "
                             f"{rays.device}")
        if tabs.tri.shape[0] == 0:
            raise ValueError("tri_search needs at least one triangle")
        best_t, _, best_i = super().__call__(rays, ent, tri_only(tabs),
                                             chunk)
        return best_t, best_i


SCL = 128        # spheres per cull cluster (models/scene.CLUSTER)


class SphSearchKernel(_Kernel):
    """ctypes wrapper of ``sph_search_launch`` (kernel N): the closest
    sphere hit of each ray over a table of whole 128-sphere clusters,
    (best t [N] float32, inf for none; best index [N] int32, 0 for none),
    as ``ops/sphere.sph_search_plain`` returns them."""

    name = "sph_search"
    library = "sphere"
    entry = "sph_search_launch"
    argtypes = (_P,) * 5 + (_I,) * 4 + (_P, _P)

    def __call__(self, rays, tab, cl_min, cl_max, n_sph, chunk=None,
                 boxes=None):
        """``rays`` [9, N] planes (o, d, time, t_min, t_max), ``tab``
        [K * 128, 12] (``ops/sphere.sph_table``: c0, c1 - c0, t0,
        1 / (t1 - t0), r, r * r, two zeros; far pad rows; 16-byte
        aligned), the swept boxes ``cl_min`` / ``cl_max`` [K, 3],
        ``n_sph`` real rows (the index clamp), ``chunk`` rays a chunk
        (None: N), ``boxes`` [K * 4, 8] the 32-row sub-boxes
        (``ops/sphere.sph_boxes``, 16-byte aligned)."""
        dev = rays.device
        if dev.type != "cuda":
            raise ValueError(f"sph_search kernel needs CUDA tensors, got "
                             f"{dev}")
        if boxes is None:
            raise ValueError("sph_search kernel needs the sub-boxes "
                             "(ops/sphere.sph_boxes)")
        n = rays.shape[1] if rays.dim() == 2 else -1
        chunk = n if chunk is None else chunk
        k = cl_min.shape[0]
        _check("rays", rays, dev, (N_RAY, n))
        _check("tab", tab, dev, (k * SCL, SPH_ROW))
        _check("boxes", boxes, dev, (k * SCL // SUB_ROWS, 8))
        _check("cl_min", cl_min, dev, (k, 3))
        _check("cl_max", cl_max, dev, (k, 3))
        if tab.data_ptr() % 16 or boxes.data_ptr() % 16:
            raise ValueError("tab and boxes must be 16-byte aligned (N "
                             "reads their rows as float4)")
        if not 0 < n_sph <= k * SCL:
            raise ValueError(f"{n_sph} spheres in {k} clusters")
        tile_count(n, chunk)          # raises unless N is whole chunks
        self.load()
        best_t = torch.empty((n,), dtype=torch.float32, device=dev)
        best_i = torch.empty((n,), dtype=torch.int32, device=dev)
        self._launch(dev, _ptr(rays), _ptr(tab), _ptr(boxes), _ptr(cl_min),
                     _ptr(cl_max), n, chunk, k, n_sph, _ptr(best_t),
                     _ptr(best_i))
        return best_t, best_i


def shade_max_lights() -> int:
    """The most lights kernels I and I' take: the light table a block of
    I' holds in shared memory beside its two light-major stages
    (``shade_max_lights`` in ``csrc/shade.cu``: 3,892 on the H100). Builds
    the library if needed."""
    return shade_bwd_kernel.max_lights()


def _check_shade(name, data, rng, kind, lt, n_lights):
    """The device of kernel I's or I''s inputs, after checking them."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    most = shade_max_lights()
    if not 0 <= n_lights <= most:
        raise ValueError(f"{n_lights} lights: {name} takes at most {most} "
                         "(kernel I' holds the light table in a block's "
                         "shared memory)")
    n = data.shape[1] if data.dim() == 2 else -1
    _check("data", data, dev, (N_DATA, n))
    _check("rng", rng, dev, (N_RNG, n))
    _check("kind", kind, dev, (n,), torch.int32)
    _check("lt", lt, dev, (n_lights, LT_COLS))
    return dev, n


class ShadeKernel(_Kernel):
    """ctypes wrapper of ``shade_launch`` (kernel I): [10, N] planes
    (emitted, weight, direction, alive) of the data planes [14, N], the
    randoms [15, N], the int32 material kinds [N] and the lights ``lt``
    [n_lights, LT_COLS], as ``ops/shade_core.plane_core`` returns them."""

    name = library = "shade"
    entry = "shade_launch"
    argtypes = (_P,) * 4 + (_I, _P, _I)

    def __call__(self, data, rng, kind, lt, n_lights: int):
        dev, n = _check_shade(self.name, data, rng, kind, lt, n_lights)
        self.load()
        out = torch.empty((SHADE_OUT, n), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(data), _ptr(rng), _ptr(kind), _ptr(lt),
                     n_lights, _ptr(out), n)
        return out


class ShadeBwdKernel(_Kernel):
    """ctypes wrapper of ``shade_bwd_launch`` (kernel I'): for the
    cotangents ``g`` [9, N] of kernel I's emitted, weight and direction
    planes, the cotangents of its data planes [14, N] and of the light
    table (like ``lt``), as ``ops/shade_core.plane_core_vjp`` returns them.
    I' leaves the table's as one partial a block (:meth:`partials`), which
    ``bwd_reduce_kernel`` (B') sums in block order: no float atomics."""

    name = "shade_bwd"
    library = "shade"
    entry = "shade_bwd_launch"
    argtypes = (_P,) * 4 + (_I,) + (_P,) * 3 + (_I,)

    def __init__(self):
        super().__init__()
        self._max_lights = None

    def max_lights(self) -> int:
        """The library's ``shade_max_lights()`` (building it if needed)."""
        if self._max_lights is None:
            lib = ctypes.CDLL(str(self.load().path))
            self._max_lights = int(lib.shade_max_lights())
        return self._max_lights

    def partials(self, data, rng, kind, lt, n_lights: int, g):
        """Kernel I' alone: (d_data [14, N], the blocks' light-table
        partials [ceil(N / 128), n_lights * LT_COLS])."""
        dev, n = _check_shade(self.name, data, rng, kind, lt, n_lights)
        _check("g", g, dev, (9, n))
        self.load()
        d_data = torch.empty((N_DATA, n), dtype=torch.float32, device=dev)
        part = torch.empty((-(-n // 128), n_lights * LT_COLS),
                           dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(data), _ptr(rng), _ptr(kind), _ptr(lt),
                     n_lights, _ptr(g), _ptr(d_data), _ptr(part), n)
        return d_data, part

    def __call__(self, data, rng, kind, lt, n_lights: int, g):
        """(d_data [14, N], dlt like ``lt``): I', then B''s sum of its
        light-table partials."""
        d_data, part = self.partials(data, rng, kind, lt, n_lights, g)
        return d_data, _light_sum(part, lt)


quad_search_kernel = QuadSearchKernel()
hit_attrs_kernel = HitAttrsKernel()
shade_update_kernel = ShadeUpdateKernel()
hit_attrs_bwd_kernel = HitAttrsBwdKernel()
shade_update_bwd_kernel = ShadeUpdateBwdKernel()
bounce_planes_kernel = BouncePlanesKernel()
bounce_planes_bwd_kernel = BouncePlanesBwdKernel()
bounce_planes_live_kernel = BouncePlanesLiveKernel()
bounce_planes_live_bwd_kernel = BouncePlanesLiveBwdKernel()
tile_enter_kernel = TileEnterKernel()
fused_search_kernel = FusedSearchKernel()
fused_search_packed_kernel = FusedSearchPackedKernel()
packed_rows_probe_kernel = PackedRowsProbeKernel()
tri_search_kernel = TriSearchKernel()
sph_search_kernel = SphSearchKernel()
shade_kernel = ShadeKernel()
shade_bwd_kernel = ShadeBwdKernel()


def search_kernel(tabs) -> FusedSearchKernel:
    """Kernel M's variant for the tables ``tabs`` (an ``ops/search.
    SearchTables``): the packed input for packed rows, else the staged
    one."""
    return fused_search_packed_kernel if tabs.packed else fused_search_kernel


def trace_wave_occupancy(library: str, triangles: bool = True,
                         device=None) -> dict[str, int]:
    """Resident blocks per multiprocessor of kernels A, D and E of
    ``library`` (``trace_wave`` or ``trace_wave_noise``, whose E is 0) on
    the CUDA ``device`` (the current one by default), from the CUDA
    runtime's occupancy calculator at their launch's block size and shared
    memory for a scene with (``triangles``) or without a triangle chunk."""
    if library not in ("trace_wave", "trace_wave_noise"):
        raise ValueError(f"{library} holds no trace kernels")
    lib = ctypes.CDLL(str(build(library).path))
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = lib.trace_wave_occupancy(out, ctypes.c_int(int(triangles)))
    if err != 0:
        raise RuntimeError(f"occupancy query of {library}: CUDA error {err}")
    return dict(zip(("trace_wave_kernel", "fused_bounce_kernel",
                     "select_kernel"), out))


def trace_kernel(ctx) -> TraceWaveKernel:
    """Kernel A's variant for ``ctx``: with marble noise or without."""
    return trace_wave_noise_kernel if ctx.has_noise else trace_wave_kernel


def trace_bwd_kernel(ctx) -> TraceWaveBwdKernel:
    """Kernel B's variant for ``ctx``: with marble noise or without."""
    return (trace_wave_bwd_noise_kernel if ctx.has_noise
            else trace_wave_bwd_kernel)


def fused_bounce_kernel(ctx) -> FusedBounceKernel:
    """Kernel D's variant for ``ctx``: with marble noise or without."""
    return bounce_uber_noise_kernel if ctx.has_noise else bounce_uber_kernel


def fused_bounce_bwd_kernel(ctx) -> FusedBounceBwdKernel:
    """Kernel D''s variant for ``ctx``: with marble noise or without."""
    return (bounce_uber_bwd_noise_kernel if ctx.has_noise
            else bounce_uber_bwd_kernel)


def reduce_order(keys: torch.Tensor):
    """(sorted keys int32, perm int32): the (bounce, ray) pairs' row keys
    in stable sorted order and each one's position. Sorting integers is
    exact, so the order is the same in every run; ``bwd_reduce_kernel``
    finds each row's run itself."""
    sorted_keys, perm = torch.sort(keys.reshape(-1), stable=True)
    return sorted_keys.to(torch.int32), perm.to(torch.int32)


def trace_backward(hist, rnd, kind, idx, ctx, g):
    """The trace's backward on the card: kernel B (its variant for
    ``ctx``), the stable sort of its row keys, then ``bwd_reduce``.
    Returns (dst [14, N], duni like ``ctx.uni``, dlt like ``ctx.lt``), as
    ``ops.uber.trace_wave_bwd_plain``."""
    dst, contrib, keys, part = trace_bwd_kernel(ctx)(hist, rnd, kind, idx,
                                                    ctx, g)
    skeys, perm = reduce_order(keys)
    duni, dlt = bwd_reduce_kernel(contrib, skeys, perm, ctx.uni.shape[0],
                                  part)
    return dst, duni, dlt.reshape(ctx.lt.shape)


def fused_bounce_backward(st, rnd_b, kind, idx, ctx, g):
    """One uber bounce's backward on the card: kernel D' (its variant for
    ``ctx``), the stable sort of its row keys, then ``bwd_reduce``.
    Returns (dst [14, N], duni like ``ctx.uni``, dlt like ``ctx.lt``), as
    ``ops.uber.fused_bounce_bwd_plain``."""
    dst, contrib, keys, part = fused_bounce_bwd_kernel(ctx)(
        st, rnd_b, kind, idx, ctx, g)
    skeys, perm = reduce_order(keys)
    duni, dlt = bwd_reduce_kernel(contrib, skeys, perm, ctx.uni.shape[0],
                                  part)
    return dst, duni, dlt.reshape(ctx.lt.shape)
