"""Build and bind the package's hand-written CUDA kernels (``csrc/``).

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``, no fast-math) into a shared
library with plain C entry points, one ``nvcc`` per source, all started
together, under ``build/torch_kernels/`` at the root of the checkout,
keyed by a hash of the sources (headers included) and flags so an edit
rebuilds them. They are loaded with ctypes; pointers come from
``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. Importing this module needs
no ``nvcc`` and no GPU.

Kernels (each wrapper counts its launches in ``launches``):
  * ``trace_wave_kernel`` — ``csrc/trace_wave.cu``, the whole-wave bounce
    loop, optionally writing the backward's residuals (replaces
    ``rust_ray_tracer_tpu/ops/pallas_uber.py`` ``_make_trace_kernel``);
    plain version ``ops/uber.trace_wave_plain``;
  * ``trace_wave_bwd_kernel`` — ``csrc/trace_wave_bwd.cu``, the adjoint
    of the bounce loop replayed from the residuals (replaces
    ``_make_trace_bwd_kernel``); ``bwd_reduce_kernel`` — the same file,
    the fixed-order sums of the winner-row and light-table cotangents
    (the in-kernel accumulation of ``pallas_uber.py:979-1012``).
    :func:`trace_backward` chains them; its plain version is
    ``ops/uber.trace_wave_bwd_plain``.
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

from rust_ray_tracer_tpu_torch.ops.shade_core import LT_COLS
from rust_ray_tracer_tpu_torch.ops.uber import (A_COL, N_RND, N_STATE, TCC,
                                                TILE)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("trace_wave", "trace_wave_bwd")
# the backward rounds as its plain version does: no a*b+c contraction, so
# its recomputed forward and adjoint of an ill-conditioned hit (a ray
# grazing a large sphere) stay within the comparison's budget; it is bound
# by memory, so the unfused instructions cost little
EXTRA_FLAGS = {"trace_wave_bwd": ("--fmad=false",)}


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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ()))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


_BUILDS: dict[str, Build] = {}


def build_all() -> dict[str, Build]:
    """Compile every source in :data:`SOURCES` whose library for these
    sources and flags does not exist yet, one ``nvcc`` each, all at once;
    raises if any fails."""
    todo = {}
    for name in SOURCES:
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
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    """The library of ``csrc/<name>.cu`` (building every source first)."""
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
    """A ctypes-bound C entry point ``entry`` of the library built from
    ``csrc/<source>.cu``; ``argtypes`` precede the stream argument.
    ``launches`` counts the kernel launches this wrapper has made."""

    name = source = entry = ""
    argtypes: tuple = ()

    def __init__(self):
        self.launches = 0
        self.build_info: Build | None = None
        self._fn = None

    def load(self) -> Build:
        """Build (if needed) and bind the library; returns the build."""
        if self._fn is None:
            self.build_info = build(self.source)
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


class TraceWaveKernel(_Kernel):
    """ctypes wrapper of ``trace_wave_launch`` (kernel A)."""

    name = source = "trace_wave"
    entry = "trace_wave_launch"
    argtypes = (_P,) * 16 + (_I,) * 11

    def __call__(self, st0: torch.Tensor, rnd: torch.Tensor, ctx,
                 depth: int, residuals: bool = False):
        """Final state [14, N] of ``depth`` bounces from ``st0`` [14, N]
        with randoms ``rnd`` [depth, 15, N] over the tables of ``ctx``
        (an ``ops.uber.TraceCtx``), all on one CUDA device; with
        ``residuals`` also (hist [depth, 14, N], kind, idx [depth, N]
        int32), as ``ops.uber.trace_wave_plain`` returns them."""
        dev = st0.device
        if dev.type != "cuda":
            raise ValueError(f"trace_wave kernel needs CUDA tensors, got "
                             f"{dev}")
        n = st0.shape[1] if st0.dim() == 2 else -1
        if n < 0 or n % 128:
            raise ValueError(f"st0 must be [{N_STATE}, N] with N % 128 == 0, "
                             f"got {tuple(st0.shape)}")
        # the kernel reads the material attrs up to MATTR_ALBEDO, and up to
        # MATTR_ISCHK with checkers
        w_min = A_COL + (13 if ctx.has_checker else 6)
        _check("st0", st0, dev, (N_STATE, n))
        _check("rnd", rnd, dev, (depth, N_RND, n))
        _check("uni", ctx.uni, dev)
        if ctx.uni.dim() != 2 or ctx.uni.shape[1] < w_min:
            raise ValueError(f"uni must be [P, >= {w_min}], got "
                             f"{tuple(ctx.uni.shape)}")
        tp = ctx.det_t.shape[0]
        for nm in ("det_t", "u_t", "v_t", "t_t"):
            _check(nm, getattr(ctx, nm), dev, (tp, 10))
        _check("dbl_t", ctx.dbl_t, dev, (tp, 1))
        if ctx.n_tri_chunks * TCC > tp:
            raise ValueError("triangle tables shorter than the chunk count")
        _check("sph", ctx.sph, dev, (ctx.sph.shape[0], 9))
        _check("quad", ctx.quad, dev, (ctx.quad.shape[0], 9))
        _check("cab", ctx.cab, dev, (max(1, -(-tp // TCC)), 8))
        _check("lt", ctx.lt, dev, (ctx.n_lights + 1, LT_COLS))
        self.load()
        stf = torch.empty_like(st0)
        null = ctypes.c_void_p(None)
        hist = kind = idx = None
        if residuals:
            hist = torch.empty((depth, N_STATE, n), dtype=torch.float32,
                               device=dev)
            kind = torch.empty((depth, n), dtype=torch.int32, device=dev)
            idx = torch.empty_like(kind)
        self._launch(
            dev, _ptr(st0), _ptr(rnd), _ptr(ctx.uni), _ptr(ctx.det_t),
            _ptr(ctx.u_t), _ptr(ctx.v_t), _ptr(ctx.t_t), _ptr(ctx.dbl_t),
            _ptr(ctx.sph), _ptr(ctx.quad), _ptr(ctx.cab), _ptr(ctx.lt),
            _ptr(stf), _ptr(hist) if residuals else null,
            _ptr(kind) if residuals else null,
            _ptr(idx) if residuals else null, n, depth, ctx.uni.shape[1],
            ctx.n_tri_chunks, ctx.sph.shape[0] if ctx.n_sph else 0,
            ctx.quad.shape[0] if ctx.n_quad else 0, ctx.t_off, ctx.s_off,
            ctx.q_off, ctx.n_lights, int(ctx.has_checker))
        return (stf, hist, kind, idx) if residuals else stf


trace_wave_kernel = TraceWaveKernel()


class TraceWaveBwdKernel(_Kernel):
    """ctypes wrapper of ``trace_wave_bwd_launch`` (kernel B): the
    adjoint of every bounce of a wave, replayed from the forward's
    residuals. Returns dst [14, N], the per-(bounce, ray) winner-row
    cotangents ``contrib`` [depth, N, W] with their winner rows ``keys``
    [depth, N] int32 (P where the ray found none), and the per-block
    light-table partials [N / 128, (n_lights + 1) * 14]."""

    name = source = "trace_wave_bwd"
    entry = "trace_wave_bwd_launch"
    argtypes = (_P,) * 11 + (_I,) * 6

    def __call__(self, hist, rnd, kind, idx, ctx, g):
        dev = g.device
        if dev.type != "cuda":
            raise ValueError(f"trace_wave_bwd kernel needs CUDA tensors, "
                             f"got {dev}")
        n = g.shape[1] if g.dim() == 2 else -1
        if n < 0 or n % TILE:
            raise ValueError(f"g must be [{N_STATE}, N] with N % {TILE} == 0,"
                             f" got {tuple(g.shape)}")
        depth = hist.shape[0]
        p_rows, w = ctx.uni.shape
        ltn = (ctx.n_lights + 1) * LT_COLS
        if ltn > 128:
            raise ValueError(f"{ctx.n_lights} lights exceed the kernel's "
                             "light table")
        _check("g", g, dev, (N_STATE, n))
        _check("hist", hist, dev, (depth, N_STATE, n))
        _check("rnd", rnd, dev, (depth, N_RND, n))
        _check("kind", kind, dev, (depth, n), torch.int32)
        _check("idx", idx, dev, (depth, n), torch.int32)
        _check("uni", ctx.uni, dev)
        if w < A_COL + (13 if ctx.has_checker else 6):
            raise ValueError(f"uni has {w} columns")
        _check("lt", ctx.lt, dev, (ctx.n_lights + 1, LT_COLS))
        self.load()
        dst = torch.empty_like(g)
        contrib = torch.empty((depth, n, w), dtype=torch.float32, device=dev)
        keys = torch.empty((depth, n), dtype=torch.int32, device=dev)
        part = torch.empty((n // 128, ltn), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(hist), _ptr(rnd), _ptr(kind), _ptr(idx),
                     _ptr(g), _ptr(ctx.uni), _ptr(ctx.lt), _ptr(dst),
                     _ptr(contrib), _ptr(keys), _ptr(part), n, depth, w,
                     p_rows, ctx.n_lights, int(ctx.has_checker))
        return dst, contrib, keys, part


PIECE = 1024     # contributions one reduction block sums at most


class BwdReduceKernel(_Kernel):
    """ctypes wrapper of ``bwd_reduce_launch``: duni [P, W] sums row p's
    contributions in the order of ``perm`` (the segment
    ``offs[p]:offs[p + 1]``), cut at the multiples of :data:`PIECE` of
    that order into parts that separate blocks sum and the row's last
    block adds in order; dlt [(n_lights + 1) * 14] sums the per-block
    partials in block order. No float atomics: the sums are bitwise
    repeatable."""

    name = "bwd_reduce"
    source = "trace_wave_bwd"
    entry = "bwd_reduce_launch"
    argtypes = (_P,) * 3 + (_I,) * 4 + (_P,) * 3 + (_I,) * 2 + (_P,) * 2

    def __call__(self, contrib, perm, offs, part):
        dev = contrib.device
        if dev.type != "cuda":
            raise ValueError(f"bwd_reduce kernel needs CUDA tensors, got "
                             f"{dev}")
        w = contrib.shape[-1]
        if w > 32:
            raise ValueError(f"{w} columns exceed the reduction's 32")
        m = contrib.numel() // w
        p_rows = offs.shape[0] - 1
        _check("contrib", contrib, dev)
        _check("perm", perm, dev, (m,), torch.int32)
        _check("offs", offs, dev, (p_rows + 1,), torch.int32)
        _check("part", part, dev)
        n_part, ltn = part.shape
        self.load()
        # row p takes offs[p+1] // PIECE - offs[p] // PIECE + 1 blocks, so
        # all rows at most p_rows + m // PIECE: known without reading offs
        max_blocks = p_rows + m // PIECE
        partial = torch.empty((max_blocks, w), dtype=torch.float32,
                              device=dev)
        done = torch.zeros((p_rows,), dtype=torch.int32, device=dev)
        duni = torch.empty((p_rows, w), dtype=torch.float32, device=dev)
        dlt = torch.empty((ltn,), dtype=torch.float32, device=dev)
        self._launch(dev, _ptr(contrib), _ptr(perm), _ptr(offs), p_rows, w,
                     PIECE, max_blocks, _ptr(partial), _ptr(done),
                     _ptr(part), n_part, ltn, _ptr(duni), _ptr(dlt))
        return duni, dlt


trace_wave_bwd_kernel = TraceWaveBwdKernel()
bwd_reduce_kernel = BwdReduceKernel()


def reduce_order(keys: torch.Tensor, p_rows: int):
    """(perm int32, offs int32 [p_rows + 1]): the (bounce, ray) pairs in
    the stable order of their winner rows, and each row's segment. Sorting
    integers is exact, so the order is the same in every run."""
    sorted_keys, perm = torch.sort(keys.reshape(-1), stable=True)
    offs = torch.searchsorted(
        sorted_keys, torch.arange(p_rows + 1, dtype=torch.int32,
                                  device=keys.device))
    return perm.to(torch.int32), offs.to(torch.int32)


def trace_backward(hist, rnd, kind, idx, ctx, g):
    """The trace's backward on the card: kernel B, the stable sort of its
    row keys, then ``bwd_reduce``. Returns (dst [14, N], duni like
    ``ctx.uni``, dlt like ``ctx.lt``), as
    ``ops.uber.trace_wave_bwd_plain``."""
    dst, contrib, keys, part = trace_wave_bwd_kernel(hist, rnd, kind, idx,
                                                     ctx, g)
    perm, offs = reduce_order(keys, ctx.uni.shape[0])
    duni, dlt = bwd_reduce_kernel(contrib, perm, offs, part)
    return dst, duni, dlt.reshape(ctx.lt.shape)
