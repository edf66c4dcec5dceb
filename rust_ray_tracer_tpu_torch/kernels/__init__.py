"""Build and bind the package's hand-written CUDA kernels (``csrc/``).

Each kernel is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``, no fast-math) into a shared
library with a plain C entry point, under ``build/torch_kernels/`` at the
root of the checkout, keyed by a hash of the source and flags so an edit
rebuilds it. It is loaded with ctypes; pointers come from
``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. Importing this module needs
no ``nvcc`` and no GPU.

Kernels:
  * ``trace_wave_kernel`` — ``csrc/trace_wave.cu``, the whole-wave bounce
    loop (replaces ``rust_ray_tracer_tpu/ops/pallas_uber.py``
    ``_make_trace_kernel``); plain version ``ops/uber.trace_wave_plain``.
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
from rust_ray_tracer_tpu_torch.ops.uber import A_COL, N_RND, N_STATE, TCC

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` into ``build/torch_kernels`` unless the
    library for this source and these flags already exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, seconds, proc.stdout + proc.stderr)


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


class TraceWaveKernel:
    """ctypes wrapper of ``trace_wave_launch``; ``launches`` counts the
    kernel launches this wrapper has made."""

    name = "trace_wave"

    def __init__(self):
        self.launches = 0
        self.build_info: Build | None = None
        self._fn = None

    def load(self) -> Build:
        """Build (if needed) and bind the library; returns the build."""
        if self._fn is None:
            self.build_info = build(self.name)
            lib = ctypes.CDLL(str(self.build_info.path))
            fn = lib.trace_wave_launch
            fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self.build_info

    def __call__(self, st0: torch.Tensor, rnd: torch.Tensor, ctx,
                 depth: int) -> torch.Tensor:
        """Final state [14, N] of ``depth`` bounces from ``st0`` [14, N]
        with randoms ``rnd`` [depth, 15, N] over the tables of ``ctx``
        (an ``ops.uber.TraceCtx``), all on one CUDA device."""
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
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
                _ptr(st0), _ptr(rnd), _ptr(ctx.uni), _ptr(ctx.det_t),
                _ptr(ctx.u_t), _ptr(ctx.v_t), _ptr(ctx.t_t),
                _ptr(ctx.dbl_t), _ptr(ctx.sph), _ptr(ctx.quad),
                _ptr(ctx.cab), _ptr(ctx.lt), _ptr(stf), n, depth,
                ctx.uni.shape[1], ctx.n_tri_chunks,
                ctx.sph.shape[0] if ctx.n_sph else 0,
                ctx.quad.shape[0] if ctx.n_quad else 0,
                ctx.t_off, ctx.s_off, ctx.q_off, ctx.n_lights,
                int(ctx.has_checker), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"trace_wave launch failed: CUDA error {err}")
        self.launches += 1
        return stf


trace_wave_kernel = TraceWaveKernel()
