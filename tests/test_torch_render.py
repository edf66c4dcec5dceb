"""The port's whole forward render on the CPU (the plain version of the
trace kernel) vs JAX render_waves on the CPU, plus the CLI."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu.ops.tonemap import tonemap_mean as jax_tonemap
from rust_ray_tracer_tpu.utils.image import decode_png, encode_png
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops.integrator import render_image, \
    render_waves
from rust_ray_tracer_tpu_torch.ops.tonemap import tonemap_mean
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import image as timage
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import assert_flip_budget, jax_compile, jax_flagship
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name,w,h", [("flagship", 64, 36),
                                      ("cornell_box", 32, 32)])
def test_render_waves_matches_jax(name, w, h, monkeypatch):
    if name == "flagship":
        js = jax_flagship(monkeypatch)
        ts = compile_scene(tb.flagship(), device="cpu")
    else:
        js = jax_compile(jb.get_scene(name, 1.0), monkeypatch)
        ts = compile_scene(tb.get_scene(name, 1.0), device="cpu")
    ref = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=1024))
    got = render_waves(ts, w, h, rng.key(0, "cpu"), 0, 2, chunk_size=1024)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    assert_flip_budget(got.numpy(), ref)


def test_render_noise_scene_matches_jax(monkeypatch):
    """tests/test_uber.py's noise scene (r = 100 marble ground): the flip
    budget of the other scenes holds."""
    from tests.torch_parity import both

    js, ts = both("noise", monkeypatch)
    ref = np.asarray(jax_render(js, 32, 32, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=1024))
    got = render_waves(ts, 32, 32, rng.key(0, "cpu"), 0, 2, chunk_size=1024)
    assert_flip_budget(got.numpy(), ref)


def _off(img, exact):
    """Share of pixels with a channel more than 1e-3 off ``exact``."""
    return float((np.abs(img - exact) > 1e-3).any(-1).mean())


@pytest.mark.parametrize("name", ["random", "perlin_spheres", "rect_light"])
def test_render_builder_noise_scenes_match_jax(name, monkeypatch):
    """The three marble-noise builder scenes, 32x18, 2 spp, on the CPU.

    Their ground is a radius-1000 sphere, and the marble moves ~50 per unit
    of the hit point, so a far hit point's last ulp (XLA contracts it into
    FMAs, the port does not) moves a pixel past the flip budget's 1e-3:
    measured, 3.6% of random's pixels and 1.7% of perlin_spheres' differ
    from JAX's render, and each float32 render is as far from a float64
    render of the same scene and rays (random: port 5.0%, JAX 5.4% of the
    pixels; perlin_spheres: 2.6%, 2.3%). So: the mean radiance within 1e-3
    of JAX's, at most 5% of the pixels more than 1e-3 off JAX's (measured
    3.6% at most), and the port at most 1.25x as far from the float64
    render as JAX, plus one pixel. rect_light's render is black (mean
    radiance 0) in both packages at this size and depth."""
    w, h = 32, 18
    js = jax_compile(jb.get_scene(name, w / h), monkeypatch)
    ts = compile_scene(tb.get_scene(name, w / h), device="cpu")
    ref = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=1024))
    got = render_waves(ts, w, h, rng.key(0, "cpu"), 0, 2,
                       chunk_size=1024).numpy()
    params, static = partition(ts)
    exact = render_waves(combine({k: v.double() for k, v in params.items()},
                                 static), w, h, rng.key(0, "cpu"), 0, 2,
                         chunk_size=1024).numpy()
    assert np.isfinite(got).all() and got.shape == (h, w, 3)
    assert abs(got.mean() - ref.mean()) <= 1e-3 * max(abs(ref.mean()), 1e-3)
    assert _off(got, ref) <= 0.05
    assert _off(got, exact) <= 1.25 * _off(ref, exact) + 1.0 / (w * h)


def test_render_is_bitwise_reproducible_and_resumable():
    ts = compile_scene(tb.cornell_box(1.0), device="cpu")
    a = render_waves(ts, 24, 24, rng.key(3, "cpu"), 0, 3, chunk_size=256)
    b = render_waves(ts, 24, 24, rng.key(3, "cpu"), 0, 3, chunk_size=256)
    assert torch.equal(a, b)
    part = render_waves(ts, 24, 24, rng.key(3, "cpu"), 0, 2, chunk_size=256)
    resumed = render_waves(ts, 24, 24, rng.key(3, "cpu"), 2, 1, chunk_size=256,
                           acc0=part)
    assert torch.equal(resumed, a)
    img = render_image(ts, 24, 24, 3, rng.key(3, "cpu"), chunk_size=256)
    assert torch.equal(img, a / 3)


def test_tonemap_and_png_match_jax():
    x = np.random.default_rng(0).uniform(-0.5, 3.0, (9, 7, 3)).astype(
        np.float32)
    x[0, 0, 1] = np.nan
    u8 = tonemap_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(u8, np.asarray(
        jax_tonemap(jax.numpy.asarray(x))))
    assert timage.encode_png(u8) == encode_png(u8)
    np.testing.assert_array_equal(decode_png(timage.encode_png(u8)), u8)


def _cli(*args):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "rust_ray_tracer_tpu_torch", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_cpu_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    proc = _cli("24", "2", "--scene", "cornell_box", "-a", "1.0", "-o",
                str(out), "--device", "cpu", "--chunk-size", "1024")
    assert proc.returncode == 0, proc.stderr
    img = decode_png(out.read_bytes())
    assert img.shape == (24, 24, 3)
    # the saved image is the vertically flipped tonemap of the render
    ts = compile_scene(tb.cornell_box(1.0), device="cpu")
    ref = tonemap_mean(render_image(ts, 24, 24, 2, rng.key(0, "cpu"),
                                    chunk_size=1024)).numpy()[::-1]
    np.testing.assert_array_equal(img, ref)


def test_cli_cuda_without_gpu_fails_clearly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the no-GPU message cannot show")
    rc = cli.main(["16", "1", "--scene", "cornell_box", "-o",
                   str(tmp_path / "x.png"), "--device", "cuda"])
    assert rc != 0
    assert "no CUDA GPU" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


_SMALL = ("24", "2", "--scene", "cornell_box", "-a", "1.0", "--device",
          "cpu", "--chunk-size", "128")


def test_cli_checkpoint_resume_is_bitwise(tmp_path):
    """A 1-spp run leaves its checkpoint; a 2-spp run with the same
    --checkpoint resumes from it (the settings it checks are seed, size,
    chunk and depth) and writes the uninterrupted 2-spp render's PNG bit
    for bit; a third run is a no-op restart: no wave rendered, the same
    PNG, the checkpoint untouched."""
    ckpt = tmp_path / "c.ckpt"
    ref = tmp_path / "ref.png"
    assert _cli(*_SMALL, "-o", str(ref)).returncode == 0
    assert (tmp_path / "ref.png.ckpt").exists()       # the default path
    one = _cli("24", "1", *_SMALL[2:], "-o", str(tmp_path / "one.png"),
               "--checkpoint", str(ckpt), "--ckpt-every", "1")
    assert one.returncode == 0, one.stderr
    out = tmp_path / "out.png"
    two = _cli(*_SMALL, "-o", str(out), "--checkpoint", str(ckpt),
               "--ckpt-every", "1")
    assert two.returncode == 0, two.stderr
    assert "wave 2/2" in two.stdout and "wave 1/2" not in two.stdout
    assert out.read_bytes() == ref.read_bytes()
    stamp = ckpt.stat().st_mtime_ns
    out.unlink()
    three = _cli(*_SMALL, "-o", str(out), "--checkpoint", str(ckpt))
    assert three.returncode == 0, three.stderr
    assert "wave" not in three.stdout
    assert out.read_bytes() == ref.read_bytes()
    assert ckpt.stat().st_mtime_ns == stamp


def test_cli_devices_two_cpu_processes_match_one(tmp_path):
    """--devices 2 --device cpu starts two local processes that shard the
    rays (the per-chunk path over gloo); rank 0's PNG equals the one-process
    run's bit for bit, and only rank 0 writes it."""
    one, two = tmp_path / "one.png", tmp_path / "two.png"
    a = _cli(*_SMALL, "-o", str(one), "--devices", "1")
    b = _cli(*_SMALL, "-o", str(two), "--devices", "2")
    assert a.returncode == 0 and b.returncode == 0, (a.stderr, b.stderr)
    assert "1 process(es)" in a.stdout and "2 process(es)" in b.stdout
    assert b.stdout.count("wrote ") == 1
    assert two.read_bytes() == one.read_bytes()


def test_cli_devices_two_cpu_processes_unfused(tmp_path, monkeypatch):
    """Under ``RRT_NO_UBER_FUSED=1`` --devices 2 --device cpu shards the
    rays over two processes whose per-chunk bounce is the unfused one (the
    plain versions of TPU kernels E and G, ``ops/uber.unfused_bounce``);
    on the CPU it renders the fused route's pixels, so rank 0's PNG equals
    a one-process run's without the flag bit for bit."""
    one, two = tmp_path / "one.png", tmp_path / "two.png"
    a = _cli(*_SMALL, "-o", str(one), "--devices", "1")
    monkeypatch.setenv("RRT_NO_UBER_FUSED", "1")
    b = _cli(*_SMALL, "-o", str(two), "--devices", "2")
    assert a.returncode == 0 and b.returncode == 0, (a.stderr, b.stderr)
    assert "2 process(es)" in b.stdout
    assert two.read_bytes() == one.read_bytes()


def test_cli_coordinator_flags_join_two_processes(tmp_path):
    """--coordinator / --num-processes / --process-id across two processes
    started by hand: rank 0 writes the PNG, equal to a one-process run's."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "mp.png"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rust_ray_tracer_tpu_torch", *_SMALL, "-o",
         str(out), "--coordinator", addr, "--num-processes", "2",
         "--process-id", str(r)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "wrote " in logs[0] and "wrote " not in logs[1]
    ref = tmp_path / "ref.png"
    assert _cli(*_SMALL, "-o", str(ref)).returncode == 0
    assert out.read_bytes() == ref.read_bytes()
