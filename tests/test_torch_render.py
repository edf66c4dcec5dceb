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
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops.integrator import render_image, \
    render_waves
from rust_ray_tracer_tpu_torch.ops.tonemap import tonemap_mean
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import image as timage
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import assert_flip_budget, jax_compile, jax_flagship


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


def test_compact_not_ported():
    ts = compile_scene(tb.cornell_box(1.0), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        render_waves(ts, 8, 8, rng.key(0, "cpu"), 0, 1, compact=True)


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


@pytest.mark.parametrize("flag", [["-g", "scene.gltf"], ["--compact"],
                                  ["--checkpoint", "x.ckpt"],
                                  ["--coordinator", "localhost:1234"]])
def test_cli_unported_flags_exit_with_message(flag, capsys):
    assert cli.main(["16", "1", *flag]) == 2
    assert "not yet ported" in capsys.readouterr().err
