"""The port's compact wavefront (``ops/integrator.trace_wave_compact``),
``auto_compact`` and the CLI's ``--compact`` / ``--cache-dir`` on the CPU.

The compact wavefront runs the split route's bounce on the wave's live
rays only, packed alive-first across all its chunks, with each ray's
randoms gathered from its original (chunk, lane). Every per-lane step of
the port is independent of the lane's position, so its image equals the
per-chunk render bit for bit, whatever the processing chunk; JAX only
promises 1e-6 between its own two routes (``integrator.py:456-459``), and
the port's compact render is held to JAX's within the flip budget of the
other render tests (``torch_parity.assert_flip_budget``). Gradients: the
permutations are gathers both ways, so two runs give the same bits; they
differ from the per-chunk route's by summation order, held to rtol 5e-4 /
atol 1e-6 as JAX's own test holds its two routes
(``tests/test_compact.py:72-92``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import integrator as jint
from rust_ray_tracer_tpu_torch import kernels
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops.integrator import (auto_compact,
                                                      render_waves,
                                                      trace_wave_compact)
from rust_ray_tracer_tpu_torch.parallel import (load_state,
                                                render_with_checkpoints)
from rust_ray_tracer_tpu_torch.utils import cli, rng
from rust_ray_tracer_tpu_torch.utils.image import decode_png

from tests.torch_parity import (assert_flip_budget, jax_compile,
                                jax_flagship, torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W, H, DEPTH, CHUNK, PROC = 24, 24, 3, 192, 96


def occupancy(S, cam_mod):
    """``tests/test_compact.py``'s ``occupancy_scene``: a checker ground
    filling the frame, spheres of three materials (one moving), a
    triangle and a rect light under a bright sky."""
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    world = [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Metal((0.8, 0.8, 0.9), 0.1)),
        S.MovingSphere((2.2, 0, -4), (2.4, 0.2, -4), 0.0, 1.0, 1.0,
                       S.Dielectric(1.5)),
        S.Triangle((-3, 0.5, -6), (3, 0.5, -6), (0, 3.5, -7),
                   S.Lambertian.from_rgb(0.7, 0.6, 0.5),
                   double_sided=True),
        S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                 S.DiffuseLight.from_color((5, 5, 5))),
    ]
    return S.Scene(cam, world, [world[-1]], (0.7, 0.8, 1.0))


def empty(S, cam_mod):
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return S.Scene(cam, [], [], (0, 0, 0))


def port_scene(name):
    if name == "flagship":
        return compile_scene(tb.procedural_flagship(), device="cpu")
    if name in ("fog", "noise"):
        return torch_scene(name)
    if name in ("occupancy", "empty"):
        return compile_scene(globals()[name](TS, tcam), device="cpu")
    return compile_scene(tb.get_scene(name, 1.0), device="cpu")


def jax_scene(name, monkeypatch):
    from tests.torch_parity import SMALL_SCENES
    if name == "flagship":
        return jax_flagship(monkeypatch)
    if name in SMALL_SCENES:
        return jax_compile(SMALL_SCENES[name](JS, jcam), monkeypatch)
    if name in ("occupancy", "empty"):
        return jax_compile(globals()[name](JS, jcam), monkeypatch)
    return jax_compile(jb.get_scene(name, 1.0), monkeypatch)


def render(ts, compact, proc_chunk=None, w=W, h=H, spp=1, key=0):
    return render_waves(ts, w, h, rng.key(key, "cpu"), 0, spp, depth=DEPTH,
                        chunk_size=CHUNK, compact=compact,
                        proc_chunk=proc_chunk)


@pytest.mark.parametrize("name", ["cornell_box", "random", "flagship",
                                  "fog"])
def test_compact_equals_per_chunk_bitwise(name):
    """The compact render equals the per-chunk one bit for bit: on the
    trace kernel's scenes (Cornell box, random, the flagship) against
    its plain version, on the media scene against the split route's.
    And the compaction is real: live lanes fall bounce over bounce and
    a later bounce runs on fewer lanes than the wave holds."""
    ts = port_scene(name)
    got = render(ts, True, PROC)
    ref = render(ts, False)
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, ref), float((got - ref).abs().max())
    stats = []
    trace_wave_compact(ts, rng.wave_key(rng.key(0, "cpu"), 0), W, H, DEPTH,
                       CHUNK, proc_chunk=PROC, stats=stats)
    alive = [s["n_alive"] for s in stats]
    assert alive[0] == W * H and alive == sorted(alive, reverse=True)
    assert all(s["lanes"] % PROC == 0 and s["n_alive"] <= s["lanes"]
               < s["n_alive"] + PROC for s in stats)
    assert stats[-1]["lanes"] < W * H


@pytest.mark.parametrize("name", ["cornell_box", "noise", "fog"])
def test_compact_matches_jax_compact(name, monkeypatch):
    """The port's compact render against JAX's ``render_waves(...,
    compact=True)`` on the CPU (its XLA bounce): a solid scene, a marble
    ground, media; within the flip budget."""
    ts = port_scene(name)
    js = jax_scene(name, monkeypatch)
    ref = np.asarray(jint.render_waves(js, W, H, jax.random.PRNGKey(0), 0,
                                       1, depth=DEPTH, chunk_size=CHUNK,
                                       compact=True, proc_chunk=PROC))
    assert_flip_budget(render(ts, True, PROC).numpy(), ref)


def test_proc_chunk_invariance_and_its_check():
    """The processing chunk is a schedule only: 64, 96, 192 and the whole
    wave (576) give the same bits; one that does not divide the padded
    ray count raises ValueError, as in JAX."""
    ts = port_scene("occupancy")
    ref = render(ts, True)
    for pc in (64, 96, 576):
        assert torch.equal(render(ts, True, pc), ref), pc
    with pytest.raises(ValueError, match="proc_chunk 100"):
        render(ts, True, 100)


def test_ragged_last_chunk():
    """20x13 = 260 pixels in chunks of 192: the last chunk is ragged, its
    pad lanes ride along alive; bitwise the per-chunk render and the same
    bits twice."""
    ts = port_scene("occupancy")
    got = render(ts, True, 64, w=20, h=13)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, render(ts, False, w=20, h=13))
    assert torch.equal(got, render(ts, True, 64, w=20, h=13))


GRAD_LEAVES = ("tex_color", "sph_c0", "sph_r", "mat_fuzz", "background",
               "light_q")


def test_compact_gradients(monkeypatch):
    """Scene gradients of mean(image) through the compact render, 16x12,
    two chunks of 96 rays (``tests/test_compact.py``'s scene and leaves):
    two runs bit for bit; within rtol 5e-4 / atol 1e-6 of the per-chunk
    route's (the plain trace kernel's adjoint) and of ``jax.grad`` of
    JAX's compact render."""
    ts = port_scene("occupancy")
    params, static = partition(ts)

    def grads(compact):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        render_waves(combine(leaves, static), 16, 12, rng.key(11, "cpu"), 0,
                     1, depth=DEPTH, chunk_size=96, compact=compact,
                     proc_chunk=32).mean().backward()
        return {k: v.grad for k, v in leaves.items() if v.grad is not None}

    got, again, per_chunk = grads(True), grads(True), grads(False)
    assert got.keys() == again.keys()
    for k in got:
        assert torch.equal(got[k], again[k]), k

    js = jax_compile(occupancy(JS, jcam), monkeypatch)
    diff, jstatic = JS.partition(js)
    g_jax = jax.grad(lambda d: jnp.mean(jint.render_waves(
        JS.combine(d, jstatic), 16, 12, jax.random.PRNGKey(11), 0, 1,
        depth=DEPTH, chunk_size=96, compact=True)))(diff)
    nonzero = 0
    for k in GRAD_LEAVES:
        a = got[k].numpy()
        np.testing.assert_allclose(a, per_chunk[k].numpy(), rtol=5e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(a, np.asarray(getattr(g_jax, k)),
                                   rtol=5e-4, atol=1e-6, err_msg=k)
        nonzero += bool((a != 0).any())
    assert nonzero >= 4


class _OnCard:
    """A CPU scene that says it lies on a CUDA device: the card branch of
    ``auto_compact`` without a card."""

    device = torch.device("cuda")

    def __init__(self, scene):
        self._scene = scene

    def __getattr__(self, name):
        return getattr(self._scene, name)


class TestAutoCompact:
    @pytest.mark.parametrize("name", ["random", "cornell_box",
                                      "final_scene", "occupancy", "empty",
                                      "flagship"])
    def test_matches_jax(self, name, monkeypatch):
        """JAX's answer on the CPU, where its probe decides: on for the
        frame-filling scenes, off for the empty one and for the flagship
        (a small mesh in a void)."""
        want = jint.auto_compact(jax_scene(name, monkeypatch))
        assert auto_compact(port_scene(name)) is want
        assert want is (name not in ("empty", "flagship"))

    @pytest.mark.parametrize("flag", [None, "RRT_NO_UBER",
                                      "RRT_NO_MEGAKERNEL",
                                      "RRT_NO_PALLAS_SHADE",
                                      "RRT_UBER_NOISE"])
    def test_card_short_circuit(self, flag, monkeypatch):
        """On the card a scene the trace kernel takes gets False without
        the probe; a route flag that sends it off the trace kernel gives
        the probe back (``RRT_UBER_NOISE=0`` only to noise scenes), as
        JAX's ``test_uber_eligibility_short_circuits_on_tpu`` shows on its
        accelerator. final_scene (media) is probed either way."""
        if flag is not None:
            monkeypatch.setenv(flag, "0" if flag == "RRT_UBER_NOISE" else "1")
        all_off = flag not in (None, "RRT_UBER_NOISE")
        for name, probed in (("cornell_box", all_off),
                             ("random", flag is not None),
                             ("final_scene", True)):
            assert auto_compact(_OnCard(port_scene(name))) is probed, name


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


SMALL = ["20", "2", "--scene", "cornell_box", "-a", "1.0", "--device", "cpu",
         "--chunk-size", "128", "--depth", "3"]


def test_cli_compact_modes(tmp_path, capsys):
    """``--compact auto`` (the default) prints its decision (on: the
    Cornell box fills the frame, and on the CPU nothing short-circuits the
    probe); ``--compact`` alone is on; every mode writes the same PNG,
    the compact image being the per-chunk one."""
    pngs = {}
    for mode in ([], ["--compact"], ["--compact", "on"],
                 ["--compact", "off"]):
        out = tmp_path / f"{len(pngs)}.png"
        assert cli.main(SMALL + mode + ["-o", str(out)]) == 0
        printed = capsys.readouterr().out
        assert ("compact=auto -> on" in printed) is (mode == [])
        pngs[" ".join(mode)] = _png(out)
    ref = pngs.pop("--compact off")
    for mode, img in pngs.items():
        np.testing.assert_array_equal(img, ref, err_msg=mode)


def test_compact_checkpoint_resume_is_bitwise(tmp_path, capsys):
    """Under compact, 1 wave checkpointed then resumed to 3 equals the
    uninterrupted 3-wave render bit for bit, through
    ``render_with_checkpoints`` and through the CLI (a rerun a no-op)."""
    ts = port_scene("occupancy")
    path = str(tmp_path / "c.ckpt")
    render_with_checkpoints(ts, 16, 12, 1, 0, path, chunk_size=64, depth=2,
                            compact=True)
    assert load_state(path).waves_done == 1
    got = render_with_checkpoints(ts, 16, 12, 3, 0, path, ckpt_every=1,
                                  chunk_size=64, depth=2, compact=True)
    ref = render_waves(ts, 16, 12, rng.key(0, "cpu"), 0, 3, depth=2,
                       chunk_size=64, compact=True) / 3
    assert torch.equal(got, ref)

    ckpt = str(tmp_path / "cli.ckpt")
    one = tmp_path / "one.png"
    assert cli.main(["20", "1"] + SMALL[2:] + ["--compact", "-o", str(one),
                                               "--checkpoint", ckpt]) == 0
    capsys.readouterr()
    out, ref_png = tmp_path / "out.png", tmp_path / "ref.png"
    assert cli.main(SMALL + ["--compact", "-o", str(out), "--checkpoint",
                             ckpt, "--ckpt-every", "1"]) == 0
    assert "wave 2/2" in capsys.readouterr().out
    assert cli.main(SMALL + ["--compact", "-o", str(ref_png)]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(_png(out), _png(ref_png))
    stamp = os.stat(ckpt).st_mtime_ns
    assert cli.main(SMALL + ["--compact", "-o", str(out), "--checkpoint",
                             ckpt]) == 0
    assert "wave" not in capsys.readouterr().out
    assert os.stat(ckpt).st_mtime_ns == stamp


def test_cli_cache_dir_reaches_kernels(tmp_path, monkeypatch):
    """``--cache-dir`` sets the directory the kernel libraries are built
    in and loaded from (``kernels.set_build_dir``); without it the
    default stays ``build/torch_kernels/``."""
    default = kernels.BUILD_DIR
    assert default.parts[-2:] == ("build", "torch_kernels")
    monkeypatch.setattr(kernels, "BUILD_DIR", default)
    assert cli.main(["8", "1", "--scene", "cornell_box", "-a", "1.0",
                     "--device", "cpu", "--cache-dir", str(tmp_path / "k"),
                     "-o", str(tmp_path / "x.png")]) == 0
    assert kernels.BUILD_DIR == (tmp_path / "k").resolve()
    assert kernels._library("split").parent == (tmp_path / "k").resolve()
