"""The port's sharded renderer, its process group and render checkpoints
(``rust_ray_tracer_tpu_torch/parallel``) on the CPU.

Two gloo processes (``python -m rust_ray_tracer_tpu_torch.parallel.dryrun``,
the counterpart of ``__graft_entry__.dryrun_multichip``; subprocesses as
``tests/test_multihost.py`` runs them) render the Cornell box sharded and
take one training step; their image must equal the one-process per-chunk
render bitwise, their gradients must be equal on both ranks and within
float32 summation order of the one-process gradients (not twice them).
Then checkpoints: the ``.npz`` layout of the JAX package, a bitwise
resume, settings checked; and the mesh's validation.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.parallel import (RenderState, dryrun,
                                                load_state, make_mesh,
                                                multihost_init,
                                                render_waves_sharded,
                                                render_with_checkpoints,
                                                save_state)
from rust_ray_tracer_tpu_torch.utils import rng
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dry run's shape: 4 chunks of 256 rays, two on each of two ranks
DRY = dict(scene_name="cornell_box", width=32, height=32, spp=2, depth=4,
           chunk_size=256)


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _two_ranks(args, timeout=120):
    """Run ``args`` (a command taking --coordinator / --num-processes /
    --process-id) as two local processes with one torch thread each;
    raises with their output if either fails."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, *args, "--coordinator", addr, "--num-processes",
         "2", "--process-id", str(r)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rank.pt"
    _two_ranks(["-m", "rust_ray_tracer_tpu_torch.parallel.dryrun",
                "--device", "cpu", "--scene", DRY["scene_name"],
                "--width", str(DRY["width"]), "--height",
                str(DRY["height"]), "--spp", str(DRY["spp"]),
                "--chunk-size", str(DRY["chunk_size"]), "--also-compact",
                "--out", str(out)])
    ranks = [torch.load(out.with_name(f"rank.{r}.pt")) for r in (0, 1)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = dryrun.run(make_mesh(device="cpu"), **DRY)
        one["compact"] = dryrun.run(make_mesh(device="cpu"), **DRY,
                                    compact=True)
    finally:
        torch.set_num_threads(threads)
    return ranks, one


def test_two_ranks_image_equals_one_process_bitwise(two_rank_run):
    """Each rank holds the whole image, equal bit for bit to the
    one-process per-chunk render and to the whole-wave render_waves."""
    (r0, r1), one = two_rank_run
    assert r0["size"] == r1["size"] == 2 and (r0["rank"], r1["rank"]) == (0,
                                                                         1)
    np.testing.assert_array_equal(r0["image"].numpy(), one["image"].numpy())
    np.testing.assert_array_equal(r1["image"].numpy(), one["image"].numpy())
    scene = compile_scene(builders.cornell_box(1.0), device="cpu")
    ref = render_waves(scene, DRY["width"], DRY["height"], rng.key(0, "cpu"),
                       0, DRY["spp"], chunk_size=DRY["chunk_size"])
    np.testing.assert_array_equal(one["image"].numpy(), ref.numpy())


def test_two_ranks_gradients_summed_not_scaled(two_rank_run):
    """The all-reduced gradients are the same bits on both ranks, and each
    leaf within rtol 1e-5 of its largest entry / atol 1e-7 of the
    one-process gradient (each rank's chunks' sums, then the sum of the two:
    another float32 order); twice the one-process gradient would fail."""
    (r0, r1), one = two_rank_run
    assert r0["grads"].keys() == r1["grads"].keys() == one["grads"].keys()
    nonzero = 0
    for k, ref in one["grads"].items():
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
        got = r0["grads"][k].numpy()
        ref = ref.numpy()
        scale = np.abs(ref).max(initial=0.0)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-7 + 1e-5 * scale, err_msg=k)
        nonzero += bool(scale > 0)
    assert nonzero >= 3
    assert r0["loss"] == r1["loss"] == one["loss"]


def test_two_ranks_sgd_step(two_rank_run):
    """One SGD step on the all-reduced gradients (as dryrun_multichip
    takes one): a finite loss, equal on both ranks and to the
    one-process step's."""
    (r0, r1), one = two_rank_run
    assert bool(torch.isfinite(r0["loss_after_step"]))
    assert r0["loss_after_step"] == r1["loss_after_step"]
    np.testing.assert_allclose(float(r0["loss_after_step"]),
                               float(one["loss_after_step"]), rtol=1e-5)
    assert float(r0["loss_after_step"]) != float(r0["loss"])


def test_two_ranks_compact_image_equals_one_process_bitwise(two_rank_run):
    """The dry run through the compact wavefront (``--also-compact``, in the
    same two processes): each rank compacts its own chunks only, and its
    whole image equals the one-process compact render bit for bit, which
    equals the per-chunk image."""
    (r0, r1), one = two_rank_run
    for r in (r0, r1):
        np.testing.assert_array_equal(r["compact"]["image"].numpy(),
                                      one["compact"]["image"].numpy())
    np.testing.assert_array_equal(one["compact"]["image"].numpy(),
                                  one["image"].numpy())


def test_two_ranks_compact_gradients_and_step(two_rank_run):
    """The compact training step's all-reduced gradients: the same bits on
    both ranks, each leaf within float32 summation order of the
    one-process compact step's (rtol 1e-5 of its largest entry / atol
    1e-7, as the per-chunk step's), and a finite SGD step equal on both
    ranks."""
    (r0, r1), one = two_rank_run
    c0, c1, ref = r0["compact"], r1["compact"], one["compact"]
    assert c0["grads"].keys() == c1["grads"].keys() == ref["grads"].keys()
    nonzero = 0
    for k, g in ref["grads"].items():
        assert torch.equal(c0["grads"][k], c1["grads"][k]), k
        scale = np.abs(g.numpy()).max(initial=0.0)
        np.testing.assert_allclose(c0["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-7 + 1e-5 * scale,
                                   err_msg=k)
        nonzero += bool(scale > 0)
    assert nonzero >= 3
    assert c0["loss"] == c1["loss"] == ref["loss"]
    assert c0["loss_after_step"] == c1["loss_after_step"]
    assert bool(torch.isfinite(c0["loss_after_step"]))


def _cornell():
    return compile_scene(builders.cornell_box(1.0), device="cpu")


def test_checkpoint_round_trip_and_jax_layout(tmp_path):
    """save_state / load_state keep every field bitwise, in the JAX
    package's layout: a checkpoint either package writes loads in the
    other."""
    from rust_ray_tracer_tpu.parallel import checkpoint as jckpt

    acc = np.random.default_rng(0).normal(size=(6, 8, 3)).astype(np.float32)
    st = RenderState(acc=acc, waves_done=3, seed=5, width=8, height=6,
                     chunk_size=64, depth=2)
    save_state(str(tmp_path / "a.ckpt"), st)
    back = load_state(str(tmp_path / "a.ckpt"))
    np.testing.assert_array_equal(back.acc, acc)
    assert (back.waves_done, back.seed, back.width, back.height,
            back.chunk_size, back.depth) == (3, 5, 8, 6, 64, 2)
    j = jckpt.load_state(str(tmp_path / "a.ckpt"))
    np.testing.assert_array_equal(j.acc, acc)
    jckpt.save_state(str(tmp_path / "j.ckpt"), j)
    np.testing.assert_array_equal(load_state(str(tmp_path / "j.ckpt")).acc,
                                  acc)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("sharded", [False, True])
def test_checkpoint_resume_is_bitwise(tmp_path, sharded):
    """A render stopped after its first segment and resumed equals the
    uninterrupted render bit for bit (render_waves, or the per-chunk
    renderer on a one-process mesh); a finished checkpoint makes the next
    call a no-op restart."""
    scene = _cornell()
    mesh = make_mesh(device="cpu") if sharded else None
    path = str(tmp_path / "r.ckpt")
    kw = dict(ckpt_every=1, depth=3, chunk_size=128, mesh=mesh)

    def stop(done, total):
        raise _Stop

    with pytest.raises(_Stop):
        render_with_checkpoints(scene, 16, 12, 3, 4, path, progress=stop,
                                **kw)
    assert load_state(path).waves_done == 1
    seen = []
    img = render_with_checkpoints(scene, 16, 12, 3, 4, path,
                                  progress=lambda d, t: seen.append(d), **kw)
    assert seen == [2, 3]
    if sharded:
        ref = render_waves_sharded(scene, 16, 12, rng.key(4, "cpu"), 0, 3,
                                   mesh, 3, 128) / 3
    else:
        ref = render_waves(scene, 16, 12, rng.key(4, "cpu"), 0, 3, 3,
                           128) / 3
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    again = render_with_checkpoints(scene, 16, 12, 3, 4, path,
                                    progress=lambda d, t: seen.append(d),
                                    **kw)
    assert seen == [2, 3]
    np.testing.assert_array_equal(again.numpy(), img.numpy())


def test_checkpoint_with_other_settings_is_rejected(tmp_path):
    scene = _cornell()
    path = str(tmp_path / "r.ckpt")
    render_with_checkpoints(scene, 8, 8, 1, 0, path, chunk_size=64, depth=2)
    for kw in (dict(seed=1), dict(width=16), dict(chunk_size=128),
               dict(depth=3)):
        args = dict(seed=0, width=8, chunk_size=64, depth=2)
        args.update(kw)
        with pytest.raises(ValueError, match="different settings"):
            render_with_checkpoints(scene, args["width"], 8, 1,
                                    args["seed"], path,
                                    chunk_size=args["chunk_size"],
                                    depth=args["depth"])


def test_make_mesh_and_multihost_init_validation():
    """Without a process group the mesh is one rank on the asked device;
    more devices than the world, or fewer, raise ValueError; a single
    process with no coordinator is a no-op; more than one needs a
    coordinator; a process id outside the world raises."""
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")
    assert make_mesh(n_devices=1, device="cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(n_devices=2, device="cpu")
    multihost_init(device="cpu")
    multihost_init(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        multihost_init(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        multihost_init("127.0.0.1:1", 2, 2, device="cpu")
