"""JAX's side of the port's parity gate, saved for the card.

    python -m tests.torch_gate_ref            # writes the reference file
    python -m tests.torch_gate_ref --drift    # the port's CPU drift from JAX

The machine with the card has no JAX, so the gate
(``rust_ray_tracer_tpu_torch/tools/verify_gpu_parity.py``) reads JAX's
numbers from ``gpu_parity_ref.npz`` beside it. This module makes that file
on the CPU (numpy arrays only, compressed):

  * ``<scene>/fingerprint``: :func:`verify_gpu_parity.fingerprint` of the
    JAX package's compiled scene (``torch_parity.scene_dict``), which must
    equal the port's;
  * ``<scene>/<kind>/shape`` and ``<scene>/<kind>/image`` for every
    ``jax`` and ``d2_jax`` row: JAX's ``render_waves`` at the row's
    (width, height, spp, depth), key 0, chunk 9216, divided by spp;
  * ``<scene>/grad_jax/leaf/<leaf>``: ``jax.grad`` of the mean of that
    image over every float leaf.

JAX runs its XLA route on the CPU, the function the port's CPU tests hold
its plain versions against, with the builders' texture cache pinned
(``torch_parity.pin_jax_texture_cache``). ``--drift`` renders each ``jax``
and ``d2_jax`` row, and the gradient rows, in both packages on the CPU at
seeds 0-2 and prints the gate's metrics of the port against JAX, one JSON
line a row: the port-vs-JAX part of those rows' budgets.

Imports JAX; the port never imports this module.
"""

from __future__ import annotations

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rust_ray_tracer_tpu.models import builders as jb  # noqa: E402
from rust_ray_tracer_tpu.models import scene as JS  # noqa: E402
from rust_ray_tracer_tpu.models.gltf import load_gltf_scene as jgltf  # noqa
from rust_ray_tracer_tpu.models.scene import combine as jcombine  # noqa
from rust_ray_tracer_tpu.models.scene import partition as jpartition  # noqa
from rust_ray_tracer_tpu.ops import camera as jcam  # noqa: E402
from rust_ray_tracer_tpu.ops.integrator import render_waves  # noqa: E402
from rust_ray_tracer_tpu_torch.models.scene import compile_scene  # noqa
from rust_ray_tracer_tpu_torch.tools import verify_gpu_parity as gate  # noqa

from tests import torch_parity as tp  # noqa: E402

JAX_KINDS = ("jax", "d2_jax", "grad_jax")


def jax_scene(name: str, monkeypatch):
    """The JAX package's compiled scene of a gate scene (inside
    ``gate.assets()``' directory)."""
    aspect = gate.FULL[0] / gate.FULL[1]
    if name in ("flagship", "tiny"):
        return tp.jax_flagship(monkeypatch)
    if name in ("random", "final_scene"):
        host = jb.get_scene(name, aspect)
    elif name == "random_earth":
        host = tp.random_earth_view(JS, jb, aspect)
    elif name == "mesh":
        host = tp.mesh(JS, jcam)
    elif name == "gltf9":
        host = jgltf("f9.gltf", aspect)
    else:
        raise ValueError(name)
    return tp.jax_compile(host, monkeypatch)


def jax_image(js, shape, seed: int = 0) -> np.ndarray:
    """JAX's mean image at ``shape`` (width, height, spp, depth)."""
    w, h, spp, depth = shape
    f = jax.jit(lambda s, k: render_waves(s, w, h, k, 0, spp, depth=depth,
                                          chunk_size=gate.CHUNK) / spp)
    return np.asarray(f(js, jax.random.PRNGKey(seed)))


def jax_grads(js, shape, seed: int = 0) -> dict:
    """{leaf: numpy} ``jax.grad`` of the mean image over every float
    leaf, named as the port's ``partition``."""
    w, h, spp, depth = shape
    diff, static = jpartition(js)

    def loss(d):
        return (render_waves(jcombine(d, static), w, h,
                             jax.random.PRNGKey(seed), 0, spp, depth=depth,
                             chunk_size=gate.CHUNK) / spp).mean()

    g = jax.jit(jax.grad(loss))(diff)
    out = {k: np.asarray(getattr(g, k)) for k in g._fields
           if k != "camera" and getattr(g, k) is not None}
    out.update({f"camera.{k}": np.asarray(v)
                for k, v in g.camera._asdict().items() if v is not None})
    return out


def port_scene(name: str):
    return compile_scene(gate.host_scene(name), device="cpu")


def write(path=gate.REF_PATH) -> dict:
    """Make the reference file; returns its arrays."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, gate.assets():
        for name, rows in gate.SCENES.items():
            t0 = time.perf_counter()
            js = jax_scene(name, mp)
            fp = gate.fingerprint(tp.scene_dict(js))
            if fp != gate.fingerprint(gate.scene_arrays(port_scene(name))):
                raise AssertionError(f"{name}: the two packages compile "
                                     "different scenes")
            out[f"{name}/fingerprint"] = np.array(fp)
            for kind, shape in rows.items():
                if kind not in JAX_KINDS:
                    continue
                out[f"{name}/{kind}/shape"] = np.array(shape, np.int32)
                if kind == "grad_jax":
                    for leaf, g in jax_grads(js, shape).items():
                        out[f"{name}/{kind}/leaf/{leaf}"] = g
                else:
                    out[f"{name}/{kind}/image"] = jax_image(js, shape)
            print(json.dumps({"scene": name, "fingerprint": fp,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    np.savez_compressed(path, **out)
    return out


def drift(seeds=(0, 1, 2)) -> None:
    """The gate's metrics of the port's CPU render (or gradients) against
    JAX's, for every JAX row at each seed."""
    with pytest.MonkeyPatch.context() as mp, gate.assets():
        for name, rows in gate.SCENES.items():
            js, ts = jax_scene(name, mp), port_scene(name)
            for kind, shape in rows.items():
                if kind not in JAX_KINDS:
                    continue
                for seed in seeds:
                    t0 = time.perf_counter()
                    if kind == "grad_jax":
                        m = gate.grad_metrics(gate.gradients(ts, shape, seed),
                                              jax_grads(js, shape, seed))
                    else:
                        m = gate.image_metrics(gate.render(ts, shape, seed),
                                               jax_image(js, shape, seed))
                    print(json.dumps({"scene": name, "row": kind,
                                      "seed": seed, **m,
                                      "seconds": time.perf_counter() - t0}),
                          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--drift", action="store_true")
    args = ap.parse_args(argv)
    if args.drift:
        drift()
    else:
        write()
        size = gate.REF_PATH.stat().st_size
        print(json.dumps({"written": str(gate.REF_PATH), "bytes": size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
