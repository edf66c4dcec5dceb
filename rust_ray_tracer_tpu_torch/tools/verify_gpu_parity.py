"""The port's parity gate: a scene matrix of whole renders on the card held
against the CPU twins and the JAX package's saved renders.

    python -m rust_ray_tracer_tpu_torch.tools.verify_gpu_parity [scene ...]
        [--device cuda|cpu] [--seed N] [--inject] [--twin-cache DIR]

Counterpart of the JAX package's ``tools/verify_pallas_parity.py``: for
every scene of :data:`SCENES` it renders the same frame through each route
the scene exercises and prints one JSON line a (scene, row), then
``{"gate": "gpu_parity_matrix", "ok": ...}``; it exits 1 when any row is
red. An exception prints a red line; it never turns into a green exit.
Rows (``kind``):

  * ``twin``: the card's render against the same call with
    ``device="cpu"`` (the kernels' plain versions, the same keys and
    (seed, chunk_size));
  * ``jax``: the card's render against the JAX package's
    ``render_waves`` of the same scene, key 0, saved in
    :data:`REF_PATH` by ``python -m tests.torch_gate_ref`` (JAX is not
    imported here; a scene whose :func:`fingerprint` differs from the
    saved one is red as "scene differs");
  * ``d2_twin``, ``d2_jax``: the same at depth 2, one scatter and then the
    next hit's emission or the background, where a fork cannot chain;
  * ``compact``: ``render_waves(..., compact=True)`` against the scene's
    own route on the card; ``sharded``: ``render_waves_sharded`` on a
    one-process mesh (the per-chunk path, kernel D) against the own route;
    ``unfused``: the per-chunk route with ``RRT_UBER_WAVE=0`` (D) against
    it with ``RRT_NO_UBER_FUSED=1`` too (E, G);
  * ``grad_twin``, ``grad_jax``: the gradients of ``mean(render)`` over
    every float leaf, held leaf by leaf by their relative L2.

An image row reports ``bitwise``, ``maxabs``, ``flip_rate`` (the share of
pixels whose channel-summed difference exceeds :data:`FLIP_EPS`, the JAX
gate's) and ``rel_mean``; its budget (:data:`BUDGETS`) is either bitwise
or a ceiling on ``flip_rate``, ``rel_mean`` and ``maxabs``. Images are
the mean over the samples, as the JAX gate's.

``--inject`` renders the card side of every ``twin``, ``jax``, ``d2_*``
and ``grad_*`` row from a perturbed scene (:func:`perturb`: every albedo
leaf scaled by 1 + 1e-3, the dielectrics' IOR raised by 1e-3); the rows
with ``must_fail`` true (every card-vs-CPU row and every depth-2 row)
must then be red, which ``chip_smoke.py``'s ``parity_gate`` phase checks.
``--twin-cache DIR`` keeps the CPU twins' renders in DIR and reuses them
(a second run of the same tree, as the injected run after the plain one).
``--seed`` renders with another key; the ``jax`` rows exist for seed 0
only. ``--device cpu`` runs the card's side on the CPU too (the Tier-1
test of the ``tiny`` scene).

The procedural scenes (the mesh, random with the earth map in view, the
9-light glTF flagship) come from the checkout's ``tests/torch_parity.py``,
which imports JAX only inside its JAX builders.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import (MAT_DIELECTRIC, MAT_LIGHT,
                                                    TEX_CHECKER, combine,
                                                    compile_scene, partition)
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.parallel import (make_mesh,
                                                render_waves_sharded)
from rust_ray_tracer_tpu_torch.utils import rng
from rust_ray_tracer_tpu_torch.utils.device import resolve

# (width, height, spp, depth): the JAX gate's shape at half its width
FULL = (128, 72, 4, 4)
DEPTH2 = (128, 72, 4, 2)
SMALL = (64, 36, 1, 2)      # the mesh's oracle slice and the gradient rows
TINY = (32, 18, 1, 2)       # the Tier-1 row
CHUNK = 9216
FLIP_EPS = 1e-3             # verify_pallas_parity.py:53
BIAS_KEEP = 0.95            # pixels a row's bias averages over
GRAD_FLOOR = 1e-6           # leaves a gradient row holds, of the largest
INJECT = 1e-3
EARTH_MAP = (1024, 512)
REF_PATH = Path(__file__).with_name("gpu_parity_ref.npz")
ROOT = Path(__file__).resolve().parents[2]

# the kinds whose card side --inject perturbs
INJECTED = ("twin", "jax", "d2_twin", "d2_jax", "grad_twin", "grad_jax")
BIT = {"bitwise": True}

# scene -> {row kind: (width, height, spp, depth)}
SCENES = {
    "flagship": {"twin": FULL, "jax": FULL, "compact": FULL,
                 "sharded": FULL, "unfused": FULL, "grad_twin": SMALL,
                 "grad_jax": SMALL},
    "random": {"twin": FULL, "jax": FULL, "d2_twin": DEPTH2,
               "d2_jax": DEPTH2, "compact": FULL},
    "final_scene": {"twin": FULL, "jax": FULL, "d2_twin": DEPTH2,
                    "d2_jax": DEPTH2, "compact": FULL, "grad_twin": SMALL,
                    "grad_jax": SMALL},
    "random_earth": {"twin": FULL, "jax": FULL, "compact": FULL},
    "mesh": {"twin": SMALL, "jax": SMALL},
    "gltf9": {"twin": FULL, "jax": FULL},
    "tiny": {"twin": TINY, "jax": TINY},
}

# (scene, kind) -> budget: twice the worst value measured over seeds 0-2
# (PERF.md, "The parity gate": the card against the CPU twin on an NVIDIA
# H100 80GB HBM3 at 700 W; a JAX row's budget is twice the sum of the
# port's CPU drift from JAX, ``python -m tests.torch_gate_ref --drift``,
# and its card-vs-CPU row, or twice the card's own distance from JAX at
# seed 0 where that is larger). A value measured 0 gets a floor: one
# pixel for a flip rate, 1e-9 for a bias. The rows PERF.md records as
# bitwise are held bitwise.
PX = 1 / (FULL[0] * FULL[1])                 # one pixel of a FULL image
BUDGETS = {
    ("flagship", "twin"): {"flip_rate": PX, "rel_mean": 1.3e-7,
                           "bias": 1e-9, "maxabs": 4e-5},
    ("flagship", "jax"): {"flip_rate": 2.2e-4, "rel_mean": 1.4e-4,
                          "bias": 3e-9},
    ("flagship", "compact"): BIT,
    ("flagship", "sharded"): BIT,
    ("flagship", "unfused"): BIT,
    ("flagship", "grad_twin"): {"rel_l2": 2.6e-5},
    ("flagship", "grad_jax"): {"rel_l2": 5.2e-5},
    ("random", "twin"): {"flip_rate": 5.5e-3, "rel_mean": 1e-4,
                         "bias": 5e-9},
    ("random", "jax"): {"flip_rate": 0.15, "rel_mean": 1.3e-3,
                        "bias": 3e-5},
    ("random", "d2_twin"): {"flip_rate": 6.6e-4, "rel_mean": 1.6e-4,
                            "bias": 3.6e-9},
    ("random", "d2_jax"): {"flip_rate": 0.046, "rel_mean": 4.8e-3,
                           "bias": 4.7e-7},
    ("random", "compact"): BIT,
    ("final_scene", "twin"): {"flip_rate": 2 * PX, "rel_mean": 2.9e-3,
                              "bias": 1e-9},
    ("final_scene", "jax"): {"flip_rate": 0.01, "rel_mean": 1.9e-2,
                             "bias": 1e-9},
    ("final_scene", "d2_twin"): {"flip_rate": PX, "rel_mean": 1e-9,
                                 "bias": 1e-9, "maxabs": 1.5e-6},
    ("final_scene", "d2_jax"): {"flip_rate": 4.2e-3, "rel_mean": 6.5e-3,
                                "bias": 1e-9},
    ("final_scene", "compact"): BIT,
    ("final_scene", "grad_twin"): {"rel_l2": 5.7e-7},
    ("final_scene", "grad_jax"): {"rel_l2": 4.0},
    ("random_earth", "twin"): {"flip_rate": 7e-3, "rel_mean": 6e-5,
                               "bias": 6.3e-9},
    ("random_earth", "jax"): {"flip_rate": 0.16, "rel_mean": 1.3e-3,
                              "bias": 7.4e-5},
    ("random_earth", "compact"): BIT,
    ("mesh", "twin"): {"flip_rate": 4 * PX, "rel_mean": 2.2e-9,
                       "bias": 1e-9, "maxabs": 1.2e-7},
    ("mesh", "jax"): {"flip_rate": 4 * PX, "rel_mean": 2.7e-8,
                      "bias": 1.3e-8, "maxabs": 1.2e-6},
    ("gltf9", "twin"): {"flip_rate": PX, "rel_mean": 1.9e-8, "bias": 1e-9,
                        "maxabs": 1.1e-4},
    ("gltf9", "jax"): {"flip_rate": PX, "rel_mean": 4.1e-8, "bias": 1e-9,
                       "maxabs": 2.2e-4},
    ("tiny", "twin"): {"flip_rate": 16 * PX, "rel_mean": 1.7e-9,
                       "bias": 1e-9, "maxabs": 6e-8},
    ("tiny", "jax"): {"flip_rate": 16 * PX, "rel_mean": 3.6e-8,
                      "bias": 2.4e-8, "maxabs": 7.5e-7},
}


# rows --inject cannot turn red (PERF.md, "The parity gate"): paths that
# fork between the packages at 1 spp move final_scene's held gradient
# leaves (background, tex_color, img_data) by more than the injection does
INJECT_BLIND = {("final_scene", "grad_jax")}


def must_fail(name: str, kind: str, shape) -> bool:
    """Whether ``--inject`` must turn a row red: every card-vs-CPU row and
    every row at depth 2, but :data:`INJECT_BLIND`'s."""
    return (kind in ("twin", "d2_twin", "grad_twin") or (
        kind in INJECTED and shape[3] == 2)) and (name, kind) \
        not in INJECT_BLIND


def _parity():
    """The checkout's ``tests/torch_parity.py`` (no JAX at import)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_parity
    return torch_parity


@contextlib.contextmanager
def assets():
    """A temporary working directory holding the procedural earth map
    (``./earthmap.jpg``, :data:`EARTH_MAP`) and the 9-light glTF flagship
    (``f9.gltf``); yields the directory."""
    tp = _parity()
    prev = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tp.write_earth_map(tmp, *EARTH_MAP)
        tp.write_gltf_flagship(os.path.join(tmp, "f9.gltf"), 9)
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(prev)


def host_scene(name: str):
    """The port's host Scene of a matrix scene, at 16:9 (inside
    :func:`assets`' directory)."""
    aspect = FULL[0] / FULL[1]
    tp = _parity()
    if name in ("flagship", "tiny"):
        return builders.procedural_flagship()
    if name in ("random", "final_scene"):
        return builders.get_scene(name, aspect)
    if name == "random_earth":
        return tp.random_earth_view(S, builders, aspect)
    if name == "mesh":
        return tp.mesh(S, cam_ops)
    if name == "gltf9":
        return load_gltf_scene("f9.gltf", aspect)
    raise ValueError(f"unknown scene {name!r}; one of {sorted(SCENES)}")


def fingerprint(arrays: dict) -> str:
    """sha256 over a compiled scene's arrays ``{field: array}`` (the JAX
    ``SceneData`` field names, the camera's as ``camera.<name>``) in sorted
    order: each name, dtype, shape and bytes. The camera's floats are
    hashed in steps of 1e-4 of their largest magnitude: ``look_at_rh`` in
    torch and in jnp differ by an ulp (``tests/test_torch_scene.py``), and
    its zeros come out as +-2e-7 in either."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        if k.startswith("camera.") and a.dtype.kind == "f":
            step = max(float(np.abs(a).max()), 1e-30) * 1e-4
            a = np.round(a.astype(np.float64) / step).astype(np.int64)
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def scene_arrays(scene) -> dict:
    """{field: numpy} of a port SceneData, named as :func:`fingerprint`
    expects."""
    params, static = partition(scene)
    return {k: v.detach().cpu().numpy() for k, v in {**params,
                                                       **static}.items()}


def perturb(scene, eps: float = INJECT):
    """``scene`` with every albedo leaf scaled by ``1 + eps`` — the texture
    rows its non-emitting materials reach (through a checker's leaves
    too) and the image atlas — and each dielectric's IOR raised by
    ``eps``: inputs of the kernels' shade math. Emission rows stay."""
    kind = scene.mat_kind.long()
    tex = scene.mat_tex.long()

    def reach(mats):
        rows = set(tex[mats].tolist())
        if scene.tex_even.shape[0]:
            for r in list(rows):
                if int(scene.tex_kind[r]) == TEX_CHECKER:
                    rows |= {int(scene.tex_even[r]), int(scene.tex_odd[r])}
        return rows

    albedo = reach(kind != MAT_LIGHT) - reach(kind == MAT_LIGHT)
    scale = torch.ones_like(scene.tex_color[:, :1])
    scale[sorted(albedo)] = 1.0 + eps
    params, static = partition(scene)
    params = dict(params)
    params["tex_color"] = scene.tex_color * scale
    params["img_data"] = scene.img_data * (1.0 + eps)
    params["mat_ior"] = torch.where(kind == MAT_DIELECTRIC,
                                    scene.mat_ior + eps, scene.mat_ior)
    return combine(params, static)


def render(scene, shape, seed: int, compact: bool = False, env=None):
    """The mean image [H, W, 3] (numpy) of ``render_waves`` at ``shape``
    with key ``seed``, under the environment overrides ``env``."""
    w, h, spp, depth = shape
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with torch.no_grad():
            img = render_waves(scene, w, h, rng.key(seed, scene.device), 0,
                               spp, depth=depth, chunk_size=CHUNK,
                               compact=compact)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return (img / spp).cpu().numpy()


def render_sharded(scene, shape, seed: int):
    """:func:`render` through ``render_waves_sharded`` on a one-process
    mesh (the per-chunk path)."""
    w, h, spp, depth = shape
    with torch.no_grad():
        img = render_waves_sharded(scene, w, h, rng.key(seed, scene.device),
                                   0, spp, make_mesh(device=scene.device),
                                   depth=depth, chunk_size=CHUNK)
    return (img / spp).cpu().numpy()


def gradients(scene, shape, seed: int) -> dict:
    """{leaf: numpy} gradients of ``mean(render)`` over every float leaf
    (zeros where a leaf takes none)."""
    w, h, spp, depth = shape
    params, static = partition(scene)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    img = render_waves(combine(leaves, static), w, h,
                       rng.key(seed, scene.device), 0, spp, depth=depth,
                       chunk_size=CHUNK)
    (img / spp).mean().backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            .cpu().numpy() for k, v in leaves.items()}


def image_metrics(got, ref) -> dict:
    """The metrics of an image row. ``bias`` is the mean of the pixels'
    channel-summed differences over the :data:`BIAS_KEEP` of the pixels
    with the smallest |difference|, over the reference's mean: a shade
    error shifts every lit pixel one way, while a forked path moves a few
    pixels far either way and is left out."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    got64, ref64 = got.astype(np.float64), ref.astype(np.float64)
    diff = np.abs(got64 - ref64)
    dsum = (got64.sum(-1) - ref64.sum(-1)).ravel()
    keep = np.argsort(np.abs(dsum), kind="stable")[:int(dsum.size
                                                        * BIAS_KEEP)]
    ref_mean = max(abs(ref.mean(dtype=np.float64)), 1e-12)
    return {"finite": bool(np.isfinite(got).all()),
            "bitwise": bool(got.shape == ref.shape
                            and np.array_equal(got, ref)),
            "maxabs": float(diff.max()),
            "flip_rate": float((diff.sum(-1) > FLIP_EPS).mean()),
            "rel_mean": float(abs(got.mean(dtype=np.float64)
                                  - ref.mean(dtype=np.float64)) / ref_mean),
            "bias": float(dsum[keep].mean() / (3.0 * ref_mean)),
            "mean": float(got.mean(dtype=np.float64))}


def grad_metrics(got: dict, ref: dict) -> dict:
    """Relative L2 of each leaf's gradient (0 where both are zero). The
    worst is taken over the leaves whose reference gradient has at least
    :data:`GRAD_FLOOR` of the largest leaf's norm; below it a gradient is
    the rounding of cancelling terms (final_scene's sphere and camera
    leaves at ~1e-10 beside ~0.3) and is reported, not held."""
    rel, norm = {}, {}
    for k in sorted(ref):
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        num, norm[k] = np.linalg.norm(g - r), np.linalg.norm(r)
        rel[k] = float(num / norm[k]) if norm[k] > 0 else (
            0.0 if num == 0 else float("inf"))
    top = max(norm.values())
    held = [k for k in rel if norm[k] >= GRAD_FLOOR * top and top > 0]
    worst = max(held or rel, key=rel.get)
    return {"finite": all(np.isfinite(got[k]).all() for k in got),
            "bitwise": all(np.array_equal(got[k], ref[k]) for k in ref),
            "rel_l2": rel, "held": held, "worst_leaf": worst,
            "worst_rel_l2": rel[worst]}


def within(m: dict, budget: dict) -> bool:
    """Whether the metrics ``m`` of a row meet ``budget`` (``bias`` by its
    magnitude)."""
    if not m["finite"]:
        return False
    if budget.get("bitwise"):
        return m["bitwise"]
    return all(abs(m[k] if k != "rel_l2" else m["worst_rel_l2"]) <= v
               for k, v in budget.items())


class Gate:
    """One run of the matrix on ``device``: the CPU twins (cached in
    ``twin_cache`` when given) and JAX's saved renders as references."""

    def __init__(self, device, seed: int, inject: bool, twin_cache=None):
        self.dev = resolve(device)
        self.seed = seed
        self.inject = inject
        self.twin_cache = Path(twin_cache) if twin_cache else None
        self.ref = dict(np.load(REF_PATH)) if REF_PATH.exists() else None

    def _twin(self, scene_cpu, name, kind, shape):
        """The CPU twin of a row (the images of ``twin`` and ``d2_twin``,
        the gradients of ``grad_twin``)."""
        path = (self.twin_cache / f"{name}_{kind}_{self.seed}.npz"
                if self.twin_cache else None)
        if path is not None and path.exists():
            return dict(np.load(path))
        if kind == "grad_twin":
            out = gradients(scene_cpu, shape, self.seed)
        else:
            out = {"image": render(scene_cpu, shape, self.seed)}
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, **out)
        return out

    def _jax(self, name, kind, shape, arrays):
        """JAX's saved render (or gradients) of a row."""
        if self.ref is None:
            raise FileNotFoundError(f"{REF_PATH} is missing: make it with "
                                    "python -m tests.torch_gate_ref")
        if str(self.ref[f"{name}/fingerprint"]) != fingerprint(arrays):
            raise AssertionError("scene differs from the one JAX's render "
                                 "was saved for")
        saved = tuple(self.ref[f"{name}/{kind}/shape"].tolist())
        if saved != tuple(shape):
            raise AssertionError(f"JAX's render was saved at {saved}")
        prefix = f"{name}/{kind}/"
        if kind == "grad_jax":
            return {k[len(prefix) + 5:]: v for k, v in self.ref.items()
                    if k.startswith(prefix + "leaf/")}
        return {"image": self.ref[prefix + "image"]}

    def _card(self, scene, shape, injected: bool, cache: dict):
        """The card's own render at ``shape`` (of the perturbed scene when
        ``injected``), made once per scene and kept in ``cache``."""
        if (shape, injected) not in cache:
            cache[shape, injected] = render(
                perturb(scene) if injected else scene, shape, self.seed)
        return cache[shape, injected]

    def row(self, name, kind, shape, scene_cpu, scene, cache):
        """(metrics, budget) of one row (metrics None for a ``jax`` row
        at another seed than 0)."""
        budget = BUDGETS[(name, kind)]
        injected = self.inject and kind in INJECTED
        if kind in ("jax", "d2_jax", "grad_jax"):
            if self.seed != 0:
                return None, budget
            ref = self._jax(name, kind, shape, scene_arrays(scene_cpu))
        elif kind in ("twin", "d2_twin", "grad_twin"):
            ref = self._twin(scene_cpu, name, kind, shape)
        if kind.startswith("grad"):
            card = perturb(scene) if injected else scene
            return grad_metrics(gradients(card, shape, self.seed), ref), \
                budget
        if kind == "compact":
            got = render(scene, shape, self.seed, compact=True)
            return image_metrics(got, self._card(scene, shape, False,
                                                 cache)), budget
        if kind == "sharded":
            got = render_sharded(scene, shape, self.seed)
            return image_metrics(got, self._card(scene, shape, False,
                                                 cache)), budget
        if kind == "unfused":
            got = render(scene, shape, self.seed, env={
                "RRT_UBER_WAVE": "0", "RRT_NO_UBER_FUSED": "1"})
            ref = render(scene, shape, self.seed, env={"RRT_UBER_WAVE": "0"})
            return image_metrics(got, ref), budget
        return image_metrics(self._card(scene, shape, injected, cache),
                             ref["image"]), budget

    def run(self, names) -> bool:
        t_all = time.perf_counter()
        ok_all = True
        with assets():
            for name in names:
                try:
                    scene_cpu = compile_scene(host_scene(name), device="cpu")
                    scene = scene_cpu.to(self.dev)
                except Exception as e:          # a red line beats a dead gate
                    ok_all = False
                    emit({"scene": name, "ok": False,
                          "error": repr(e)[:300]})
                    continue
                cache = {}
                for kind, shape in SCENES[name].items():
                    t0 = time.perf_counter()
                    line = {"scene": name, "row": kind, "shape": shape,
                            "seed": self.seed, "inject": self.inject,
                            "must_fail": (self.inject
                                          and must_fail(name, kind, shape))}
                    try:
                        m, budget = self.row(name, kind, shape, scene_cpu,
                                             scene, cache)
                        if m is None:
                            continue
                        ok = within(m, budget)
                        line.update(m, budget=budget)
                    except Exception as e:
                        ok = False
                        line["error"] = repr(e)[:300]
                    line.update(ok=bool(ok),
                                seconds=time.perf_counter() - t0)
                    ok_all &= bool(ok)
                    emit(line)
        emit({"gate": "gpu_parity_matrix", "ok": bool(ok_all),
              "device": str(self.dev), "seed": self.seed,
              "inject": self.inject,
              "seconds": time.perf_counter() - t_all})
        return ok_all


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenes", nargs="*", help=f"of {sorted(SCENES)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject", action="store_true",
                    help="render the card side of the twin, jax, depth-2 "
                         "and gradient rows from a perturbed scene")
    ap.add_argument("--twin-cache",
                    help="directory keeping the CPU twins' renders")
    args = ap.parse_args(argv)
    names = args.scenes or [n for n in SCENES]
    for n in names:
        if n not in SCENES:
            ap.error(f"unknown scene {n!r}; one of {sorted(SCENES)}")
    gate = Gate(args.device, args.seed, args.inject, args.twin_cache)
    return 0 if gate.run(names) else 1


if __name__ == "__main__":
    sys.exit(main())
