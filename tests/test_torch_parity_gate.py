"""The port's parity gate (``rust_ray_tracer_tpu_torch/tools/
verify_gpu_parity.py``) on the CPU.

The gate runs its scene matrix on the card; here it is held where it can
be without one:

  * its row check is green on equal images and red on a CPU render of the
    injected scene (``verify_gpu_parity.perturb``: every albedo leaf
    scaled by 1 + 1e-3) against the plain one, the flagship at 32x18, 1
    spp, depth 2, under the budgets of the tiny row's CPU-twin and JAX
    rows;
  * every fingerprint saved in ``gpu_parity_ref.npz`` equals both the
    port's and the JAX package's compiled scene today, so a drifted
    builder shows as "scene differs", not as a parity failure;
  * the tiny row (the flagship at 32x18, 1 spp, depth 2) regenerates from
    JAX bit for bit (``tests/torch_gate_ref.jax_image``), and the gate's
    own CPU run of it (``--device cpu tiny``) exits 0 with its two rows
    green.
"""

import json

import numpy as np
import pytest

from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.tools import verify_gpu_parity as gate

from tests import torch_gate_ref as ref
from tests import torch_parity as tp
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

SAVED = dict(np.load(gate.REF_PATH))


def test_row_check_green_on_equal_red_on_injected():
    scene = compile_scene(gate.host_scene("tiny"), device="cpu")
    img = gate.render(scene, gate.TINY, 0)
    same = gate.image_metrics(img.copy(), img)
    assert same["bitwise"] and same["maxabs"] == 0.0
    hurt = gate.image_metrics(gate.render(gate.perturb(scene), gate.TINY, 0),
                              img)
    assert not hurt["bitwise"] and hurt["rel_mean"] > 1e-4
    for kind in ("twin", "jax"):
        budget = gate.BUDGETS["tiny", kind]
        assert gate.within(same, budget), kind
        assert not gate.within(hurt, budget), (kind, hurt)
    g = {"a": np.ones(3, np.float32)}
    assert gate.within(gate.grad_metrics(g, g), {"rel_l2": 0.0})
    assert not gate.within(gate.grad_metrics({"a": 1.001 * g["a"]}, g),
                           {"rel_l2": 1e-6})


def test_fingerprints_match_both_packages(monkeypatch):
    with gate.assets():
        for name in gate.SCENES:
            saved = str(SAVED[f"{name}/fingerprint"])
            port = compile_scene(gate.host_scene(name), device="cpu")
            assert gate.fingerprint(gate.scene_arrays(port)) == saved, name
            js = ref.jax_scene(name, monkeypatch)
            assert gate.fingerprint(tp.scene_dict(js)) == saved, name


def test_tiny_row_regenerates_and_gate_cpu_run_is_green(monkeypatch,
                                                        capsys):
    with gate.assets():
        js = ref.jax_scene("tiny", monkeypatch)
    np.testing.assert_array_equal(ref.jax_image(js, gate.TINY),
                                  SAVED["tiny/jax/image"])
    assert tuple(SAVED["tiny/jax/shape"]) == gate.TINY
    assert gate.main(["tiny", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows = {x["row"]: x for x in lines if "row" in x}
    assert set(rows) == {"twin", "jax"}
    assert all(r["ok"] for r in rows.values()) and rows["twin"]["bitwise"]
    assert lines[-1]["gate"] == "gpu_parity_matrix" and lines[-1]["ok"]


@pytest.mark.parametrize("name", sorted(gate.SCENES))
def test_reference_holds_every_jax_row(name):
    """The reference file has JAX's image (or gradients) at each JAX
    row's shape, finite, and stays under 1.5 MB."""
    assert gate.REF_PATH.stat().st_size <= 1.5e6
    for kind, shape in gate.SCENES[name].items():
        if kind not in ref.JAX_KINDS:
            continue
        assert tuple(SAVED[f"{name}/{kind}/shape"]) == shape
        if kind == "grad_jax":
            leaves = [v for k, v in SAVED.items()
                      if k.startswith(f"{name}/{kind}/leaf/")]
            assert leaves and all(np.isfinite(v).all() for v in leaves)
        else:
            img = SAVED[f"{name}/{kind}/image"]
            assert img.shape == (shape[1], shape[0], 3)
            assert np.isfinite(img).all() and img.mean() > 0
