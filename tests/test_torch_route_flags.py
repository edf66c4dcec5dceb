"""The JAX package's four route flags in the port, on the CPU.

``RRT_NO_UBER=1``, ``RRT_NO_MEGAKERNEL=1`` and ``RRT_NO_PALLAS_SHADE=1``
send every scene off the trace kernel (``pallas_uber.py:1245-1250``;
``ops/uber.ineligible_reason``); the last two also switch off the split
route's fused bounce F and shade+update H (``pallas_bounce.py:745-747,
811-813``; ``ops/bounce.megakernels_off``), so a bounce runs J,
``texture_value``, I and the torch update. ``RRT_UBER_NOISE=0`` sends
noise scenes off the trace kernel (``pallas_uber.py:1259``). Each flag is
set by ``monkeypatch`` (read at call time), the route is shown by spies
on the plain versions (what the card's kernels would be), and the image
is held against JAX's ``render_waves`` under the same flag within the
flip budget. On the CPU JAX's route never reaches its kernels, so its
image is its XLA route's under every flag.
"""

import contextlib

import jax
import numpy as np
import pytest

from rust_ray_tracer_tpu.ops import integrator as jint
from rust_ray_tracer_tpu_torch.ops import bounce as bounce_ops
from rust_ray_tracer_tpu_torch.ops import hit as hit_ops
from rust_ray_tracer_tpu_torch.ops import shade as shade_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import assert_flip_budget, both
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

# plain version -> the kernel it stands for on the card
SPIES = {"trace_wave_plain": (uber, "A"),
         "bounce_plane_core": (bounce_ops, "F"),
         "hit_plane_core": (hit_ops, "J"),
         "su_plane_core": (bounce_ops, "H"),
         "shade_plane_core": (shade_ops, "I")}


@contextlib.contextmanager
def spies():
    """The kernels whose plain versions ran inside ``with``."""
    ran = set()
    real = {name: getattr(mod, name) for name, (mod, _) in SPIES.items()}
    for name, (mod, letter) in SPIES.items():
        def spy(*args, _real=real[name], _letter=letter, **kw):
            ran.add(_letter)
            return _real(*args, **kw)
        setattr(mod, name, spy)
    try:
        yield ran
    finally:
        for name, (mod, _) in SPIES.items():
            setattr(mod, name, real[name])


@pytest.mark.parametrize("flag,value,scene,route", [
    (None, None, "solid", {"A"}),
    ("RRT_NO_UBER", "1", "solid", {"F"}),
    ("RRT_NO_MEGAKERNEL", "1", "solid", {"J", "I"}),
    ("RRT_NO_PALLAS_SHADE", "1", "solid", {"J", "I"}),
    ("RRT_UBER_NOISE", "0", "noise", {"J", "H"}),
    ("RRT_UBER_NOISE", "0", "solid", {"A"}),
])
def test_flag_routes_as_jax(flag, value, scene, route, monkeypatch):
    js, ts = both(scene, monkeypatch)
    if flag is not None:
        monkeypatch.setenv(flag, value)
        reason = uber.ineligible_reason(ts)
        assert (reason is None) is (route == {"A"})
        assert reason is None or flag in reason
    ref = np.asarray(jint.render_waves(js, 16, 16, jax.random.PRNGKey(0), 0,
                                       1, depth=3, chunk_size=256))
    with spies() as ran:
        got = render_waves(ts, 16, 16, rng.key(0, "cpu"), 0, 1, depth=3,
                           chunk_size=256)
    assert ran == route
    assert_flip_budget(got.numpy(), ref)
