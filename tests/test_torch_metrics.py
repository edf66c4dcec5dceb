"""The port's ``utils/metrics`` on the CPU: ``occupancy_probe`` against
JAX's on the same scene and key, against the compact wavefront's own
live counts, ``RenderStats``' fields, ``Throughput`` and ``xla_trace``."""

import json

import jax
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.utils import metrics as jmetrics
from rust_ray_tracer_tpu_torch.ops.integrator import trace_wave_compact
from rust_ray_tracer_tpu_torch.utils import rng
from rust_ray_tracer_tpu_torch.utils.metrics import (RenderStats,
                                                     Throughput,
                                                     occupancy_probe,
                                                     xla_trace)

from tests.torch_parity import both
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["solid", "fog"])
def test_occupancy_probe_matches_jax(name, monkeypatch):
    """The live lanes entering each bounce of a 20x16 wave in chunks of
    128 (the last ragged), depth 3: the same counts as JAX's probe (its
    XLA bounce) and as the compact wavefront's per-bounce live counts of
    the same wave; the histogram is their differences."""
    js, ts = both(name, monkeypatch)
    got = occupancy_probe(ts, 20, 16, rng.key(3, "cpu"), depth=3,
                          chunk_size=128)
    ref = jmetrics.occupancy_probe(js, 20, 16, jax.random.PRNGKey(3),
                                   depth=3, chunk_size=128)
    total = 3 * 128
    np.testing.assert_array_equal(np.rint(got.occupancy * total),
                                  np.rint(ref.occupancy * total))
    np.testing.assert_allclose(got.depth_histogram, ref.depth_histogram,
                               atol=1e-12)
    stats = []
    trace_wave_compact(ts, rng.wave_key(rng.key(3, "cpu"), 0), 20, 16, 3,
                       128, stats=stats)
    np.testing.assert_array_equal(got.occupancy[:len(stats)] * total,
                                  [s["n_alive"] for s in stats])
    assert (got.spp, got.depth, got.width, got.height) == (1, 3, 20, 16)


def test_occupancy_probe_sample_chunks(monkeypatch):
    """``sample_chunks`` probes the first chunks only, as in JAX."""
    js, ts = both("solid", monkeypatch)
    got = occupancy_probe(ts, 20, 16, rng.key(3, "cpu"), depth=2,
                          chunk_size=128, sample_chunks=1)
    ref = jmetrics.occupancy_probe(js, 20, 16, jax.random.PRNGKey(3),
                                   depth=2, chunk_size=128, sample_chunks=1)
    np.testing.assert_array_equal(np.rint(got.occupancy * 128),
                                  np.rint(ref.occupancy * 128))
    assert got.occupancy[0] == 1.0


def test_render_stats_fields():
    """Lane rays, useful rays, the rate and the report of JAX's
    ``RenderStats`` from the same numbers."""
    kw = dict(width=8, height=4, spp=2, depth=3, wall_s=0.5,
              occupancy=np.array([1.0, 0.5, 0.25]),
              depth_histogram=np.array([0.5, 0.25, 0.125]))
    got, ref = RenderStats(**kw), jmetrics.RenderStats(**kw)
    assert got.lane_rays == ref.lane_rays == 8 * 4 * 2 * 3
    assert got.useful_rays == ref.useful_rays == 8 * 4 * 2 * 1.75
    assert got.mrays_per_s == ref.mrays_per_s
    assert got.report() == ref.report()


def test_throughput_and_trace(tmp_path):
    """``Throughput`` counts its steps and reports a positive rate;
    ``xla_trace`` writes a Chrome trace holding the block's torch ops."""
    meter = Throughput(1000)
    rates = [meter.step() for _ in range(3)]
    assert meter.steps == 3 and all(r > 0 for r in rates)
    with xla_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
