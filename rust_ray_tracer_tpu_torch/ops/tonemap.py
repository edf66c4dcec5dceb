"""Sample averaging + gamma-2 tonemap to u8.

Counterpart of ``rust_ray_tracer_tpu/ops/tonemap.py`` and of ``get_color``
(the reference's ``src/vec3.rs:30-53``): divide the per-pixel color sum
by the sample count, per-channel NaN -> 0 (checked on the raw sum), gamma
2.0 via sqrt, clamp to [0, 0.999], scale by 256 and truncate to u8.
"""

from __future__ import annotations

import torch


def tonemap_sum(color_sum: torch.Tensor, samples) -> torch.Tensor:
    """color_sum [..., 3] (sum over ``samples`` draws) -> u8 [..., 3]."""
    scale = 1.0 / samples
    scaled = torch.sqrt(torch.clamp_min(color_sum * scale, 0.0))
    ch = torch.where(torch.isnan(color_sum), torch.zeros_like(scaled),
                     scaled)
    return (256.0 * torch.clamp(ch, 0.0, 0.999)).to(torch.uint8)


def tonemap_mean(color_mean: torch.Tensor, samples: int = 1) -> torch.Tensor:
    """Tonemap an already-averaged image. NaN channels still map to 0."""
    return tonemap_sum(color_mean * samples, samples)
