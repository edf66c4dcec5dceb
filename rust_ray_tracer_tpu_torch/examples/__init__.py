"""Runnable examples of the port (``python -m
rust_ray_tracer_tpu_torch.examples.<name>``)."""
