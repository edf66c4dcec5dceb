"""``python -m rust_ray_tracer_tpu_torch``: the CLI of utils/cli.py
(counterpart of ``rust_ray_tracer_tpu/__main__.py``)."""

import sys

from rust_ray_tracer_tpu_torch.utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
