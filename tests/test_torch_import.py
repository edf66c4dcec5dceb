"""The torch port stands alone: importing it and rendering on the CPU
never imports JAX, and importing its kernel module needs no nvcc."""

import os
import subprocess
import sys
import textwrap
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

_SCRIPT = textwrap.dedent("""
    import shutil, sys
    import rust_ray_tracer_tpu_torch as rt
    from rust_ray_tracer_tpu_torch import kernels
    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.utils import cli, rng
    assert shutil.which("nvcc") is None, "PATH should hide nvcc here"
    assert kernels.trace_wave_kernel.build_info is None   # not built
    scene = rt.compile_scene(builders.cornell_box(1.0), device="cpu")
    img = rt.render_image(scene, 16, 16, 1, rng.key(0, "cpu"), chunk_size=256)
    assert img.shape == (16, 16, 3) and bool(img.isfinite().all())
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not jax_mods, jax_mods
    assert "rust_ray_tracer_tpu" not in sys.modules
    print("ok", float(img.mean()))
""")


def test_port_imports_no_jax_and_needs_no_nvcc():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PATH": os.path.dirname(sys.executable), "PYTHONPATH": root,
           "HOME": os.environ.get("HOME", root)}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_package_sources_never_import_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "rust_ray_tracer_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for line in fh:
                        s = line.strip()
                        if (s.startswith(("import jax", "from jax"))
                                or s.startswith("from rust_ray_tracer_tpu.")
                                or s.startswith("import rust_ray_tracer_tpu.")
                                or s == "import rust_ray_tracer_tpu"):
                            offenders.append(f"{path}: {s}")
    assert not offenders, offenders
