"""Which kernels of the port's libraries differ in SASS between two trees.

A change to a shared device function (``csrc/trace_common.cuh``,
``csrc/trace_bwd_common.cuh``) recompiles every kernel that inlines it;
this names the kernels whose machine code moved, so that only those need
their times and bits held against the parent. On a machine with the CUDA
toolkit, after each tree has built its libraries (``kernels.build_all()``
run from the tree's root with ``PYTHONPATH=<tree>``, into
``<tree>/build/torch_kernels/``)::

    python3 rust_ray_tracer_tpu_torch/tools/sass_diff.py <tree a> <tree b>

prints one JSON object: for each library of tree a (matched in tree b by
its exact name), its kernel count, tree b's file and the kernels whose
SASS differs. ``cuobjdump -sass`` pads its columns to the module's widest
line and names an anonymous namespace by a hash of the build, so
whitespace is collapsed and those hashes are taken out before comparing.
Imports neither torch nor JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
_LIB = re.compile(r"lib(\w+)_[0-9a-f]{16}\.so")


def norm(text: str) -> str:
    """``text`` without the per-build hashes of anonymous namespaces."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__X_", text)


def parse_sass(listing: str) -> dict[str, str]:
    """{kernel: its SASS} of a ``cuobjdump -sass`` listing, names and
    lines normalised (:func:`norm`, whitespace collapsed)."""
    funcs, name, body = {}, None, []
    for line in listing.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = "\n".join(body)
            name, body = norm(m.group(1)), []
        elif name:
            body.append(norm(" ".join(line.split())))
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def libraries(tree: str) -> dict[str, str]:
    """{library name: path} of the libraries built in ``tree``; raises if
    a name has more than one build there."""
    d = os.path.join(tree, "build", "torch_kernels")
    out = {}
    for f in sorted(os.listdir(d)):
        m = _LIB.fullmatch(f)
        if m:
            if m.group(1) in out:
                raise ValueError(f"two builds of {m.group(1)} in {d}")
            out[m.group(1)] = os.path.join(d, f)
    return out


def sass(path: str) -> dict[str, str]:
    """{kernel: SASS} of the library at ``path`` (cuobjdump)."""
    return parse_sass(subprocess.run([CUOBJDUMP, "-sass", path],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def compare(tree_a: str, tree_b: str) -> dict:
    """Per library of ``tree_a``: its kernel count, ``tree_b``'s file and
    the kernels whose SASS differs (or that only one tree has)."""
    libs_b = libraries(tree_b)
    res = {}
    for lib, path in libraries(tree_a).items():
        fa, fb = sass(path), sass(libs_b[lib])
        res[lib] = {"kernels": len(fa),
                    "other": os.path.basename(libs_b[lib]),
                    "differ": sorted(k for k in fa.keys() | fb.keys()
                                     if fa.get(k) != fb.get(k))}
    return res


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print("usage: sass_diff.py <tree a> <tree b>", file=sys.stderr)
        return 2
    print(json.dumps(compare(*args), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
