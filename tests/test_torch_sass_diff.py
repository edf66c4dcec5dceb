"""``tools/sass_diff.py``, the comparison of two trees' kernel libraries
by SASS, on listings and build directories written here: kernel names
taken apart from their anonymous namespaces' per-build hashes, columns
padded differently read alike, one changed instruction found, a kernel
only one tree has named, and libraries matched by their exact names (not
``trace_wave`` against ``trace_wave_bwd``)."""

import pytest

from rust_ray_tracer_tpu_torch.tools import sass_diff

from torch_threads import torch_one_thread  # noqa: F401 (autouse)

A = "_ZN40_GLOBAL__N__{}_8_shade_cu_db4dd13512shade_kernelEPKfS1_PKiS1_iPfi"
B = "_ZN40_GLOBAL__N__{}_8_shade_cu_db4dd13516shade_bwd_kernelEPKfS1_i"


def _listing(h, pad, extra="", second=True):
    """A ``cuobjdump -sass`` listing of one or two kernels, the anonymous
    namespace hashed ``h``, columns padded by ``pad`` spaces."""
    sp = " " * pad
    text = (f"\tcode for sm_90a\n\t\tFunction : {A.format(h)}\n"
            f"{sp}/*0000*/{sp}MOV R1, c[0x0][0x28] ;{sp}/* 0x00 */\n"
            f"{sp}/*0010*/{sp}FADD R2, R3, R4 ;{extra}\n")
    if second:
        text += (f"\t\tFunction : {B.format(h)}\n"
                 f"{sp}/*0000*/{sp}EXIT ;\n")
    return text


def test_parse_sass_normalises_names_and_columns():
    a = sass_diff.parse_sass(_listing("d15a194e", 4))
    b = sass_diff.parse_sass(_listing("90eec172", 9))
    assert a == b and len(a) == 2
    assert A.format("X") in a
    assert "MOV R1, c[0x0][0x28] ;" in a[A.format("X")]


def test_compare_names_the_kernels_that_moved(tmp_path, monkeypatch):
    """Tree b's shade library has one instruction more in I and no I'; its
    split library is the same: only those two kernels are named."""
    listings = {}
    for tree, shade in (("a", _listing("d15a194e", 4)),
                        ("b", _listing("90eec172", 6, " FMUL R5, R6, R7 ;",
                                       second=False))):
        d = tmp_path / tree / "build" / "torch_kernels"
        d.mkdir(parents=True)
        digest = "0123456789abcdef" if tree == "a" else "fedcba9876543210"
        for lib, text in (("shade", shade), ("split", _listing("1", 2))):
            f = d / f"lib{lib}_{digest}.so"
            f.write_bytes(b"")
            listings[str(f)] = text
    monkeypatch.setattr(sass_diff, "sass",
                        lambda p: sass_diff.parse_sass(listings[p]))
    res = sass_diff.compare(str(tmp_path / "a"), str(tmp_path / "b"))
    assert res["shade"]["differ"] == sorted([A.format("X"), B.format("X")])
    assert res["split"]["differ"] == [] and res["split"]["kernels"] == 2
    assert res["shade"]["other"] == "libshade_fedcba9876543210.so"


def test_libraries_match_exact_names(tmp_path):
    d = tmp_path / "build" / "torch_kernels"
    d.mkdir(parents=True)
    for name in ("libtrace_wave_bwd_0123456789abcdef.so",
                 "libtrace_wave_0123456789abcdef.so",
                 "libtrace_wave_noise_0123456789abcdef.so",
                 "libtrace_wave_0123456789abcdef.log"):
        (d / name).write_bytes(b"")
    libs = sass_diff.libraries(str(tmp_path))
    assert sorted(libs) == ["trace_wave", "trace_wave_bwd",
                            "trace_wave_noise"]
    assert libs["trace_wave"].endswith("libtrace_wave_0123456789abcdef.so")
    (d / "libtrace_wave_fedcba9876543210.so").write_bytes(b"")
    with pytest.raises(ValueError, match="two builds of trace_wave"):
        sass_diff.libraries(str(tmp_path))
