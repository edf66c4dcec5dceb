"""Primitive-kind tags, material-attribute columns and the Plücker
triangle coefficients.

Counterpart of the parts of ``rust_ray_tracer_tpu/ops/intersect.py`` that
the trace path uses: the ``KIND_*`` and ``MATTR_*`` constants,
``_tri_coeffs`` (``intersect.py:79``), ``_mat_attr_table`` (``:539``) and
``mattr_noise_cols`` (``:571``).
The split-path search and its kernels are not ported yet (ROADMAP queue 2
E-O).
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.models.scene import TEX_CHECKER, TEX_NOISE

TRI_DET_EPS = 1e-5      # triangle.rs:42 (scale-invariant form)
T_MIN = 1e-4            # ray.rs:89

# kind tags for the cross-kind argmin
KIND_NONE, KIND_TRI, KIND_SPH, KIND_QUAD, KIND_MED = 0, 1, 2, 3, 4

# column layout of the per-material attribute rows (_mat_attr_table);
# integer-valued columns travel as exact small floats
MATTR_MKIND = 0
MATTR_FUZZ = 1
MATTR_IOR = 2
MATTR_ALBEDO = slice(3, 6)     # solid leaf / checker base tex_color
MATTR_EVEN = slice(6, 9)       # checker leaves (only when the scene
MATTR_ODD = slice(9, 12)       # has checker textures; A grows 6 -> 13)
MATTR_ISCHK = 12


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def _tri_coeffs(v0, e1, e2):
    """Four [10, T] coefficient matrices (det, u_num, v_num, t_num) over
    the Plücker ray features [o, d, o×d, 1], pre-scaled by 1/|e1×e2| so
    the determinant row gives det = -d·n̂ and the degeneracy test
    |det| > TRI_DET_EPS·|d| is a pure angle test. Zero-area pads keep
    det == 0 and never pass it."""
    n = _cross(e1, e2)
    nl = torch.sqrt(_sum3(n * n))[:, None]
    inv_n = 1.0 / torch.where(nl > 0, nl, torch.ones_like(nl))
    n = n * inv_n
    z = torch.zeros_like(v0)
    zs = torch.zeros_like(v0[:, 0])

    def col(o_c, d_c, m_c, one_c):
        return torch.cat([o_c.T, d_c.T, m_c.T, one_c[None, :]], dim=0)

    det = col(z, -n, z, zs)
    u_num = col(z, -_cross(e2, v0) * inv_n, e2 * inv_n, zs)
    v_num = col(z, -_cross(v0, e1) * inv_n, -e1 * inv_n, zs)
    t_num = col(n, z, z, -_sum3(v0 * n))
    return det, u_num, v_num, t_num


def _mat_attr_table(scene):
    """[n_mats, A] per-material attribute rows: kind, fuzz, ior, albedo
    (+ checker even/odd leaves and flag when the scene has checkers,
    + noise scale and flag when it has noise)."""
    f32 = scene.mat_fuzz.dtype
    tid = scene.mat_tex.long()
    cols = [scene.mat_kind.to(f32)[:, None], scene.mat_fuzz[:, None],
            scene.mat_ior[:, None], scene.tex_color[tid]]
    if scene.tex_even.shape[0] > 0:
        cols += [scene.tex_color[scene.tex_even.long()[tid]],
                 scene.tex_color[scene.tex_odd.long()[tid]],
                 (scene.tex_kind[tid] == TEX_CHECKER).to(f32)[:, None]]
    if scene.perlin_vec.shape[0] > 0:
        cols += [scene.tex_scale[tid][:, None],
                 (scene.tex_kind[tid] == TEX_NOISE).to(f32)[:, None]]
    return torch.cat(cols, dim=1)


def mattr_noise_cols(has_checker: bool):
    """(scale_col, is_noise_col) positions in the ``_mat_attr_table`` row:
    the noise block sits after the optional checker block."""
    base = 6 + (7 if has_checker else 0)
    return base, base + 1
