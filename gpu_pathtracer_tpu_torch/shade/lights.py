"""Light sampling: the light pick, area lights and the environment light.

The port of gpu_pathtracer_tpu/shade/lights.py: the reference's Area
(area.h:7-42), Infinite (infinite.h:6-95) and its light-pick
distribution (scene.h:64-82). The pick CDF has one slot per area light
and, when the scene has an environment light, one more after them: a
picked index equal to the number of area lights is the environment.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.sampling import (
    cosine_hemisphere, uniform_sphere, uniform_triangle,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    INV_FOUR_PI, PI, TWO_PI, cross, dot, length, make_coordinate, normalize,
    to_world,
)
from gpu_pathtracer_tpu_torch.shade.texture import env_lookup


def pick_light(scene, u):
    """Search the normalized power CDF. Returns (idx[N], choice_pdf[N]):
    the last i with cdf[i] <= u, as searchsorted(side="right") - 1;
    idx == n_lights is the environment light (pathtracer.cu:930-931)."""
    cdf = scene.light_cdf
    idx = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[0] - 2).to(torch.int32)
    return idx, light_choice_pdf(scene, idx)


def light_choice_pdf(scene, idx):
    """PdfFromLightDistribution (pathtracer.cu:183-185)."""
    cdf = scene.light_cdf
    i = torch.clamp(idx, 0, cdf.shape[0] - 2).long()
    return cdf[i + 1] - cdf[i]


def n_light_rows(static) -> int:
    """Rows of light_attrs: one per area light, one dummy row when there
    are none (the light CDF has n_light_rows + 2 entries)."""
    return max(static.n_lights, 1)


def _light_rows(scene, idx):
    """The light_attrs rows of `idx`, clamped into the table (an
    environment pick reads the last row, and its result is replaced)."""
    a = scene.light_attrs[torch.clamp(idx, 0, scene.light_attrs.shape[0] - 1)
                          .long()]
    return (a[:, 0:3], a[:, 3:6], a[:, 6:9],
            a[:, 9:12], a[:, 12:15], a[:, 15:18], a[:, 18:21])


def _tri_area(v0, v1, v2):
    return 0.5 * length(cross(v1 - v0, v2 - v0))


def sample_area_light(scene, idx, pos, u1, u2, epsilon):
    """Area::SampleLight toward a shading point (area.h:14-19 +
    mesh.h:100-109): solid-angle pdf, one-sided emission.

    Returns (radiance[N,3], shadow_o, shadow_d, shadow_tmax, light_nor,
    pdf)."""
    v0, v1, v2, n0, n1, n2, rad = _light_rows(scene, idx)
    bu, bv = uniform_triangle(u1, u2)
    w = 1.0 - bu - bv
    p = bu[..., None] * v0 + bv[..., None] * v1 + w[..., None] * v2
    nor = normalize(bu[..., None] * n0 + bv[..., None] * n1
                    + w[..., None] * n2)
    d = p - pos
    dist2 = dot(d, d)
    nd = normalize(d)
    cos_l = torch.abs(dot(nor, nd))
    pdf = dist2 / torch.clamp_min(_tri_area(v0, v1, v2) * cos_l, 1e-30)
    # one-sided: emission only against the normal (mesh.h:107-108)
    pdf = torch.where(dot(nor, d) >= 0.0, 0.0, pdf)
    radiance = torch.where((pdf != 0.0)[..., None], rad, 0.0)
    tmax = torch.sqrt(torch.clamp_min(dist2 - epsilon, 0.0))
    return radiance, pos, nd, tmax, nor, pdf


def sample_area_light_emission(scene, idx, u1, u2, u3, u4, epsilon):
    """Area::SampleLight emitting a photon (area.h:21-26 + mesh.h:
    111-120): a uniform point of the light's triangle, a cosine-weighted
    direction about its normal. Returns (ray_o, ray_d, light_nor,
    radiance, pdf_a, pdf_w)."""
    v0, v1, v2, n0, n1, n2, rad = _light_rows(scene, idx)
    bu, bv = uniform_triangle(u1, u2)
    w = 1.0 - bu - bv
    p = bu[..., None] * v0 + bv[..., None] * v1 + w[..., None] * v2
    nor = normalize(bu[..., None] * n0 + bv[..., None] * n1
                    + w[..., None] * n2)
    local, pdf_w = cosine_hemisphere(u3, u4)
    uu, ww = make_coordinate(nor)
    d = to_world(local, uu, nor, ww)
    pdf_a = 1.0 / torch.clamp_min(_tri_area(v0, v1, v2), 1e-30)
    return p, d, nor, rad, pdf_a, pdf_w


def area_light_pdf(scene, idx, ray_d, nor):
    """Area::Pdf (area.h:28-32): (pdfA = 1/area, pdfW = |cos|/pi)."""
    v0, v1, v2, _, _, _, _ = _light_rows(scene, idx)
    pdf_a = 1.0 / torch.clamp_min(_tri_area(v0, v1, v2), 1e-30)
    return pdf_a, torch.abs(dot(ray_d, nor)) * (1.0 / torch.pi)


def area_light_le(scene, idx, nor, dir_out):
    """Area::Le (area.h:38-41): one-sided emission."""
    rad = scene.light_attrs[torch.clamp_min(idx, 0).long()][:, 18:21]
    return torch.where((dot(nor, dir_out) > 0.0)[..., None], rad, 0.0)


# ---------------------------------------------------------------------------
# the environment light (infinite.h)
# ---------------------------------------------------------------------------

def _env_uv_from_dir(scene, d):
    """Direction -> equirect uv in the light's rotated frame
    (infinite.h:47-58)."""
    costheta = dot(d, scene.env_v)
    theta = torch.acos(torch.clamp(costheta, -1.0, 1.0))
    flat = normalize(d - costheta[..., None] * scene.env_v)
    phi = torch.acos(torch.clamp(dot(flat, scene.env_u), -1.0, 1.0))
    phi = torch.where(dot(flat, scene.env_w) > 0.0, TWO_PI - phi, phi)
    return torch.stack([1.0 - phi * (1.0 / TWO_PI), theta * (1.0 / PI)],
                       -1)


def infinite_le(scene, d):
    """Infinite::Le (infinite.h:47-59): the sky's radiance along d."""
    return env_lookup(scene, _env_uv_from_dir(scene, d))


def sample_infinite_light(scene, pos, u1, u2, epsilon):
    """Infinite::SampleLight (infinite.h:17-36): a uniform-sphere
    direction (the reference samples no importance either).

    Returns (radiance, shadow_o, shadow_d, shadow_tmax, light_nor, pdf)."""
    d, pdf = uniform_sphere(u1, u2)
    rad = infinite_le(scene, d)
    tmax = torch.full_like(u1, 2.0 * scene.world_radius - epsilon)
    return rad, pos, d, tmax, -d, pdf


def infinite_pdf(scene):
    """Infinite::Pdf (infinite.h:38-41): (pdfA, pdfW) as float32 scalars."""
    r = scene.world_radius
    return (torch.tensor(1.0 / (PI * r * r), dtype=torch.float32),
            torch.tensor(INV_FOUR_PI, dtype=torch.float32))
