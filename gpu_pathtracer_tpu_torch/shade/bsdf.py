"""BSDF sampling and evaluation for the six material models.

The port of gpu_pathtracer_tpu/shade/bsdf.py (the reference's SampleBSDF
/ Fr, pathtracer.cu:491-826): every model in the scene is evaluated
masked over the whole lane batch and the results are selected by
material type. The transport `mode` (material.h:8) is RADIANCE for
paths from the camera and IMPORTANCE for paths from a light (light
tracing, BDPT's light subpaths): only the refraction of the two
dielectric models differs, by the eta^2 that radiance picks up across
the interface. csrc/pt_fused.cu computes the radiance models per
thread, operation for operation.

Conventions (identical to the reference):
- `wi` points AWAY from the surface toward the incoming ray origin;
- `wo` is the sampled outgoing direction;
- normals are the shading normals as intersected (not pre-flipped);
- pdf == 0 and fr == 0 mark invalid samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch.core.sampling import (
    cosine_hemisphere, sincos_2pi,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    INV_PI, PI, TWO_PI, cross, dot, dot3, face_forward, normalize, reflect,
    refract, same_hemisphere, to_world,
)
from gpu_pathtracer_tpu_torch.scene.model import MaterialType
from gpu_pathtracer_tpu_torch.shade.texture import get_texel

LAMBERTIAN = int(MaterialType.LAMBERTIAN)
MIRROR = int(MaterialType.MIRROR)
DIELECTRIC = int(MaterialType.DIELECTRIC)
ROUGHDIELECTRIC = int(MaterialType.ROUGHDIELECTRIC)
ROUGHCONDUCTOR = int(MaterialType.ROUGHCONDUCTOR)
SUBSTRATE = int(MaterialType.SUBSTRATE)

RADIANCE = 0      # TransportMode::Radiance (material.h:8)
IMPORTANCE = 1    # TransportMode::Importance


@dataclass
class MatParams:
    """Per-lane material parameters gathered at the hit's mat_idx."""
    type: torch.Tensor         # [N] i32
    alpha_u: torch.Tensor      # [N]
    alpha_v: torch.Tensor      # [N]
    inside_ior: torch.Tensor   # [N]
    outside_ior: torch.Tensor  # [N]
    k: torch.Tensor            # [N, 3]
    eta: torch.Tensor          # [N, 3]
    specular: torch.Tensor     # [N, 3]
    diffuse: torch.Tensor      # [N, 3]
    # the scene has an anisotropic material (gates sample_ggx's tan/atan
    # branch exactly like the JAX package's StaticConfig.has_aniso)
    aniso: bool = True


def gather_materials(scene, static, mat_idx, uv) -> MatParams:
    """One row of mat_attrs [M, 24] per lane (-1 clamps to material 0),
    the diffuse colour resolved at the hit's uv [N, 2] when the scene
    has textures (bsdf.py:53-78)."""
    m = torch.clamp_min(mat_idx, 0)
    a = scene.mat_attrs[m.long()]
    diffuse = a[:, 11:14]
    if static.has_textures:
        diffuse = get_texel(scene, m, uv)
    return MatParams(
        type=a[:, 0].to(torch.int32), alpha_u=a[:, 1], alpha_v=a[:, 2],
        inside_ior=a[:, 3], outside_ior=a[:, 4], k=a[:, 5:8],
        eta=a[:, 8:11], diffuse=diffuse, specular=a[:, 14:17],
        aniso=static.has_aniso)


def is_delta(mtype):
    """material.h:37-39."""
    return (mtype == MIRROR) | (mtype == DIELECTRIC)


def is_glossy(mtype):
    """material.h:32-34."""
    return (mtype == ROUGHCONDUCTOR) | (mtype == ROUGHDIELECTRIC) | (
        mtype == SUBSTRATE)


# ---------------------------------------------------------------------------
# Fresnel + microfacet building blocks (pathtracer.cu:51-164)
# ---------------------------------------------------------------------------

def dielectric_fresnel(cosi, cost, etai, etat):
    """pathtracer.cu:51-56."""
    d1 = etat * cosi + etai * cost
    d2 = etai * cosi + etat * cost
    rparl = (etat * cosi - etai * cost) / torch.where(
        torch.abs(d1) > 1e-30, d1, 1.0)
    rperp = (etai * cosi - etat * cost) / torch.where(
        torch.abs(d2) > 1e-30, d2, 1.0)
    return 0.5 * (rparl * rparl + rperp * rperp)


def conduct_fresnel(cosi, eta, k):
    """pathtracer.cu:58-66. cosi [N], eta/k [N,3] -> [N,3]."""
    c = cosi[..., None]
    tmp = (eta * eta + k * k) * c * c
    rparl2 = (tmp - 2.0 * eta * c + 1.0) / (tmp + 2.0 * eta * c + 1.0)
    tmp_f = eta * eta + k * k
    rperp2 = (tmp_f - 2.0 * eta * c + c * c) / (tmp_f + 2.0 * eta * c + c * c)
    return 0.5 * (rparl2 + rperp2)


def schlick_fresnel(specular, costheta):
    """pathtracer.cu:160-164."""
    c = 1.0 - costheta[..., None]
    return specular + c * c * c * c * c * (1.0 - specular)


def _phi_frame_cos(w_perp, dpdu):
    """cos(phi) of a direction's projection against the anisotropy frame."""
    return dot(normalize(w_perp), dpdu)


def ggx_d(wh, n, dpdu, alpha_u, alpha_v):
    """Anisotropic GGX NDF (pathtracer.cu:68-84)."""
    costheta = dot(wh, n)
    ok = costheta > 0.0
    ct = torch.clamp(costheta, 0.0, 1.0)
    ct2 = ct * ct
    st2 = 1.0 - ct2
    ct4 = ct2 * ct2
    tt2 = st2 / torch.clamp_min(ct2, 1e-12)
    cosphi = _phi_frame_cos(wh - ct[..., None] * n, dpdu)
    cosphi2 = cosphi * cosphi
    sinphi2 = 1.0 - cosphi2
    sqr = 1.0 + tt2 * (cosphi2 / (alpha_u * alpha_u)
                       + sinphi2 / (alpha_v * alpha_v))
    d = 1.0 / (PI * alpha_u * alpha_v
               * torch.clamp_min(ct4 * sqr * sqr, 1e-30))
    return torch.where(ok, d, 0.0)


def smith_g(w, n, wh, dpdu, alpha_u, alpha_v):
    """pathtracer.cu:86-101."""
    wdn = dot(w, n)
    ok = wdn * dot(w, wh) >= 0.0
    sintheta = torch.sqrt(torch.clamp(1.0 - wdn * wdn, 0.0, 1.0))
    tantheta = sintheta / torch.where(torch.abs(wdn) > 1e-12, wdn, 1e-12)
    finite = torch.isfinite(tantheta)
    cosphi = _phi_frame_cos(w - wdn[..., None] * n, dpdu)
    cosphi2 = cosphi * cosphi
    sinphi2 = 1.0 - cosphi2
    alpha2 = cosphi2 * alpha_u * alpha_u + sinphi2 * alpha_v * alpha_v
    sqr = alpha2 * tantheta * tantheta
    g = 2.0 / (1.0 + torch.sqrt(1.0 + sqr))
    return torch.where(ok & finite, g, 0.0)


def ggx_g(wo, wi, n, wh, dpdu, alpha_u, alpha_v):
    """pathtracer.cu:103-105."""
    return smith_g(wo, n, wh, dpdu, alpha_u, alpha_v) * \
        smith_g(wi, n, wh, dpdu, alpha_u, alpha_v)


def sample_ggx(alpha_u, alpha_v, u1, u2, aniso=True):
    """pathtracer.cu:107-138, local (+Y up) half vector. `aniso=False`
    leaves out the tan/atan branch when every material is isotropic."""
    denom = u1 * (alpha_u * alpha_v - 1.0) + 1.0
    ct_iso = torch.sqrt(torch.clamp((1.0 - u1) / torch.clamp_min(
        denom, 1e-30), 0.0, 1.0))
    if not aniso:
        cphi, sphi = sincos_2pi(u2)
        st_iso = torch.sqrt(torch.clamp(1.0 - ct_iso * ct_iso, 0.0, 1.0))
        return torch.stack([st_iso * cphi, ct_iso, st_iso * sphi], -1)

    phi_iso = TWO_PI * u2
    base = torch.atan(alpha_v / alpha_u * torch.tan(TWO_PI * u2))
    phi_a = torch.where(u2 <= 0.25, base,
                        torch.where(u2 >= 0.75, base + TWO_PI, base + PI))
    sinphi = torch.sin(phi_a)
    cosphi2 = 1.0 - sinphi * sinphi
    sinphi2 = sinphi * sinphi
    inv_a = 1.0 / (cosphi2 / (alpha_u * alpha_u)
                   + sinphi2 / (alpha_v * alpha_v))
    theta = torch.atan(torch.sqrt(torch.clamp_min(
        inv_a * u1 / torch.clamp_min(1.0 - u1, 1e-12), 0.0)))
    ct_a = torch.cos(theta)

    iso = alpha_u == alpha_v
    costheta = torch.where(iso, ct_iso, ct_a)
    phi = torch.where(iso, phi_iso, phi_a)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, 0.0, 1.0))
    return torch.stack([sintheta * torch.cos(phi), costheta,
                        sintheta * torch.sin(phi)], -1)


def _shading_frame(n, dpdu):
    """uu = dpdu, ww = cross(uu, n) (pathtracer.cu:499-501 et al)."""
    return dpdu, cross(dpdu, n)


# ---------------------------------------------------------------------------
# Per-model sample + eval (each masked over the full batch)
# ---------------------------------------------------------------------------

def _sample_lambertian(mat, wi, nor, dpdu, u1, u2):
    n = face_forward(nor, wi)
    local, pdf = cosine_hemisphere(u1, u2)
    uu, ww = _shading_frame(n, dpdu)
    return to_world(local, uu, n, ww), mat.diffuse * INV_PI, pdf


def _eval_lambertian(mat, wi, wo, nor):
    ok = same_hemisphere(wi, wo, nor)
    pdf = torch.abs(dot(wo, nor)) * INV_PI
    return (torch.where(ok[..., None], mat.diffuse * INV_PI, 0.0),
            torch.where(ok, pdf, 0.0))


def _sample_mirror(mat, wi, nor):
    wo = reflect(wi, nor)
    fr = mat.specular / torch.clamp_min(torch.abs(dot3(wo, nor)), 1e-12)
    return wo, fr, torch.ones_like(wi[..., 0])


def _sample_dielectric(mat, wi_in, nor, u1, mode=RADIANCE):
    """pathtracer.cu:512-551. wi_in = reference `in` (= -ray.d)."""
    wi = -wi_in
    n = nor
    cosi = dot(wi, n)
    enter = cosi < 0.0
    ei = torch.where(enter, mat.outside_ior, mat.inside_ior)
    et = torch.where(enter, mat.inside_ior, mat.outside_ior)
    eta = ei / et
    sint2 = eta * eta * (1.0 - cosi * cosi)
    cost = torch.sqrt(torch.clamp(1.0 - sint2, 0.0, 1.0))
    rdir = reflect(wi_in, n)
    tdir = refract(wi_in, nor, mat.outside_ior, mat.inside_ior)

    tir = sint2 > 1.0
    fresnel = dielectric_fresnel(torch.abs(cost), torch.abs(cosi), et, ei)
    choose_refract = (~tir) & (u1 > fresnel)

    wo = torch.where(choose_refract[..., None], tdir, rdir)
    abs_cos = torch.clamp_min(torch.abs(dot(wo, n)), 1e-12)[..., None]
    fr_reflect = mat.specular / abs_cos * torch.where(
        tir, 1.0, fresnel)[..., None]
    # radiance transport squeezes the beam through the interface
    # (pathtracer.cu:541-543); importance does not
    fr_refract = mat.specular / abs_cos * (1.0 - fresnel)[..., None]
    if mode == RADIANCE:
        fr_refract = fr_refract * (eta * eta)[..., None]
    fr = torch.where(choose_refract[..., None], fr_refract, fr_reflect)
    pdf = torch.where(tir, 1.0,
                      torch.where(choose_refract, 1.0 - fresnel, fresnel))
    return wo, fr, pdf


def _sample_roughconduct(mat, wi, nor, dpdu, u1, u2):
    """pathtracer.cu:553-578."""
    n = face_forward(nor, wi)
    wh_local = sample_ggx(mat.alpha_u, mat.alpha_v, u1, u2, mat.aniso)
    uu, ww = _shading_frame(n, dpdu)
    wh = to_world(wh_local, uu, n, ww)
    wo = reflect(wi, wh)
    ok = same_hemisphere(wi, wo, nor)
    cosi = dot(wo, wh)
    F = conduct_fresnel(torch.abs(cosi), mat.eta, mat.k)
    D = ggx_d(wh, n, dpdu, mat.alpha_u, mat.alpha_v)
    G = ggx_g(wi, wo, n, wh, dpdu, mat.alpha_u, mat.alpha_v)
    denom = 4.0 * torch.abs(dot(wi, n)) * torch.abs(dot(wo, n))
    fr = mat.specular * F * (D * G / torch.clamp_min(denom, 1e-12))[..., None]
    pdf = D * torch.abs(dot(wh, n)) / torch.clamp_min(
        4.0 * torch.abs(dot(wi, wh)), 1e-12)
    return wo, torch.where(ok[..., None], fr, 0.0), torch.where(ok, pdf, 0.0)


def _eval_roughconduct(mat, wi, wo, nor, dpdu):
    """pathtracer.cu:721-740."""
    ok = same_hemisphere(wi, wo, nor)
    n = face_forward(nor, wi)
    wh = normalize(wi + wo)
    cosi = dot(wo, wh)
    D = ggx_d(wh, n, dpdu, mat.alpha_u, mat.alpha_v)
    G = ggx_g(wi, wo, n, wh, dpdu, mat.alpha_u, mat.alpha_v)
    F = conduct_fresnel(torch.abs(cosi), mat.eta, mat.k)
    denom = 4.0 * torch.abs(dot(wi, n)) * torch.abs(dot(wo, n))
    fr = mat.specular * F * (D * G / torch.clamp_min(denom, 1e-12))[..., None]
    pdf = D * torch.abs(dot(wh, n)) / torch.clamp_min(
        4.0 * torch.abs(dot(wi, wh)), 1e-12)
    return torch.where(ok[..., None], fr, 0.0), torch.where(ok, pdf, 0.0)


def _substrate_fr_pdf(mat, wi, wo, n, dpdu):
    """Shared substrate fr/pdf (pathtracer.cu:604-637 == 749-783)."""
    c0 = torch.abs(dot(wi, n))
    c1 = torch.abs(dot(wo, n))
    rd = mat.diffuse
    rs = mat.specular
    cons0 = 1.0 - 0.5 * c0
    cons1 = 1.0 - 0.5 * c1
    k5 = (1.0 - cons0 * cons0 * cons0 * cons0 * cons0) \
        * (1.0 - cons1 * cons1 * cons1 * cons1 * cons1)
    diffuse = (28.0 / (23.0 * PI)) * rd * (1.0 - rs) * k5[..., None]
    wh = normalize(wi + wo)
    D = ggx_d(wh, n, dpdu, mat.alpha_u, mat.alpha_v)
    denom = 4.0 * torch.abs(dot(wo, wh)) * torch.maximum(c0, c1)
    specular = (D / torch.clamp_min(denom, 1e-12))[..., None] * \
        schlick_fresnel(rs, dot(wo, wh))
    # the reference uses a signed dot(in, wh) in the pdf (quirk kept)
    dwh = dot(wi, wh)
    pdf = 0.5 * (c1 * INV_PI + D * torch.abs(dot(wh, n))
                 / (4.0 * torch.where(torch.abs(dwh) > 1e-12, dwh, 1e-12)))
    return diffuse + specular, pdf


def _sample_substrate(mat, wi, nor, dpdu, u1, u2):
    """pathtracer.cu:580-640."""
    n = face_forward(nor, wi)
    uu, ww = _shading_frame(n, dpdu)
    local, _ = cosine_hemisphere(torch.clamp_max(u1 * 2.0, 1.0), u2)
    wo_diff = to_world(local, uu, n, ww)
    ux = torch.clamp((u1 - 0.5) * 2.0, 0.0, 1.0)
    wh = to_world(sample_ggx(mat.alpha_u, mat.alpha_v, ux, u2, mat.aniso),
                  uu, n, ww)
    wo_spec = reflect(wi, wh)
    wo = torch.where((u1 < 0.5)[..., None], wo_diff, wo_spec)
    ok = same_hemisphere(wi, wo, n)
    fr, pdf = _substrate_fr_pdf(mat, wi, wo, n, dpdu)
    return wo, torch.where(ok[..., None], fr, 0.0), torch.where(ok, pdf, 0.0)


def _eval_substrate(mat, wi, wo, nor, dpdu):
    ok = same_hemisphere(wi, wo, nor)
    n = face_forward(nor, wi)
    fr, pdf = _substrate_fr_pdf(mat, wi, wo, n, dpdu)
    return torch.where(ok[..., None], fr, 0.0), torch.where(ok, pdf, 0.0)


def _rough_dielectric_lobes(mat, wi_in, wo, n, wh, dpdu, ei, et, eta,
                            fresnel, f_refl, mode):
    """Reflection and refraction fr-scale / pdf of the rough dielectric
    (pathtracer.cu:642-693 and 787-824 share them)."""
    D = ggx_d(wh, n, dpdu, mat.alpha_u, mat.alpha_v)
    G = ggx_g(wi_in, wo, n, wh, dpdu, mat.alpha_u, mat.alpha_v)
    abs_in_n = torch.abs(dot(wi_in, n))
    abs_out_n = torch.abs(dot(wo, n))
    s_refl = f_refl * D * G / torch.clamp_min(
        4.0 * abs_in_n * abs_out_n, 1e-12)
    pdf_refl = D * torch.abs(dot(wh, n)) / torch.clamp_min(
        4.0 * torch.abs(dot(wh, wi_in)), 1e-12) * f_refl
    c = et * dot(wo, wh) + ei * dot(wi_in, wh)
    c2 = torch.clamp_min(c * c, 1e-12)
    s_refr = (ei * ei * D * G * (1.0 - fresnel)
              * torch.abs(dot(wi_in, wh)) * torch.abs(dot(wo, wh))
              / torch.clamp_min(abs_out_n * abs_in_n * c2, 1e-12))
    if mode == RADIANCE:
        s_refr = s_refr * (1.0 / torch.clamp_min(eta * eta, 1e-12))
    pdf_refr = (1.0 - fresnel) * D * torch.abs(dot(wh, n)) * et * et \
        * torch.abs(dot(wo, wh)) / c2
    return s_refl, pdf_refl, s_refr, pdf_refr


def _sample_roughdielectric(mat, wi_in, nor, dpdu, u1, u2, u3,
                            mode=RADIANCE):
    """pathtracer.cu:642-693."""
    wi = -wi_in
    n = nor
    uu, ww = _shading_frame(n, dpdu)
    wh = to_world(sample_ggx(mat.alpha_u, mat.alpha_v, u1, u2, mat.aniso),
                  uu, n, ww)
    enter = dot(wi, n) < 0.0
    ei = torch.where(enter, mat.outside_ior, mat.inside_ior)
    et = torch.where(enter, mat.inside_ior, mat.outside_ior)
    eta = ei / et
    cosi = dot(wi, wh)
    sint2 = eta * eta * (1.0 - cosi * cosi)
    cost = torch.sqrt(torch.clamp(1.0 - sint2, 0.0, 1.0))
    rdir = reflect(wi_in, wh)
    sign = torch.where(enter, -1.0, 1.0)
    tdir = normalize((wi - wh * cosi[..., None]) * eta[..., None]
                     + (sign * cost)[..., None] * wh)
    tir = sint2 > 1.0
    fresnel = dielectric_fresnel(torch.abs(cost), torch.abs(cosi), et, ei)
    choose_refract = (~tir) & (u3 > fresnel)
    wo = torch.where(choose_refract[..., None], tdir, rdir)
    f_refl = torch.where(tir, 1.0, fresnel)
    s_refl, pdf_refl, s_refr, pdf_refr = _rough_dielectric_lobes(
        mat, wi_in, wo, n, wh, dpdu, ei, et, eta, fresnel, f_refl, mode)
    s = torch.where(choose_refract, s_refr, s_refl)
    pdf = torch.where(choose_refract, pdf_refr, pdf_refl)
    return wo, mat.specular * s[..., None], pdf


def _eval_roughdielectric(mat, wi_in, wo, nor, dpdu, mode=RADIANCE):
    """pathtracer.cu:787-824."""
    wi = -wi_in
    n = nor
    is_reflect = dot(wi_in, n) * dot(wo, n) > 0.0
    enter = dot(wi, n) < 0.0
    ei = torch.where(enter, mat.outside_ior, mat.inside_ior)
    et = torch.where(enter, mat.inside_ior, mat.outside_ior)
    wh = normalize(-(ei[..., None] * wi_in + et[..., None] * wo))
    eta = ei / et
    cosi = dot(wi, wh)
    sint2 = eta * eta * (1.0 - cosi * cosi)
    cost = torch.sqrt(torch.clamp(1.0 - sint2, 0.0, 1.0))
    fresnel = dielectric_fresnel(torch.abs(cost), torch.abs(cosi), et, ei)
    s_refl, pdf_refl, s_refr, pdf_refr = _rough_dielectric_lobes(
        mat, wi_in, wo, n, wh, dpdu, ei, et, eta, fresnel, fresnel, mode)
    s = torch.where(is_reflect, s_refl, s_refr)
    pdf = torch.where(is_reflect, pdf_refl, pdf_refr)
    return mat.specular * s[..., None], pdf


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def sample_bsdf(mat: MatParams, wi, nor, dpdu, u1, u2, u3,
                material_types: tuple, mode: int = RADIANCE):
    """SampleBSDF dispatch (pathtracer.cu:491-695). Returns (wo[N,3],
    fr[N,3], pdf[N]); only the models in `material_types` run."""
    wo = torch.zeros_like(wi)
    fr = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])

    def sel(mtype, c, wo, fr, pdf):
        m = mat.type == mtype
        m3 = m[..., None]
        return (torch.where(m3, c[0], wo), torch.where(m3, c[1], fr),
                torch.where(m, c[2], pdf))

    if LAMBERTIAN in material_types:
        wo, fr, pdf = sel(LAMBERTIAN, _sample_lambertian(
            mat, wi, nor, dpdu, u1, u2), wo, fr, pdf)
    if MIRROR in material_types:
        wo, fr, pdf = sel(MIRROR, _sample_mirror(mat, wi, nor), wo, fr, pdf)
    if DIELECTRIC in material_types:
        wo, fr, pdf = sel(DIELECTRIC, _sample_dielectric(
            mat, wi, nor, u1, mode), wo, fr, pdf)
    if ROUGHCONDUCTOR in material_types:
        wo, fr, pdf = sel(ROUGHCONDUCTOR, _sample_roughconduct(
            mat, wi, nor, dpdu, u1, u2), wo, fr, pdf)
    if SUBSTRATE in material_types:
        wo, fr, pdf = sel(SUBSTRATE, _sample_substrate(
            mat, wi, nor, dpdu, u1, u2), wo, fr, pdf)
    if ROUGHDIELECTRIC in material_types:
        wo, fr, pdf = sel(ROUGHDIELECTRIC, _sample_roughdielectric(
            mat, wi, nor, dpdu, u1, u2, u3, mode), wo, fr, pdf)
    return wo, fr, pdf


def eval_bsdf(mat: MatParams, wi, wo, nor, dpdu, material_types: tuple,
              mode: int = RADIANCE):
    """Fr dispatch (pathtracer.cu:698-826). Returns (fr[N,3], pdf[N]);
    delta materials (mirror, dielectric) return 0."""
    fr = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])

    def sel(mtype, c, fr, pdf):
        m = mat.type == mtype
        return torch.where(m[..., None], c[0], fr), torch.where(m, c[1], pdf)

    if LAMBERTIAN in material_types:
        fr, pdf = sel(LAMBERTIAN, _eval_lambertian(mat, wi, wo, nor),
                      fr, pdf)
    if ROUGHCONDUCTOR in material_types:
        fr, pdf = sel(ROUGHCONDUCTOR, _eval_roughconduct(
            mat, wi, wo, nor, dpdu), fr, pdf)
    if SUBSTRATE in material_types:
        fr, pdf = sel(SUBSTRATE, _eval_substrate(mat, wi, wo, nor, dpdu),
                      fr, pdf)
    if ROUGHDIELECTRIC in material_types:
        fr, pdf = sel(ROUGHDIELECTRIC, _eval_roughdielectric(
            mat, wi, wo, nor, dpdu, mode), fr, pdf)
    return fr, pdf
