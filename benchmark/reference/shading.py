"""Camera rays, light sampling and the two BSDFs the configurations use.

Frozen from brickray/gpu-pathtracer's camera.h, area.h, wrap.h and
pathtracer.cu (SampleBSDF / Fr for "lambertian" and "roughconduct", the
power heuristic), written as plain tensor code over [N] lanes. The
local frame has the normal as +Y.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.geometry import (
    cross, dot, length, normalize,
)
from benchmark.reference.scene import LAMBERTIAN, ROUGHCONDUCTOR

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
LUMA = (0.212671, 0.715160, 0.072169)
# the pinhole's film distance and its square, rounded as float32 math
DIST = float(np.float32(0.1))
DIST2 = float(np.float32(0.1) * np.float32(0.1))


def luminance(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def power_heuristic(f, g):
    den = f * f + g * g
    ok = den > 0.0
    return torch.where(ok, f * f / torch.where(ok, den, 1.0), 0.0)


def sincos_2pi(u):
    c = torch.cos(TWO_PI * u)
    s = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    return c, torch.where(u <= 0.5, s, -s)


def _local(costheta, sintheta, u2):
    c, s = sincos_2pi(u2)
    return torch.stack([sintheta * c, costheta, sintheta * s], -1)


def cosine_hemisphere(u1, u2):
    st = torch.sqrt(torch.clamp_min(u1, 0.0))
    ct = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return _local(ct, st, u2), ct * INV_PI


def to_world(d, u, v, w):
    return d[..., 0:1] * u + d[..., 1:2] * v + d[..., 2:3] * w


def make_coordinate(n):
    """Orthonormal (u, w) around unit n (wrap.h:6-16)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    ix = 1.0 / torch.sqrt(nx * nx + nz * nz + 1e-30)
    iy = 1.0 / torch.sqrt(ny * ny + nz * nz + 1e-30)
    wx = torch.cat([nz * ix, torch.zeros_like(ix), -nx * ix], -1)
    wy = torch.cat([torch.zeros_like(iy), nz * iy, -ny * iy], -1)
    w = torch.where(torch.abs(nx) > torch.abs(ny), wx, wy)
    return cross(w, n), w


def face_forward(n, d):
    return torch.where((dot(n, d) < 0.0)[..., None], -n, n)


def reflect(wi, n):
    return 2.0 * dot(wi, n)[..., None] * n - wi


# ---------------------------------------------------------------------------
# camera (camera.h:48-121, pinhole)
# ---------------------------------------------------------------------------
def primary_rays(cam, x, y):
    """Rays through continuous pixel coordinates x, y [N]."""
    xx = x * cam["p2s"][0] - cam["half_w"]
    yy = y * cam["p2s"][1] - cam["half_h"]
    d = xx[:, None] * cam["u"] + yy[:, None] * cam["v"] \
        - DIST * cam["w"]
    return cam["position"].expand(d.shape), normalize(d)


def sample_camera(cam, pos, eps):
    """A world point to the pinhole: (dir to the camera, tmax, importance,
    pdf (0: behind or off the film), raster x, y)."""
    d = cam["position"] - pos
    nd = normalize(d)
    tmax = length(d) - eps
    cn = torch.stack([dot(-nd, cam["u"]), dot(-nd, cam["v"]),
                      dot(-nd, cam["w"])], -1)
    ok = cn[..., 2] < 0.0
    costheta = -cn[..., 2]
    scale = -DIST / torch.where(ok, cn[..., 2], -1.0)
    px = cn[..., 0] * scale / cam["half_w"]
    py = cn[..., 1] * scale / cam["half_h"]
    ok = ok & (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    # nothing changes in float32 on a connection that holds (|px| <= 1);
    # in a lower precision the rounding can reach past the film, or NaN
    rx, ry = (torch.nan_to_num(torch.floor((p * 0.5 + 0.5) * (res - 1.0)
                                           + 0.5)).clamp(-1.0, res).long()
              .clamp(0, int(res) - 1)
              for p, res in ((px, cam["res"][0]), (py, cam["res"][1])))
    pdf = torch.where(ok, dot(d, d) / torch.clamp_min(costheta, 1e-30), 0.0)
    we = DIST2 / torch.clamp_min(cam["area"] * costheta ** 4, 1e-30)
    return nd, tmax, we, pdf, rx, ry


def camera_pdf(cam, d):
    """The camera ray's solid-angle pdf along d (camera -> point)."""
    c = dot(d, -cam["w"])
    return DIST2 / torch.clamp_min(cam["area"] * c ** 3, 1e-30)


# ---------------------------------------------------------------------------
# area lights (area.h, scene.h:64-82)
# ---------------------------------------------------------------------------
def pick_light(scene, u):
    cdf = scene.cdf
    idx = torch.searchsorted(cdf, u.float().contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[0] - 2)
    return idx, choice_pdf(scene, idx)


def choice_pdf(scene, idx):
    i = torch.clamp(idx, 0, scene.cdf.shape[0] - 2)
    return scene.cdf[i + 1] - scene.cdf[i]


def light_area(scene, idx):
    t = scene.l_tri[idx]
    return 0.5 * length(cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]))


def light_point(scene, idx, u1, u2):
    """A uniform point of light `idx`'s triangle and its normal."""
    t, n = scene.l_tri[idx], scene.l_nor[idx]
    su = torch.sqrt(torch.clamp_min(u1, 0.0))
    bu, bv = 1.0 - su, u2 * su
    w = 1.0 - bu - bv
    p = bu[:, None] * t[:, 0] + bv[:, None] * t[:, 1] + w[:, None] * t[:, 2]
    nor = normalize(bu[:, None] * n[:, 0] + bv[:, None] * n[:, 1]
                    + w[:, None] * n[:, 2])
    return p, nor


def sample_light(scene, idx, pos, u1, u2, eps):
    """Toward `pos`: (radiance, direction, tmax, solid-angle pdf)."""
    p, nor = light_point(scene, idx, u1, u2)
    d = p - pos
    dist2 = dot(d, d)
    nd = normalize(d)
    cos_l = torch.abs(dot(nor, nd))
    pdf = dist2 / torch.clamp_min(light_area(scene, idx) * cos_l, 1e-30)
    pdf = torch.where(dot(nor, d) >= 0.0, 0.0, pdf)
    rad = torch.where((pdf != 0.0)[:, None], scene.l_rad[idx], 0.0)
    return rad, nd, torch.sqrt(torch.clamp_min(dist2 - eps, 0.0)), pdf


def light_le(scene, idx, nor, wo):
    rad = scene.l_rad[torch.clamp_min(idx, 0)]
    return torch.where((dot(nor, wo) > 0.0)[:, None], rad, 0.0)


# ---------------------------------------------------------------------------
# BSDFs (pathtracer.cu:491-826)
# ---------------------------------------------------------------------------
def materials(scene, idx):
    return dict(type=scene.m_type[idx], au=scene.m_alpha[idx, 0],
                av=scene.m_alpha[idx, 1], k=scene.m_k[idx],
                eta=scene.m_eta[idx], diffuse=scene.m_diffuse[idx],
                specular=scene.m_specular[idx], aniso=scene.has_aniso)


def _conduct_fresnel(cosi, eta, k):
    c = cosi[..., None]
    tmp = (eta * eta + k * k) * c * c
    rparl2 = (tmp - 2.0 * eta * c + 1.0) / (tmp + 2.0 * eta * c + 1.0)
    tmp_f = eta * eta + k * k
    rperp2 = (tmp_f - 2.0 * eta * c + c * c) / (tmp_f + 2.0 * eta * c + c * c)
    return 0.5 * (rparl2 + rperp2)


def _cos_phi(w_perp, dpdu):
    return dot(normalize(w_perp), dpdu)


def _ggx_d(wh, n, dpdu, au, av):
    ct = dot(wh, n)
    ok = ct > 0.0
    ct = torch.clamp(ct, 0.0, 1.0)
    ct2 = ct * ct
    tt2 = (1.0 - ct2) / torch.clamp_min(ct2, 1e-12)
    cp = _cos_phi(wh - ct[..., None] * n, dpdu)
    cp2 = cp * cp
    sqr = 1.0 + tt2 * (cp2 / (au * au) + (1.0 - cp2) / (av * av))
    d = 1.0 / (PI * au * av * torch.clamp_min(ct2 * ct2 * sqr * sqr, 1e-30))
    return torch.where(ok, d, 0.0)


def _smith_g(w, n, wh, dpdu, au, av):
    wdn = dot(w, n)
    ok = wdn * dot(w, wh) >= 0.0
    st = torch.sqrt(torch.clamp(1.0 - wdn * wdn, 0.0, 1.0))
    tt = st / torch.where(torch.abs(wdn) > 1e-12, wdn, 1e-12)
    cp = _cos_phi(w - wdn[..., None] * n, dpdu)
    cp2 = cp * cp
    a2 = cp2 * au * au + (1.0 - cp2) * av * av
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tt * tt))
    return torch.where(ok & torch.isfinite(tt), g, 0.0)


def _sample_ggx(au, av, u1, u2, aniso):
    den = u1 * (au * av - 1.0) + 1.0
    ct_iso = torch.sqrt(torch.clamp((1.0 - u1) / torch.clamp_min(den, 1e-30),
                                    0.0, 1.0))
    if not aniso:
        c, s = sincos_2pi(u2)
        st = torch.sqrt(torch.clamp(1.0 - ct_iso * ct_iso, 0.0, 1.0))
        return torch.stack([st * c, ct_iso, st * s], -1)
    base = torch.atan(av / au * torch.tan(TWO_PI * u2))
    phi_a = torch.where(u2 <= 0.25, base,
                        torch.where(u2 >= 0.75, base + TWO_PI, base + PI))
    sp = torch.sin(phi_a)
    inv_a = 1.0 / ((1.0 - sp * sp) / (au * au) + sp * sp / (av * av))
    theta = torch.atan(torch.sqrt(torch.clamp_min(
        inv_a * u1 / torch.clamp_min(1.0 - u1, 1e-12), 0.0)))
    iso = au == av
    ct = torch.where(iso, ct_iso, torch.cos(theta))
    phi = torch.where(iso, TWO_PI * u2, phi_a)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, 0.0, 1.0))
    return torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)], -1)


def _conductor(m, wi, wo, n, wh, dpdu, nor):
    ok = dot(wi, nor) * dot(wo, nor) > 0.0
    f = _conduct_fresnel(torch.abs(dot(wo, wh)), m["eta"], m["k"])
    d = _ggx_d(wh, n, dpdu, m["au"], m["av"])
    g = _smith_g(wi, n, wh, dpdu, m["au"], m["av"]) \
        * _smith_g(wo, n, wh, dpdu, m["au"], m["av"])
    den = 4.0 * torch.abs(dot(wi, n)) * torch.abs(dot(wo, n))
    fr = m["specular"] * f * (d * g / torch.clamp_min(den, 1e-12))[..., None]
    pdf = d * torch.abs(dot(wh, n)) / torch.clamp_min(
        4.0 * torch.abs(dot(wi, wh)), 1e-12)
    return torch.where(ok[..., None], fr, 0.0), torch.where(ok, pdf, 0.0)


def sample_bsdf(m, wi, nor, dpdu, u1, u2):
    """(wo, fr, pdf) of one BSDF sample; wi points away from the surface."""
    n = face_forward(nor, wi)
    uu, ww = dpdu, cross(dpdu, n)
    local, pdf_l = cosine_hemisphere(u1, u2)
    wo_l = to_world(local, uu, n, ww)
    wh = to_world(_sample_ggx(m["au"], m["av"], u1, u2, m["aniso"]), uu, n,
                  ww)
    wo_c = reflect(wi, wh)
    fr_c, pdf_c = _conductor(m, wi, wo_c, n, wh, dpdu, nor)
    lam = (m["type"] == LAMBERTIAN)
    con = (m["type"] == ROUGHCONDUCTOR)
    zero3 = torch.zeros_like(wi)
    wo = torch.where(lam[:, None], wo_l, torch.where(con[:, None], wo_c,
                                                     zero3))
    fr = torch.where(lam[:, None], m["diffuse"] * INV_PI,
                     torch.where(con[:, None], fr_c, zero3))
    pdf = torch.where(lam, pdf_l, torch.where(con, pdf_c, 0.0))
    return wo, fr, pdf


def eval_bsdf(m, wi, wo, nor, dpdu):
    """(fr, pdf) of the pair wi, wo."""
    same = dot(wi, nor) * dot(wo, nor) > 0.0
    fr_l = torch.where(same[:, None], m["diffuse"] * INV_PI, 0.0)
    pdf_l = torch.where(same, torch.abs(dot(wo, nor)) * INV_PI, 0.0)
    n = face_forward(nor, wi)
    fr_c, pdf_c = _conductor(m, wi, wo, n, normalize(wi + wo), dpdu, nor)
    lam = (m["type"] == LAMBERTIAN)
    con = (m["type"] == ROUGHCONDUCTOR)
    fr = torch.where(lam[:, None], fr_l,
                     torch.where(con[:, None], fr_c, torch.zeros_like(wi)))
    pdf = torch.where(lam, pdf_l, torch.where(con, pdf_c, 0.0))
    return fr, pdf
