"""Camera: primary rays, and the connection of a point to the lens.

The port of gpu_pathtracer_tpu/shade/camera.py (the reference's
camera.h:48-121): `generate_primary_ray`, and for the light-to-camera
strategies of light tracing and BDPT `sample_camera` (a world point to
its raster pixel, importance and pdf) and `pdf_camera`. The camera
record is `flatten.DeviceCamera`.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.vecmath import (
    PI, TWO_PI, dot, length, normalize, to_local,
)


def generate_primary_ray(cam, x, y, aperture_xy, environment: bool):
    """x/y are continuous pixel coords [N]; aperture_xy is a unit-disk
    sample [N, 2]. Returns (origin[N,3], dir[N,3])."""
    if environment:
        theta = PI * (1.0 - y / cam.resolution[1])
        phi = TWO_PI * (1.0 - x / cam.resolution[0])
        st = torch.sin(theta)
        d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                         st * torch.sin(phi)], -1)
        dirs = d[..., 0:1] * cam.u + d[..., 1:2] * cam.v \
            - d[..., 2:3] * cam.w
        return cam.position.expand(dirs.shape), normalize(dirs)

    xx = x * cam.pixel2screen[0] - cam.half_w
    yy = y * cam.pixel2screen[1] - cam.half_h

    # thin lens (camera.h:63-73); aperture == 0 falls back to pinhole
    ax = aperture_xy[..., 0] * cam.aperture
    ay = aperture_xy[..., 1] * cam.aperture
    dx = cam.ratio * xx - ax
    dy = cam.ratio * yy - ay
    dz = -cam.focal
    dir_lens = dx[..., None] * cam.u + dy[..., None] * cam.v + dz * cam.w
    orig_lens = cam.position + ax[..., None] * cam.u + ay[..., None] * cam.v

    dir_pin = xx[..., None] * cam.u + yy[..., None] * cam.v \
        - cam.distance * cam.w
    orig_pin = cam.position.expand(dir_pin.shape)

    use_lens = cam.aperture > 1e-5
    dirs = torch.where(use_lens, dir_lens, dir_pin)
    orig = torch.where(use_lens, orig_lens, orig_pin)
    return orig, normalize(dirs)


def sample_camera(cam, pos, epsilon):
    """camera.h:86-114: connect world points [N, 3] to the pinhole.

    Returns (ray_o, ray_d, ray_tmax, we [N], pdf [N], raster_x [N] i32,
    raster_y [N] i32); pdf == 0 marks a failed connection (behind the
    camera or off the screen)."""
    d = cam.position - pos
    nd = normalize(d)
    tmax = length(d) - epsilon
    cn = to_local(-nd, cam.u, cam.v, cam.w)
    ok = cn[..., 2] < 0.0
    costheta = -cn[..., 2]
    scale = -cam.distance / torch.where(ok, cn[..., 2], -1.0)
    px = cn[..., 0] * scale / cam.half_w
    py = cn[..., 1] * scale / cam.half_h
    ok = ok & (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    sx = px * 0.5 + 0.5
    sy = py * 0.5 + 0.5
    rx = torch.floor(sx * (cam.resolution[0] - 1.0) + 0.5).to(torch.int32)
    ry = torch.floor(sy * (cam.resolution[1] - 1.0) + 0.5).to(torch.int32)
    pdf = torch.where(ok, dot(d, d) / torch.clamp_min(costheta, 1e-30), 0.0)
    c4 = costheta ** 4
    we = cam.distance * cam.distance / torch.clamp_min(cam.area * c4, 1e-30)
    return pos, nd, tmax, we, pdf, rx, ry


def pdf_camera(cam, d):
    """camera.h:117-121: the pdf of the camera ray along d (camera ->
    point). Returns (pdfA = 1, pdfW)."""
    costheta = dot(d, -cam.w)
    pdf_w = cam.distance * cam.distance / torch.clamp_min(
        cam.area * costheta ** 3, 1e-30)
    return torch.ones_like(costheta), pdf_w
