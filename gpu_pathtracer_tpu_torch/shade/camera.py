"""Camera: primary-ray generation (the reference's camera.h:48-84).

The port of gpu_pathtracer_tpu/shade/camera.py::generate_primary_ray;
the camera record is `flatten.DeviceCamera`.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.vecmath import PI, TWO_PI, normalize


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
