"""Light tracing: paths start at the lights and splat to the camera.

The port of gpu_pathtracer_tpu/integrators/lt.py (the reference
LightTracing kernel, pathtracer.cu:1246-1389). One light path per lane;
at the emission point and at every scattering event the path connects
to the camera (shade/camera.py::sample_camera) and splats
beta x we x fr x Tr / camera pdf at the raster pixel. The reference's
atomicAdd film (pathtracer.cu:1320-1322) is an accumulating
`index_put_` into a [W*H, 3] film: on the card the adds land in no
fixed order, so a film agrees with another within float32 summation
order, not bit for bit.

Kept from the reference, as the JAX package keeps them: the emission
point splats tr x radiance without the camera importance
(pathtracer.cu:1282-1286); the BSDF is sampled and evaluated with
importance transport (pathtracer.cu:1370); the infinite light is no
source (the pick is clamped to the area lights); material-less hits are
medium interfaces that the path crosses without a bounce, with
INTERFACE_BUDGET extra steps for them in a scene with media.

Random numbers (core/rng.py): the lane id is the path's index within
the iteration (0 .. W*H - 1), so a film does not depend on tiling.
Sites 0-4 are the emission (light pick, triangle u, v, direction u1,
u2); step s reads sites LT_EMIT_DIMS + LT_STEP_DIMS s + k: k = 0-2 the
BSDF's u1-u3, 3 Russian roulette, 4-5 the phase sample, 6 the
homogeneous distance sample. Tracking walks draw at track_tag(s + 1,
TRACK_SAMPLE) for distance sampling and track_tag(s + 1, TRACK_CAMERA)
for the camera connection (step 0: the emission point's). An explicit
primary-sample matrix `psample [LT_EMIT_DIMS + LT_STEP_DIMS * steps, N]`
is read row for row instead of the tag-0 sites.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    TRACK_CAMERA, TRACK_SAMPLE, lane_stream, track_tag,
)
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.common import shadow_transmittance
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

INTERFACE_BUDGET = 8
LT_EMIT_DIMS = 8   # emission sites (5 read)
LT_STEP_DIMS = 8   # sites per step (7 read)


def n_steps(static) -> int:
    """Steps of the light walk: max_depth, plus INTERFACE_BUDGET with
    media."""
    return static.max_depth + (INTERFACE_BUDGET if static.has_media else 0)


def splat(film, raster_x, raster_y, width: int, L, valid):
    """Accumulate L [N, 3] at raster (x, y) of film [W*H, 3] where valid
    and finite (the reference's atomicAdd)."""
    ok = valid & torch.isfinite(L).all(-1)
    # only the splatting lanes add: masked lanes all aimed at one pixel
    # would serialise the card's atomic adds there
    idx = (raster_x.long() + raster_y.long() * width)[ok]
    film.index_put_((idx,), L[ok], accumulate=True)


def connect_camera(scene, static, key, pos, med_idx, active, plain=False):
    """SampleCamera + the transmittance toward the lens. Returns (we,
    1 / pdf, tr [N, 3], raster x, raster y, ok, direction to the
    camera, rays traced: 0-d int64)."""
    eps = scene.epsilon
    ro, sd, st, we, pdf, rx, ry = camera_mod.sample_camera(scene.camera, pos,
                                                           eps)
    ok = active & (pdf != 0.0)
    tr, rays = shadow_transmittance(scene, static, med_idx, ro, sd, st, key,
                                    ok, plain)
    ok = ok & ~is_black(tr)
    return we, 1.0 / torch.clamp_min(pdf, 1e-30), tr, rx, ry, ok, sd, rays


def render_film(scene, static, seed: int, iteration: int, path_ids,
                with_stats: bool = False, psample=None, plain: bool = False):
    """Trace one light path per id of `path_ids` [N]; returns their
    splats as a film [W*H, 3] (and, with_stats, the rays traced: closest
    hits, camera connections and Tr-walk segments, 0-d int64). `plain`
    runs the plain intersection and tracking on any device."""
    n = path_ids.shape[0]
    dev = path_ids.device
    width = static.width
    eps = scene.epsilon
    lanes = path_ids.long()
    film = torch.zeros((static.width * static.height, 3), device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    def key(step, site):
        return TrackKey(seed, iteration, lanes, track_tag(step, site))

    # ---- emission sampling (area.h:21-26; pathtracer.cu:1264-1275) ------
    rng = lane_stream(seed, iteration, lanes, psample, 0, LT_EMIT_DIMS,
                      plain=plain)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    # the infinite light is no source (the reference indexes
    # kernel_lights directly): clamp to the area lights
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    ro, rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, eps)
    med = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if static.has_media:
        med = scene.l_medium[light_idx.long()]

    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    beta = radiance * (torch.abs(dot(rd, l_nor)) / denom)[:, None]
    alive = torch.full((n,), static.n_lights > 0, dtype=torch.bool,
                       device=dev)

    # the emission point's splat (quirk: tr x radiance only,
    # pathtracer.cu:1282-1286)
    _, _, tr0, rx0, ry0, ok0, _, r0 = connect_camera(
        scene, static, key(0, TRACK_CAMERA), ro, med, alive, plain)
    splat(film, rx0, ry0, width, tr0 * radiance, ok0)
    rays = rays + r0

    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    gate = plain or not dev.type == "cuda"
    for it in range(n_steps(static)):
        if gate and not bool(alive.any()):
            break
        rng = lane_stream(seed, iteration, lanes, psample,
                          LT_EMIT_DIMS + it * LT_STEP_DIMS, LT_STEP_DIMS,
                          plain=plain)
        u_bsdf = rng.uniform3()
        u_rr = rng.uniform()
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid

        if static.has_media:
            pu1, pu2 = rng.uniform2()
            u0 = rng.uniform()
            weight, t_med, sampled = media_mod.medium_sample(
                scene, static, med, ro, rd, hit.t, u0,
                key(it + 1, TRACK_SAMPLE), alive, plain)
            beta = torch.where(alive[:, None], beta * weight, beta)
            alive = alive & ~is_black(beta)

            # medium scatter: splat + phase bounce (pathtracer.cu:1306-1330)
            in_scatter = alive & sampled
            sample_pos = ro + rd * t_med[:, None]
            we, inv_pdf, tr, rx, ry, ok, sd, r_c = connect_camera(
                scene, static, key(it + 1, TRACK_CAMERA), sample_pos, med,
                in_scatter, plain)
            rays = rays + r_c
            ph = media_mod.phase(scene, med, -rd, sd)
            splat(film, rx, ry, width,
                  beta * (we * inv_pdf * ph)[:, None] * tr, ok)
            new_dir, _ = media_mod.sample_phase(scene, med, -rd, pu1, pu2)
            ro = torch.where(in_scatter[:, None], sample_pos, ro)
            rd = torch.where(in_scatter[:, None], new_dir, rd)
        else:
            in_scatter = torch.zeros_like(alive)

        # ---- surface ----------------------------------------------------
        on_surface = alive & ~in_scatter
        interface = on_surface & (hit.mat_idx == -1)
        going_out = dot(rd, hit.nor) > 0.0
        side_med = torch.where(going_out, hit.medium_outside,
                               hit.medium_inside)
        med = torch.where(interface, side_med, med)
        ro = torch.where(interface[:, None], hit.pos, ro)
        on_surface = on_surface & ~interface

        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        wi = -rd
        conn = on_surface & ~bsdf_mod.is_delta(mat.type)

        # the camera connection from the surface (pathtracer.cu:1344-1365)
        we, inv_pdf, tr, rx, ry, ok, sd, r_c = connect_camera(
            scene, static, key(it + 1, TRACK_CAMERA), hit.pos, med, conn,
            plain)
        rays = rays + r_c
        fr, _ = bsdf_mod.eval_bsdf(mat, wi, sd, hit.nor, hit.dpdu,
                                   static.material_types, bsdf_mod.IMPORTANCE)
        splat(film, rx, ry, width,
              tr * beta * fr * (we * inv_pdf
                                * torch.abs(dot(sd, hit.nor)))[:, None], ok)

        # the bounce, importance transport (pathtracer.cu:1367-1378)
        wo, fr_s, pdf_s = bsdf_mod.sample_bsdf(
            mat, wi, hit.nor, hit.dpdu, *u_bsdf, static.material_types,
            bsdf_mod.IMPORTANCE)
        dead = on_surface & (is_black(fr_s) | (pdf_s <= 0.0))
        alive = alive & ~dead
        surf_go = on_surface & ~dead
        beta_next = beta * fr_s * torch.abs(dot(wo, hit.nor))[:, None] \
            / torch.clamp_min(pdf_s, 1e-30)[:, None]
        beta = torch.where(surf_go[:, None], beta_next, beta)
        out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                               hit.medium_inside)
        same_side = dot(wi, hit.nor) * dot(wo, hit.nor) > 0.0
        med = torch.where(surf_go, torch.where(same_side, med, out_side), med)
        ro = torch.where(surf_go[:, None], hit.pos, ro)
        rd = torch.where(surf_go[:, None], wo, rd)

        consumed = in_scatter | surf_go
        depth = torch.where(consumed, depth + 1, depth)
        alive = alive & (depth < static.max_depth)

        # Russian roulette (pathtracer.cu:1381-1387)
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = (depth > 4) & alive & consumed
        alive = alive & ~(do_rr & (u_rr < illumate))
        rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
        beta = torch.where((do_rr & alive)[:, None],
                           beta * rr_scale[:, None], beta)

    if with_stats:
        return film, rays
    return film
