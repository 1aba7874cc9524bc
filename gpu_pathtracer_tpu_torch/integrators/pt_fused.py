"""Path-trace megakernel: the whole PT estimator in one CUDA kernel.

The port of gpu_pathtracer_tpu/integrators/pt_fused.py. One thread
traces one path through every bounce (csrc/pt_fused.cu; for scenes of
triangles only without a sky a persistent grid whose threads take the
next lane when their path ends), so the path state never leaves
registers; the plain PyTorch version beside it is the
dense-regime wavefront of integrators/pt.py over the plain intersection
(`render_lanes_torch`). Both read the same random sites (core/rng.py)
and compute the same shading arithmetic; the kernel tests triangles
without dividing (csrc/intersect.cuh::tri_cross_n), so on the same
inputs the two agree lane by lane within PERF.md section 2's radiance
limits.

Primary rays come from the shared plain camera code
(integrators/common.primary_rays), as in the JAX package. Scope
(`supports`): <= DENSE_MAX prims, up to 32 area lights and at least one
light (an area light or the environment), the six material models and
three prim types, with or without textures. The kernel has a variant
per scene kind (environment light or not, textures or not, triangles
only or all prim kinds: `all_kinds`), chosen at launch from the
StaticConfig; each follows the wavefront's estimator,
not the JAX kernel's TPU workarounds (its escape record and mean-texel
fold): the sky is credited on a miss with the wavefront's MIS weight
and sampled by NEE through its slot of the full light CDF.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_BOUNCE_DIMS, PSS_CAM_DIMS, lane_stream,
)
from gpu_pathtracer_tpu_torch.geom.dense import DENSE_MAX, kinds_of
from gpu_pathtracer_tpu_torch.integrators import pt
from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
from gpu_pathtracer_tpu_torch import kernels, telemetry
from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)
from gpu_pathtracer_tpu_torch.shade.lights import n_light_rows

STATS = KernelStats()
MAX_LIGHTS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float


def supports(static) -> bool:
    """Scenes the megakernel covers; the rest run the wavefront (JAX
    pt_fused.py:101-106). All six material models and all three prim
    types are compiled in, textured or not. Scenes with a BSSRDF take the
    wavefront, whose subsurface hook the kernel does not have."""
    return (static.n_primitives <= DENSE_MAX
            and not static.has_bssrdf
            and static.n_lights <= MAX_LIGHTS
            and (static.n_lights >= 1 or static.has_infinite))


def all_kinds(static) -> bool:
    """Whether the kernel's all-kinds variant runs (the scene has spheres
    or lines); else its triangles-only variant."""
    return kernels.all_kinds(kinds_of(static))


def _lib():
    lib = load_library("pt_fused")
    if lib.pt_fused.argtypes is None:
        lib.pt_fused.restype = ctypes.c_int
        lib.pt_fused.argtypes = [
            _P, _P, _P, _I,        # ro, rd, lane ids, n
            _U, _U, _P,            # seed, iteration, psample or NULL
            _P, _I, _P, _P, _P, _I,  # dense_prims, Pp, prim_attrs,
                                     # mats, lights, L
            _P, _I, _F, _I,        # light_cdf, max_depth, eps, aniso
            _P, _I, _I, _P, _P, _P, _F,  # env data, w, h, frame, tmax
            _P, _P, _P, _P,        # tex data, offsets, widths, heights
            _I, _P,                # all kinds, lane counter
            _P, _P, _P]            # li out, rays out, stream
    return lib


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, psample=None):
    """Megakernel PT, same contract as pt.render_lanes. CUDA tensors
    launch the kernel; CPU tensors run `render_lanes_torch`."""
    if not pixel_x.is_cuda:
        return render_lanes_torch(scene, static, seed, iteration, pixel_x,
                                  pixel_y, with_stats, psample)
    with telemetry.span("pt.camera"):
        lanes = pt.lane_ids_of(static, pixel_x, pixel_y)
        rng0 = lane_stream(seed, iteration, lanes, psample, 0, PSS_CAM_DIMS)
        ro, rd = primary_rays(scene, static, rng0, pixel_x, pixel_y)
    with telemetry.span("pt.fused"):
        li, rays = fused_call(scene, static, seed, iteration, lanes, ro, rd,
                              psample)
        if with_stats:
            return li, rays.sum(dtype=torch.int64)
    return li


def fused_call(scene, static, seed, iteration, lanes, ro, rd, psample=None):
    """Launch csrc/pt_fused.cu on primary rays -> (li [N, 3] f32,
    rays [N] i32: closest + shadow rays each lane traced)."""
    dev = ro.device
    n = ro.shape[0]
    ro = ro.contiguous()
    rd = rd.contiguous()
    check_cuda_f32("ro", ro, (n, 3), dev)
    check_cuda_f32("rd", rd, (n, 3), dev)
    lanes = lanes.to(torch.int32).contiguous()
    if lanes.shape != (n,) or lanes.device != dev:
        raise ValueError("lane ids must be [N] on the rays' device")
    if psample is not None:
        need = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
        check_cuda_f32("psample", psample, (None, n), dev)
        if psample.shape[0] < need:
            raise ValueError(f"psample needs {need} rows, got "
                             f"{psample.shape[0]}")
    dp = scene.dense_prims
    check_cuda_f32("dense_prims", dp, (None, 16), dev)
    if dp.shape[0] > DENSE_MAX:
        raise ValueError(f"dense_prims has {dp.shape[0]} > {DENSE_MAX} rows")
    check_cuda_f32("prim_attrs", scene.prim_attrs, (None, 40), dev)
    check_cuda_f32("mat_attrs", scene.mat_attrs, (None, 24), dev)
    rows = n_light_rows(static)
    check_cuda_f32("light_attrs", scene.light_attrs, (rows, 24), dev)
    check_cuda_f32("light_cdf", scene.light_cdf, (rows + 2,), dev)
    if not supports(static):
        raise ValueError(f"{static.n_lights} area lights, environment "
                         f"{static.has_infinite}: the kernel takes 0.."
                         f"{MAX_LIGHTS} area lights and at least one light")
    env = (None, 0, 0, None, None, None, 0.0)
    if static.has_infinite:
        check_cuda_f32("env_data", scene.env_data, (None, None, 3), dev)
        for name in ("env_u", "env_v", "env_w"):
            check_cuda_f32(name, getattr(scene, name), (3,), dev)
        env = (scene.env_data.data_ptr(), scene.env_data.shape[1],
               scene.env_data.shape[0], scene.env_u.data_ptr(),
               scene.env_v.data_ptr(), scene.env_w.data_ptr(),
               2.0 * scene.world_radius - scene.epsilon)
    tex = (None,) * 4
    if static.has_textures:
        check_cuda_f32("tex_data", scene.tex_data, (None, 3), dev,
                       torch.uint8)
        n_tex = scene.tex_offset.shape[0]
        for name in ("tex_offset", "tex_w", "tex_h"):
            check_cuda_f32(name, getattr(scene, name), (n_tex,), dev,
                           torch.int32)
        tex = tuple(t.data_ptr() for t in (scene.tex_data, scene.tex_offset,
                                           scene.tex_w, scene.tex_h))

    li = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rays = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return li, rays
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    rc = _lib().pt_fused(
        ro.data_ptr(), rd.data_ptr(), lanes.data_ptr(), n,
        int(seed) & 0xFFFFFFFF, int(iteration) & 0xFFFFFFFF,
        psample.data_ptr() if psample is not None else None,
        dp.data_ptr(), dp.shape[0], scene.prim_attrs.data_ptr(),
        scene.mat_attrs.data_ptr(), scene.light_attrs.data_ptr(),
        static.n_lights, scene.light_cdf.data_ptr(), static.max_depth,
        float(scene.epsilon), int(static.has_aniso), *env, *tex,
        int(all_kinds(static)), counter.data_ptr(), li.data_ptr(),
        rays.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "pt_fused")
    STATS.launches += 1
    return li, rays


def render_lanes_torch(scene, static, seed: int, iteration: int, pixel_x,
                       pixel_y, with_stats: bool = False, psample=None):
    """The megakernel's plain version: the wavefront of integrators/pt.py
    over the plain PyTorch intersection, on any device."""
    if pixel_x.is_cuda:
        STATS.plain_cuda += 1
    return pt.wavefront(scene, static, seed, iteration, pixel_x, pixel_y,
                        with_stats, psample, plain=True)
