"""Flatten a HostScene + BVH into device tensors.

The port of gpu_pathtracer_tpu/scene/flatten.py (flatten.py:403-916) for
the fields the path-tracing slice reads: geometry, the BVH node arrays,
materials with their textures (the uint8 atlas `tex_data` and its
per-texture offset and size), area lights, the environment light (its
equirect map `env_data` and frame) and the pick CDF over both, the
camera, the world sphere and the packed tables the kernels take (`dense_prims`, `block_bbox`,
the unified BVH8 table `bvh8_table` with its instance table `bvh8_aux`,
`fused_attrs`, `mat_attrs`, `light_attrs`, plus `prim_attrs`) and the
participating media (flatten.py:617-660, 848-864: the medium records,
also packed one row per medium in `med_table`, the bf16-pair oct-packed density grid and the supervoxel majorant table
that the tracking walk reads). The numpy table code is the JAX
package's, so both packages compute on the same values, and the
dipole BSSRDF records (flatten.py:658-668, one row per BSSRDF, the
prim's index in `prim_attrs` column 32). Not ported, because nothing on the port's path reads
them: the u8 density table `med_density_oct2` (a knob measured negative
on the TPU), the x-pair grid `med_density_pairs` (read only by the JAX
package's `_density`), the corner-packed texture rows `tex_corners`
(128 B per texel for the TPU's row gather; a GPU thread reads its four
texels from `tex_data`) and the mean texels `m_avg_texel` (the JAX
megakernel's stand-in diffuse).

The binary BVH comes from `geom/bvh.load_or_build_bvh`: the native
builder, through the content-addressed disk cache unless `cache` is
false.

Instancing (geom/tlas.py): with `instancing`, repeated meshes become
instances of one BLAS, the prims are laid out (instance, blas-local),
and the binary BVH is a one-leaf stand-in, as in the JAX package
(flatten.py:403-434). The JAX package plans instances on a TPU or under
an environment variable; the port plans them when asked, and
`flatten_scene` asks on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.core.vecmath import LUMA
from gpu_pathtracer_tpu_torch.geom import bvh8 as bvh8_mod
from gpu_pathtracer_tpu_torch.geom import tlas as tlas_mod
from gpu_pathtracer_tpu_torch.geom import blocked_cuda
from gpu_pathtracer_tpu_torch.geom.blocked_cuda import BLOCK
from gpu_pathtracer_tpu_torch.geom.bvh import FlatBVH, load_or_build_bvh
from gpu_pathtracer_tpu_torch.geom.dense_cuda import DENSE_MAX
from gpu_pathtracer_tpu_torch.scene.model import (
    GeometryType, HostScene, IntegratorType, MediumType,
)

LUMA64 = np.array([0.212671, 0.715160, 0.072169])


@dataclass
class DeviceCamera:
    """Camera record (camera.h:8-46, precomputed film constants)."""
    position: torch.Tensor      # [3]
    u: torch.Tensor             # [3]
    v: torch.Tensor             # [3]
    w: torch.Tensor             # [3]
    resolution: torch.Tensor    # [2] (x, y)
    distance: torch.Tensor      # 0-d
    half_w: torch.Tensor        # 0-d: film half-width at `distance`
    half_h: torch.Tensor        # 0-d
    pixel2screen: torch.Tensor  # [2]
    ratio: torch.Tensor         # 0-d: focalDistance / distance
    area: torch.Tensor          # 0-d: 4*half_w*half_h
    aperture: torch.Tensor      # 0-d
    focal: torch.Tensor         # 0-d


@dataclass
class DeviceScene:
    """The slice's scene tensors, all on `device` (layouts as the JAX
    package's DeviceScene)."""
    device: torch.device

    node_bbox_min: torch.Tensor      # [Nn, 3]
    node_bbox_max: torch.Tensor      # [Nn, 3]
    node_second_child: torch.Tensor  # [Nn] i32 (-1 for leaves)
    node_start: torch.Tensor         # [Nn] i32
    node_end: torch.Tensor           # [Nn] i32 (inclusive)

    # primitives, leaf-contiguous BVH order
    prim_type: torch.Tensor          # [P] i32 (GeometryType)
    v0: torch.Tensor                 # [P, 3] tri v0 | line p0 | centre
    v1: torch.Tensor                 # [P, 3] tri v1 | line p1
    v2: torch.Tensor                 # [P, 3] tri v2
    n0: torch.Tensor                 # [P, 3]
    n1: torch.Tensor                 # [P, 3]
    n2: torch.Tensor                 # [P, 3]
    uv0: torch.Tensor                # [P, 2]
    uv1: torch.Tensor                # [P, 2]
    uv2: torch.Tensor                # [P, 2]
    dpdv_unit: torch.Tensor          # [P, 3] shading-frame column
    radius0: torch.Tensor            # [P] sphere radius | line width0
    radius1: torch.Tensor            # [P] line width1
    mat_idx: torch.Tensor            # [P] i32
    light_idx: torch.Tensor          # [P] i32
    bssrdf_idx: torch.Tensor         # [P] i32
    medium_inside: torch.Tensor      # [P] i32
    medium_outside: torch.Tensor     # [P] i32

    m_type: torch.Tensor             # [M] i32
    m_alpha_u: torch.Tensor          # [M]
    m_alpha_v: torch.Tensor          # [M]
    m_inside_ior: torch.Tensor       # [M]
    m_outside_ior: torch.Tensor      # [M]
    m_k: torch.Tensor                # [M, 3]
    m_eta: torch.Tensor              # [M, 3]
    m_diffuse: torch.Tensor          # [M, 3]
    m_specular: torch.Tensor         # [M, 3]
    m_tex_idx: torch.Tensor          # [M] i32 (-1: constant diffuse)

    # textures: one uint8 atlas of linear RGB texels, texture t at rows
    # tex_offset[t] .. + tex_w[t] * tex_h[t] (row 0 = the image's bottom);
    # one dummy texel when the scene has none
    tex_data: torch.Tensor           # [T, 3] u8
    tex_offset: torch.Tensor         # [Nt] i32
    tex_w: torch.Tensor              # [Nt] i32
    tex_h: torch.Tensor              # [Nt] i32

    l_v0: torch.Tensor               # [L, 3]
    l_v1: torch.Tensor               # [L, 3]
    l_v2: torch.Tensor               # [L, 3]
    l_n0: torch.Tensor               # [L, 3]
    l_n1: torch.Tensor               # [L, 3]
    l_n2: torch.Tensor               # [L, 3]
    l_radiance: torch.Tensor         # [L, 3]
    l_medium: torch.Tensor           # [L] i32
    # [L + 2] normalized power CDF, L = max(#area lights, 1); with an
    # environment light its slot follows the area lights'
    light_cdf: torch.Tensor

    # the environment light: equirect map ([1, 1, 3] zeros when the scene
    # has none) and its rotated frame (infinite.h:6-95)
    env_data: torch.Tensor           # [He, We, 3]
    env_u: torch.Tensor              # [3]
    env_v: torch.Tensor              # [3]
    env_w: torch.Tensor              # [3]

    world_center: torch.Tensor       # [3] scene bounding-sphere centre
    world_radius: float

    # [Pp, 16]: v0(3) a(3) b(3) type r0 r1 prim_idx pad(3); a/b = e1/e2
    # for triangles, p1/- for lines; type -1 on the pad rows
    dense_prims: torch.Tensor
    block_bbox: torch.Tensor         # [nb, 8]: min(3) max(3) pad(2)
    # [nb * 8, 8]: the port's sub-boxes, one per 8 rows of dense_prims
    # (geom/blocked_cuda.py::sub_boxes); derived from dense_prims
    block_sub: torch.Tensor
    # [rows, 128]: the unified BVH8 table (geom/bvh8.py; TLAS rows first
    # when instanced, geom/tlas.py)
    bvh8_table: torch.Tensor
    # [n_inst, 20]: world->blas xform(12) root row, slot base, world
    # bbox min(3) max(3) per instance; one zero row when flat
    bvh8_aux: torch.Tensor
    # [P, 40]: v0 v1 v2 | n0 n1 n2 | uv0 uv1 uv2 | dpdv | r0 r1 |
    #   type mat light bssrdf med_in med_out | pad
    prim_attrs: torch.Tensor
    # [Pp, 16]: n0(3) n1(3) n2(3) dpdv(3) mat light type pad
    fused_attrs: torch.Tensor
    # [M, 24]: type aU aV iIOR oIOR | k | eta | diffuse | specular | pad
    mat_attrs: torch.Tensor
    # [L, 24]: v0 v1 v2 | n0 n1 n2 | radiance | medium | area | pick pdf
    light_attrs: torch.Tensor

    # participating media, K = max(#media, 1) records
    med_type: torch.Tensor           # [K] i32 (MediumType)
    med_g: torch.Tensor              # [K] HG asymmetry
    med_sigma_a: torch.Tensor        # [K, 3]
    med_sigma_s: torch.Tensor        # [K, 3]
    med_sigma_t: torch.Tensor        # [K, 3]
    # [K, Dz+1, Dy+1, Dx+1, 4]: the 8 trilinear corners of every cell
    # (zero border), bf16-truncated, two to a float32 carrier
    med_density_oct4: torch.Tensor
    # [K * S1^3] supervoxel majorants (S1 = sv_res(K) + 1, zero border)
    med_sv_max: torch.Tensor
    med_n: torch.Tensor              # [K, 3] i32 grid size (nx, ny, nz)
    med_p0: torch.Tensor             # [K, 3] grid box
    med_p1: torch.Tensor             # [K, 3]
    med_inv_max_density: torch.Tensor  # [K]
    med_eval_tr_type: torch.Tensor   # [K] i32: 0 delta, 1 ratio, 2 residual
    # [K, MED_COLS]: the fields above packed one row per medium
    # (`media_table`); derived, so change media with `replace_media`
    med_table: torch.Tensor

    # dipole BSSRDFs, B = max(#bssrdfs, 1) records (bssrdf.h:18-141)
    b_sigma_a: torch.Tensor          # [B, 3]
    b_sigma_sp: torch.Tensor         # [B, 3] reduced scattering sigma_s'
    b_eta: torch.Tensor              # [B]
    b_g: torch.Tensor                # [B]

    camera: DeviceCamera
    epsilon: float                   # ray offset (pathtracer.cu:38)


@dataclass(frozen=True)
class StaticConfig:
    """Scene facts the integrators branch on (hashable)."""
    width: int
    height: int
    integrator: IntegratorType
    max_depth: int
    max_dist: float        # AO's occlusion distance (maxDist)
    init_radius: float     # SPPM's first photon radius (initRadius)
    photons_per_iteration: int  # SPPM's photons a pass (photonsPerIteration)
    vpl_bias: float        # IR's squared-distance clamp (vplBias)
    n_lights: int          # area lights
    has_infinite: bool     # an environment light
    has_textures: bool
    # sorted material types that carry a texture; no port code reads it,
    # it is kept for field-for-field parity with the JAX package's config
    textured_types: tuple
    has_triangles: bool
    has_spheres: bool
    has_lines: bool
    has_aniso: bool
    filmic: bool
    environment_camera: bool
    n_primitives: int
    n_nodes: int
    material_types: tuple  # sorted tuple of MaterialType ints present
    bvh8_n8: int           # node rows of the unified BVH8 table
    bvh8_rows: int         # all its rows (nodes, leaves, zero row)
    bvh8_tlas_rows: int    # TLAS node rows at its front (0 when flat)
    bvh8_n_inst: int       # instances (0 = flat scene)
    bvh8_stack: int        # stack entries a walk needs (bvh8.stack_bound)
    has_media: bool
    has_hetero: bool
    camera_medium: int     # the medium the camera sits in (-1: vacuum)
    med_iter_max: int      # the tracking walk's draw cap (iterMax)
    has_bssrdf: bool       # a prim carries a BSSRDF (prim_attrs col 32)


def _tri_dpdv(pos: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Per-triangle dpdv column of the shading frame (mesh.h:69-91);
    MakeCoordinate's `w` of the geometric normal when the uv determinant
    is degenerate."""
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = np.abs(det) >= 1e-8
    inv = 1.0 / np.where(ok, det, 1.0)
    dpdv = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv[:, None]

    nn = np.cross(e1, e2)
    nn /= np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)
    use_x = np.abs(nn[:, 0]) > np.abs(nn[:, 1])
    inv_x = 1.0 / np.sqrt(nn[:, 0] ** 2 + nn[:, 2] ** 2 + 1e-30)
    wx = np.stack([nn[:, 2] * inv_x, np.zeros_like(inv_x),
                   -nn[:, 0] * inv_x], -1)
    inv_y = 1.0 / np.sqrt(nn[:, 1] ** 2 + nn[:, 2] ** 2 + 1e-30)
    wy = np.stack([np.zeros_like(inv_y), nn[:, 2] * inv_y,
                   -nn[:, 1] * inv_y], -1)
    w = np.where(use_x[:, None], wx, wy)

    out = np.where(ok[:, None], dpdv, w)
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(ln, 1e-30)).astype(np.float32)


def _prim_fields(scene: HostScene) -> np.ndarray:
    """[P, 7] int64 per primitive: type, tri_index, matIdx, lightIdx,
    bssrdfIdx, mediumInside, mediumOutside."""
    return np.array([(int(p.type), p.tri_index, p.matIdx, p.lightIdx,
                      p.bssrdfIdx, p.mediumInside, p.mediumOutside)
                     for p in scene.primitives], np.int64).reshape(-1, 7)


def _prim_bboxes(scene: HostScene, fields: np.ndarray):
    """Per-primitive AABBs for the BVH build."""
    n = len(scene.primitives)
    bmin = np.empty((n, 3), np.float32)
    bmax = np.empty((n, 3), np.float32)
    tri = fields[:, 0] == int(GeometryType.TRIANGLE)
    pos = scene.tri_positions[fields[tri, 1]]
    bmin[tri] = pos.min(axis=1)
    bmax[tri] = pos.max(axis=1)
    for i in np.nonzero(~tri)[0]:
        p = scene.primitives[i]
        if p.type == GeometryType.SPHERE:
            bmin[i] = p.center - p.radius
            bmax[i] = p.center + p.radius
        else:  # LINE (line.h:15-25)
            w = max(p.width0, p.width1)
            bmin[i] = np.minimum(p.p0, p.p1) - w
            bmax[i] = np.maximum(p.p0, p.p1) + w
    return bmin, bmax


def _oct_pack(med_density: np.ndarray) -> np.ndarray:
    """[K,Dz,Dy,Dx] -> [K,Dz+1,Dy+1,Dx+1,8]: the 8 trilinear corner values
    of every cell, with a zero border so edge taps read 0
    (flatten.py:279-293)."""
    K, Dz, Dy, Dx = med_density.shape
    P = np.zeros((K, Dz + 2, Dy + 2, Dx + 2), np.float32)
    P[:, 1:-1, 1:-1, 1:-1] = med_density
    oct_ = np.empty((K, Dz + 1, Dy + 1, Dx + 1, 8), np.float32)
    c = 0
    for oz in (0, 1):
        for oy in (0, 1):
            for ox in (0, 1):
                oct_[..., c] = P[:, oz:oz + Dz + 1, oy:oy + Dy + 1,
                                 ox:ox + Dx + 1]
                c += 1
    return oct_


def _pack_bf16_pairs(oct_: np.ndarray) -> np.ndarray:
    """[..., 8] f32 -> [..., 4] f32 carriers (flatten.py:324-334): value 2c
    truncated to bf16 in the high 16 bits of carrier c, value 2c+1 in the
    low 16. Truncation rounds the non-negative densities toward zero, so
    a decoded value never exceeds the supervoxel majorant of its f32."""
    u = np.ascontiguousarray(oct_, np.float32).view(np.uint32)
    hi = u[..., 0::2] & np.uint32(0xFFFF0000)
    lo = u[..., 1::2] >> np.uint32(16)
    return (hi | lo).view(np.float32)


SV = 24   # supervoxel grid resolution per axis (flatten.py:337)


def sv_res(n_media: int) -> int:
    """Supervoxel resolution for `n_media` media (flatten.py:343-352): the
    JAX package caps the majorant table at 32,768 entries, its lookup
    kernel's size; the port keeps the cap so the tables are equal."""
    sv = SV
    while n_media * (sv + 1) ** 3 > 256 * 128 and sv > 2:
        sv -= 1
    return sv


def _sv_majorants(med_density: np.ndarray, med_n: np.ndarray) -> np.ndarray:
    """[K,Dz,Dy,Dx] -> [K,SV,SV,SV] local majorants: the max density over
    each supervoxel's region dilated by one fine cell (flatten.py:355-378)."""
    K = med_density.shape[0]
    sv = sv_res(K)
    out = np.zeros((K, sv, sv, sv), np.float32)
    for k in range(K):
        nx, ny, nz = (int(v) for v in med_n[k])
        if nx * ny * nz <= 1:
            continue
        d = med_density[k, :nz, :ny, :nx]
        zs = np.linspace(0, nz, sv + 1)
        ys = np.linspace(0, ny, sv + 1)
        xs = np.linspace(0, nx, sv + 1)
        for iz in range(sv):
            z0, z1 = int(zs[iz]) - 1, int(np.ceil(zs[iz + 1])) + 1
            for iy in range(sv):
                y0, y1 = int(ys[iy]) - 1, int(np.ceil(ys[iy + 1])) + 1
                for ix in range(sv):
                    x0 = int(xs[ix]) - 1
                    x1 = int(np.ceil(xs[ix + 1])) + 1
                    r = d[max(z0, 0):z1, max(y0, 0):y1, max(x0, 0):x1]
                    out[k, iz, iy, ix] = r.max() if r.size else 0.0
    return out


def _media_arrays(scene: HostScene) -> tuple[dict, int]:
    """The media block (flatten.py:617-660, 848-864) -> (arrays, iterMax
    of the walk)."""
    K = max(len(scene.mediums), 1)
    med_type = np.zeros(K, np.int32)
    med_g = np.zeros(K, np.float32)
    med_sa = np.zeros((K, 3), np.float32)
    med_ss = np.zeros((K, 3), np.float32)
    med_n = np.ones((K, 3), np.int32)
    med_p0 = np.zeros((K, 3), np.float32)
    med_p1 = np.ones((K, 3), np.float32)
    med_imd = np.ones(K, np.float32)
    med_ett = np.ones(K, np.int32)
    dz = dy = dx = 1
    for m in scene.mediums:
        if m.type == MediumType.HETEROGENEOUS:
            dz, dy, dx = max(dz, m.nz), max(dy, m.ny), max(dx, m.nx)
    med_density = np.zeros((K, dz, dy, dx), np.float32)
    iter_max = 1000
    for i, m in enumerate(scene.mediums):
        med_type[i] = int(m.type)
        med_g[i] = m.g
        med_sa[i] = m.sigmaA
        med_ss[i] = m.sigmaS
        med_ett[i] = m.evalTransmittanceType
        iter_max = max(iter_max, m.iterMax)
        if m.type == MediumType.HETEROGENEOUS:
            med_n[i] = (m.nx, m.ny, m.nz)
            med_p0[i] = m.p0
            med_p1[i] = m.p1
            med_imd[i] = m.inv_max_density
            med_density[i, :m.nz, :m.ny, :m.nx] = m.density
    arrays = dict(
        med_type=med_type, med_g=med_g, med_sigma_a=med_sa,
        med_sigma_s=med_ss, med_sigma_t=med_sa + med_ss,
        med_density_oct4=_pack_bf16_pairs(_oct_pack(med_density)),
        med_sv_max=_oct_pack(_sv_majorants(med_density, med_n))
        .max(axis=-1).reshape(-1),
        med_n=med_n, med_p0=med_p0, med_p1=med_p1,
        med_inv_max_density=med_imd, med_eval_tr_type=med_ett)
    return arrays, iter_max


def _bssrdf_arrays(scene: HostScene) -> dict:
    """The dipole BSSRDF records (flatten.py:658-668), B = max(#bssrdfs,
    1) rows; the dummy row when there are none."""
    B = max(len(scene.bssrdfs), 1)
    b_sa = np.ones((B, 3), np.float32)
    b_sp = np.ones((B, 3), np.float32)
    b_eta = np.full(B, 1.5, np.float32)
    b_g = np.zeros(B, np.float32)
    for i, b in enumerate(scene.bssrdfs):
        b_sa[i] = b.sigmaA
        b_sp[i] = b.sigmaSP
        b_eta[i] = b.eta
        b_g[i] = b.g
    return dict(b_sigma_a=b_sa, b_sigma_sp=b_sp, b_eta=b_eta, b_g=b_g)


def _texture_arrays(scene: HostScene) -> dict:
    """The texture atlas (flatten.py:512-533): every texture's texels
    one after another, with each texture's first row and size."""
    if not scene.textures:
        return dict(tex_data=np.zeros((1, 3), np.uint8),
                    tex_offset=np.zeros(1, np.int32),
                    tex_w=np.ones(1, np.int32), tex_h=np.ones(1, np.int32))
    sizes = [t.width * t.height for t in scene.textures]
    return dict(
        tex_data=np.concatenate([t.data.reshape(-1, 3)
                                 for t in scene.textures]),
        tex_offset=np.concatenate([[0], np.cumsum(sizes)[:-1]])
        .astype(np.int32),
        tex_w=np.asarray([t.width for t in scene.textures], np.int32),
        tex_h=np.asarray([t.height for t in scene.textures], np.int32))


def _env_arrays(scene: HostScene) -> dict:
    """The environment map and frame (flatten.py:605-615)."""
    inf = scene.infinite
    if inf is None:
        return dict(env_data=np.zeros((1, 1, 3), np.float32),
                    env_u=np.array([1, 0, 0], np.float32),
                    env_v=np.array([0, 1, 0], np.float32),
                    env_w=np.array([0, 0, 1], np.float32))
    return dict(env_data=inf.data, env_u=inf.u, env_v=inf.v, env_w=inf.w)


def flatten_numpy(scene: HostScene, instancing: bool = False,
                  cache: bool = True) -> tuple[dict, dict]:
    """HostScene -> (arrays, static): the DeviceScene fields as numpy
    arrays (camera fields under "camera") and the StaticConfig fields
    (all but `bvh8_stack`, which device_scene_from_numpy derives).
    `instancing` plans TLAS/BLAS instances (geom/tlas.py); `cache` reads
    and writes the BVH disk cache. The TLAS plan or the binary BVH, and
    the BVH8 table, are each a set-up span "scene.bvh"."""
    fields = _prim_fields(scene)
    bmin, bmax = _prim_bboxes(scene, fields)
    with telemetry.span("scene.bvh"):
        plan = tlas_mod.plan_instances(scene, bmin, bmax, cache) \
            if instancing else None
        bvh = load_or_build_bvh(bmin, bmax, cache=cache) if plan is None \
            else None
    if plan is None:
        order = bvh.prim_order
    else:
        # one-leaf stand-in: its prim order is the instanced slot layout
        order = plan.order
        bvh = FlatBVH(
            bbox_min=bmin.min(0)[None], bbox_max=bmax.max(0)[None],
            is_leaf=np.ones(1, bool), second_child=np.full(1, -1, np.int32),
            start=np.zeros(1, np.int32),
            end=np.asarray([order.shape[0] - 1], np.int32),
            prim_order=order)
    P = order.shape[0]

    of = fields[order]
    prim_type = of[:, 0].astype(np.int32)
    mat_idx, light_idx, bssrdf_idx, medium_inside, medium_outside = (
        of[:, k].astype(np.int32) for k in range(2, 7))
    v0 = np.zeros((P, 3), np.float32)
    v1 = np.zeros((P, 3), np.float32)
    v2 = np.zeros((P, 3), np.float32)
    n0 = np.zeros((P, 3), np.float32)
    n1 = np.zeros((P, 3), np.float32)
    n2 = np.zeros((P, 3), np.float32)
    uv0 = np.zeros((P, 2), np.float32)
    uv1 = np.zeros((P, 2), np.float32)
    uv2 = np.zeros((P, 2), np.float32)
    radius0 = np.zeros(P, np.float32)
    radius1 = np.zeros(P, np.float32)

    is_tri = prim_type == int(GeometryType.TRIANGLE)
    for slot in np.nonzero(~is_tri)[0]:
        p = scene.primitives[order[slot]]
        if p.type == GeometryType.SPHERE:
            v0[slot] = p.center
            radius0[slot] = p.radius
        else:
            v0[slot] = p.p0
            v1[slot] = p.p1
            radius0[slot] = p.width0
            radius1[slot] = p.width1

    dpdv = np.zeros((P, 3), np.float32)
    if is_tri.any():
        ts = np.nonzero(is_tri)[0]
        tr = of[ts, 1]
        pos = scene.tri_positions[tr]
        nor = scene.tri_normals[tr]
        uvs = scene.tri_uvs[tr]
        v0[ts], v1[ts], v2[ts] = pos[:, 0], pos[:, 1], pos[:, 2]
        n0[ts], n1[ts], n2[ts] = nor[:, 0], nor[:, 1], nor[:, 2]
        uv0[ts], uv1[ts], uv2[ts] = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        dpdv[ts] = _tri_dpdv(pos, uvs)

    # ---- materials ----------------------------------------------------
    M = max(len(scene.materials), 1)
    m_type = np.zeros(M, np.int32)
    m_alpha_u = np.full(M, 0.01, np.float32)
    m_alpha_v = np.full(M, 0.01, np.float32)
    m_inside = np.ones(M, np.float32)
    m_outside = np.ones(M, np.float32)
    m_k = np.zeros((M, 3), np.float32)
    m_eta = np.zeros((M, 3), np.float32)
    m_diffuse = np.ones((M, 3), np.float32)
    m_specular = np.ones((M, 3), np.float32)
    m_tex = np.full(M, -1, np.int32)
    for i, m in enumerate(scene.materials):
        m_type[i] = int(m.type)
        m_alpha_u[i] = m.alphaU
        m_alpha_v[i] = m.alphaV
        m_inside[i] = m.insideIOR
        m_outside[i] = m.outsideIOR
        m_k[i] = m.k
        m_eta[i] = m.eta
        m_diffuse[i] = m.diffuse
        m_specular[i] = m.specular
        m_tex[i] = m.textureIdx

    # ---- lights -------------------------------------------------------
    L = max(len(scene.lights), 1)
    l_v0 = np.zeros((L, 3), np.float32)
    l_v1 = np.zeros((L, 3), np.float32)
    l_v2 = np.zeros((L, 3), np.float32)
    l_n0 = np.zeros((L, 3), np.float32)
    l_n1 = np.zeros((L, 3), np.float32)
    l_n2 = np.zeros((L, 3), np.float32)
    l_rad = np.zeros((L, 3), np.float32)
    l_med = np.full(L, -1, np.int32)
    for i, lt in enumerate(scene.lights):
        l_v0[i], l_v1[i], l_v2[i] = scene.tri_positions[lt.tri_index]
        l_n0[i], l_n1[i], l_n2[i] = scene.tri_normals[lt.tri_index]
        l_rad[i] = lt.radiance
        l_med[i] = lt.medium

    # world bounding sphere from the BVH root box (bbox.h:98-101)
    rb_min, rb_max = bvh.root_box
    center = 0.5 * (rb_min + rb_max)
    radius = float(np.linalg.norm(rb_max - center))

    # light-pick CDF (scene.h:64-82); the environment's power reads its
    # texel [0, 0] (the reference's quirk, infinite.h:43-45: GetPower()
    # reads data[0])
    powers = []
    for i, lt in enumerate(scene.lights):
        area = 0.5 * np.linalg.norm(np.cross(l_v1[i] - l_v0[i],
                                             l_v2[i] - l_v0[i]))
        powers.append(float(LUMA64 @ (lt.radiance * area * np.pi)))
    if scene.infinite is not None:
        p_inf = 4.0 * np.pi * radius * radius * scene.infinite.data[0, 0]
        powers.append(float(LUMA64 @ p_inf))
    cdf = np.zeros(L + 2, np.float64)
    if powers:
        cs = np.cumsum(powers)
        total = cs[-1] if cs[-1] > 0 else 1.0
        cdf[1:1 + len(powers)] = cs / total
        cdf[1 + len(powers):] = 1.0

    # ---- camera (camera.h:31-46, distance=0.1 per main.cpp:270) -------
    cam = scene.camera
    half_h = np.tan(np.deg2rad(0.5 * cam.fov)) * cam.distance
    half_w = half_h * scene.width / scene.height
    f32 = np.float32
    camera = dict(
        position=np.asarray(cam.position, f32), u=np.asarray(cam.u, f32),
        v=np.asarray(cam.v, f32), w=np.asarray(cam.w, f32),
        resolution=np.asarray([scene.width, scene.height], f32),
        distance=f32(cam.distance), half_w=f32(half_w), half_h=f32(half_h),
        pixel2screen=np.asarray([2.0 * half_w / scene.width,
                                 2.0 * half_h / scene.height], f32),
        ratio=f32(cam.focalDistance / cam.distance),
        area=f32(4.0 * half_w * half_h), aperture=f32(cam.apertureRadius),
        focal=f32(cam.focalDistance))

    # dense-intersection table (type -1 pad rows never match); the row
    # counts follow the JAX package so the tables compare field by field
    Pp = (P + 7) // 8 * 8 if P <= DENSE_MAX else (P + 63) // 64 * 64
    dense_prims = np.zeros((Pp, 16), np.float32)
    dense_prims[P:, 9] = -1.0
    is_tri_col = (prim_type == int(GeometryType.TRIANGLE))[:, None]
    dense_prims[:P, 0:3] = v0
    dense_prims[:P, 3:6] = np.where(is_tri_col, v1 - v0, v1)
    dense_prims[:P, 6:9] = np.where(is_tri_col, v2 - v0, 0.0)
    dense_prims[:P, 9] = prim_type
    dense_prims[:P, 10] = radius0
    dense_prims[:P, 11] = radius1
    dense_prims[:P, 12] = np.arange(P)

    # block-culling bbox table over 64-prim runs of the leaf order
    pb_min = np.where(
        np.arange(Pp)[:, None] < P,
        np.concatenate([bmin[order], np.zeros((Pp - P, 3), np.float32)]),
        np.inf)
    pb_max = np.where(
        np.arange(Pp)[:, None] < P,
        np.concatenate([bmax[order], np.zeros((Pp - P, 3), np.float32)]),
        -np.inf)
    nb = (Pp + BLOCK - 1) // BLOCK
    pad_rows = nb * BLOCK - Pp
    pb_min = np.concatenate(
        [pb_min, np.full((pad_rows, 3), np.inf, np.float32)])
    pb_max = np.concatenate(
        [pb_max, np.full((pad_rows, 3), -np.inf, np.float32)])
    block_bbox = np.zeros((nb, 8), np.float32)
    block_bbox[:, 0:3] = pb_min.reshape(nb, BLOCK, 3).min(axis=1)
    block_bbox[:, 3:6] = pb_max.reshape(nb, BLOCK, 3).max(axis=1)

    # the unified BVH8 table (geom/bvh8.py), instanced when planned
    with telemetry.span("scene.bvh"):
        if plan is None:
            bvh8_table, bvh8_n8 = bvh8_mod.build_bvh8(bvh, dense_prims[:P])
            bvh8_aux = np.zeros((1, tlas_mod.AUX_COLS), np.float32)
            bvh8_tlas_rows = bvh8_n_inst = 0
        else:
            bvh8_table, bvh8_n8, bvh8_aux, bvh8_tlas_rows = \
                tlas_mod.build_instanced_table(plan, dense_prims[:P], bmin,
                                               bmax)
            bvh8_n_inst = plan.n_inst

    prim_attrs = np.zeros((P, 40), np.float32)
    prim_attrs[:, 0:3] = v0
    prim_attrs[:, 3:6] = v1
    prim_attrs[:, 6:9] = v2
    prim_attrs[:, 9:12] = n0
    prim_attrs[:, 12:15] = n1
    prim_attrs[:, 15:18] = n2
    prim_attrs[:, 18:20] = uv0
    prim_attrs[:, 20:22] = uv1
    prim_attrs[:, 22:24] = uv2
    prim_attrs[:, 24:27] = dpdv
    prim_attrs[:, 27] = radius0
    prim_attrs[:, 28] = radius1
    prim_attrs[:, 29] = prim_type
    prim_attrs[:, 30] = mat_idx
    prim_attrs[:, 31] = light_idx
    prim_attrs[:, 32] = bssrdf_idx
    prim_attrs[:, 33] = medium_inside
    prim_attrs[:, 34] = medium_outside

    fused_attrs = np.zeros((Pp, 16), np.float32)
    fused_attrs[:P, 0:3] = n0
    fused_attrs[:P, 3:6] = n1
    fused_attrs[:P, 6:9] = n2
    fused_attrs[:P, 9:12] = dpdv
    fused_attrs[:P, 12] = mat_idx
    fused_attrs[:P, 13] = light_idx
    fused_attrs[:P, 14] = prim_type
    fused_attrs[P:, 12:14] = -1.0

    mat_attrs = np.zeros((M, 24), np.float32)
    mat_attrs[:, 0] = m_type
    mat_attrs[:, 1] = m_alpha_u
    mat_attrs[:, 2] = m_alpha_v
    mat_attrs[:, 3] = m_inside
    mat_attrs[:, 4] = m_outside
    mat_attrs[:, 5:8] = m_k
    mat_attrs[:, 8:11] = m_eta
    mat_attrs[:, 11:14] = m_diffuse
    mat_attrs[:, 14:17] = m_specular
    mat_attrs[:, 17] = m_tex

    light_attrs = np.zeros((L, 24), np.float32)
    light_attrs[:, 0:3] = l_v0
    light_attrs[:, 3:6] = l_v1
    light_attrs[:, 6:9] = l_v2
    light_attrs[:, 9:12] = l_n0
    light_attrs[:, 12:15] = l_n1
    light_attrs[:, 15:18] = l_n2
    light_attrs[:, 18:21] = l_rad
    light_attrs[:, 21] = l_med
    light_attrs[:, 22] = 0.5 * np.linalg.norm(
        np.cross(l_v1 - l_v0, l_v2 - l_v0), axis=-1)
    light_attrs[:, 23] = (cdf[1:L + 1] - cdf[0:L]).astype(np.float32)

    med_arrays, iter_max = _media_arrays(scene)
    arrays = dict(
        node_bbox_min=bvh.bbox_min, node_bbox_max=bvh.bbox_max,
        node_second_child=bvh.second_child, node_start=bvh.start,
        node_end=bvh.end,
        prim_type=prim_type, v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
        uv0=uv0, uv1=uv1, uv2=uv2, dpdv_unit=dpdv,
        radius0=radius0, radius1=radius1, mat_idx=mat_idx,
        light_idx=light_idx, bssrdf_idx=bssrdf_idx,
        medium_inside=medium_inside, medium_outside=medium_outside,
        m_type=m_type, m_alpha_u=m_alpha_u, m_alpha_v=m_alpha_v,
        m_inside_ior=m_inside, m_outside_ior=m_outside, m_k=m_k,
        m_eta=m_eta, m_diffuse=m_diffuse, m_specular=m_specular,
        m_tex_idx=m_tex, **_texture_arrays(scene), **_env_arrays(scene),
        l_v0=l_v0, l_v1=l_v1, l_v2=l_v2, l_n0=l_n0, l_n1=l_n1, l_n2=l_n2,
        l_radiance=l_rad, l_medium=l_med,
        light_cdf=cdf.astype(np.float32),
        world_center=center, world_radius=np.float32(radius),
        dense_prims=dense_prims, block_bbox=block_bbox,
        bvh8_table=bvh8_table, bvh8_aux=bvh8_aux,
        prim_attrs=prim_attrs, fused_attrs=fused_attrs,
        mat_attrs=mat_attrs, light_attrs=light_attrs,
        camera=camera, epsilon=np.float32(scene.epsilon), **med_arrays,
        **_bssrdf_arrays(scene))
    static = dict(
        width=scene.width, height=scene.height,
        integrator=scene.integrator.type,
        max_depth=scene.integrator.maxDepth,
        max_dist=scene.integrator.maxDist,
        init_radius=scene.integrator.initRadius,
        photons_per_iteration=scene.integrator.photonsPerIteration,
        vpl_bias=scene.integrator.vplBias,
        n_lights=len(scene.lights),
        has_infinite=scene.infinite is not None,
        has_textures=bool(scene.textures),
        textured_types=tuple(sorted({int(m.type) for m in scene.materials
                                     if m.textureIdx >= 0})),
        has_triangles=bool((prim_type == int(GeometryType.TRIANGLE)).any()),
        has_spheres=bool((prim_type == int(GeometryType.SPHERE)).any()),
        has_lines=bool((prim_type == int(GeometryType.LINE)).any()),
        has_aniso=any(m.alphaU != m.alphaV for m in scene.materials),
        filmic=scene.camera.filmic,
        environment_camera=scene.camera.environment,
        n_primitives=P, n_nodes=bvh.n_nodes,
        material_types=tuple(sorted({int(m.type)
                                     for m in scene.materials})),
        bvh8_n8=bvh8_n8, bvh8_rows=int(bvh8_table.shape[0]),
        bvh8_tlas_rows=bvh8_tlas_rows, bvh8_n_inst=bvh8_n_inst,
        has_media=bool(scene.mediums),
        has_hetero=any(m.type == MediumType.HETEROGENEOUS
                       for m in scene.mediums),
        camera_medium=scene.camera.medium, med_iter_max=iter_max,
        has_bssrdf=bool(scene.bssrdfs) and bool((bssrdf_idx >= 0).any()))
    return arrays, static


MED_COLS = 24   # media_table: type g | sigma_a | sigma_s | sigma_t |
                # 1/max d | ett | p0 | p1 | n | luma sigma_t | pad


def _luma_sigma(sigma_t):
    """The luminance of sigma_t, the rate of distance sampling (>= 1e-12;
    media.py:361)."""
    return torch.clamp_min(sigma_t[..., 0] * LUMA[0] + sigma_t[..., 1]
                           * LUMA[1] + sigma_t[..., 2] * LUMA[2], 1e-12)


def media_table(f: dict) -> torch.Tensor:
    """[K, MED_COLS] float32 from the med_* tensors of `f` (field name ->
    tensor): one packed row per medium, the layout that shade/media.py::
    gather_medium and csrc/track.cu read."""
    k = f["med_type"].shape[0]
    return torch.cat([
        f["med_type"][:, None].float(), f["med_g"][:, None],
        f["med_sigma_a"], f["med_sigma_s"], f["med_sigma_t"],
        f["med_inv_max_density"][:, None],
        f["med_eval_tr_type"][:, None].float(), f["med_p0"], f["med_p1"],
        f["med_n"].float(), _luma_sigma(f["med_sigma_t"])[:, None],
        torch.zeros((k, 1), device=f["med_g"].device)], 1).contiguous()


def replace_media(scene: DeviceScene, **changes) -> DeviceScene:
    """`scene` with some med_* fields replaced and `med_table` rebuilt."""
    s = dataclasses.replace(scene, **changes)
    return dataclasses.replace(s, med_table=media_table(vars(s)))


def device_scene_from_numpy(arrays: dict, static: dict, device
                            ) -> tuple[DeviceScene, StaticConfig]:
    """Build the port's (DeviceScene, StaticConfig) from numpy fields.

    `arrays` maps DeviceScene field names to arrays (the camera's fields
    as a dict under "camera"); `static` maps StaticConfig field names to
    values. Extra keys are ignored, so the JAX package's DeviceScene and
    StaticConfig, read out field by field, carry across as they are.
    `bvh8_stack` is computed here from the BVH8 table.
    """
    device = torch.device(device)

    def tensor(a):
        a = np.array(a)   # a writable copy
        dtype = (torch.uint8 if a.dtype == np.uint8 else torch.int32
                 if a.dtype.kind in "iu" else torch.float32)
        return torch.as_tensor(a, dtype=dtype, device=device)

    cam = DeviceCamera(**{f.name: tensor(arrays["camera"][f.name])
                          for f in dataclasses.fields(DeviceCamera)})
    fields = {}
    for f in dataclasses.fields(DeviceScene):
        if f.name == "device":
            fields[f.name] = device
        elif f.name == "camera":
            fields[f.name] = cam
        elif f.name in ("world_radius", "epsilon"):
            fields[f.name] = float(np.float32(arrays[f.name]))
        elif f.name not in ("med_table", "block_sub"):
            fields[f.name] = tensor(arrays[f.name])
    fields["med_table"] = media_table(fields)
    fields["block_sub"] = blocked_cuda.sub_boxes(
        fields["dense_prims"], fields["block_bbox"].shape[0])
    st = {f.name: static[f.name] for f in dataclasses.fields(StaticConfig)
          if f.name != "bvh8_stack"}
    st["bvh8_stack"] = bvh8_mod.stack_bound(
        np.asarray(arrays["bvh8_table"]), np.asarray(arrays["bvh8_aux"]),
        int(st["bvh8_n_inst"]))
    st["integrator"] = IntegratorType(int(st["integrator"]))
    for name in ("material_types", "textured_types"):
        st[name] = tuple(int(t) for t in st[name])
    return DeviceScene(**fields), StaticConfig(**st)


def flatten_scene(scene: HostScene, device, instancing: bool | None = None,
                  cache: bool = True) -> tuple[DeviceScene, StaticConfig]:
    """HostScene -> (DeviceScene on `device`, StaticConfig). Repeated
    meshes are instanced when `instancing` is true; None means "when
    `device` is a CUDA device". `cache` false builds every BVH anew,
    without reading or writing the disk cache. Set-up spans:
    "scene.flatten" (flatten_numpy, its "scene.bvh" spans inside) and
    "scene.upload"."""
    device = torch.device(device)
    if instancing is None:
        instancing = device.type == "cuda"
    with telemetry.span("scene.flatten"):
        arrays, static = flatten_numpy(scene, instancing, cache)
    with telemetry.span("scene.upload"):
        return device_scene_from_numpy(arrays, static, device)
