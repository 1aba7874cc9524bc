"""The reference's own reading of a scene file: JSON, OBJ meshes, tables.

A frozen copy of the parts of the program's scene reader that the
benchmark's configurations use (the JSON layout of brickray/
gpu-pathtracer's parsescene.cpp, the OBJ loader with assimp's fan
triangulation and smooth normals, the TRS transform, the per-triangle
shading frame, the light-pick CDF by emitted power and the pinhole
camera at distance 0.1). It reads the scene file and its meshes itself
and keeps the triangles in file order; it builds no acceleration
structure. What a configuration uses beyond this subset (spheres, lines,
textures, media, sky, BSSRDFs, depth of field) is refused, not ignored.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

LUMA = np.array([0.212671, 0.715160, 0.072169])
LAMBERTIAN, ROUGHCONDUCTOR = 0, 4
_BSDF = {"lambertian": LAMBERTIAN, "roughconduct": ROUGHCONDUCTOR}
CAMERA_DISTANCE = 0.1


@dataclass
class Scene:
    """Device tables of one scene, in the reference's dtype."""
    width: int
    height: int
    max_depth: int
    epsilon: float
    integrator: str
    tri: torch.Tensor        # [P, 3, 3] corner positions
    nor: torch.Tensor        # [P, 3, 3] corner normals
    uv: torch.Tensor         # [P, 3, 2]
    dpdv: torch.Tensor       # [P, 3] unit tangent of the shading frame
    mat: torch.Tensor        # [P] int64 material index
    light: torch.Tensor      # [P] int64 area-light index, -1 for none
    m_type: torch.Tensor     # [M] int64
    m_alpha: torch.Tensor    # [M, 2] alphaU, alphaV
    m_k: torch.Tensor        # [M, 3]
    m_eta: torch.Tensor      # [M, 3]
    m_diffuse: torch.Tensor  # [M, 3]
    m_specular: torch.Tensor  # [M, 3]
    l_tri: torch.Tensor      # [L, 3, 3]
    l_nor: torch.Tensor      # [L, 3, 3]
    l_rad: torch.Tensor      # [L, 3]
    cdf: torch.Tensor        # [L + 1] light-pick CDF (float32)
    cam: dict                # camera record, tensors and floats
    has_aniso: bool


def _f3(v):
    return np.asarray(v, np.float32)


def _parse_index(tok, n_v, n_vt, n_vn):
    parts = tok.split("/")
    vi = int(parts[0])
    vi = vi - 1 if vi > 0 else n_v + vi
    ti = ni = -1
    if len(parts) > 1 and parts[1]:
        t = int(parts[1])
        ti = t - 1 if t > 0 else n_vt + t
    if len(parts) > 2 and parts[2]:
        n = int(parts[2])
        ni = n - 1 if n > 0 else n_vn + n
    return vi, ti, ni


def load_obj(path):
    """(positions, normals, uvs) float32 [T, 3, 3 | 2] of an OBJ file."""
    v, vt, vn, faces = [], [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                v.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vt":
                vt.append(tuple(map(float, tok[1:3])))
            elif tok[0] == "vn":
                vn.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "f":
                c = [_parse_index(t, len(v), len(vt), len(vn))
                     for t in tok[1:]]
                faces += [[c[0], c[i], c[i + 1]] for i in range(1, len(c) - 1)]
    v = np.asarray(v, np.float64)
    vt = np.asarray(vt, np.float64).reshape(-1, 2)
    vn = np.asarray(vn, np.float64).reshape(-1, 3)
    fidx = np.asarray(faces, np.int64)
    vi, ti, ni = fidx[:, :, 0], fidx[:, :, 1], fidx[:, :, 2]
    pos = v[vi]
    uv = np.zeros((len(faces), 3, 2))
    if vt.shape[0]:
        uv[ti >= 0] = vt[np.where(ti >= 0, ti, 0)][ti >= 0]
    nor = np.zeros((len(faces), 3, 3))
    if vn.shape[0]:
        nor[ni >= 0] = vn[np.where(ni >= 0, ni, 0)][ni >= 0]
    if not (ni >= 0).all():
        nor[ni < 0] = _smooth_normals(v, vi)[ni < 0]
    ln = np.linalg.norm(nor, axis=-1, keepdims=True)
    nor = np.where(ln > 1e-12, nor / np.maximum(ln, 1e-30), nor)
    return pos.astype(np.float32), nor.astype(np.float32), \
        uv.astype(np.float32)


def _unit(x):
    ln = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.where(ln > 1e-12, x / np.maximum(ln, 1e-30), x)


def _smooth_normals(v, vi):
    """Unit face normals averaged over the corners that share a position."""
    fn = _unit(np.cross(v[vi[:, 1]] - v[vi[:, 0]], v[vi[:, 2]] - v[vi[:, 0]]))
    _, group = np.unique(np.round(v * 1e6).astype(np.int64), axis=0,
                         return_inverse=True)
    group = group.reshape(-1)
    acc = np.zeros((group.max() + 1, 3))
    for c in range(3):
        np.add.at(acc, group[vi[:, c]], fn)
    acc = _unit(acc)
    return np.stack([acc[group[vi[:, c]]] for c in range(3)], 1)


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    m = np.eye(4)
    m[:3, :3] = [[c + x * x * (1 - c), x * y * (1 - c) - z * s,
                  x * z * (1 - c) + y * s],
                 [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                  y * z * (1 - c) - x * s],
                 [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                  c + z * z * (1 - c)]]
    return m


def _trs(unit):
    t = np.eye(4)
    t[:3, 3] = unit.get("translate", [0, 0, 0])
    r = unit.get("rotate", [0, 0, 0])
    s = np.diag([*unit.get("scale", [1, 1, 1]), 1.0])
    return t @ _rot((1, 0, 0), r[0]) @ _rot((0, 1, 0), r[1]) \
        @ _rot((0, 0, 1), r[2]) @ s


def _transform(mesh, trs):
    pos, nor, uv = mesh
    if np.allclose(trs, np.eye(4)):
        return mesh
    p = pos.astype(np.float64) @ trs[:3, :3].T + trs[:3, 3]
    n = _unit(nor.astype(np.float64) @ np.linalg.inv(trs).T[:3, :3].T)
    return p.astype(np.float32), n.astype(np.float32), uv


def _dpdv(pos, uv):
    """Unit dpdv of each triangle from its uvs, else the `w` axis of the
    frame around its geometric normal."""
    e1, e2 = pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]
    d1, d2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    ok = np.abs(det) >= 1e-8
    dpdv = (-d2[:, 0:1] * e1 + d1[:, 0:1] * e2) \
        * (1.0 / np.where(ok, det, 1.0))[:, None]
    nn = np.cross(e1, e2)
    nn /= np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)
    ix = 1.0 / np.sqrt(nn[:, 0] ** 2 + nn[:, 2] ** 2 + 1e-30)
    iy = 1.0 / np.sqrt(nn[:, 1] ** 2 + nn[:, 2] ** 2 + 1e-30)
    wx = np.stack([nn[:, 2] * ix, 0 * ix, -nn[:, 0] * ix], -1)
    wy = np.stack([0 * iy, nn[:, 2] * iy, -nn[:, 1] * iy], -1)
    w = np.where((np.abs(nn[:, 0]) > np.abs(nn[:, 1]))[:, None], wx, wy)
    out = np.where(ok[:, None], dpdv, w)
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True),
                            1e-30)


def _camera(doc, width, height):
    cam = doc["camera"]
    for key in ("environment", "medium"):
        if cam.get(key):
            raise ValueError(f"the reference has no camera {key}")
    if float(cam.get("apertureRadius", 0.0)) > 0.0:
        raise ValueError("the reference renders a pinhole camera only")
    eye, look, up = (_f3(cam.get(k, d)).astype(np.float64) for k, d in (
        ("position", [0, 0, 0]), ("lookat", [0, 0, -1]), ("up", [0, 1, 0])))
    w = eye - look
    w /= np.linalg.norm(w)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    v /= np.linalg.norm(v)
    # float32 first, as the scene's own camera record holds them
    eye, u, v, w = (np.float32(x) for x in (eye, u, v, w))
    half_h = np.tan(np.deg2rad(0.5 * float(cam.get("fov", 60.0)))) \
        * CAMERA_DISTANCE
    half_w = half_h * width / height
    return dict(position=eye, u=u, v=v, w=w, half_w=np.float32(half_w),
                half_h=np.float32(half_h),
                p2s=(np.float32(2.0 * half_w / width),
                     np.float32(2.0 * half_h / height)),
                area=np.float32(4.0 * half_w * half_h),
                res=(float(width), float(height)))


def load(path, device, dtype=torch.float32, size=None) -> Scene:
    """Read the scene file `path` into tables on `device` in `dtype`;
    `size` renders it size x size (tests) in place of its own film."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)
    if doc.get("medium"):
        raise ValueError("the reference has no media")
    width = int(doc.get("screen_width", 512))
    height = int(doc.get("screen_height", 512))
    if size is not None:
        width = height = size
    names, mats = [], []
    for m in doc.get("material", []):
        if "bssrdf" in m or isinstance(m.get("diffuse"), str) \
                or m.get("remap") or m["bsdf"] not in _BSDF:
            raise ValueError(f"the reference has no material like {m}")
        au = av = float(m["alpha"]) if "alpha" in m else None
        if au is None:
            au, av = float(m.get("alphaU", 0.01)), float(m.get("alphaV", 0.01))
        mats.append(dict(type=_BSDF[m["bsdf"]], alpha=(au, av),
                         k=_f3(m.get("k", [0, 0, 0])),
                         eta=_f3(m.get("eta", [0, 0, 0])),
                         diffuse=_f3(m.get("diffuse", [1, 1, 1])),
                         specular=_f3(m.get("specular", [1, 1, 1]))))
        names.append(m["name"])
    meshes = {}

    def mesh_of(unit):
        p = os.path.join(base, unit["mesh"])
        if p not in meshes:
            meshes[p] = load_obj(p)
        return _transform(meshes[p], _trs(unit))

    pos, nor, uv, mat, light = [], [], [], [], []
    lights = []
    for unit in doc.get("scene", []):
        if "mesh" not in unit or unit.get("inside") or unit.get("outside"):
            raise ValueError(f"the reference has triangle meshes only: {unit}")
        p, n, t = mesh_of(unit)
        pos.append(p), nor.append(n), uv.append(t)
        mat.append(np.full(len(p), names.index(unit["material"])))
        light.append(np.full(len(p), -1))
    for unit in doc.get("light", []):
        if "mesh" not in unit or unit.get("medium"):
            raise ValueError(f"the reference has area lights only: {unit}")
        p, n, t = mesh_of(unit)
        pos.append(p), nor.append(n), uv.append(t)
        mat.append(np.full(len(p), names.index(unit.get("material", ""))))
        light.append(len(lights) + np.arange(len(p)))
        rad = _f3(unit.get("radiance", [0, 0, 0]))
        lights += [(p[i], n[i], rad) for i in range(len(p))]
    pos, nor, uv = (np.concatenate(x) for x in (pos, nor, uv))
    if not lights:
        raise ValueError("the reference needs an area light")
    l_tri = np.stack([lt[0] for lt in lights])
    area = 0.5 * np.linalg.norm(np.cross(l_tri[:, 1] - l_tri[:, 0],
                                         l_tri[:, 2] - l_tri[:, 0]), axis=-1)
    powers = [float(LUMA @ (lt[2] * a * np.pi)) for lt, a in zip(lights, area)]
    cs = np.cumsum(powers)
    cdf = np.concatenate([[0.0], cs / (cs[-1] if cs[-1] > 0 else 1.0)])

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    cam = _camera(doc, width, height)
    return Scene(
        width=width, height=height,
        max_depth=int(doc.get("maxDepth", 5)),
        epsilon=float(np.float32(doc.get("epsilon", 1e-3))),
        integrator=doc.get("integrator", "pt"),
        tri=t(pos), nor=t(nor), uv=t(uv), dpdv=t(_dpdv(pos, uv)),
        mat=t(np.concatenate(mat), torch.int64),
        light=t(np.concatenate(light), torch.int64),
        m_type=t([m["type"] for m in mats], torch.int64),
        m_alpha=t([m["alpha"] for m in mats]),
        m_k=t([m["k"] for m in mats]), m_eta=t([m["eta"] for m in mats]),
        m_diffuse=t([m["diffuse"] for m in mats]),
        m_specular=t([m["specular"] for m in mats]),
        l_tri=t(l_tri), l_nor=t(np.stack([lt[1] for lt in lights])),
        l_rad=t(np.stack([lt[2] for lt in lights])),
        cdf=t(cdf.astype(np.float32), torch.float32),
        cam={k: (t(v) if isinstance(v, np.ndarray) and v.ndim else
                 (tuple(float(x) for x in v) if isinstance(v, tuple)
                  else float(v))) for k, v in cam.items()},
        has_aniso=any(m["alpha"][0] != m["alpha"][1] for m in mats))
