"""Wavefront OBJ loader (numpy, no assimp); a copy of the JAX package's.

Reproduces the semantics the reference gets from assimp with
aiProcess_Triangulate | aiProcess_GenSmoothNormals plus its own TRS transform
(reference mesh.cpp:4-91):

- polygon faces are fan-triangulated;
- if the OBJ supplies `vn`, those are used; otherwise smooth normals are
  generated by averaging unit face normals over vertices that share a
  position (assimp GenSmoothNormals with the default "smooth everything"
  angle);
- positions are transformed by the TRS matrix, normals by its
  inverse-transpose (mesh.cpp:49-58);
- missing uv coordinates become (0, 0) (mesh.cpp:42-44).

Returns SoA numpy arrays: one row per triangle corner.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    """Triangle soup: [T, 3, 3] positions/normals, [T, 3, 2] uvs."""
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


def _parse_index(tok: str, n_v: int, n_vt: int, n_vn: int):
    """An OBJ face corner `v[/vt][/vn]` with negative-index support."""
    parts = tok.split("/")
    vi = int(parts[0])
    vi = vi - 1 if vi > 0 else n_v + vi
    ti = -1
    ni = -1
    if len(parts) > 1 and parts[1]:
        t = int(parts[1])
        ti = t - 1 if t > 0 else n_vt + t
    if len(parts) > 2 and parts[2]:
        n = int(parts[2])
        ni = n - 1 if n > 0 else n_vn + n
    return vi, ti, ni


def resolve_path_case(path: str) -> str:
    """Resolve a path case-insensitively (the reference scenes were authored
    on Windows; e.g. cornell_box references Right.obj but ships right.obj)."""
    if os.path.exists(path):
        return path
    d, name = os.path.split(path)
    if os.path.isdir(d):
        lower = name.lower()
        for f in os.listdir(d):
            if f.lower() == lower:
                return os.path.join(d, f)
    return path


def load_obj(path: str) -> TriMesh:
    path = resolve_path_case(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"OBJ file not found: {path}")

    v_list: list[tuple] = []
    vt_list: list[tuple] = []
    vn_list: list[tuple] = []
    faces: list[list[tuple]] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                v_list.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vt":
                vt_list.append((float(tok[1]), float(tok[2])))
            elif key == "vn":
                vn_list.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "f":
                corners = [
                    _parse_index(t, len(v_list), len(vt_list), len(vn_list))
                    for t in tok[1:]
                ]
                # fan triangulation (assimp aiProcess_Triangulate)
                for i in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[i], corners[i + 1]])

    if not faces:
        return TriMesh(
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
        )

    v = np.asarray(v_list, np.float64)
    vt = np.asarray(vt_list, np.float64) if vt_list else np.zeros((0, 2))
    vn = np.asarray(vn_list, np.float64) if vn_list else np.zeros((0, 3))

    fidx = np.asarray(faces, np.int64)            # [T, 3, 3] (v, vt, vn)
    vi = fidx[:, :, 0]
    ti = fidx[:, :, 1]
    ni = fidx[:, :, 2]

    pos = v[vi]                                    # [T, 3, 3]

    # uvs: (0,0) where missing (mesh.cpp:42-44)
    uv = np.zeros((len(faces), 3, 2))
    has_t = ti >= 0
    if vt.shape[0]:
        uv[has_t] = vt[np.where(has_t, ti, 0)][has_t]

    # normals: supplied, else smooth-generated by shared position
    nor = np.zeros((len(faces), 3, 3))
    has_n = ni >= 0
    if vn.shape[0]:
        nor[has_n] = vn[np.where(has_n, ni, 0)][has_n]
    if not has_n.all():
        gen = _gen_smooth_normals(v, vi)
        nor[~has_n] = gen[~has_n]

    # normalize (guard zero-length)
    ln = np.linalg.norm(nor, axis=-1, keepdims=True)
    nor = np.where(ln > 1e-12, nor / np.maximum(ln, 1e-30), nor)

    return TriMesh(
        pos.astype(np.float32), nor.astype(np.float32), uv.astype(np.float32))


def _gen_smooth_normals(v: np.ndarray, vi: np.ndarray) -> np.ndarray:
    """Assimp-style GenSmoothNormals: average unit face normals over shared
    vertex positions. Returns per-corner normals [T, 3, 3]."""
    p0, p1, p2 = v[vi[:, 0]], v[vi[:, 1]], v[vi[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = np.where(ln > 1e-12, fn / np.maximum(ln, 1e-30), fn)

    # vertices sharing an identical position smooth together
    key = np.round(v * 1e6).astype(np.int64)
    _, group = np.unique(key, axis=0, return_inverse=True)

    acc = np.zeros((group.max() + 1 if group.size else 1, 3))
    for c in range(3):
        np.add.at(acc, group[vi[:, c]], fn)
    ln = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = np.where(ln > 1e-12, acc / np.maximum(ln, 1e-30), acc)

    out = np.empty((vi.shape[0], 3, 3))
    for c in range(3):
        out[:, c] = acc[group[vi[:, c]]]
    return out


def trs_matrix(translate, rotate_deg, scale) -> np.ndarray:
    """T*R*S with R = Rx*Ry*Rz applied as successive glm::rotate calls
    (reference parsescene.cpp:349-355: r = rotate(rotate(rotate(I,x),y),z),
    i.e. the final matrix is Rx @ Ry @ Rz)."""
    sx, sy, sz = scale
    s = np.diag([sx, sy, sz, 1.0])
    t = np.eye(4)
    t[:3, 3] = translate

    def rot(axis, deg):
        a = np.deg2rad(deg)
        c, si = np.cos(a), np.sin(a)
        x, y, z = axis
        # glm::rotate (axis-angle, column-major math identical in row form)
        m = np.eye(4)
        m[:3, :3] = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * si, x * z * (1 - c) + y * si],
            [y * x * (1 - c) + z * si, c + y * y * (1 - c), y * z * (1 - c) - x * si],
            [z * x * (1 - c) - y * si, z * y * (1 - c) + x * si, c + z * z * (1 - c)],
        ])
        return m

    r = rot((1, 0, 0), rotate_deg[0]) @ rot((0, 1, 0), rotate_deg[1]) @ rot(
        (0, 0, 1), rotate_deg[2])
    return t @ r @ s


def transform_mesh(mesh: TriMesh, trs: np.ndarray) -> TriMesh:
    """Apply TRS to positions and inverse-transpose to normals
    (reference mesh.cpp:49-60)."""
    if np.allclose(trs, np.eye(4)):
        return mesh
    pos = mesh.positions.astype(np.float64)
    nor = mesh.normals.astype(np.float64)
    p = pos @ trs[:3, :3].T + trs[:3, 3]
    inv_t = np.linalg.inv(trs).T
    n = nor @ inv_t[:3, :3].T
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-30), n)
    return TriMesh(p.astype(np.float32), n.astype(np.float32), mesh.uvs)
