"""Write the torus-knot meshes of scenes/knot_port/.

A (p, q) = (2, 3) torus knot (a trefoil) swept by a circular tube: the
centre line is r = 2 + cos(3 phi), (x, y, z) = (r cos 2 phi,
r sin 2 phi, -sin 3 phi), the tube radius is 0.35, and the tube's frame
is the centre line's Frenet frame (its curvature never vanishes). The
mesh is a closed grid of `n_seg` segments along the knot by `n_ring`
around the tube, two triangles per cell, wound outward, vertices shared
between cells. It is scaled to x, y in [-1, 1] and lifted to stand on
y = 0 (the knot faces +z). The OBJ has `v` and `f` lines only: the
loader generates smooth normals.

    python tools/gen_knot_port.py   # rewrites scenes/knot_port/knot_*.obj

knot_100k.obj is 500 x 100 segments (100,000 triangles), knot_16k.obj
160 x 50 (16,000 triangles). Deterministic: numpy only, 5 decimals.
"""
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "knot_port")
MESHES = {"knot_100k.obj": (500, 100), "knot_16k.obj": (160, 50)}
TUBE = 0.35


def knot_mesh(n_seg: int, n_ring: int):
    """(vertices [n_seg * n_ring, 3] f64, faces [2 * n_seg * n_ring, 3]
    zero-based int) of the tube."""
    phi = 2.0 * np.pi * np.arange(n_seg) / n_seg
    c2, s2, c3, s3 = np.cos(2 * phi), np.sin(2 * phi), np.cos(3 * phi), \
        np.sin(3 * phi)
    r, dr, ddr = 2.0 + c3, -3.0 * s3, -9.0 * c3
    p = np.stack([r * c2, r * s2, -s3], -1)
    d1 = np.stack([dr * c2 - 2 * r * s2, dr * s2 + 2 * r * c2, -3 * c3], -1)
    d2 = np.stack([ddr * c2 - 4 * dr * s2 - 4 * r * c2,
                   ddr * s2 + 4 * dr * c2 - 4 * r * s2, 9 * s3], -1)
    t = d1 / np.linalg.norm(d1, axis=-1, keepdims=True)
    n = d2 - (d2 * t).sum(-1, keepdims=True) * t
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    b = np.cross(t, n)
    th = 2.0 * np.pi * np.arange(n_ring) / n_ring
    out = np.cos(th)[None, :, None] * n[:, None] \
        + np.sin(th)[None, :, None] * b[:, None]
    v = (p[:, None] + TUBE * out).reshape(-1, 3)

    i = np.arange(n_seg)[:, None]
    j = np.arange(n_ring)[None, :]
    a = i * n_ring + j                       # (i, j)
    bj = i * n_ring + (j + 1) % n_ring       # (i, j + 1)
    ci = ((i + 1) % n_seg) * n_ring + (j + 1) % n_ring   # (i + 1, j + 1)
    di = ((i + 1) % n_seg) * n_ring + j      # (i + 1, j)
    f = np.stack([np.stack([a, bj, ci], -1), np.stack([a, ci, di], -1)],
                 2).reshape(-1, 3)

    # outward winding: face normals point away from the centre line
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    centre = np.repeat(p, 2 * n_ring, axis=0)
    assert ((fn * (v[f].mean(1) - centre)).sum(-1) > 0).all()

    lo, hi = v.min(0), v.max(0)
    s = 2.0 / max(hi[0] - lo[0], hi[1] - lo[1])
    v = (v - [0.5 * (lo[0] + hi[0]), lo[1], 0.0]) * s
    return v, f


def obj_text(v: np.ndarray, f: np.ndarray) -> str:
    lines = [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in v]
    lines += [f"f {a} {b} {c}" for a, b, c in f + 1]
    return "\n".join(lines) + "\n"


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    for name, (n_seg, n_ring) in MESHES.items():
        v, f = knot_mesh(n_seg, n_ring)
        with open(os.path.join(OUT, name), "w") as fh:
            fh.write(obj_text(v, f))
        print(f"{name}: {len(v)} vertices, {len(f)} triangles")


if __name__ == "__main__":
    main()
