"""Write the self-contained Cornell box of scenes/cornell_port/.

The room follows the frame of scenes/mlt_slit (x, z in [-1, 1], y in
[0, 2]); the boxes, light quad, camera and radiance follow Benedikt
Bitterli's public "cornell-box" scene (short box centred at
(0.33, 0.3, 0.37), half size 0.3; tall box at (-0.34, 0.6, -0.29), half
size 0.3 x 0.6 x 0.3; light 0.47 x 0.38 at y = 1.98). Every face is an
OBJ quad with a flat `vn` and unit `vt` corners. `light_grid.obj` is the
same light rectangle cut into 6 x 6 quads (72 emitting triangles, the
light set of scenes/cornell_port/many_lights.json).

    python tools/gen_cornell_port.py      # rewrites scenes/cornell_port/*.obj
"""
import math
import os

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "cornell_port")


def _fmt(x):
    return f"{x:.6f}".rstrip("0").rstrip(".") if x != 0 else "0"


def _obj(quads):
    """quads: [(p0, p1, p2, p3, normal)] -> OBJ text (two tris each)."""
    lines = []
    for qi, (p0, p1, p2, p3, nor) in enumerate(quads):
        for p in (p0, p1, p2, p3):
            lines.append("v " + " ".join(_fmt(c) for c in p))
        lines.append("vn " + " ".join(_fmt(c) for c in nor))
        for uv in ((0, 0), (1, 0), (1, 1), (0, 1)):
            lines.append(f"vt {uv[0]} {uv[1]}")
        a, b, c, d = (4 * qi + k for k in range(1, 5))
        n = qi + 1
        lines.append(f"f {a}/{a}/{n} {b}/{b}/{n} {c}/{c}/{n}")
        lines.append(f"f {a}/{a}/{n} {c}/{c}/{n} {d}/{d}/{n}")
    return "\n".join(lines) + "\n"


def _box(center, half, yaw_deg):
    """Five faces (no bottom) of a box rotated by yaw about +y."""
    cx, cy, cz = center
    hx, hy, hz = half
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    ax = (c, 0.0, s)        # local x in world
    az = (-s, 0.0, c)       # local z in world

    def p(lx, ly, lz):
        return (cx + lx * ax[0] + lz * az[0], cy + ly,
                cz + lx * ax[2] + lz * az[2])

    def neg(v):
        return tuple(-x for x in v)

    return [
        (p(-hx, hy, -hz), p(hx, hy, -hz), p(hx, hy, hz), p(-hx, hy, hz),
         (0.0, 1.0, 0.0)),
        (p(hx, -hy, -hz), p(hx, -hy, hz), p(hx, hy, hz), p(hx, hy, -hz),
         ax),
        (p(-hx, -hy, hz), p(-hx, -hy, -hz), p(-hx, hy, -hz), p(-hx, hy, hz),
         neg(ax)),
        (p(hx, -hy, hz), p(-hx, -hy, hz), p(-hx, hy, hz), p(hx, hy, hz),
         az),
        (p(-hx, -hy, -hz), p(hx, -hy, -hz), p(hx, hy, -hz), p(-hx, hy, -hz),
         neg(az)),
    ]


LIGHT = ((-0.24, 1.98, -0.22), (0.23, 1.98, 0.16))   # x, z corners at y


def _light_grid(n):
    """The light rectangle as n x n quads facing down."""
    (x0, y, z0), (x1, _, z1) = LIGHT
    xs = [x0 + (x1 - x0) * i / n for i in range(n + 1)]
    zs = [z0 + (z1 - z0) * i / n for i in range(n + 1)]
    return [((xs[i], y, zs[j]), (xs[i + 1], y, zs[j]),
             (xs[i + 1], y, zs[j + 1]), (xs[i], y, zs[j + 1]), (0, -1, 0))
            for j in range(n) for i in range(n)]


MESHES = {
    "floor.obj": [((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1),
                   (0, 1, 0))],
    "ceiling.obj": [((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1),
                     (0, -1, 0))],
    "back.obj": [((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1),
                  (0, 0, 1))],
    "left.obj": [((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1),
                  (1, 0, 0))],
    "right.obj": [((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1),
                   (-1, 0, 0))],
    "light.obj": _light_grid(1),
    "light_grid.obj": _light_grid(6),
    "shortbox.obj": _box((0.33, 0.3, 0.37), (0.3, 0.3, 0.3), 16.6),
    "tallbox.obj": _box((-0.34, 0.6, -0.29), (0.3, 0.6, 0.3), 19.2),
}


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, quads in MESHES.items():
        with open(os.path.join(OUT, name), "w") as f:
            f.write(_obj(quads))
        print(f"wrote {os.path.join(OUT, name)} ({2 * len(quads)} tris)")


if __name__ == "__main__":
    main()
