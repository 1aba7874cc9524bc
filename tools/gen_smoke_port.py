"""Write scenes/smoke_port/: smoke and fog in the Cornell room.

The room is scenes/cornell_port's five walls and light (its meshes are
referenced, not copied), without the two boxes. Two media:

- "smoke", heterogeneous: a rising plume on a 100 x 100 x 40 grid (x, y,
  z), the dimensions of the reference's cornell_box smoke. Its density is
  a Gaussian tube around a swaying centre line that widens and thins
  with height, times smooth seeded noise, scaled to a maximum of 1; the
  mean over the grid comes out near 0.05 of the maximum, like the
  reference smoke. It sits in `box.obj`, a material-less box with
  `"inside": "smoke"` (a medium interface), in the back left of the room.
  sigma_a = 2, sigma_s = 13 in every channel, ratio tracking (the
  reference's default `evalTransmittanceType` 1).
- "fog", homogeneous, Henyey-Greenstein g = 0.6, inside a material-less
  sphere in the front right.

    python tools/gen_smoke_port.py   # rewrites scenes/smoke_port/

The grid is written as text, one value per line at 4 decimals, in the
reference's order d[z * ny * nx + y * nx + x] (medium.h:174-177).
Deterministic: numpy only, seed 7.
"""
import json
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "smoke_port")
NX, NY, NZ = 100, 100, 40
P0 = (-0.85, 0.02, -0.85)    # the smoke box: clear of the floor and walls
P1 = (0.15, 1.9, -0.05)
SEED = 7


def _smooth_noise(rng, shape, cells):
    """Trilinearly upsampled uniform noise in [0, 1) on a `cells`-per-axis
    lattice, sampled at the centres of a grid of `shape` (z, y, x)."""
    lat = rng.random((cells + 1,) * 3)
    axes = [(np.arange(n) + 0.5) / n * cells for n in shape]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    iz, iy, ix = (np.minimum(a.astype(int), cells - 1) for a in (z, y, x))
    fz, fy, fx = z - iz, y - iy, x - ix
    out = np.zeros(shape)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (fz if dz else 1 - fz) * (fy if dy else 1 - fy) \
                    * (fx if dx else 1 - fx)
                out += w * lat[iz + dz, iy + dy, ix + dx]
    return out


def plume_density(seed: int = SEED) -> np.ndarray:
    """[NZ, NY, NX] float32 density in [0, 1]."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid((np.arange(NZ) + 0.5) / NZ,
                          (np.arange(NY) + 0.5) / NY,
                          (np.arange(NX) + 0.5) / NX, indexing="ij")
    # centre line sways in x and z as it rises; the tube widens with y
    xc = 0.5 + 0.16 * np.sin(2.6 * np.pi * y) * y
    zc = 0.5 + 0.12 * np.cos(1.7 * np.pi * y) * y
    r = 0.055 + 0.17 * y
    # x spans 1.0 world units and z 0.8: distances in world units
    d2 = ((x - xc) * 1.0) ** 2 + ((z - zc) * 0.8) ** 2
    tube = np.exp(-d2 / (r * r)) * (1.0 - 0.55 * y)
    noise = 0.55 * _smooth_noise(rng, (NZ, NY, NX), 6) \
        + 0.45 * _smooth_noise(rng, (NZ, NY, NX), 17)
    d = tube * (0.3 + 1.4 * noise)
    return (d / d.max()).astype(np.float32)


def box_obj(p0, p1) -> str:
    """An axis-aligned box with outward face normals, 12 triangles."""
    (x0, y0, z0), (x1, y1, z1) = p0, p1
    faces = [   # 4 corners counter-clockwise seen from outside, normal
        ([(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)], (0, 0, 1)),
        ([(x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)],
         (0, 0, -1)),
        ([(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
         (-1, 0, 0)),
        ([(x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)], (1, 0, 0)),
        ([(x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)], (0, 1, 0)),
        ([(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
         (0, -1, 0)),
    ]
    lines = []
    for k, (corners, n) in enumerate(faces):
        lines += [f"v {a:.4f} {b:.4f} {c:.4f}" for a, b, c in corners]
        lines.append(f"vn {n[0]} {n[1]} {n[2]}")
        b = 4 * k
        lines.append(f"f {b + 1}//{k + 1} {b + 2}//{k + 1} {b + 3}//{k + 1}")
        lines.append(f"f {b + 1}//{k + 1} {b + 3}//{k + 1} {b + 4}//{k + 1}")
    return "\n".join(lines) + "\n"


def scene_doc() -> dict:
    room = "../cornell_port/"
    return {
        "_comment": (
            "Volumetric path tracing in the room of scenes/cornell_port "
            "without its boxes, written by tools/gen_smoke_port.py: a "
            "heterogeneous smoke plume on a 100x100x40 grid (the "
            "reference cornell_box smoke's dimensions) in a material-less "
            "box, and a homogeneous HG (g = 0.6) fog in a material-less "
            "sphere. 1024^2, maxDepth 5, VPT."),
        "screen_width": 1024, "screen_height": 1024,
        "integrator": "vpt", "maxDepth": 5, "epsilon": 0.001,
        "camera": {"position": [0, 1, 6.8], "lookat": [0, 1, 0],
                   "fov": 19.5, "filmicTonemap": True},
        "medium": [
            {"name": "smoke", "type": "heterogeneous",
             "sigmaA": [2.0, 2.0, 2.0], "sigmaS": [13.0, 13.0, 13.0],
             "nx": NX, "ny": NY, "nz": NZ, "p0": list(P0), "p1": list(P1),
             "density": "density.d", "evalTransmittanceType": 1},
            {"name": "fog", "type": "homogeneous",
             "sigmaA": [0.05, 0.05, 0.05], "sigmaS": [1.2, 1.2, 1.2],
             "g": 0.6},
        ],
        "material": [
            {"name": "Left", "bsdf": "lambertian",
             "diffuse": [0.63, 0.065, 0.05]},
            {"name": "Right", "bsdf": "lambertian",
             "diffuse": [0.14, 0.45, 0.091]},
            {"name": "General", "bsdf": "lambertian",
             "diffuse": [0.725, 0.725, 0.725]},
            {"name": "Emission", "bsdf": "lambertian", "diffuse": [0, 0, 0]},
        ],
        "scene": [
            {"mesh": room + "floor.obj", "material": "General"},
            {"mesh": room + "ceiling.obj", "material": "General"},
            {"mesh": room + "back.obj", "material": "General"},
            {"mesh": room + "left.obj", "material": "Left"},
            {"mesh": room + "right.obj", "material": "Right"},
            {"mesh": "box.obj", "inside": "smoke"},
            {"sphere": True, "center": [0.5, 0.42, 0.45], "radius": 0.4,
             "inside": "fog"},
        ],
        "light": [
            {"mesh": room + "light.obj", "material": "Emission",
             "radiance": [17.0, 12.0, 4.0]},
        ],
    }


def main():
    os.makedirs(OUT, exist_ok=True)
    d = plume_density()
    with open(os.path.join(OUT, "density.d"), "w") as f:
        f.write("\n".join(f"{v:.4f}" for v in d.reshape(-1)) + "\n")
    with open(os.path.join(OUT, "box.obj"), "w") as f:
        f.write(box_obj(P0, P1))
    with open(os.path.join(OUT, "scene.json"), "w") as f:
        json.dump(scene_doc(), f, indent=1)
        f.write("\n")
    print(f"density {d.shape}: mean {d.mean():.4f} of max {d.max():.4f}, "
          f"nonzero {(d > 1e-4).mean():.3f}")


if __name__ == "__main__":
    main()
