"""Host-side scene model: plain dataclasses + numpy, filled by the parser.

A copy of gpu_pathtracer_tpu/scene/model.py: the reference's Scene
(scene.h:26-84) and GlobalConfig (parsescene.h:8-24). Everything here
lives on the host; `flatten.py` turns it into device tensors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class MaterialType(enum.IntEnum):
    """material.h:10-17."""
    LAMBERTIAN = 0
    MIRROR = 1
    DIELECTRIC = 2
    ROUGHDIELECTRIC = 3
    ROUGHCONDUCTOR = 4
    SUBSTRATE = 5


class IntegratorType(enum.IntEnum):
    """scene.h:15-24."""
    AO = 0
    PT = 1
    VPT = 2
    LT = 3
    BDPT = 4
    MLT = 5
    SPPM = 6
    IR = 7


class MediumType(enum.IntEnum):
    """medium.h:181-184."""
    HOMOGENEOUS = 0
    HETEROGENEOUS = 1


class GeometryType(enum.IntEnum):
    """primitive.h:9-13."""
    TRIANGLE = 0
    LINE = 1
    SPHERE = 2


@dataclass
class Material:
    """material.h:19-27."""
    type: MaterialType = MaterialType.LAMBERTIAN
    alphaU: float = 0.01
    alphaV: float = 0.01
    insideIOR: float = 1.0
    outsideIOR: float = 1.0
    k: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    eta: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    specular: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    textureIdx: int = -1


@dataclass
class Bssrdf:
    """bssrdf.h dipole parameters (sigmaA/sigmaS' scaled at parse time)."""
    sigmaA: np.ndarray
    sigmaSP: np.ndarray
    eta: float = 1.5
    g: float = 0.0


@dataclass
class Medium:
    """medium.h:9-195 (tagged union flattened into one record)."""
    type: MediumType = MediumType.HOMOGENEOUS
    g: float = 0.0
    sigmaA: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    sigmaS: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    # heterogeneous only:
    nx: int = 0
    ny: int = 0
    nz: int = 0
    p0: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    p1: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    density: np.ndarray | None = None  # [nz, ny, nx] float32
    iterMax: int = 1000
    evalTransmittanceType: int = 1  # 0 delta / 1 ratio / 2 residual-ratio

    @property
    def sigmaT(self) -> np.ndarray:
        return self.sigmaA + self.sigmaS

    @property
    def inv_max_density(self) -> float:
        assert self.density is not None
        return float(1.0 / max(self.density.max(), 1e-30))


@dataclass
class Texture:
    """texture.h:9-28: linear RGB quantized to uint8 (matches the reference's
    uchar4 storage so texel values round-trip identically)."""
    data: np.ndarray  # [H, W, 3] uint8, linear space
    width: int
    height: int


@dataclass
class CameraConfig:
    """camera.h:8-46 + parsescene.cpp:162-176; `distance` fixed at 0.1
    (main.cpp:270)."""
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    u: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0], np.float32))
    v: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    w: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    fov: float = 60.0
    apertureRadius: float = 0.0
    focalDistance: float = 0.0
    filmic: bool = True
    environment: bool = False
    medium: int = -1
    distance: float = 0.1

    def lookat(self, eye, dest, up):
        """camera.h:123-128."""
        eye = np.asarray(eye, np.float64)
        dest = np.asarray(dest, np.float64)
        up = np.asarray(up, np.float64)
        w = eye - dest
        w = w / np.linalg.norm(w)
        u = np.cross(up, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        v = v / np.linalg.norm(v)
        self.position = eye.astype(np.float32)
        self.u = u.astype(np.float32)
        self.v = v.astype(np.float32)
        self.w = w.astype(np.float32)


@dataclass
class InfiniteLight:
    """infinite.h:6-95: equirect env map with rotated frame."""
    data: np.ndarray  # [H, W, 3] float32
    u: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0], np.float32))
    v: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    w: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


@dataclass
class IntegratorConfig:
    """scene.h:38-47 integrator tagged union, flattened."""
    type: IntegratorType = IntegratorType.PT
    maxDepth: int = 5
    maxDist: float = 0.5       # AO only
    vplBias: float = 0.5       # IR only
    initRadius: float = 0.5    # SPPM only
    photonsPerIteration: int = 100000  # SPPM only


@dataclass
class Primitive:
    """primitive.h:15-23, SoA-friendly host record.

    For triangles: mesh-local index into the scene triangle arrays.
    For spheres/lines: parameters inline.
    """
    type: GeometryType
    # triangle payload: index into HostScene.tri_* arrays
    tri_index: int = -1
    # sphere payload
    center: np.ndarray | None = None
    radius: float = 0.0
    # line payload
    p0: np.ndarray | None = None
    p1: np.ndarray | None = None
    width0: float = 0.0
    width1: float = 0.0
    # shared indices
    matIdx: int = -1
    bssrdfIdx: int = -1
    lightIdx: int = -1
    mediumInside: int = -1
    mediumOutside: int = -1


@dataclass
class InstanceUnit:
    """One scene[] mesh entry, for instanced (TLAS/BLAS) traversal:
    repeated mesh_keys become instances of one BLAS (geom/tlas.py)."""
    mesh_key: str          # resolved mesh path (identity of the geometry)
    trs: np.ndarray        # [4, 4] object->world matrix of this entry
    prim_ids: np.ndarray   # global primitive indices it contributed


@dataclass
class AreaLight:
    """area.h:7-42: one emissive triangle."""
    radiance: np.ndarray
    tri_index: int  # into HostScene.tri_* arrays
    medium: int = -1


@dataclass
class HostScene:
    """Everything the renderer needs, on host, pre-BVH."""
    # triangle soup shared by primitives and lights: [T, 3, 3]/[T, 3, 2]
    tri_positions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32))
    tri_normals: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32))
    tri_uvs: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3, 2), np.float32))

    primitives: list[Primitive] = field(default_factory=list)
    units: list[InstanceUnit] = field(default_factory=list)
    materials: list[Material] = field(default_factory=list)
    bssrdfs: list[Bssrdf] = field(default_factory=list)
    mediums: list[Medium] = field(default_factory=list)
    lights: list[AreaLight] = field(default_factory=list)
    textures: list[Texture] = field(default_factory=list)
    infinite: InfiniteLight | None = None

    camera: CameraConfig = field(default_factory=CameraConfig)
    integrator: IntegratorConfig = field(default_factory=IntegratorConfig)

    width: int = 512
    height: int = 512
    epsilon: float = 1e-3
    camera_move_speed: float = 0.1
    base_dir: str = "."

    def append_triangles(self, mesh) -> np.ndarray:
        """Append a TriMesh to the shared soup; returns new tri indices."""
        start = self.tri_positions.shape[0]
        self.tri_positions = np.concatenate(
            [self.tri_positions, mesh.positions], axis=0)
        self.tri_normals = np.concatenate(
            [self.tri_normals, mesh.normals], axis=0)
        self.tri_uvs = np.concatenate([self.tri_uvs, mesh.uvs], axis=0)
        return np.arange(start, self.tri_positions.shape[0])

    def light_distribution(self) -> np.ndarray:
        """Power-weighted CDF over area lights (+1 slot for the infinite
        light), normalized — reference scene.h:64-82."""
        luma = np.array([0.212671, 0.715160, 0.072169])
        cdf = [0.0]
        total = 0.0
        for lt in self.lights:
            tri = self.tri_positions[lt.tri_index]
            e1 = tri[1] - tri[0]
            e2 = tri[2] - tri[0]
            area = 0.5 * np.linalg.norm(np.cross(e1, e2))
            power = lt.radiance * area * np.pi
            total += float(luma @ power)
            cdf.append(total)
        if self.infinite is not None:
            # power = 4*pi*r^2*data[0] (infinite.h:43-45); the scene bounding
            # radius scales all entries equally so it cancels unless mixed with
            # area lights — match the reference by using the real radius,
            # which flatten computes from the BVH root box.
            cdf.append(total)  # placeholder; flatten patches it
        arr = np.asarray(cdf, np.float64)
        return arr
