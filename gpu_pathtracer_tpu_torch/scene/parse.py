"""Scene JSON parser — schema-compatible with the reference renderer.

A numpy copy of gpu_pathtracer_tpu/scene/parse.py, which mirrors the
reference's parsescene.cpp:45-591 section by section (medium ->
global/camera -> integrator -> material -> scene -> light), including
every default value: textures (linear RGB quantised to uint8, one
record per file) and the `infinite` environment light with its `rotate`
or `matrix` frame, and dipole BSSRDF materials, given by `sigmaA` /
`sigmaSP` or converted from a diffuse colour (`kd`, `meanPathLength`)
by shade/bssrdf.py::convert_from_diffuse.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.film.imageio import (
    load_exr, load_texture, read_density_file,
)
from gpu_pathtracer_tpu_torch.scene import objloader
from gpu_pathtracer_tpu_torch.scene.model import (
    AreaLight, Bssrdf, CameraConfig, GeometryType, HostScene, InfiniteLight,
    InstanceUnit, IntegratorConfig, IntegratorType, Material, MaterialType,
    Medium, MediumType, Primitive, Texture,
)


_MAT_MAP = {
    "lambertian": MaterialType.LAMBERTIAN,
    "mirror": MaterialType.MIRROR,
    "dielectric": MaterialType.DIELECTRIC,
    "roughdielectric": MaterialType.ROUGHDIELECTRIC,
    "roughconduct": MaterialType.ROUGHCONDUCTOR,
    "substrate": MaterialType.SUBSTRATE,
}

_INTEGRATOR_MAP = {
    "ao": IntegratorType.AO,
    "pt": IntegratorType.PT,
    "vpt": IntegratorType.VPT,
    "lt": IntegratorType.LT,
    "bdpt": IntegratorType.BDPT,
    "mlt": IntegratorType.MLT,
    "sppm": IntegratorType.SPPM,
    "ir": IntegratorType.IR,
}


def _f3(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _remap_roughness(r: float) -> float:
    """Mitsuba-style log-polynomial roughness remap
    (parsescene.cpp:283-288)."""
    r = max(r, 1e-3)
    x = np.log(r)
    return float(1.62142 + 0.819955 * x + 0.1734 * x * x
                 + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def load_scene(path: str) -> HostScene:
    """The scene file at `path` and the meshes it names, parsed (the
    set-up span "scene.parse")."""
    with telemetry.span("scene.parse"):
        return _load_scene(path)


def _load_scene(path: str) -> HostScene:
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)

    scene = HostScene(base_dir=base)

    # ---- medium[] (parsescene.cpp:73-137) ------------------------------
    medium_names: list[str] = []
    for m in doc.get("medium", []):
        mtype = m.get("type", "homogeneous")
        sigma_a = _f3(m.get("sigmaA", [1, 1, 1]))
        sigma_s = _f3(m.get("sigmaS", [1, 1, 1]))
        scale = float(m.get("scale", 1.0))
        sigma_a = sigma_a * scale
        sigma_s = sigma_s * scale
        med = Medium(
            g=float(m.get("g", 0.0)),
            sigmaA=sigma_a, sigmaS=sigma_s,
            iterMax=int(m.get("iterMax", 1000)),
        )
        if mtype == "homogeneous":
            med.type = MediumType.HOMOGENEOUS
        else:
            sigma_t = sigma_a + sigma_s
            if not (sigma_t[0] == sigma_t[1] == sigma_t[2]):
                raise ValueError(
                    "heterogeneous medium requires uniform attenuation "
                    "coefficient (parsescene.cpp:102-105)")
            med.type = MediumType.HETEROGENEOUS
            med.nx = int(m["nx"])
            med.ny = int(m["ny"])
            med.nz = int(m["nz"])
            med.p0 = _f3(m["p0"])
            med.p1 = _f3(m["p1"])
            med.evalTransmittanceType = int(m.get("evalTransmittanceType", 1))
            med.density = read_density_file(
                os.path.join(base, m["density"]), med.nx, med.ny, med.nz)
        scene.mediums.append(med)
        medium_names.append(m["name"])

    def get_medium(name: str) -> int:
        return medium_names.index(name) if name in medium_names else -1

    # ---- global config (parsescene.cpp:149-181) ------------------------
    scene.width = int(doc.get("screen_width", 512))
    scene.height = int(doc.get("screen_height", 512))
    scene.epsilon = float(doc.get("epsilon", 1e-3))

    if "camera" not in doc:
        raise ValueError("Scene file must define camera")
    cam_doc = doc["camera"]
    cam = CameraConfig()
    cam.environment = bool(cam_doc.get("environment", False))
    position = _f3(cam_doc.get("position", [0, 0, 0]))
    cam.fov = float(cam_doc.get("fov", 60.0))
    up = _f3(cam_doc.get("up", [0, 1, 0]))
    lookat = _f3(cam_doc.get("lookat", [0, 0, -1]))
    cam.lookat(position, lookat, up)
    cam.apertureRadius = float(cam_doc.get("apertureRadius", 0.0))
    cam.focalDistance = float(cam_doc.get("focalDistance", 0.0))
    scene.camera_move_speed = float(cam_doc.get("move_speed", 0.1))
    cam.filmic = bool(cam_doc.get("filmicTonemap", True))
    cam.medium = get_medium(cam_doc.get("medium", ""))
    scene.camera = cam

    # ---- integrator (parsescene.cpp:183-226) ---------------------------
    iname = doc.get("integrator", "pt")
    if iname not in _INTEGRATOR_MAP:
        raise ValueError(
            f"Unsupported integrator [{iname}]; choose one of "
            f"[ao, pt, vpt, lt, bdpt, mlt, sppm, ir]")
    integ = IntegratorConfig(type=_INTEGRATOR_MAP[iname])
    integ.maxDepth = int(doc.get("maxDepth", 5))
    integ.maxDist = float(doc.get("maxDist", 0.5))
    integ.initRadius = float(doc.get("initRadius", 0.5))
    integ.photonsPerIteration = int(doc.get("photonsPerIteration", 100000))
    integ.vplBias = float(doc.get("vplBias", 0.5))
    scene.integrator = integ

    # ---- material[] (parsescene.cpp:228-330) ---------------------------
    mat_names: list[str] = []
    bssrdf_names: list[str] = []
    tex_map: dict[str, int] = {}   # texture file -> index, each read once
    for m in doc.get("material", []):
        if "bssrdf" in m:
            scale = float(m.get("scale", 1.0))
            b = Bssrdf(
                sigmaA=_f3(m.get("sigmaA", [1, 1, 1])) * scale,
                sigmaSP=_f3(m.get("sigmaSP", [1, 1, 1])) * scale,
                eta=float(m.get("eta", 1.5)),
                g=float(m.get("g", 0.0)),
            )
            if "kd" in m:
                from gpu_pathtracer_tpu_torch.shade.bssrdf import (
                    convert_from_diffuse,
                )
                b = convert_from_diffuse(
                    _f3(m["kd"]), float(m.get("meanPathLength", 1.0)), b.eta,
                    b.g)
            scene.bssrdfs.append(b)
            bssrdf_names.append(m["name"])
            continue

        if "alpha" in m:
            alpha_u = alpha_v = float(m["alpha"])
        else:
            alpha_u = float(m.get("alphaU", 0.01))
            alpha_v = float(m.get("alphaV", 0.01))
        if bool(m.get("remap", False)):
            alpha_u = _remap_roughness(alpha_u)
            alpha_v = _remap_roughness(alpha_v)

        mat = Material(
            type=_MAT_MAP[m["bsdf"]],
            alphaU=alpha_u, alphaV=alpha_v,
            insideIOR=float(m.get("insideIOR", 1.0)),
            outsideIOR=float(m.get("outsideIOR", 1.0)),
            k=_f3(m.get("k", [0, 0, 0])),
            eta=_f3(m.get("eta", [0, 0, 0])),
            specular=_f3(m.get("specular", [1, 1, 1])),
        )
        if "diffuse" in m:
            if isinstance(m["diffuse"], str):
                file = m["diffuse"]
                if file not in tex_map:
                    img = load_texture(os.path.join(base, file), gamma=True)
                    data = np.clip(img * 255.0, 0, 255).astype(np.uint8)
                    scene.textures.append(Texture(
                        data=data, width=data.shape[1], height=data.shape[0]))
                    tex_map[file] = len(scene.textures) - 1
                mat.textureIdx = tex_map[file]
            else:
                mat.diffuse = _f3(m["diffuse"])
        scene.materials.append(mat)
        mat_names.append(m["name"])

    def find_material(name: str) -> tuple[int, int]:
        """Returns (matIdx, bssrdfIdx); raises when neither exists
        (parsescene.cpp:361-381)."""
        if name in mat_names:
            return mat_names.index(name), -1
        if name in bssrdf_names:
            return -1, bssrdf_names.index(name)
        raise ValueError(f'There is no material named:["{name}"]')

    # ---- scene[] geometry (parsescene.cpp:332-490) ---------------------
    meshes: dict[str, objloader.TriMesh] = {}   # each OBJ is read once

    def load_obj(path: str) -> objloader.TriMesh:
        if path not in meshes:
            meshes[path] = objloader.load_obj(path)
        return meshes[path]

    for unit in doc.get("scene", []):
        if "mesh" in unit:
            mat_name = unit.get("material", "")
            mi = get_medium(unit.get("inside", ""))
            mo = get_medium(unit.get("outside", ""))
            mat_idx, bssrdf_idx = -1, -1
            # a mesh with only media attached may omit the material
            # (parsescene.cpp:361: matIdx stays -1 -> interface boundary)
            if mat_name != "" or not (mi != -1 or mo != -1):
                mat_idx, bssrdf_idx = find_material(mat_name)
            trs = objloader.trs_matrix(
                unit.get("translate", [0, 0, 0]),
                unit.get("rotate", [0, 0, 0]),
                unit.get("scale", [1, 1, 1]))
            mesh_path = os.path.join(base, unit["mesh"])
            mesh = objloader.transform_mesh(load_obj(mesh_path), trs)
            tri_ids = scene.append_triangles(mesh)
            p_start = len(scene.primitives)
            for t in tri_ids:
                scene.primitives.append(Primitive(
                    type=GeometryType.TRIANGLE, tri_index=int(t),
                    matIdx=mat_idx, bssrdfIdx=bssrdf_idx,
                    mediumInside=mi, mediumOutside=mo))
            scene.units.append(InstanceUnit(
                mesh_key=os.path.normpath(mesh_path), trs=trs,
                prim_ids=np.arange(p_start, len(scene.primitives))))
        elif "line" in unit:
            mat_name = unit.get("material", "matte")
            mat_idx = mat_names.index(mat_name)  # raises like the reference
            trs = objloader.trs_matrix(
                unit.get("translate", [0, 0, 0]),
                unit.get("rotate", [0, 0, 0]),
                unit.get("scale", [1, 1, 1]))
            p0 = np.append(_f3(unit.get("p0", [0, 0, 0])), 1.0) @ trs.T
            p1 = np.append(_f3(unit.get("p1", [1, 1, 1])), 1.0) @ trs.T
            scene.primitives.append(Primitive(
                type=GeometryType.LINE,
                p0=p0[:3].astype(np.float32), p1=p1[:3].astype(np.float32),
                width0=float(unit.get("width0", 0.025)),
                width1=float(unit.get("width1", 0.025)),
                matIdx=mat_idx))
        elif "sphere" in unit:
            mat_name = unit.get("material", "")
            mi = get_medium(unit.get("inside", ""))
            mo = get_medium(unit.get("outside", ""))
            mat_idx, bssrdf_idx = -1, -1
            if mat_name != "" or not (mi != -1 or mo != -1):
                mat_idx, bssrdf_idx = find_material(mat_name)
            scene.primitives.append(Primitive(
                type=GeometryType.SPHERE,
                center=_f3(unit.get("center", [0, 0, 0])),
                radius=float(unit.get("radius", 1.0)),
                matIdx=mat_idx, bssrdfIdx=bssrdf_idx,
                mediumInside=mi, mediumOutside=mo))
        else:
            raise ValueError("Error scene file format")

    # ---- light[] (parsescene.cpp:492-587) ------------------------------
    for unit in doc.get("light", []):
        if "mesh" in unit:
            mat_name = unit.get("material", "matte")
            mat_idx = mat_names.index(mat_name)
            radiance = _f3(unit.get("radiance", [0, 0, 0]))
            lt_medium = get_medium(unit.get("medium", ""))
            trs = objloader.trs_matrix(
                unit.get("translate", [0, 0, 0]),
                unit.get("rotate", [0, 0, 0]),
                unit.get("scale", [1, 1, 1]))
            mesh = objloader.transform_mesh(
                load_obj(os.path.join(base, unit["mesh"])), trs)
            tri_ids = scene.append_triangles(mesh)
            for t in tri_ids:
                light_idx = len(scene.lights)
                scene.primitives.append(Primitive(
                    type=GeometryType.TRIANGLE, tri_index=int(t),
                    matIdx=mat_idx, lightIdx=light_idx))
                scene.lights.append(AreaLight(
                    radiance=radiance, tri_index=int(t), medium=lt_medium))
        elif "infinite" in unit:
            inf = InfiniteLight(data=load_exr(os.path.join(base,
                                                           unit["infinite"])))
            if "rotate" in unit:
                rs = objloader.trs_matrix([0, 0, 0], unit["rotate"], [1, 1, 1])
                inf.u, inf.v, inf.w = (rs[:3, k].astype(np.float32)
                                       for k in range(3))
            if "matrix" in unit:
                rs = np.linalg.inv(
                    np.asarray(unit["matrix"], np.float64).reshape(4, 4).T)
                inf.u, inf.v, inf.w = (rs[:3, k].astype(np.float32)
                                       for k in range(3))
            scene.infinite = inf
        else:
            raise ValueError("Only support area and infinite light")

    return scene
