"""A configuration file as plain arrays: the inputs that the benchmark
hands, unchanged, to the program (as a Scene) and to the plain reference.

Numpy only. The meshes are the frozen copies in benchmark/assets, read by
the upstream OBJ loader's rules (Mesh.cpp:6-50: ``v`` lines, the position
index of each ``f`` token, fan triangulation, 1-based indices); a mesh
file that is not there is an empty mesh, as the upstream demo's missing
car.obj is. Transforms compose GLM-style: each op post-multiplies.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(BENCH_DIR, "assets")


def load_obj(path: str) -> np.ndarray:
    """(T, 3, 3) float32 triangles of an OBJ file; (0, 3, 3) if absent."""
    if not os.path.exists(path):
        return np.zeros((0, 3, 3), np.float32)
    pos, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                pos.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/", 1)[0]) - 1 for tok in line.split()[1:]]
                tris.extend((idx[0], idx[i], idx[i + 1])
                            for i in range(1, len(idx) - 1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.asarray(pos, np.float32)[np.asarray(tris, np.int64)]


def _op_matrix(op) -> np.ndarray:
    kind = op[0]
    m = np.eye(4, dtype=np.float32)
    if kind == "translate":
        m[:3, 3] = np.asarray(op[1], np.float32)
    elif kind == "scale":
        m[0, 0], m[1, 1], m[2, 2] = np.asarray(op[1], np.float32)
    elif kind == "rotate_deg":  # glm::rotate about an axis, in float64
        a = math.radians(float(op[1]))
        x, y, z = np.asarray(op[2], np.float64) / np.linalg.norm(op[2])
        c, s = math.cos(a), math.sin(a)
        t = 1.0 - c
        m = np.array([
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y, 0.0],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x, 0.0],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0]]).astype(np.float32)
    else:
        raise ValueError(f"unknown transform op {kind!r}")
    return m


def compose(ops) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    for op in ops:
        m = (m @ _op_matrix(op)).astype(np.float32)
    return m


def _grid_instances(g: dict) -> list:
    """The instances of a ``grid`` block: ``count`` copies of one mesh on a
    square grid in x and -z, each turned about ``rotate_axis`` by i times
    ``rotate_deg_step`` (mod 360), materials cycling over the first
    ``materials``."""
    n = int(g["count"])
    side = int(math.ceil(math.sqrt(n)))
    sp = float(g["spacing"])
    out = []
    for i in range(n):
        gx, gz = i % side, i // side
        out.append({
            "mesh": g["mesh"], "material": i % int(g["materials"]),
            "ops": [["translate", [sp * (gx - side / 2), 0.0, -sp * gz]],
                    ["rotate_deg", (i * float(g["rotate_deg_step"])) % 360.0,
                     g["rotate_axis"]]],
        })
    return out


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def scene_arrays(cfg: dict) -> dict:
    """The configuration's scene as arrays:
    meshes {name: (T, 3, 3) f32}, instances [(mesh, (4, 4) f32, material
    override or -1)], materials (M, 8) f32 [albedo rgb, metallic,
    roughness, reflectivity, transparency, ior], lights (L, 8) f32 [xyz,
    w (1 point, 0 directional), rgb, power], camera {position, target, up,
    fov, near, far, aspect}, and the frame settings."""
    meshes = {k: load_obj(os.path.join(ASSETS, v)) for k, v in cfg["meshes"].items()}
    insts = list(cfg.get("instances", ()))
    if "grid" in cfg:
        insts += _grid_instances(cfg["grid"])
    instances = [(i["mesh"], compose(i["ops"]), int(i.get("material", -1)))
                 for i in insts]
    materials = np.array(
        [[*m["albedo"], m["metallic"], m["roughness"], m["reflectivity"],
          m["transparency"], m["ior"]] for m in cfg["materials"]], np.float32)
    lights = np.array(
        [[*l["vector"], 1.0 if l["kind"] == "point" else 0.0, *l["color"],
          l["power"]] for l in cfg["lights"]], np.float32).reshape(-1, 8)
    cam = dict(cfg["camera"])
    cam["aspect"] = cfg["width"] / cfg["height"]
    frame = {k: cfg[k] for k in (
        "width", "height", "max_bounces", "rr_start_bounce", "rng", "ambient",
        "sky_horizon", "sky_zenith", "shadow_min_visibility")}
    return {"meshes": meshes, "instances": instances, "materials": materials,
            "lights": lights, "camera": cam, "frame": frame}


def num_triangles(scene: dict) -> int:
    return sum(scene["meshes"][m].shape[0] for m, _, _ in scene["instances"])
