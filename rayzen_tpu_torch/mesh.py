"""Triangle meshes and the OBJ loader.

Reference: RayZen/include/Mesh.h:9-23 (Triangle = three padded vec3s + material
index) and RayZen/src/Mesh.cpp:6-50 (hand-rolled OBJ parser: `v` position lines,
`f` face lines with `a/b/c` tokens where only the position index is kept, fan
triangulation of n-gons, 1-based index fixup, per-mesh material index stamped on
every triangle). Vertex normals/UVs are parsed out and discarded — the renderer is
flat-shaded everywhere (SURVEY.md §7 quirks).

Instead of an array-of-structs with padding, triangles live as a dense
(T, 3, 3) float32 vertex array plus a (T,) int32 material-index array — the natural
HBM layout for batched Möller–Trumbore.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import logging_util as log
from .accel import native


@dataclasses.dataclass
class Mesh:
    """A triangle soup: vertices (T, 3, 3) float32, material_index (T,) int32."""

    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3), dtype=np.float32)
    )
    material_index: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.material_index = np.ascontiguousarray(self.material_index, dtype=np.int32)
        assert self.vertices.ndim == 3 and self.vertices.shape[1:] == (3, 3)
        assert self.material_index.shape == (self.vertices.shape[0],)

    @property
    def num_triangles(self) -> int:
        return int(self.vertices.shape[0])

    @staticmethod
    def from_triangles(tri_verts: np.ndarray, material_index: int = 0) -> "Mesh":
        tri_verts = np.asarray(tri_verts, dtype=np.float32).reshape(-1, 3, 3)
        mats = np.full(tri_verts.shape[0], material_index, dtype=np.int32)
        return Mesh(tri_verts, mats)

    @staticmethod
    def load_from_obj(path: str, material_index: int = 0) -> "Mesh":
        """Parse an OBJ file with the reference loader's semantics
        (Mesh.cpp:6-50). A missing/unreadable file returns an *empty* mesh and
        logs an error — the reference keeps rendering with an empty mesh when
        e.g. car.obj is absent (main.cpp:183-188, exercised at :371).

        Uses the native C++ parser when available (accel/native.py), else
        the Python parser below (the same triangles)."""
        native_verts = native.parse_obj_file(path)
        if native_verts is not None:
            log.debug(
                f"Loaded {native_verts.shape[0]} triangles from {path} (native)"
            )
            return Mesh.from_triangles(native_verts, material_index)
        try:
            with open(path, "r") as f:
                text = f.read()
        except OSError:
            log.error(f"Failed to open OBJ file: {path}")
            return Mesh()
        mesh = parse_obj(text, material_index)
        log.debug(f"Loaded {mesh.num_triangles} triangles from {path}")
        return mesh


def parse_obj(text: str, material_index: int = 0) -> Mesh:
    """OBJ parsing core (string input, testable without the filesystem).

    Robustness deviation from the reference: malformed `v`/`f` lines are
    skipped with a log line (the reference's std::stoi would throw and abort,
    Mesh.cpp:30); out-of-range face indices are dropped likewise."""
    positions = []
    tris = []
    bad = 0
    for line in text.splitlines():
        try:
            if line.startswith("v "):
                parts = line[2:].split()
                positions.append(
                    [float(parts[0]), float(parts[1]), float(parts[2])]
                )
            elif line.startswith("f "):
                idxs = []
                for token in line[2:].split():
                    # position index only, from tokens like "3/5/7" or "3//1"
                    head = token.split("/", 1)[0]
                    idxs.append(int(head))
                if len(idxs) >= 3:
                    # fan triangulation, 1-based indices (Mesh.cpp:38-46)
                    for i in range(1, len(idxs) - 1):
                        tri = (idxs[0] - 1, idxs[i] - 1, idxs[i + 1] - 1)
                        if all(0 <= t < len(positions) for t in tri):
                            tris.append(tri)
                        else:
                            bad += 1
        except (ValueError, IndexError):
            bad += 1
    if bad:
        log.error(f"OBJ parse: skipped {bad} malformed face(s)/line(s)")
    if not tris:
        return Mesh()
    pos = np.asarray(positions, dtype=np.float32)
    tri_idx = np.asarray(tris, dtype=np.int64)
    verts = pos[tri_idx]  # (T, 3, 3)
    mats = np.full(verts.shape[0], material_index, dtype=np.int32)
    return Mesh(verts, mats)


def save_obj(mesh: Mesh, path: str) -> None:
    """Write a triangle soup back out as OBJ (unshared vertices)."""
    with open(path, "w") as f:
        for tri in mesh.vertices:
            for v in tri:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in range(mesh.num_triangles):
            b = 3 * t
            f.write(f"f {b + 1} {b + 2} {b + 3}\n")
