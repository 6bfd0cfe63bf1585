"""Carry packed state across from the JAX package.

``scene_arrays_from_numpy`` and ``world_arrays_from_numpy`` take a
rayzen_tpu ``SceneArrays`` / ``WorldArrays`` with its leaves given as numpy
arrays — ``{f.name: np.asarray(getattr(x, f.name)) for f in
dataclasses.fields(x)}`` — and return the port's dataclass with tensors on
``device``. Every field is carried: the tables of each view (the miss-link
``records``, the BVH2, wide and treelet tables) and the static fields
(``instance_meta``, ``tree_depth``, ``leaf_k``, ``tiered``); K7's device
tables, which JAX does not have, are built from them. The treelet
tables lose JAX's 128-lane padding (``tre_inner`` keeps its 16 columns,
``tre_leaf`` the leaf-table width), and the tiered and wide walks' depth
bounds, which JAX does not keep, are computed from the tables. Tests use this to feed the port exactly the JAX
tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .packing import (
    InstanceMeta, SceneArrays, WorldArrays, misslink_tables, tiered_depths,
    wide_stack_bound,
)


def _tensor(x, device):
    return torch.from_numpy(np.array(x)).to(device)  # a copy: JAX's are read-only


def scene_arrays_from_numpy(d: dict, device) -> SceneArrays:
    """A JAX SceneArrays (as a dict of numpy leaves) as the port's
    SceneArrays with tensors on ``device``."""
    arrays = {}
    for f in dataclasses.fields(SceneArrays):
        if f.name == "instance_meta":
            arrays[f.name] = tuple(
                InstanceMeta(*dataclasses.astuple(m))
                if dataclasses.is_dataclass(m) else InstanceMeta(*m)
                for m in d[f.name]
            )
        elif f.name == "tree_depth":
            arrays[f.name] = int(d.get(f.name, 0))
        elif f.name not in ("top_depth", "treelet_depth", "wide_depth",
                            "wide_stack"):
            arrays[f.name] = np.array(d[f.name])
    arrays["top_depth"], arrays["treelet_depth"] = tiered_depths(
        arrays["top_child_ref"], arrays["top_child_count"],
        arrays["tre_child_ref"], arrays["tre_child_count"],
    )
    arrays["wide_depth"], arrays["wide_stack"] = wide_stack_bound(
        arrays["bvh8_child_ref"], arrays["bvh8_child_count"])
    return SceneArrays(**arrays).to(device)


def world_arrays_from_numpy(d: dict, device) -> WorldArrays:
    """A JAX WorldArrays (as a dict of numpy leaves) as the port's
    WorldArrays with tensors on ``device``."""
    d = dict(d)
    d["tre_inner"] = np.asarray(d["tre_inner"])[..., :16]
    d["tre_leaf"] = np.asarray(d["tre_leaf"])[..., : np.shape(d["leaf_table"])[1]]
    top, tre = np.asarray(d["top_table"]), d["tre_inner"]
    d["top_depth"], d["treelet_depth"] = tiered_depths(
        top[:, 12:14].astype(np.int32), top[:, 14:16].astype(np.int32),
        tre[..., 12:14].astype(np.int32), tre[..., 14:16].astype(np.int32),
    )
    i8 = np.asarray(d["inner8_table"])
    d["wide_depth"], d["wide_stack"] = wide_stack_bound(
        i8[:, 48:56].astype(np.int32), i8[:, 56:64].astype(np.int32))
    kw = {}
    for f in dataclasses.fields(WorldArrays):
        if f.name in ("leaf_k", "tree_depth", "top_depth", "treelet_depth",
                      "wide_depth", "wide_stack"):
            kw[f.name] = int(d[f.name])
        elif f.name == "tiered":
            kw[f.name] = bool(d[f.name])
        elif f.name not in ("ml_nodes", "ml_tris"):
            kw[f.name] = _tensor(d[f.name], device).contiguous()
    kw["ml_nodes"], kw["ml_tris"] = misslink_tables(
        kw["records"], kw["leaf_k"], kw["tri_v0"], kw["tri_e1"], kw["tri_e2"],
        kw["tri_mat"], kw["tri_nsign"], kw["materials"])
    return WorldArrays(**kw)


def to_numpy(x) -> dict:
    """The port's SceneArrays / WorldArrays as a dict of numpy leaves (the
    inverse of the two functions above)."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out
