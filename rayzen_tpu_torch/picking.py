"""Mouse picking: the triangle and instance under a pixel.

Port of rayzen_tpu/picking.py (the reference's brute-force pick in
BLAS-debug mode, main.cpp:502-552): one ray through the pixel centre,
intersected with every world triangle (ops/traverse.brute_force_world,
which JAX also computes outside any Pallas kernel), on the device of the
packed scene.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops.camera_rays import generate_rays, upload
from .ops.traverse import brute_force_world
from .packing import SceneArrays, host_array, world_geometry


def pick(
    arrays: SceneArrays,
    camera_params: dict,
    pixel_xy: Tuple[float, float],
    resolution: Tuple[int, int],
) -> Optional[dict]:
    """Pick at a pixel (x, y) in GL window coordinates (origin bottom-left).

    Returns None on a miss, else a dict with the instance, the triangle (an
    index into the instance's packed leaf-order soup, usable as
    RenderConfig.debug_selected_tri), the world t and the hit point."""
    width, height = resolution
    dev = arrays.transforms.device
    uv = upload(np.asarray(
        [[(pixel_xy[0] + 0.5) / width, (pixel_xy[1] + 0.5) / height]],
        dtype=np.float32), dev)
    origin, direction = generate_rays(
        uv, torch.zeros_like(uv), camera_params["inv_proj"],
        camera_params["inv_view"], camera_params["position"])
    ws = world_geometry(arrays)
    hit = brute_force_world(ws, origin, direction,
                            torch.ones(1, dtype=torch.bool, device=dev))
    if not bool(hit.found[0]):
        return None
    world_tri = int(hit.tri[0])
    inst = int(hit.inst[0])
    # world-tri index -> index within the instance's triangle range
    first_of_inst = int(np.argmax(host_array(arrays.wtri_inst) == inst))
    return dict(
        instance=inst,
        triangle=world_tri - first_of_inst,
        t=float(hit.t[0]),
        point=hit.point[0].cpu().numpy(),
    )


def pick_chunks(
    arrays_list,
    camera_params: dict,
    pixel_xy: Tuple[float, float],
    resolution: Tuple[int, int],
) -> Optional[dict]:
    """Pick across a chunked scene (bigscene.partition_scene): the pick per
    chunk, the closest hit kept. The dict gains a "chunk" key;
    "instance"/"triangle" index within that chunk's packed arrays."""
    best = None
    for ci, arrays in enumerate(arrays_list):
        hit = pick(arrays, camera_params, pixel_xy, resolution)
        if hit is not None and (best is None or hit["t"] < best["t"]):
            hit["chunk"] = ci
            best = hit
    return best
