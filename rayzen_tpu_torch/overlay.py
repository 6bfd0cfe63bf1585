"""Debug overlays: BVH wireframes, light markers, the FPS readout.

Port of rayzen_tpu/overlay.py (the reference's in-shader overlay suite,
fragment_shader.glsl :118-183, :257-373, :776-819): composable passes over
the rendered frame, dense per-pixel tensor math on the frame's device
(distance-to-segment fields for the wireframes), with the small host parts
(the box lists, the branch search over the static BVH) in numpy, as in JAX.
The reference's quirks are kept: mode-0 BLAS root boxes are drawn in
object space (glsl:335-344), mode-1 branch boxes transform only their
min/max corners (glsl:365-366). FONT, _EDGES and _CORNER_SEL are JAX's.

JAX scans over the boxes and lights (lax.scan) to keep the reference's
sequential mix/max order; here that is a Python loop over boxes of batched
torch ops, in the same order. Overlays are no Pallas kernel.

``apply_overlays`` is the eager reference; ``composite_core`` (the
Renderer's path) takes the box sets as padded, masked operands built once
per scene state by ``build_overlay_inputs``. It makes no call that
synchronises the stream: the view-projection matrix and the FPS glyph rows
go up through pinned memory (camera_rays.upload), the box operands are
uploaded when built.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import camera_rays
from .ops.camera_rays import pixel_grid, upload
from .packing import SceneArrays, host_array, instance_world_aabbs

# 8x8 digit glyphs, rows top-to-bottom, bit 7 = leftmost pixel. Chars: 0-9, '.'
FONT = np.asarray(
    [
        [0x3C, 0x42, 0x46, 0x5A, 0x62, 0x42, 0x3C, 0x00],  # 0
        [0x08, 0x18, 0x28, 0x08, 0x08, 0x08, 0x3E, 0x00],  # 1
        [0x3C, 0x42, 0x02, 0x0C, 0x30, 0x40, 0x7E, 0x00],  # 2
        [0x3C, 0x42, 0x02, 0x1C, 0x02, 0x42, 0x3C, 0x00],  # 3
        [0x04, 0x0C, 0x14, 0x24, 0x7E, 0x04, 0x04, 0x00],  # 4
        [0x7E, 0x40, 0x7C, 0x02, 0x02, 0x42, 0x3C, 0x00],  # 5
        [0x1C, 0x20, 0x40, 0x7C, 0x42, 0x42, 0x3C, 0x00],  # 6
        [0x7E, 0x02, 0x04, 0x08, 0x10, 0x10, 0x10, 0x00],  # 7
        [0x3C, 0x42, 0x42, 0x3C, 0x42, 0x42, 0x3C, 0x00],  # 8
        [0x3C, 0x42, 0x42, 0x3E, 0x02, 0x04, 0x38, 0x00],  # 9
        [0x00, 0x00, 0x00, 0x00, 0x00, 0x18, 0x18, 0x00],  # .
    ],
    dtype=np.int32,
)

_EDGES = np.asarray(
    [0, 1, 1, 2, 2, 3, 3, 0, 4, 5, 5, 6, 6, 7, 7, 4, 0, 4, 1, 5, 2, 6, 3, 7],
    dtype=np.int64,
).reshape(12, 2)

_CORNER_SEL = np.asarray(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.float32,
)  # matches aabbWireframe corner order (glsl:231-239)

_BRANCH_PAD = 64  # fixed branch-box width: the traversal stack bound (glsl:422)


def hsv2rgb(h, s, v):
    """hsv2rgb (glsl:215-219), scalar numpy."""
    h = np.asarray(h, np.float64)
    p = np.abs((h + np.asarray([1.0, 2.0 / 3.0, 1.0 / 3.0])) % 1.0 * 6.0 - 3.0)
    return (v * ((1.0 - s) + s * np.clip(p - 1.0, 0.0, 1.0))).astype(np.float32)


def _box_corners(bmin, bmax):
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    return bmin * (1.0 - _CORNER_SEL) + bmax * _CORNER_SEL  # (8, 3)


def _clip_space(points, vp):
    """(..., 3) world points -> (..., 4) clip coordinates through the 4x4
    ``vp``, each row's products summed in order (w = 1 last)."""
    x, y, z = points.unbind(-1)
    return torch.stack(
        [((x * vp[j, 0] + y * vp[j, 1]) + z * vp[j, 2]) + vp[j, 3]
         for j in range(4)], dim=-1)


def _edge_ends(x):
    """x[_EDGES[:, 0]], x[_EDGES[:, 1]] for per-corner rows ``x`` (8, ...),
    as slices and rolls: an index array from the host would be a copy that
    synchronises the stream."""
    lo, hi = x[0:4], x[4:8]
    return (torch.cat([lo, hi, lo]),
            torch.cat([torch.roll(lo, -1, 0), torch.roll(hi, -1, 0), hi]))


def _one_box(frag, c, vp, res, thickness):
    """(P,) 0/1 float: pixels within ``thickness`` of one box's 12 projected
    edges (segments with both ends in front of the camera)."""
    clip = _clip_space(c, vp)  # (8, 4)
    w = clip[:, 3]
    screen = (clip[:, :2] / w[:, None] * 0.5 + 0.5) * res  # (8, 2)
    a, b = _edge_ends(screen)  # (12, 2) each
    wa, wb = _edge_ends(w)
    seg_ok = (wa > 0.0) & (wb > 0.0)
    ab = b - a
    denom = torch.clamp_min(ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1], 1e-12)
    pa = frag[:, None, :] - a[None, :, :]
    t = torch.clamp((pa[..., 0] * ab[None, :, 0] + pa[..., 1] * ab[None, :, 1])
                    / denom[None], 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    dv = frag[:, None, :] - proj
    d = torch.sqrt(dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1])
    d = torch.where(seg_ok[None], d, 1e6)
    return (torch.amin(d, dim=1) < thickness).float()


def _wireframe(frag, corners, colors, mask, vp, res, thickness):
    """(wire (P,), color (P, 3)) over the boxes in order: each box's hit
    pixels take its colour (mix) and the wire coverage its max, as the
    reference accumulates (glsl:318-344). ``mask`` (B,) or None: padded
    slots draw nothing."""
    wire = frag[:, 0] * 0.0
    color = torch.zeros((frag.shape[0], 3), dtype=torch.float32,
                        device=frag.device)
    for i in range(corners.shape[0]):
        hit = _one_box(frag, corners[i], vp, res, thickness)
        if mask is not None:
            hit = hit * mask[i]
        color = color * (1.0 - hit[:, None]) + colors[i][None] * hit[:, None]
        wire = torch.maximum(wire, hit)
    return wire, color


def wireframe_pass(frag, boxes, box_colors, view_proj, resolution, thickness):
    """Distance-to-segment wireframe field for a list of AABBs (corners
    (8, 3) each, in the space ``view_proj`` expects; colours (3,) each).
    Returns (wire (P,), color (P, 3))."""
    if not boxes:
        return frag[:, 0] * 0.0, torch.zeros((frag.shape[0], 3),
                                             dtype=torch.float32,
                                             device=frag.device)
    dev = frag.device
    corners = upload(np.stack(boxes).astype(np.float32), dev)
    colors = upload(np.stack(box_colors).astype(np.float32), dev)
    vp = upload(np.asarray(view_proj, np.float32), dev)
    return _wireframe(frag, corners, colors, None, vp,
                      camera_rays.resolution(*resolution, dev), float(thickness))


def tlas_leaf_boxes(arrays: SceneArrays):
    """World-space instance AABBs and a hue per instance (glsl:316-332).
    Mode 0."""
    wmin, wmax = instance_world_aabbs(arrays)
    wmin, wmax = host_array(wmin), host_array(wmax)
    n = arrays.num_instances
    boxes, colors = [], []
    for i, meta in enumerate(arrays.instance_meta):
        if meta.num_triangles == 0:
            continue
        boxes.append(_box_corners(wmin[i], wmax[i]))
        colors.append(hsv2rgb(i / n * 0.5, 1.0, 1.0))
    return boxes, colors


def blas_root_boxes(arrays: SceneArrays):
    """Object-space BLAS root bounds in black, drawn untransformed like the
    reference (glsl:335-344). Mode 0."""
    node_bounds = host_array(arrays.node_bounds)
    boxes, colors = [], []
    for meta in arrays.instance_meta:
        if meta.num_triangles == 0:
            continue
        nb = node_bounds[meta.node_offset]
        boxes.append(_box_corners(nb[:3], nb[3:]))
        colors.append(np.zeros(3, np.float32))
    return boxes, colors


def blas_branch_boxes(arrays: SceneArrays, instance: int, triangle: int):
    """Root-to-leaf path to the leaf holding packed triangle ``triangle`` of
    instance ``instance``'s BLAS (findBVHBranchIterative, glsl:257-307).
    Boxes transform only their min/max corners by the instance transform
    (glsl:365-366); colours ramp through hue along the path."""
    meta = arrays.instance_meta[instance]
    if meta.num_triangles == 0 or not (0 <= triangle < meta.num_triangles):
        return [], []
    node_meta = host_array(arrays.node_meta)
    node_bounds = host_array(arrays.node_bounds)
    xform = host_array(arrays.transforms)[instance]

    # walk from the root toward the leaf whose contiguous range holds `triangle`
    path = []
    cur = 0
    for _ in range(64):
        path.append(cur)
        row = node_meta[meta.node_offset + cur]
        left_first, count = int(row[0]), int(row[1])
        if count >= 0:
            break
        # children partition the triangle range; right starts where left ends
        right = left_first + 1
        right_first = _subtree_first(node_meta, meta.node_offset, right)
        cur = left_first if triangle < right_first else right

    boxes, colors = [], []
    for i, node in enumerate(path):
        nb = node_bounds[meta.node_offset + node]
        bmin = (xform[:3, :3] @ nb[:3]) + xform[:3, 3]
        bmax = (xform[:3, :3] @ nb[3:]) + xform[:3, 3]
        boxes.append(_box_corners(bmin, bmax))
        colors.append(hsv2rgb(i / len(path), 1.0, 1.0))
    return boxes, colors


def _subtree_first(node_meta, offset, node):
    """First triangle position covered by ``node``'s subtree (leftmost leaf)."""
    cur = node
    for _ in range(64):
        row = node_meta[offset + cur]
        if int(row[1]) >= 0:
            return int(row[0])
        cur = int(row[0])
    return 0


def _lights(color, frag, lights, vp, res):
    """Point-light markers (glsl:782-803): radius-8 circles with a 2-pixel
    smoothstep edge in the light's colour, light by light; rows that are not
    point lights (positionOrDirection.w != 1, glsl:783) draw nothing."""
    for li in range(lights.shape[0]):
        posdir = lights[li, :4]
        lcol = lights[li, 4:7]
        clip = _clip_space(posdir[:3], vp)
        w = clip[3]
        screen = (clip[:2] / w * 0.5 + 0.5) * res
        dv = frag - screen[None]
        dist = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1])
        # smoothstep(radius, radius - 2, dist), radius 8
        t = torch.clamp((8.0 - dist) / 2.0, 0.0, 1.0)
        alpha = t * t * (3.0 - 2.0 * t)
        alpha = torch.where((w > 0.0) & (posdir[3] == 1.0), alpha, 0.0)
        color = color * (1.0 - alpha[:, None]) + lcol[None] * alpha[:, None]
    return color


def light_markers_pass(color, frag, arrays: SceneArrays, view_proj, resolution):
    """Point-light screen markers over ``color`` (P, 3)."""
    dev = frag.device
    lights = upload(host_array(arrays.lights).astype(np.float32), dev)
    vp = upload(np.asarray(view_proj, np.float32), dev)
    return _lights(color, frag, lights, vp, camera_rays.resolution(*resolution, dev))


def _fps_chars(fps: float) -> list:
    """The five glyphs of "HTO.t" for ``fps``, in JAX's float32 arithmetic."""
    fps = np.float32(fps)
    fps_int = int(np.floor(fps))
    tenths = int(np.floor((fps - np.float32(fps_int)) * np.float32(10.0)))
    return [(fps_int // 100) % 10, (fps_int // 10) % 10, fps_int % 10, 10,
            tenths]


def fps_pass(color, frag, fps, resolution):
    """FPS readout "HTO.t" at the top left in 2x-scaled 8x8 glyphs, white
    (glsl:805-819 layout: margin 8, scale 2, 9-pixel advance). ``fps`` is a
    host number; its glyph rows go up through pinned memory."""
    width, height = resolution
    margin, scale = 8.0, 2.0
    font_h = 8
    pos_x, pos_y = np.float32(margin), np.float32(height - margin - font_h * scale)
    rows = upload(FONT[_fps_chars(fps)], frag.device)  # (5, 8) int32
    coverage = frag[:, 0] * 0.0
    for i in range(5):
        cx = float(pos_x + np.float32(i * 9.0 * scale))
        x = torch.floor((frag[:, 0] - cx) / scale).to(torch.int32)
        y = 7 - torch.floor((frag[:, 1] - float(pos_y)) / scale).to(torch.int32)
        inside = (x >= 0) & (x < 8) & (y >= 0) & (y < 8)
        row = rows[i][torch.clamp(y, 0, 7).long()]
        bit = (row >> (7 - torch.clamp(x, 0, 7))) & 1
        coverage = torch.maximum(coverage,
                                 torch.where(inside, bit.float(), 0.0))
    return color * (1.0 - coverage[:, None]) + coverage[:, None]


def _blend_wire(color, wire, wcol):
    """The 50% wireframe blend (glsl:776-779)."""
    return color * (1.0 - 0.5 * wire[:, None]) + wcol * (0.5 * wire[:, None])


def camera_view_proj(camera_params: dict) -> np.ndarray:
    """The camera's 4x4 projection @ view, float32 on the host."""
    return (host_array(camera_params["proj"]).astype(np.float32)
            @ host_array(camera_params["view"]).astype(np.float32))


def apply_overlays(image, arrays: SceneArrays, camera_params: dict, cfg,
                   fps: float | None = None):
    """Composite the configured overlays onto a frame (H, W, 3) in the
    reference's order: BVH wireframes (50% blend), light markers, the FPS
    readout. The eager reference for composite_core."""
    height, width = image.shape[:2]
    frag, _ = pixel_grid(width, height, image.device)
    color = image.reshape(-1, 3)
    view_proj = camera_view_proj(camera_params)

    if cfg.debug_show_bvh:
        if cfg.debug_bvh_mode == 0:
            tb, tc = tlas_leaf_boxes(arrays)
            bb, bc = blas_root_boxes(arrays)
            t_wire, t_col = wireframe_pass(frag, tb, tc, view_proj,
                                           (width, height), 1.5)
            b_wire, b_col = wireframe_pass(frag, bb, bc, view_proj,
                                           (width, height), 2.0)
        else:
            pb, pc = blas_branch_boxes(
                arrays, cfg.debug_selected_blas, cfg.debug_selected_tri)
            t_wire = frag[:, 0] * 0.0
            t_col = torch.zeros_like(color)
            b_wire, b_col = wireframe_pass(frag, pb, pc, view_proj,
                                           (width, height), 2.0)
        color = _blend_wire(color, t_wire, t_col)
        color = _blend_wire(color, b_wire, b_col)

    if cfg.debug_show_lights:
        color = light_markers_pass(color, frag, arrays, view_proj,
                                   (width, height))

    if cfg.show_fps_overlay and fps is not None:
        color = fps_pass(color, frag, fps, (width, height))

    return torch.clamp(color, 0.0, 1.0).reshape(height, width, 3)


def composite_core(
    image,
    t_corners, t_colors, t_mask,
    b_corners, b_colors, b_mask,
    vp, lights, fps,
    *, use_t, use_b, show_lights, show_fps, width, height,
):
    """Every configured overlay in one function, in the reference's order
    (wireframes with the 50% blend, light markers, FPS). ``vp``: the 4x4
    view-projection (host array or tensor); ``lights`` the (L, 8) light
    table on the frame's device; ``fps`` a host number. Passes switched off
    are skipped; their operands may be anything."""
    dev = image.device
    frag, _ = pixel_grid(width, height, dev)
    res = camera_rays.resolution(width, height, dev)
    if not isinstance(vp, torch.Tensor):
        vp = upload(np.asarray(vp, np.float32), dev)
    color = image.reshape(-1, 3)
    if use_t:
        t_wire, t_col = _wireframe(frag, t_corners, t_colors, t_mask, vp, res, 1.5)
        color = _blend_wire(color, t_wire, t_col)
    if use_b:
        b_wire, b_col = _wireframe(frag, b_corners, b_colors, b_mask, vp, res, 2.0)
        color = _blend_wire(color, b_wire, b_col)
    if show_lights:
        color = _lights(color, frag, lights, vp, res)
    if show_fps:
        color = fps_pass(color, frag, fps, (width, height))
    return torch.clamp(color, 0.0, 1.0).reshape(height, width, 3)


# JAX splits the overlays into composite_traced and its jit, composite_core;
# torch has no trace to split, so both names are the one function.
composite_traced = composite_core


def build_overlay_inputs(arrays: SceneArrays, cfg):
    """The box operands of composite_core for the current toggles, on the
    device of ``arrays``: ((t_corners, t_colors, t_mask, use_t), (b_...)).
    Mode-1 branch boxes pad to _BRANCH_PAD with a mask, as in JAX. Built on
    the host (it reads the tables back) and uploaded once; the Renderer
    caches them per scene state and toggles."""
    dev = arrays.transforms.device if isinstance(arrays.transforms, torch.Tensor) \
        else torch.device("cpu")
    none = (None, None, None, False)

    def pack(boxes, colors, pad=None):
        n = len(boxes)
        if n == 0:
            return none
        width = pad if pad is not None else n
        c = np.zeros((width, 8, 3), np.float32)
        col = np.zeros((width, 3), np.float32)
        m = np.zeros((width,), np.float32)
        c[:n] = np.stack(boxes)
        col[:n] = np.stack(colors)
        m[:n] = 1.0
        return upload(c, dev), upload(col, dev), upload(m, dev), True

    if not cfg.debug_show_bvh:
        return none, none
    if cfg.debug_bvh_mode == 0:
        return (pack(*tlas_leaf_boxes(arrays)), pack(*blas_root_boxes(arrays)))
    return none, pack(*blas_branch_boxes(arrays, cfg.debug_selected_blas,
                                         cfg.debug_selected_tri),
                      pad=_BRANCH_PAD)
