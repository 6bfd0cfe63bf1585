"""Preview renderer, the "editor mode" frame.

Port of rayzen_tpu/preview.py: primary visibility from the camera, shaded
with the reference editor fragment shader's model (editor_fragment.glsl:
56-109): GGX D/G/F with clamped roughness, kD = (1 - F)(1 - metallic)
diffuse, no shadow rays, transparency shown as a 50% albedo mix; misses
show the sky. Every expression is in the JAX package's order.

The primary walk on the card is K7 (ops/walk.closest_hit_misslink, the
live-ray miss-link kernel in the frame's warp tiles), which walks the same
miss-link tree as JAX's traverse_world; on the CPU it is
ops/traverse.traverse_world, the plain version (which waits on the host at
every step of its loop).
"""

from __future__ import annotations

import numpy as np
import torch

from . import light as light_mod
from . import material as mat_mod
from .config import RenderConfig
from .ops import camera_rays, walk
from .ops.intersect import dot3, normalize
from .ops.shade import PI_REF, fresnel_schlick, sky_color
from .ops.traverse import hit_shading_data, traverse_world
from .packing import SceneArrays, WorldArrays, world_geometry


def shade_preview(ws: WorldArrays, point, normal, material, view_dir,
                  cfg: RenderConfig):
    """editor_fragment.glsl main(): PBR without shadows, (R, 3)."""
    albedo = material[:, mat_mod.ALBEDO]
    metallic = material[:, mat_mod.METALLIC]
    roughness = material[:, mat_mod.ROUGHNESS]
    transparency = material[:, mat_mod.TRANSPARENCY]

    n = normal
    v = view_dir
    n_dot_v = torch.clamp_min(dot3(n, v), 0.0)
    f0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    ambient = camera_rays.upload(np.asarray(cfg.ambient, np.float32),
                                 albedo.device)
    color = ambient * albedo

    for li in range(ws.num_lights):
        lrow = ws.lights[li]
        posdir = lrow[light_mod.POSDIR]
        lcolor = lrow[light_mod.COLOR]
        power = lrow[light_mod.POWER]
        is_point = posdir[3] == 1.0

        lv = posdir[:3] - point
        dist = torch.clamp_min(torch.sqrt(dot3(lv, lv)), 0.001)
        p3 = posdir[:3]
        l_dir = torch.where(
            is_point, lv / dist[:, None],
            p3 / torch.clamp_min(torch.sqrt(dot3(p3, p3)), 1e-20))
        attenuation = torch.where(is_point, power / (dist * dist), power)

        n_dot_l = torch.clamp_min(dot3(n, l_dir), 0.0)
        lit = n_dot_l > 0.0  # editor_fragment.glsl:84 continue
        h = normalize(v + l_dir, eps=1e-20)
        n_dot_h = torch.clamp_min(dot3(n, h), 0.0)
        v_dot_h = torch.clamp_min(dot3(v, h), 0.0)

        rough = torch.clamp(roughness, 0.05, 1.0)  # editor_fragment.glsl:91
        a = rough * rough
        a2 = a * a
        dden = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
        d = a2 / torch.clamp_min(PI_REF * dden * dden, 1e-4)
        kp = rough + 1.0
        k = kp * kp / 8.0
        g = (n_dot_v / (n_dot_v * (1.0 - k) + k + 1e-6)) * (
            n_dot_l / (n_dot_l * (1.0 - k) + k + 1e-6)
        )
        f = fresnel_schlick(v_dot_h[:, None], f0)
        spec = f * (d * g)[:, None] / torch.clamp_min(
            4.0 * n_dot_v * n_dot_l, 1e-4)[:, None]
        kd = (1.0 - f) * (1.0 - metallic[:, None])
        diffuse = kd * albedo / PI_REF
        contrib = (diffuse + spec) * lcolor * (attenuation * n_dot_l)[:, None]
        color = color + torch.where(lit[:, None], contrib, 0.0)

    # transparency display mix (editor_fragment.glsl:105-107)
    mix_amt = torch.clamp(transparency, 0.0, 1.0) * 0.5
    return color * (1.0 - mix_amt[:, None]) + albedo * mix_amt[:, None]


def primary_hit(ws: WorldArrays, origin, direction, active, cfg: RenderConfig):
    """The frame's closest hits: K7 on CUDA tensors, traverse_world (the
    plain version) on CPU tensors."""
    if origin.is_cuda:
        return walk.closest_hit_misslink(ws, origin, direction, active,
                                         width=cfg.width, height=cfg.height)
    if origin.device.type != "cpu":
        raise ValueError(f"no preview walk for device {origin.device}")
    return traverse_world(ws, origin, direction, active)


def render_preview(arrays: SceneArrays, camera_params: dict, cfg: RenderConfig):
    """(H, W, 3) preview frame on the device of ``arrays``: primary
    visibility and editor shading, the sky where rays miss."""
    dev = arrays.transforms.device
    _, uv = camera_rays.pixel_grid(cfg.width, cfg.height, dev)
    origin, direction = camera_rays.generate_rays(
        uv, torch.zeros_like(uv), camera_params["inv_proj"],
        camera_params["inv_view"], camera_params["position"])
    active = torch.ones(direction.shape[0], dtype=torch.bool, device=dev)
    ws = world_geometry(arrays)
    hit = primary_hit(ws, origin, direction, active, cfg)
    normal, material, _ = hit_shading_data(ws, hit)
    cam_pos = camera_rays.camera_tensor(camera_params["position"], dev)
    view_dir = normalize(cam_pos - hit.point, eps=1e-20)
    shaded = shade_preview(ws, hit.point, normal, material, view_dir, cfg)
    color = torch.where(hit.found[:, None], shaded, sky_color(direction, cfg))
    color = torch.clamp(color, 0.0, 1.0)
    return color.reshape(cfg.height, cfg.width, 3)
