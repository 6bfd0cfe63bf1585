"""Shading of the per-wave path: GGX direct lighting with transmission
shadow rays, the sky, and the BSDF sampling helpers.

Port of rayzen_tpu/ops/shade.py (from RayZen/shaders/fragment_shader.glsl):
fresnelSchlick (:533), reflectRay (:537), refractDir (:558-567),
randomHemisphereDirection (:192-202), shadowVisibility (:507-528),
calculateLighting (:569-663) and the sky gradient miss shader (:706-709).
Dense tensor math over a wave of rays, every expression in the JAX
package's order; the light loop runs over the light table's rows. The
reference's literal 3.14159 for pi is kept for image parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import light as light_mod
from .. import material as mat_mod
from ..config import RenderConfig
from ..packing import WorldArrays
from .intersect import cross3, dot3, normalize
from .traverse import shadow_walk

PI_REF = 3.14159  # the reference's pi (glsl:197,600,648,657)
SHADOW_EPS = 1e-3  # glsl:510


def pow5(x):
    """x ** 5 in jax.lax.integer_pow's order: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def _vec(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def sky_color(direction, cfg: RenderConfig):
    """Blueish gradient miss shader (glsl:706-709): (R, 3)."""
    t = 0.5 * (direction[..., 1] + 1.0)
    horizon = _vec(cfg.sky_horizon, direction.device)
    zenith = _vec(cfg.sky_zenith, direction.device)
    return horizon + (zenith - horizon) * t[..., None]


def fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * pow5(1.0 - cos_theta)


def reflect(incident, normal):
    return incident - 2.0 * dot3(incident, normal)[..., None] * normal


def refract_dir(incident, normal, eta):
    """(refracted, ok): ok False signals total internal reflection
    (glsl:558-567). ``normal`` must oppose ``incident``."""
    cosi = torch.clamp(dot3(-incident, normal), -1.0, 1.0)
    sint2 = torch.clamp_min(1.0 - cosi * cosi, 0.0)
    k = 1.0 - eta * eta * sint2
    ok = k >= 0.0
    k_safe = torch.clamp_min(k, 0.0)
    refr = (eta[..., None] * incident
            + (eta * cosi - torch.sqrt(k_safe))[..., None] * normal)
    return normalize(refr, eps=1e-20), ok


def hemisphere_direction(normal, u, v):
    """Cosine-ish hemisphere sample in the normal's tangent frame
    (randomHemisphereDirection, glsl:192-202): theta = acos(sqrt(1 - u))."""
    ct = torch.sqrt(1.0 - u)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * PI_REF * v
    dx = st * torch.cos(phi)
    dy = st * torch.sin(phi)
    dz = ct
    up = torch.where(
        (normal[..., 1].abs() < 0.99)[..., None],
        _vec([0.0, 1.0, 0.0], normal.device),
        _vec([1.0, 0.0, 0.0], normal.device),
    )
    tangent = normalize(cross3(up, normal), eps=1e-20)
    bitangent = cross3(normal, tangent)
    out = tangent * dx[..., None] + bitangent * dy[..., None] + normal * dz[..., None]
    return normalize(out, eps=1e-20)


class ShadowResult(NamedTuple):
    visible: torch.Tensor  # (R,) bool
    visibility: torch.Tensor  # (R,) float: accumulated transmission
    rays: torch.Tensor  # () int64: occlusion rays cast


def shadow_visibility(ws: WorldArrays, origin, direction, max_dist, active,
                      cfg: RenderConfig, shadow_fn=None) -> ShadowResult:
    """Transparent-aware occlusion query (shadowVisibility, glsl:507-528) as
    one transmission walk (``shadow_fn``, traverse.shadow_walk by default):
    opaque blocker -> 0, the product of the transparencies otherwise,
    invisible at or below cfg.shadow_min_visibility."""
    fn = shadow_fn or shadow_walk
    max_dist = torch.broadcast_to(
        torch.as_tensor(max_dist, dtype=torch.float32, device=origin.device),
        (origin.shape[0],))
    vis, rays = fn(ws, origin, direction, max_dist, active,
                   min_visibility=cfg.shadow_min_visibility, t_eps=SHADOW_EPS)
    visible = (vis > cfg.shadow_min_visibility) & active
    return ShadowResult(visible, vis, rays)


def direct_lighting(ws: WorldArrays, point, normal, material, view_dir, active,
                    cfg: RenderConfig, shadow_fn=None):
    """calculateLighting (glsl:569-663) on bounce 0: per light one shadow
    ray (the expensive part), then the transparent specular-only lobe and
    the standard diffuse + specular lobe, both evaluated and selected per
    ray. Returns (radiance (R, 3), shadow rays cast () int64)."""
    albedo = material[:, mat_mod.ALBEDO]
    metallic = material[:, mat_mod.METALLIC]
    roughness = material[:, mat_mod.ROUGHNESS]
    transparency = material[:, mat_mod.TRANSPARENCY]
    ior = material[:, mat_mod.IOR]
    is_transparent = transparency > 0.0

    # transparent F0 from the IOR (glsl:572); standard mix(0.04, albedo, metal)
    q = (1.0 - ior) / (1.0 + ior)
    f0_trans = q * q
    f0_std = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]

    out_std = _vec(cfg.ambient, point.device) * albedo  # (glsl:612)
    out_trans = torch.zeros_like(albedo)  # the transparent path: no ambient

    n_dot_v = torch.clamp_min(dot3(normal, view_dir), 0.0)
    shadow_rays = torch.zeros((), dtype=torch.int64, device=point.device)

    for li in range(ws.num_lights):
        lrow = ws.lights[li]
        posdir = lrow[light_mod.POSDIR]
        color = lrow[light_mod.COLOR]
        power = lrow[light_mod.POWER]
        is_point = posdir[3] == 1.0

        lv = posdir[:3] - point
        dist = torch.clamp_min(torch.sqrt(dot3(lv, lv)), 0.001)
        l_point = lv / dist[:, None]
        p3 = posdir[:3]
        l_dirl = p3 / torch.clamp_min(torch.sqrt(dot3(p3, p3)), 1e-20)
        l_dir = torch.where(is_point, l_point, l_dirl)
        attenuation = torch.where(is_point, power / (dist * dist), power)
        max_dist = torch.where(is_point, dist, 1e30)

        shadow = shadow_visibility(ws, point + l_dir * 0.001, l_dir, max_dist,
                                   active, cfg, shadow_fn=shadow_fn)
        attenuation = attenuation * shadow.visibility
        lit = active & shadow.visible
        shadow_rays = shadow_rays + shadow.rays

        n_dot_l = torch.clamp_min(dot3(normal, l_dir), 0.0)
        h = normalize(l_dir + view_dir, eps=1e-20)
        n_dot_h = torch.clamp_min(dot3(normal, h), 0.0)
        h_dot_v = torch.clamp_min(dot3(h, view_dir), 0.0)

        # --- transparent specular-only lobe (glsl:571-609) ---
        f_t = fresnel_schlick(h_dot_v, f0_trans)
        rough_t = torch.clamp_min(roughness, 0.02)
        a_t = rough_t * rough_t
        a2_t = a_t * a_t
        dden_t = n_dot_h * n_dot_h * (a2_t - 1.0) + 1.0
        d_t = a2_t / (PI_REF * dden_t * dden_t + 1e-6)
        kp = rough_t + 1.0
        k_t = kp * kp / 8.0
        gv_t = n_dot_v / (n_dot_v * (1.0 - k_t) + k_t + 1e-6)
        gl_t = n_dot_l / (n_dot_l * (1.0 - k_t) + k_t + 1e-6)
        denom_t = torch.clamp_min(4.0 * n_dot_l * n_dot_v, 1e-4)
        spec_t = (f_t * d_t * gv_t * gl_t) / denom_t
        contrib_t = spec_t[:, None] * color * (attenuation * n_dot_l)[:, None]
        lit_t = lit & (n_dot_l > 0.0)  # glsl:591 continue
        out_trans = out_trans + torch.where(lit_t[:, None], contrib_t, 0.0)

        # --- standard diffuse + specular (glsl:611-660) ---
        f_s = fresnel_schlick(h_dot_v[:, None], f0_std)
        alpha = roughness * roughness
        alpha2 = alpha * alpha
        dden_s = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
        d_s = alpha2 / torch.clamp_min(PI_REF * dden_s * dden_s, 1e-12)
        ks = roughness + 1.0
        k_s = ks * ks / 8.0
        g_s = n_dot_v / (n_dot_v * (1.0 - k_s) + k_s)
        g_s = g_s * (n_dot_l / (n_dot_l * (1.0 - k_s) + k_s))
        denom_s = torch.clamp_min(4.0 * n_dot_v * n_dot_l, 1e-4)
        spec_s = f_s * (d_s * g_s / denom_s)[:, None]
        diffuse = (1.0 - f_s) * albedo * (n_dot_l / PI_REF)[:, None]
        contrib_s = torch.clamp_min(
            (diffuse + spec_s) * color * attenuation[:, None], 0.0)
        out_std = out_std + torch.where(lit[:, None], contrib_s, 0.0)

    return torch.where(is_transparent[:, None], out_trans, out_std), shadow_rays
