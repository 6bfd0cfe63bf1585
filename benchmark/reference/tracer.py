"""The plain reference path tracer: what a progressive frame of the
upstream RayZen shader is, written out in plain PyTorch from the scene's
own arrays.

It imports nothing of the program. From the benchmark's scene arrays
(harness/scenes.py) it works out its own world triangles, its own camera
matrices and rays, and finds hits by brute force: every ray is tested
against every triangle of each instance whose world box it crosses, so no
acceleration structure can be wrong here. Shading follows the upstream
fragment shader (fragment_shader.glsl): direct lighting with transmission
shadow rays on the first hit only (:569-663, :716), the Fresnel/TIR
dielectric and the stochastic mirror-or-diffuse scatter (:722-756), the
0.003 self-intersection push (:758-761), Russian roulette from bounce
rr_start + 1 reusing the scatter draw (:764-769), the sky gradient on a
miss (:706-709), and the /spp clip (:772-773). Draws are the sin hash
(reference/rng.py), keyed per pixel and sample index, where the sample
index of sample s of frame k is k * spp + s (the progressive flow).

``dtype`` is the precision of the geometry and shading arithmetic
(float32 as the configuration states; bfloat16 for the control). The
draws are defined bit for bit on float32 and stay so.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng

PI_REF = 3.14159  # the shader's PI (glsl:197)
DET_EPS = 1e-4  # hitTriangle's determinant and t epsilons (glsl:391-416)
T_EPS = 1e-4
SHADOW_T_EPS = 1e-3
PAIR_ELEMS = 1 << 22  # (ray, triangle) tests per chunk of the brute force


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAt (right-handed), in float64, rounded to float32."""
    eye, center, up = (np.asarray(x, np.float64) for x in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m.astype(np.float32)


def perspective(fovy_rad, aspect, near, far) -> np.ndarray:
    """glm::perspective (right-handed, clip z in [-1, 1])."""
    t = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def camera_table(cam: dict) -> np.ndarray:
    """(9, 4) float32: the inverse projection, the inverse view, the eye."""
    pos = np.asarray(cam["position"], np.float32)
    view = look_at(pos, pos + np.asarray(cam["target"], np.float32),
                   np.asarray(cam["up"], np.float32))
    proj = perspective(np.radians(cam["fov"]), cam["aspect"], cam["near"],
                       cam["far"])
    inv = lambda m: np.linalg.inv(m.astype(np.float64)).astype(np.float32)  # noqa: E731
    return np.concatenate([inv(proj), inv(view), np.append(pos, 0.0)[None]]
                          ).astype(np.float32)


@dataclasses.dataclass
class World:
    """World-space triangles padded per instance: tri (I, Tmax, 9) [v0 e1
    e2], cross (I, Tmax, 3), mat (I, Tmax) int64, transp (I, Tmax), count
    (I,), the instances' boxes, and the orientation sign per instance."""

    tri: torch.Tensor
    cross: torch.Tensor
    mat: torch.Tensor
    transp: torch.Tensor
    count: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    nsign: torch.Tensor
    materials: torch.Tensor
    lights: torch.Tensor


def _apply(r, v):
    """r (3, 3) @ v (T, 3), each row summed left to right."""
    return np.stack([(r[i, 0] * v[:, 0] + r[i, 1] * v[:, 1]) + r[i, 2] * v[:, 2]
                     for i in range(3)], 1).astype(np.float32)


def build_world(scene: dict, device, dtype=torch.float32) -> World:
    insts = [(scene["meshes"][m], x, mo) for m, x, mo in scene["instances"]
             if scene["meshes"][m].shape[0]]
    tmax = max(v.shape[0] for v, _, _ in insts)
    n = len(insts)
    tri = np.zeros((n, tmax, 9), np.float32)
    mat = np.zeros((n, tmax), np.int64)
    count = np.zeros(n, np.int64)
    nsign = np.ones(n, np.float32)
    for i, (verts, m, override) in enumerate(insts):
        r, t = m[:3, :3], m[:3, 3]
        v0 = verts[:, 0]
        e1 = (verts[:, 1] - verts[:, 0]).astype(np.float32)
        e2 = (verts[:, 2] - verts[:, 0]).astype(np.float32)
        k = verts.shape[0]
        tri[i, :k] = np.concatenate([_apply(r, v0) + t, _apply(r, e1),
                                     _apply(r, e2)], 1)
        mat[i, :k] = override if override >= 0 else 0  # the OBJ loader stamps 0
        count[i] = k
        nsign[i] = -1.0 if np.linalg.det(r.astype(np.float64)) < 0 else 1.0
    materials = np.asarray(scene["materials"], np.float32)
    a, b = tri[..., 3:6], tri[..., 6:9]
    cross = np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                      a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                      a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)
    corners = np.stack([tri[..., 0:3], tri[..., 0:3] + tri[..., 3:6],
                        tri[..., 0:3] + tri[..., 6:9]], 2)  # (I, Tmax, 3, 3)
    valid = (np.arange(tmax)[None, :] < count[:, None])[..., None, None]
    bmin = np.where(valid, corners, np.inf).min(axis=(1, 2))
    bmax = np.where(valid, corners, -np.inf).max(axis=(1, 2))
    pad = 1e-4 * (bmax - bmin).max(axis=1, keepdims=True) + 1e-5
    dev = torch.device(device)
    td = lambda x: torch.as_tensor(x, device=dev).to(dtype)  # noqa: E731
    return World(
        tri=td(tri), cross=td(cross), mat=torch.as_tensor(mat, device=dev),
        transp=td(materials[mat, 6]), count=torch.as_tensor(count, device=dev),
        bmin=td(bmin - pad), bmax=td(bmax + pad), nsign=td(nsign),
        materials=td(materials),
        lights=td(np.asarray(scene["lights"], np.float32).reshape(-1, 8)))


def _safe_inv(d):
    return torch.where(d >= 0.0, 1.0, -1.0).to(d.dtype) / torch.clamp_min(d.abs(), 1e-30)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _moller_trumbore(o, d, tri):
    """hitTriangle (glsl:391-416) for rays o, d (S, 1, 3) against tri
    (S, T, 9): (t, hit) (S, T)."""
    v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    h = _cross(d, e2)
    a = _dot(e1, h)
    valid = a.abs() >= DET_EPS
    f = 1.0 / torch.where(valid, a, torch.ones_like(a))
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    hit = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_EPS)
    return t, hit


class Counter:
    """Ray-triangle tests made (the brute force's own work, for the log)."""

    def __init__(self):
        self.tests = 0


def _pairs(world: World, o, d):
    """(ray, instance) pairs whose instance box the ray crosses."""
    inv = _safe_inv(d)
    out_r, out_i = [], []
    step = max(1, PAIR_ELEMS // max(1, world.bmin.shape[0]))
    for r0 in range(0, o.shape[0], step):
        oo, ii = o[r0:r0 + step, None, :], inv[r0:r0 + step, None, :]
        t0 = (world.bmin[None] - oo) * ii
        t1 = (world.bmax[None] - oo) * ii
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        r, i = (tmax >= torch.clamp_min(tmin, 0.0)).nonzero(as_tuple=True)
        out_r.append(r + r0)
        out_i.append(i)
    return torch.cat(out_r), torch.cat(out_i)


def _chunks(world: World, o, d, counter):
    """Yields (ray ids, t (S, T), hit (S, T), instance ids) over every pair
    of a ray and an instance box it crosses, the instance's padding
    triangles never hit."""
    rays, insts = _pairs(world, o, d)
    tmax = world.tri.shape[1]
    ar = torch.arange(tmax, device=o.device)
    step = max(1, PAIR_ELEMS // tmax)
    for p0 in range(0, rays.numel(), step):
        r, i = rays[p0:p0 + step], insts[p0:p0 + step]
        t, hit = _moller_trumbore(o[r][:, None, :], d[r][:, None, :], world.tri[i])
        hit = hit & (ar[None, :] < world.count[i][:, None])
        if counter is not None:
            counter.tests += int(world.count[i].sum())
        yield r, t, hit, i


def closest(world: World, o, d, counter=None):
    """Closest hit of each ray: (t, instance, triangle slot), -1 on a
    miss. Equal t goes to the lower (instance, slot)."""
    n = o.shape[0]
    big = torch.finfo(o.dtype).max
    t_best = torch.full((n,), big, dtype=o.dtype, device=o.device)
    cands = []
    for r, t, hit, i in _chunks(world, o, d, counter):
        tm = torch.where(hit, t, torch.full_like(t, big))
        tmin, slot = tm.min(dim=1)
        keep = tmin < big
        r, i, tmin, slot = r[keep], i[keep], tmin[keep], slot[keep]
        t_best.scatter_reduce_(0, r, tmin, "amin")
        cands.append((r, i, tmin, slot))
    code = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=o.device)
    tmax = world.tri.shape[1]
    for r, i, tmin, slot in cands:
        win = tmin == t_best[r]
        code.scatter_reduce_(0, r[win], (i * tmax + slot)[win], "amin")
    found = t_best < big
    code = torch.where(found, code, 0)
    return t_best, found, code // tmax, code % tmax


def visibility(world: World, o, d, max_dist, counter=None):
    """Transmission shadow walk: the product of the transparencies of every
    triangle hit with SHADOW_T_EPS <= t < max_dist (a shadow walk stops
    once the product falls to the floor, where it no longer lights)."""
    vis = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)
    for r, t, hit, i in _chunks(world, o, d, counter):
        block = hit & (t >= SHADOW_T_EPS) & (t < max_dist[r][:, None])
        f = torch.where(block, world.transp[i], torch.ones_like(t)).prod(dim=1)
        vis.scatter_reduce_(0, r, f, "prod")
    return vis


def _normalize(x, y, z, eps):
    n = torch.clamp_min(torch.sqrt(x * x + y * y + z * z), eps)
    return x / n, y / n, z / n


def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def _hemisphere(nx, ny, nz, u, v):
    """randomHemisphereDirection (glsl:192-202)."""
    ct = torch.sqrt(1.0 - u)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * PI_REF * v
    lx, ly, lz = st * torch.cos(phi), st * torch.sin(phi), ct
    m = ny.abs() < 0.99
    ux = torch.where(m, 0.0, 1.0).to(nx.dtype)
    uy = torch.where(m, 1.0, 0.0).to(nx.dtype)
    uz = torch.zeros_like(ux)
    tx, ty, tz = uy * nz - uz * ny, uz * nx - ux * nz, ux * ny - uy * nx
    tx, ty, tz = _normalize(tx, ty, tz, 1e-20)
    bx, by, bz = ny * tz - nz * ty, nz * tx - nx * tz, nx * ty - ny * tx
    return _normalize(tx * lx + bx * ly + nx * lz, ty * lx + by * ly + ny * lz,
                      tz * lx + bz * ly + nz * lz, 1e-20)


def _scatter(dx, dy, dz, nx, ny, nz, cur_ior, rand_val, hu, hv, mat):
    """The material's scatter (glsl:722-756): (new direction, throughput
    factor rgb, new ior)."""
    ar, ag, ab, _metal, _rough, refl, transp, mat_ior = mat
    is_trans = transp > 0.0
    entering = -(dx * nx + dy * ny + dz * nz) > 0.0
    sgn = torch.where(entering, 1.0, -1.0).to(dx.dtype)
    nox, noy, noz = nx * sgn, ny * sgn, nz * sgn
    next_ior = torch.where(entering, mat_ior, torch.ones_like(mat_ior))
    eta = cur_ior / next_ior
    mdn = -(dx * nox + dy * noy + dz * noz)
    cosi = torch.clamp(mdn, 0.0, 1.0)
    q = (cur_ior - next_ior) / (cur_ior + next_ior)
    f0 = q * q
    fresnel = f0 + (1.0 - f0) * pow5(1.0 - cosi)
    cosi2 = torch.clamp(mdn, -1.0, 1.0)
    sint2 = torch.clamp_min(1.0 - cosi2 * cosi2, 0.0)
    kk = 1.0 - eta * eta * sint2
    refr_ok = kk >= 0.0
    w = eta * cosi2 - torch.sqrt(torch.clamp_min(kk, 0.0))
    rf = _normalize(eta * dx + w * nox, eta * dy + w * noy, eta * dz + w * noz, 1e-20)
    tir = is_trans & ~refr_ok
    refr = is_trans & refr_ok
    mirror = ~is_trans & (rand_val < refl)
    ddn = dx * nox + dy * noy + dz * noz
    to = (dx - 2.0 * ddn * nox, dy - 2.0 * ddn * noy, dz - 2.0 * ddn * noz)
    ddn = dx * nx + dy * ny + dz * nz
    tn = (dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, dz - 2.0 * ddn * nz)
    hd = _hemisphere(nx, ny, nz, hu, hv)

    def pick(a, b, c, e):
        return torch.where(tir, a, torch.where(refr, b, torch.where(mirror, c, e)))

    def factor(a):
        tint = (1.0 - transp) + a * transp
        return pick(torch.full_like(a, 0.98),
                    torch.clamp(tint * transp * (1.0 - fresnel), 0.0, 1.0),
                    torch.full_like(a, 0.95), a * 0.4)

    new_dir = tuple(pick(to[k], rf[k], tn[k], hd[k]) for k in range(3))
    return new_dir, (factor(ar), factor(ag), factor(ab)), torch.where(refr, next_ior, cur_ior)


def _direct(world: World, fr: dict, p, n, v, mat, counter, walker=None):
    """calculateLighting (glsl:569-663) at hit points p with normals n and
    view directions v: radiance rgb."""
    px, py, pz = p
    nx, ny, nz = n
    vx, vy, vz = v
    ar, ag, ab, metallic, roughness, _refl, transp, mat_ior = mat
    dt = px.dtype
    amb = [rng.f32(a) for a in fr["ambient"]]
    min_vis = rng.f32(fr["shadow_min_visibility"])
    q = (1.0 - mat_ior) / (1.0 + mat_ior)
    f0t = q * q
    f0s = [0.04 * (1.0 - metallic) + a * metallic for a in (ar, ag, ab)]
    outs = [amb[0] * ar, amb[1] * ag, amb[2] * ab]
    outt = [torch.zeros_like(ar) for _ in range(3)]
    n_dot_v = torch.clamp_min(nx * vx + ny * vy + nz * vz, 0.0)
    for li in range(world.lights.shape[0]):
        g = world.lights[li]
        is_point = bool(g[3] == 1.0)
        if is_point:
            lvx, lvy, lvz = g[0] - px, g[1] - py, g[2] - pz
            dist = torch.clamp_min(torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz), 0.001)
            ldx, ldy, ldz = lvx / dist, lvy / dist, lvz / dist
            atten = g[7] / (dist * dist)
            max_dist = dist
        else:
            dn = torch.sqrt(torch.clamp_min(g[0] * g[0] + g[1] * g[1] + g[2] * g[2], 1e-40))
            ldx, ldy, ldz = (torch.full_like(px, 0.0) + g[k] / dn for k in range(3))
            atten = torch.full_like(px, 0.0) + g[7]
            max_dist = torch.full_like(px, 1e30)
        so = torch.stack([px + ldx * 0.001, py + ldy * 0.001, pz + ldz * 0.001], 1)
        sd = torch.stack([ldx, ldy, ldz], 1)
        vis = (walker.visibility(so, sd, max_dist, min_vis) if walker is not None
               else visibility(world, so, sd, max_dist, counter))
        atten = atten * vis
        lit = vis > min_vis
        n_dot_l = torch.clamp_min(nx * ldx + ny * ldy + nz * ldz, 0.0)
        hx, hy, hz = _normalize(ldx + vx, ldy + vy, ldz + vz, 1e-20)
        n_dot_h = torch.clamp_min(nx * hx + ny * hy + nz * hz, 0.0)
        h_dot_v = torch.clamp_min(hx * vx + hy * vy + hz * vz, 0.0)
        p5 = pow5(1.0 - h_dot_v)
        # transparent surfaces: a specular-only lobe (glsl:571-609)
        f_t = f0t + (1.0 - f0t) * p5
        rough_t = torch.clamp_min(roughness, 0.02)
        r2 = rough_t * rough_t
        a2_t = r2 * r2
        dden_t = n_dot_h * n_dot_h * (a2_t - 1.0) + 1.0
        d_t = a2_t / (PI_REF * dden_t * dden_t + 1e-6)
        k_t = (rough_t + 1.0) * (rough_t + 1.0) / 8.0
        gv_t = n_dot_v / (n_dot_v * (1.0 - k_t) + k_t + 1e-6)
        gl_t = n_dot_l / (n_dot_l * (1.0 - k_t) + k_t + 1e-6)
        denom_t = torch.clamp_min(4.0 * n_dot_l * n_dot_v, 1e-4)
        spec_t = (f_t * d_t * gv_t * gl_t) / denom_t
        lit_t = lit & (n_dot_l > 0.0)
        wt = spec_t * atten * n_dot_l
        zero = torch.zeros((), dtype=dt, device=px.device)
        for c in range(3):
            outt[c] = outt[c] + torch.where(lit_t, wt * g[4 + c], zero)
        # opaque surfaces: diffuse and specular (glsl:611-660)
        r2s = roughness * roughness
        alpha2 = r2s * r2s
        dden_s = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
        d_s = alpha2 / torch.clamp_min(PI_REF * dden_s * dden_s, 1e-12)
        k_s = (roughness + 1.0) * (roughness + 1.0) / 8.0
        g_s = n_dot_v / (n_dot_v * (1.0 - k_s) + k_s)
        g_s = g_s * (n_dot_l / (n_dot_l * (1.0 - k_s) + k_s))
        denom_s = torch.clamp_min(4.0 * n_dot_v * n_dot_l, 1e-4)
        dg = d_s * g_s / denom_s
        ndl_pi = _div(n_dot_l, PI_REF)
        for c, a in enumerate((ar, ag, ab)):
            f_s = f0s[c] + (1.0 - f0s[c]) * p5
            val = torch.clamp_min(((1.0 - f_s) * a * ndl_pi + f_s * dg) * g[4 + c] * atten, 0.0)
            outs[c] = outs[c] + torch.where(lit, val, zero)
    return tuple(torch.where(transp > 0.0, outt[c], outs[c]) for c in range(3))


def trace_paths(world: World, fr: dict, cam: np.ndarray, u, v, samp_f,
                counter: Counter | None = None, walker=None):
    """One path per entry of u, v (float32 uv of its pixel) and samp_f
    (float32 sample index). Returns (radiance (n, 3) in world.dtype,
    rays (n,) int64: the closest-hit queries and shadow rays cast).
    ``walker`` (reference/bvh.Walker) finds the hits instead of the brute
    force, counting its work."""
    dev, dt = u.device, world.tri.dtype
    n = u.shape[0]
    W, H = fr["width"], fr["height"]
    camt = torch.as_tensor(cam, device=dev).to(dt)
    sky_h = [rng.f32(h) for h in fr["sky_horizon"]]
    sky_d = [rng.f32(z - h) for h, z in zip(fr["sky_horizon"], fr["sky_zenith"])]
    n_lights = world.lights.shape[0]
    # the sample's seeds (glsl:688), camera jitter (:205): float32 draws
    scale = ((torch.floor(u * W) + torch.floor(v * H)) + 1.0) + (samp_f + 1.0)
    s0, s1 = u * scale, v * scale
    jx = (rng.rand(s0, s1) * 0.00002)
    jy = (rng.rand(s0 + 1.0, s1 + 1.0) * 0.00002)

    def draws(b, sel):
        return tuple(x.to(dt) for x in rng.bounce_draws(s0[sel], s1[sel], samp_f[sel], b))

    # calculateRay (glsl:204-212)
    ndx = (u.to(dt) + jx.to(dt)) * 2.0 - 1.0
    ndy = (v.to(dt) + jy.to(dt)) * 2.0 - 1.0
    e0 = camt[0, 0] * ndx + camt[0, 1] * ndy - camt[0, 2] + camt[0, 3]
    e1 = camt[1, 0] * ndx + camt[1, 1] * ndy - camt[1, 2] + camt[1, 3]
    wd = [camt[4 + k, 0] * e0 + camt[4 + k, 1] * e1 - camt[4 + k, 2] for k in range(3)]
    dx, dy, dz = _normalize(*wd, 0.0)
    ox, oy, oz = (torch.zeros_like(dx) + camt[8, k] for k in range(3))

    color = torch.zeros((n, 3), dtype=dt, device=dev)
    rays = torch.ones((n,), dtype=torch.int64, device=dev)
    sel = torch.arange(n, device=dev)
    tp = [torch.ones((n,), dtype=dt, device=dev) for _ in range(3)]
    ior = torch.ones((n,), dtype=dt, device=dev)
    rr_start = int(fr["rr_start_bounce"])
    rr_on = rr_start < fr["max_bounces"] - 1
    for b in range(fr["max_bounces"]):
        if not sel.numel():
            break
        if b:
            rays[sel] += 1
        ro, rd = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
        t, found, inst, slot = (walker.closest(ro, rd) if walker is not None
                                else closest(world, ro, rd, counter))
        miss = ~found
        if miss.any():
            sky = torch.stack([tp[c][miss] * (sky_h[c] + sky_d[c] * (0.5 * (dy[miss] + 1.0)))
                               for c in range(3)], 1)
            color[sel[miss]] += sky
        keep = found.nonzero()[:, 0]
        sel, t, inst, slot = sel[keep], t[keep], inst[keep], slot[keep]
        ox, oy, oz, dx, dy, dz, ior = (x[keep] for x in (ox, oy, oz, dx, dy, dz, ior))
        tp = [x[keep] for x in tp]
        cr = world.cross[inst, slot]
        sg = world.nsign[inst]
        nx, ny, nz = _normalize(cr[:, 0], cr[:, 1], cr[:, 2], 1e-20)
        nx, ny, nz = nx * sg, ny * sg, nz * sg
        mat = world.materials[world.mat[inst, slot]].unbind(1)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        if b == 0:
            rays[sel] += n_lights
            vv = _normalize(camt[8, 0] - px, camt[8, 1] - py, camt[8, 2] - pz, 1e-20)
            direct = _direct(world, fr, (px, py, pz), (nx, ny, nz), vv, mat, counter,
                             walker)
            color[sel] += torch.stack(direct, 1)
        rand_val, hu, hv = draws(b, sel)
        (ndx_, ndy_, ndz_), fac, ior = _scatter(dx, dy, dz, nx, ny, nz, ior,
                                                rand_val, hu, hv, mat)
        if b:
            tp = [tp[c] * fac[c] for c in range(3)]
        else:
            tp = list(fac)
        push = torch.where(ndx_ * nx + ndy_ * ny + ndz_ * nz > 0.0, 0.003, -0.003).to(dt)
        ox, oy, oz = px + nx * push, py + ny * push, pz + nz * push
        dx, dy, dz = ndx_, ndy_, ndz_
        if rr_on and b > rr_start:
            p = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
            inv_p = 1.0 / torch.clamp_min(p, 1e-12)
            tp = [x * inv_p for x in tp]
            keep = (~(rand_val > p)).nonzero()[:, 0]
            sel = sel[keep]
            ox, oy, oz, dx, dy, dz, ior = (x[keep] for x in (ox, oy, oz, dx, dy, dz, ior))
            tp = [x[keep] for x in tp]
    return color, rays


def _div(a, b: float):
    """a / b rounded as IEEE division on every device: PyTorch's CUDA
    kernels divide by a host scalar as a multiply by its reciprocal, which
    moves a uv by an ulp, and the sin hash turns that into another path."""
    return a / torch.full_like(a, b)


def pixel_uv(width: int, height: int, x, y, device):
    """gl_FragCoord / resolution of pixels (x, y), y counted from the
    bottom row: float32 (n,) each."""
    fx = torch.as_tensor(np.asarray(x), device=device).to(torch.float32) + 0.5
    fy = torch.as_tensor(np.asarray(y), device=device).to(torch.float32) + 0.5
    return _div(fx, float(width)), _div(fy, float(height))


def primary_hits(world: World, fr: dict, cam: np.ndarray, x, y) -> np.ndarray:
    """(n,) bool: whether the ray through each pixel's centre hits any
    triangle."""
    dev, dt = world.tri.device, world.tri.dtype
    u, v = pixel_uv(fr["width"], fr["height"], x, y, dev)
    camt = torch.as_tensor(cam, device=dev).to(dt)
    ndx, ndy = u.to(dt) * 2.0 - 1.0, v.to(dt) * 2.0 - 1.0
    e0 = camt[0, 0] * ndx + camt[0, 1] * ndy - camt[0, 2] + camt[0, 3]
    e1 = camt[1, 0] * ndx + camt[1, 1] * ndy - camt[1, 2] + camt[1, 3]
    d = torch.stack(_normalize(*[camt[4 + k, 0] * e0 + camt[4 + k, 1] * e1 - camt[4 + k, 2]
                                 for k in range(3)], 0.0), 1)
    o = torch.zeros_like(d) + camt[8, :3]
    return closest(world, o, d)[1].cpu().numpy()


def render_frames(world: World, fr: dict, cam: np.ndarray, x, y, keys, spp: int,
                  counter: Counter | None = None, max_paths: int = 1 << 18,
                  samples: int | None = None):
    """The images of frames ``keys`` (each spp samples a pixel, sample
    index key * spp + s) at pixels (x, y): (F, P, 3) float32, the clipped
    mean of each pixel's samples summed in sample order, and the rays
    traced (F, P) int64. ``samples`` < spp traces only each frame's first
    samples (for their rays; the image then is of those samples)."""
    dev = world.tri.device
    u, v = pixel_uv(fr["width"], fr["height"], x, y, dev)
    P, F = u.shape[0], len(keys)
    n_s = spp if samples is None else samples
    # (frame, sample, pixel) paths, flattened in that order
    base = np.float32(0.0) + np.asarray(keys, np.float32) * np.float32(spp)
    samp = torch.as_tensor(base, device=dev)[:, None] + torch.arange(n_s, device=dev, dtype=torch.float32)[None]
    samp = samp[:, :, None].expand(F, n_s, P).reshape(-1)
    uu = u[None, None].expand(F, n_s, P).reshape(-1)
    vv = v[None, None].expand(F, n_s, P).reshape(-1)
    col = torch.empty((F * n_s * P, 3), dtype=world.tri.dtype, device=dev)
    rays = torch.empty((F * n_s * P,), dtype=torch.int64, device=dev)
    for i in range(0, uu.numel(), max_paths):
        col[i:i + max_paths], rays[i:i + max_paths] = trace_paths(
            world, fr, cam, uu[i:i + max_paths], vv[i:i + max_paths],
            samp[i:i + max_paths], counter)
    col = col.float().reshape(F, n_s, P, 3)
    total = torch.zeros((F, P, 3), dtype=torch.float32, device=dev)
    for s in range(n_s):  # summed one sample at a time, in order
        total = total + col[:, s]
    img = torch.clamp(total / float(n_s), 0.0, 1.0)
    return img, rays.reshape(F, n_s, P).sum(1)
