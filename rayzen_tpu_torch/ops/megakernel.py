"""Full path-tracing samples (K1): raygen, primary hit, direct lighting with
shadow rays, scatter and the bounce loop, ``n_samples`` samples summed per
pixel.

Counterpart of rayzen_tpu/ops/megakernel.py: ``sample_wave`` replaces its
``sample_wave`` (:1044) and the kernel body ``_make_sample_kernel`` (:460).
For CUDA tensors it launches csrc/sample_kernel.cu, one thread per pixel:
over the whole tree (K2/K3 walks), or, when the pack built the treelet view
(``ws.tiered``), its tiered instantiation (K8 walks), as the JAX package
does (:1097-1135). These and the wide form run the regenerating schedule
(warps of 8x4 screen pixels, one ray per lane per step, a lane starting its
next sample as soon as its path ends), K4's plain phase 1 too (one sample);
the K9 and K6 forms, of K1 and of phase 1, run the lockstep loop with the
same warp tiles and register budget. Both give each pixel the same result
bit for bit. The walk
knobs follow JAX's rules (:503-525, :1101-1105):
``wide_nodes`` runs the wide instantiation (K5 walks everywhere) and is
ignored, with an info log, on a tiered scene; ``frustum_primary`` runs the
primary closest hit as the warp-packet frustum walk (K6) and applies only
when the walk is neither wide nor tiered. For CPU tensors it runs
``sample_wave_reference``, the plain PyTorch version built from the helpers
below, each ported 1:1 from the JAX tile helpers (megakernel.py:56-457) with
the same operation order, on the plain walks of the same view. The plain
version is vectorised over rays: each bounce runs on the rays still alive.

Kept reference quirks (as in the JAX module): direct lighting on bounce 0
only, throughput trims 0.95 / 0.98 / albedo*0.4, the scatter draw reused for
Russian roulette, geometric unflipped normals, and a 0.003 self-intersection
offset signed by the new direction.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import ext
from .. import logging_util as log
from ..config import RenderConfig
from ..packing import WorldArrays
from ..profiler import span
from . import camera_rays, walk
from .shade import pow5
from .rng import (  # noqa: F401 (sinf_libm: the K1 tests read it here)
    _M32, _bounce_draws_hash, _bounce_draws_reference, _f32, _hash_u32,
    _ref_rand, _u32_to_unit_float, sinf_libm,
)

PI_REF = 3.14159  # glsl:197


# ---- elementwise helpers (1:1 with megakernel.py:56-143) -------------------


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _normalize(vx, vy, vz, eps):
    n = torch.clamp_min(torch.sqrt(vx * vx + vy * vy + vz * vz), eps)
    return vx / n, vy / n, vz / n


def _hemisphere(nx, ny, nz, u, v):
    """randomHemisphereDirection (glsl:192-202)."""
    ct = torch.sqrt(1.0 - u)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * PI_REF * v
    lx = st * torch.cos(phi)
    ly = st * torch.sin(phi)
    lz = ct
    m = ny.abs() < 0.99  # up = (0,1,0) else (1,0,0)
    ux = torch.where(m, 0.0, 1.0)
    uy = torch.where(m, 1.0, 0.0)
    tx, ty, tz = _cross(ux, uy, torch.zeros_like(ux), nx, ny, nz)
    tx, ty, tz = _normalize(tx, ty, tz, 1e-20)
    bx, by, bz = _cross(nx, ny, nz, tx, ty, tz)
    ox = tx * lx + bx * ly + nx * lz
    oy = ty * lx + by * ly + ny * lz
    oz = tz * lx + bz * ly + nz * lz
    return _normalize(ox, oy, oz, 1e-20)


def _material_columns(materials, mat_f):
    """Per-ray material fields (albedo rgb, metallic, roughness,
    reflectivity, transparency, ior): the row of material id ``mat_f``
    (float, exact), zeros where it is no material id — a gather where the
    TPU kernel needs a select chain."""
    n_mats = materials.shape[0]
    ok = (mat_f >= 0.0) & (mat_f < float(n_mats)) & (mat_f == torch.floor(mat_f))
    idx = torch.where(ok, mat_f, 0.0).long()
    cols = torch.where(ok[:, None], materials[idx], 0.0)
    return cols.unbind(1)


def _scatter_tiles(dx, dy, dz, nx, ny, nz, cur_ior, rand_val, hemi_u, hemi_v,
                   ar, ag, ab, refl, transp, mat_ior):
    """integrator._scatter (glsl:722-756). Returns (new_dir xyz,
    throughput factor rgb, new_ior)."""
    is_trans = transp > 0.0
    entering = -(dx * nx + dy * ny + dz * nz) > 0.0
    sgn = torch.where(entering, 1.0, -1.0)
    nox, noy, noz = nx * sgn, ny * sgn, nz * sgn
    next_ior = torch.where(entering, mat_ior, 1.0)
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
    rfx, rfy, rfz = _normalize(
        eta * dx + w * nox, eta * dy + w * noy, eta * dz + w * noz, 1e-20
    )

    tir_case = is_trans & ~refr_ok
    refract_case = is_trans & refr_ok
    mirror_case = ~is_trans & (rand_val < refl)

    d_dot_no = dx * nox + dy * noy + dz * noz
    tox = dx - 2.0 * d_dot_no * nox
    toy = dy - 2.0 * d_dot_no * noy
    toz = dz - 2.0 * d_dot_no * noz
    d_dot_n = dx * nx + dy * ny + dz * nz
    tnx = dx - 2.0 * d_dot_n * nx
    tny = dy - 2.0 * d_dot_n * ny
    tnz = dz - 2.0 * d_dot_n * nz
    hx, hy, hz = _hemisphere(nx, ny, nz, hemi_u, hemi_v)

    def pick(tir, refr, mirr, diff):
        return torch.where(
            tir_case, tir,
            torch.where(refract_case, refr, torch.where(mirror_case, mirr, diff)),
        )

    def factor(a):
        tint = (1.0 - transp) + a * transp
        return pick(
            torch.full_like(a, 0.98),
            torch.clamp(tint * transp * (1.0 - fresnel), 0.0, 1.0),
            torch.full_like(a, 0.95),
            a * 0.4,
        )

    new_ior = torch.where(refract_case, next_ior, cur_ior)
    return (pick(tox, rfx, tnx, hx), pick(toy, rfy, tny, hy),
            pick(toz, rfz, tnz, hz), factor(ar), factor(ag), factor(ab),
            new_ior)


def _raygen_tiles(u, v, jx, jy, cam):
    """calculateRay (glsl:204-212) from the packed (9, 4) camera table."""
    ndx = (u + jx) * 2.0 - 1.0
    ndy = (v + jy) * 2.0 - 1.0
    eye0 = cam[0, 0] * ndx + cam[0, 1] * ndy - cam[0, 2] + cam[0, 3]
    eye1 = cam[1, 0] * ndx + cam[1, 1] * ndy - cam[1, 2] + cam[1, 3]
    wx = cam[4, 0] * eye0 + cam[4, 1] * eye1 - cam[4, 2]
    wy = cam[5, 0] * eye0 + cam[5, 1] * eye1 - cam[5, 2]
    wz = cam[6, 0] * eye0 + cam[6, 1] * eye1 - cam[6, 2]
    dx, dy, dz = _normalize(wx, wy, wz, 0.0)
    ox = torch.zeros_like(dx) + cam[8, 0]
    oy = torch.zeros_like(dy) + cam[8, 1]
    oz = torch.zeros_like(dz) + cam[8, 2]
    return ox, oy, oz, dx, dy, dz


def _direct_lighting_tiles(ws, lights, min_vis, ambient, px, py, pz, nx, ny,
                           nz, vx, vy, vz, ar, ag, ab, metallic, roughness,
                           transp, mat_ior, work, shadow):
    """calculateLighting (glsl:569-663) with transmission shadow walks (the
    plain walk ``shadow``), for live rays only (``work``: the walks'
    walk.Work, if counted). Returns radiance rgb."""
    is_transparent = transp > 0.0
    q = (1.0 - mat_ior) / (1.0 + mat_ior)
    f0t = q * q
    f0sr = 0.04 * (1.0 - metallic) + ar * metallic
    f0sg = 0.04 * (1.0 - metallic) + ag * metallic
    f0sb = 0.04 * (1.0 - metallic) + ab * metallic
    outsr = ambient[0] * ar
    outsg = ambient[1] * ag
    outsb = ambient[2] * ab
    outtr = torch.zeros_like(ar)
    outtg = torch.zeros_like(ar)
    outtb = torch.zeros_like(ar)
    n_dot_v = torch.clamp_min(nx * vx + ny * vy + nz * vz, 0.0)
    live = torch.ones_like(ar, dtype=torch.bool)

    for li in range(lights.shape[0]):
        g = lambda c: lights[li, c]  # noqa: E731
        is_point = g(3) == 1.0  # w = 1 point, w = 0 directional
        lvx, lvy, lvz = g(0) - px, g(1) - py, g(2) - pz
        dist = torch.clamp_min(torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz), 0.001)
        dn = torch.sqrt(torch.clamp_min(g(0) * g(0) + g(1) * g(1) + g(2) * g(2), 1e-40))
        ldx = torch.where(is_point, lvx / dist, g(0) / dn)
        ldy = torch.where(is_point, lvy / dist, g(1) / dn)
        ldz = torch.where(is_point, lvz / dist, g(2) / dn)
        attenuation = torch.where(is_point, g(7) / (dist * dist), g(7))
        max_dist = torch.where(is_point, dist, torch.full_like(dist, 1e30))

        vis = shadow(
            ws,
            torch.stack([px + ldx * 0.001, py + ldy * 0.001, pz + ldz * 0.001], 1),
            torch.stack([ldx, ldy, ldz], 1), max_dist, live, min_vis, 1e-3,
            work=work,
        )
        attenuation = attenuation * vis
        lit = vis > min_vis

        n_dot_l = torch.clamp_min(nx * ldx + ny * ldy + nz * ldz, 0.0)
        hx, hy, hz = _normalize(ldx + vx, ldy + vy, ldz + vz, 1e-20)
        n_dot_h = torch.clamp_min(nx * hx + ny * hy + nz * hz, 0.0)
        h_dot_v = torch.clamp_min(hx * vx + hy * vy + hz * vz, 0.0)
        p5 = pow5(1.0 - h_dot_v)

        # transparent specular-only lobe (glsl:571-609)
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
        lit_t = lit & (n_dot_l > 0.0)  # glsl:591 continue
        wt = spec_t * attenuation * n_dot_l
        outtr = outtr + torch.where(lit_t, wt * g(4), 0.0)
        outtg = outtg + torch.where(lit_t, wt * g(5), 0.0)
        outtb = outtb + torch.where(lit_t, wt * g(6), 0.0)

        # standard diffuse + specular (glsl:611-660)
        r2s = roughness * roughness
        alpha2 = r2s * r2s
        dden_s = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
        d_s = alpha2 / torch.clamp_min(PI_REF * dden_s * dden_s, 1e-12)
        k_s = (roughness + 1.0) * (roughness + 1.0) / 8.0
        g_s = n_dot_v / (n_dot_v * (1.0 - k_s) + k_s)
        g_s = g_s * (n_dot_l / (n_dot_l * (1.0 - k_s) + k_s))
        denom_s = torch.clamp_min(4.0 * n_dot_v * n_dot_l, 1e-4)
        dg = d_s * g_s / denom_s
        ndl_pi = n_dot_l / PI_REF

        def chan(f0c, a, lc):
            f_s = f0c + (1.0 - f0c) * p5
            spec = f_s * dg
            diffuse = (1.0 - f_s) * a * ndl_pi
            return torch.clamp_min((diffuse + spec) * lc * attenuation, 0.0)

        outsr = outsr + torch.where(lit, chan(f0sr, ar, g(4)), 0.0)
        outsg = outsg + torch.where(lit, chan(f0sg, ag, g(5)), 0.0)
        outsb = outsb + torch.where(lit, chan(f0sb, ab, g(6)), 0.0)

    return (torch.where(is_transparent, outtr, outsr),
            torch.where(is_transparent, outtg, outsg),
            torch.where(is_transparent, outtb, outsb))


def _pack_camera(camera_params: dict, device) -> torch.Tensor:
    """(9, 4) camera table: rows 0-3 inv_proj, 4-7 inv_view, 8 position.
    From host arrays it is built in numpy and uploaded through pinned memory
    (camera_rays.upload), from tensors it is built on their device: either
    way no call synchronises the stream, so a frame's dispatch never waits
    for the frames in flight before it."""
    vals = [camera_params[k] for k in ("inv_proj", "inv_view", "position")]
    if any(isinstance(v, torch.Tensor) for v in vals):
        inv_proj, inv_view, pos = (camera_rays.camera_tensor(v, device)
                                   for v in vals)
        pos = torch.cat([pos.reshape(3), torch.zeros_like(pos.reshape(3)[:1])])
        return torch.cat([inv_proj.reshape(4, 4), inv_view.reshape(4, 4),
                          pos[None]]).contiguous()
    as_np = lambda x: np.asarray(x, np.float32)  # noqa: E731
    pos = np.concatenate([as_np(vals[2]).reshape(3), np.zeros(1, np.float32)])
    cam = np.concatenate(
        [as_np(vals[0]).reshape(4, 4), as_np(vals[1]).reshape(4, 4),
         pos.reshape(1, 4)],
        axis=0,
    )
    return camera_rays.upload(cam, device)


# ---- K1 --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Consts:
    """Per-call constants shared by the kernel and its plain version, each
    rounded to float32 the way the JAX kernel rounds it."""

    width: int
    height: int
    n_samples: int
    max_bounces: int
    rr_start: int
    hash_rng: bool
    key: int
    samp0: float  # first sample index (progressive keyed for the sin hash)
    min_vis: float
    sky_h: tuple
    sky_d: tuple  # zenith - horizon, in double then rounded (as JAX does)
    ambient: tuple
    octant: bool  # bounce walks as K9 (cfg.octant_bounce_walks)
    wide: bool = False  # K5 walks (cfg.wide_nodes, not on the treelet view)
    frustum: bool = False  # K6 primary walk (cfg.frustum_primary, BVH2 only)
    fuse: int = 1  # sample fusion (cfg.sample_fuse; see sample_fuse)


def sample_fuse(cfg: RenderConfig, n_samples: int) -> int:
    """The samples K1 sums per sub-block (megakernel.py:1106-1110): the
    largest divisor of n_samples that is at most cfg.sample_fuse. A
    per-thread K1 traces one sample at a time either way; fusion fixes only
    the order of the per-pixel sum: sub-block s sums the samples g * fuse + s
    in order of g, and the sub-blocks add up in order (:592-607, :723-730).
    It also turns the frustum primary walk off (:521-525)."""
    fuse = max(1, int(cfg.sample_fuse))
    while n_samples % fuse:
        fuse -= 1
    return fuse


def _consts(cfg: RenderConfig, samp, rng_key, max_bounces, n_samples,
            tiered: bool = False) -> _Consts:
    hash_rng = cfg.rng != "reference"
    fuse = sample_fuse(cfg, n_samples)
    if hash_rng:
        samp0 = np.float32(samp)
    else:  # the sin-hash flow continues the sample index across frames
        samp0 = np.float32(samp) + np.float32(rng_key) * np.float32(cfg.spp)
    return _Consts(
        width=int(cfg.width), height=int(cfg.height),
        n_samples=int(n_samples), max_bounces=int(max_bounces),
        rr_start=int(cfg.rr_start_bounce), hash_rng=hash_rng,
        key=int(rng_key), samp0=float(samp0),
        min_vis=_f32(cfg.shadow_min_visibility),
        sky_h=tuple(_f32(h) for h in cfg.sky_horizon),
        sky_d=tuple(_f32(z - h) for h, z in zip(cfg.sky_horizon, cfg.sky_zenith)),
        ambient=tuple(_f32(a) for a in cfg.ambient),
        octant=bool(cfg.octant_bounce_walks),
        # the walk knobs as megakernel.py:503-525 selects them (no frustum
        # primary with sample fusion)
        wide=bool(cfg.wide_nodes) and not tiered,
        frustum=(bool(cfg.frustum_primary) and not cfg.wide_nodes and not tiered
                 and fuse == 1),
        fuse=fuse,
    )


def _sky(c: _Consts, dy, ch: int):
    return c.sky_h[ch] + c.sky_d[ch] * (0.5 * (dy + 1.0))


def _hit_normal(cross, menc):
    cnx, cny, cnz = cross.unbind(1)
    sgn = torch.where(menc < 0.0, -1.0, 1.0)
    nn = torch.clamp_min(torch.sqrt(cnx * cnx + cny * cny + cnz * cnz), 1e-20)
    return cnx / nn * sgn, cny / nn * sgn, cnz / nn * sgn


def octant_walk_reference(ws: WorldArrays, origin, direction, active,
                          work: walk.Work | None = None, wide: bool = False):
    """K9's plain version (megakernel._octant_masked_walk :215): the closest
    hit as 8 sub-walks of the plain closest walk of the view (the wide one
    with ``wide``), one per direction octant, each over the active rays of
    that octant, merged disjointly. Returns (t, tri, cross (R, 3), menc), the
    walk's own."""
    closest = walk.plain_walks(ws, wide)[0]
    d = direction
    octv = ((d[:, 0] > 0.0).int() + 2 * (d[:, 1] > 0.0).int()
            + 4 * (d[:, 2] > 0.0).int())
    out = list(walk._closest_state(origin.shape[0], origin.device, None))
    for k in range(8):
        sel = active & (octv == k)
        if not sel.any():  # an empty octant's walk stops at the root
            continue
        for acc, x in zip(out, closest(ws, origin, direction, sel, work=work)):
            acc[sel] = x[sel]
    return tuple(out)


def _per_ray(x, sel):
    """x[sel] for a per-ray tensor, x itself for one value shared by all."""
    return x[sel] if isinstance(x, torch.Tensor) and x.dim() else x


def _ref_draws(s0, s1, samp_f):
    """Per-bounce sin-hash draws of the rays ``sel`` (indices into s0/s1)."""

    def draws(b, sel):
        b_f = torch.tensor(float(b), dtype=torch.float32, device=s0.device)
        return _bounce_draws_reference(s0[sel], s1[sel], _per_ray(samp_f, sel), b_f)

    return draws


def _sampler(c: _Consts, u, v, h_pix, s):
    """Sample ``s``'s jitter and per-bounce draws for rays (u, v): (jx, jy,
    draws(b, sel), the sin-hash seeds (s0, s1) or None). ``s`` is one sample
    index, or an int64 tensor of one per ray."""
    dev = u.device
    samp_f = torch.tensor(c.samp0, dtype=torch.float32, device=dev) + (
        s.float() if isinstance(s, torch.Tensor) else float(s))
    if not c.hash_rng:
        # seed = uv * (fragX + fragY + samp + 1) (glsl:688); frag =
        # floor(uv * res) + 0.5, so fragX + fragY = floor(u*W) + floor(v*H) + 1
        scale = (torch.floor(u * c.width) + torch.floor(v * c.height) + 1.0
                 + (samp_f + 1.0))
        s0, s1 = u * scale, v * scale
        jx = _ref_rand(s0, s1) * 0.00002
        jy = _ref_rand(s0 + 1.0, s1 + 1.0) * 0.00002
        return jx, jy, _ref_draws(s0, s1, samp_f), (s0, s1)
    samp_u = int(c.samp0) + s
    jbase = (h_pix + ((samp_u * 7919) & _M32)) & _M32
    jx = (_u32_to_unit_float(_hash_u32(jbase)) - 0.5) / c.width
    jy = (_u32_to_unit_float(_hash_u32(jbase + 1)) - 0.5) / c.height

    def draws(b, sel):
        return _bounce_draws_hash(h_pix[sel], _per_ray(samp_u, sel), b)

    return jx, jy, draws, None


# csrc/sample_kernel.cu RZ_K1_THREADS, 4 warps a block: the built value is
# sample_budget's "threads", which chip_smoke.py and the card tests hold to
# this one (a build with another -D RZ_K1_THREADS has other warp tiles)
K1_THREADS = 128
_TILE_W = 16  # a block's screen tile: 16 x (K1_THREADS // 16) pixels


def tile_pixels(n: int, width: int, height: int) -> torch.Tensor:
    """The plain form of csrc/sample_kernel.cu tile_pixel over a K1 launch
    on n pixels of a width x height frame: (warps, 32) int64, entry [w, l]
    the pixel of lane l of warp w (block w // 4, its warp w % 4), -1 for
    none. A full frame is cut into 16 x 8 block tiles of two by two warps of
    8 x 4 pixels, clipped at the right and bottom edges; any other wave is
    mapped linearly (32 consecutive pixels a warp)."""
    warps = K1_THREADS // 32
    if width * height != n:
        i = torch.arange(-(-n // K1_THREADS) * K1_THREADS).reshape(-1, 32)
        return torch.where(i < n, i, -1)
    tile_h = K1_THREADS // _TILE_W
    tiles_x = -(-width // _TILE_W)
    tiles = tiles_x * -(-height // tile_h)
    tile = torch.arange(tiles)[:, None, None]
    warp = torch.arange(warps)[None, :, None]
    lane = torch.arange(32)[None, None, :]
    x = (tile % tiles_x) * _TILE_W + (warp & 1) * 8 + (lane & 7)
    y = (tile // tiles_x) * tile_h + (warp >> 1) * 4 + (lane >> 3)
    return torch.where((x < width) & (y < height), y * width + x, -1).reshape(-1, 32)


def pixel_warps(n: int, width: int, height: int, device=None) -> torch.Tensor:
    """(n,) int64: the K1 warp of each pixel (tile_pixels' map), which is
    the K6 forms' packet of sample 0."""
    tp = tile_pixels(n, width, height)
    on = tp >= 0
    warp = torch.empty(n, dtype=torch.int64)
    warp[tp[on]] = torch.arange(tp.shape[0])[:, None].expand_as(tp)[on]
    return warp.to(device)


def _primary_walk(ws, c: _Consts, packet_ids):
    """The plain primary closest walk: K6's over packets of equal
    ``packet_ids`` under c.frustum, else the view's closest walk."""
    if c.frustum:
        return lambda ws, o, d, a, work: walk.frustum_closest_walk_reference(
            ws, o, d, a, packet_ids=packet_ids, work=work)
    return walk.plain_walks(ws, c.wide)[0]


def _bounce0(ws, c: _Consts, cam, u, v, jx, jy, draws, work, packet_ids):
    """Raygen, the primary hit (sky on a miss), direct lighting and the
    bounce-0 scatter of rays (u, v), all active (``packet_ids``: their
    frustum packets). Returns (color (n, 3), rays (n,) int64, the rays that
    hit, their paths (o xyz, d xyz, throughput rgb, ior))."""
    n, dev = u.shape[0], u.device
    ox, oy, oz, dx, dy, dz = _raygen_tiles(u, v, jx, jy, cam)
    rays = torch.ones((n,), dtype=torch.int64, device=dev)
    act = torch.ones((n,), dtype=torch.bool, device=dev)
    t, _tri, cross, menc = _primary_walk(ws, c, packet_ids)(
        ws, torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1), act,
        work=work,
    )
    found = menc != 0.0
    color = torch.stack(
        [torch.where(found, 0.0, _sky(c, dy, ch)) for ch in range(3)], 1
    )

    sel = found.nonzero()[:, 0]
    rays[sel] += ws.lights.shape[0]
    nx, ny, nz = _hit_normal(cross[sel], menc[sel])
    ar, ag, ab, metal, rough, refl, transp, mat_ior = _material_columns(
        ws.materials, menc[sel].abs() - 1.0
    )
    t = t[sel]
    ox, oy, oz, dx, dy, dz = (x[sel] for x in (ox, oy, oz, dx, dy, dz))
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
    vx, vy, vz = _normalize(cam[8, 0] - px, cam[8, 1] - py, cam[8, 2] - pz, 1e-20)
    direct = _direct_lighting_tiles(
        ws, ws.lights, c.min_vis, c.ambient, px, py, pz, nx, ny, nz, vx, vy,
        vz, ar, ag, ab, metal, rough, transp, mat_ior, work,
        walk.plain_walks(ws, c.wide)[1],
    )
    color[sel] = color[sel] + torch.stack(direct, 1)

    rand_val, hemi_u, hemi_v = draws(0, sel)
    ndx, ndy, ndz, tx, ty, tz, ior = _scatter_tiles(
        dx, dy, dz, nx, ny, nz, torch.ones_like(px), rand_val, hemi_u, hemi_v,
        ar, ag, ab, refl, transp, mat_ior,
    )
    push = torch.where(ndx * nx + ndy * ny + ndz * nz > 0.0, 0.003, -0.003)
    path = (px + nx * push, py + ny * push, pz + nz * push, ndx, ndy, ndz,
            tx, ty, tz, ior)
    return color, rays, sel, path


def _bounces(ws, c: _Consts, sel, path, color, rays, draws, b_start: int,
             b_stop: int, work):
    """Bounces b_start..b_stop-1 of the paths of the rays ``sel`` (indices
    into color / rays, which take the sky radiance and the traced rays in
    place): the plain form of shade.cuh trace_bounces, each bounce on the
    rays still alive. Returns the rays alive after b_stop - 1 and their
    paths."""
    if c.octant:
        closest = lambda *a, work: octant_walk_reference(  # noqa: E731
            *a, work=work, wide=c.wide)
    else:
        closest = walk.plain_walks(ws, c.wide)[0]
    ox, oy, oz, dx, dy, dz, tx, ty, tz, ior = path
    rr_on = c.rr_start < c.max_bounces - 1
    for b in range(b_start, b_stop):
        if not sel.numel():
            break
        rays[sel] += 1
        t, _tri, cross, menc = closest(
            ws, torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1),
            torch.ones_like(ox, dtype=torch.bool), work=work,
        )
        found = menc != 0.0
        miss = ~found
        if miss.any():  # sky (glsl:706-709), weighted by throughput
            sky = torch.stack(
                [tp[miss] * _sky(c, dy[miss], ch)
                 for ch, tp in enumerate((tx, ty, tz))], 1
            )
            color[sel[miss]] = color[sel[miss]] + sky
        keep = found.nonzero()[:, 0]
        sel = sel[keep]
        ox, oy, oz, dx, dy, dz, tx, ty, tz, ior, t = (
            x[keep] for x in (ox, oy, oz, dx, dy, dz, tx, ty, tz, ior, t)
        )
        nx, ny, nz = _hit_normal(cross[keep], menc[keep])
        ar, ag, ab, _metal, _rough, refl, transp, mat_ior = _material_columns(
            ws.materials, menc[keep].abs() - 1.0
        )
        rand_val, hemi_u, hemi_v = draws(b, sel)
        ndx, ndy, ndz, fr, fg, fb, ior = _scatter_tiles(
            dx, dy, dz, nx, ny, nz, ior, rand_val, hemi_u, hemi_v,
            ar, ag, ab, refl, transp, mat_ior,
        )
        tx, ty, tz = tx * fr, ty * fg, tz * fb
        push = torch.where(ndx * nx + ndy * ny + ndz * nz > 0.0, 0.003, -0.003)
        ox = ox + dx * t + nx * push
        oy = oy + dy * t + ny * push
        oz = oz + dz * t + nz * push
        dx, dy, dz = ndx, ndy, ndz
        if rr_on and b > c.rr_start:  # Russian roulette, reusing rand_val
            p = torch.maximum(torch.maximum(tx, ty), tz)
            inv_p = 1.0 / torch.clamp_min(p, 1e-12)
            tx, ty, tz = tx * inv_p, ty * inv_p, tz * inv_p
            keep = (~(rand_val > p)).nonzero()[:, 0]
            sel = sel[keep]
            ox, oy, oz, dx, dy, dz, tx, ty, tz, ior = (
                x[keep] for x in (ox, oy, oz, dx, dy, dz, tx, ty, tz, ior)
            )
    return sel, (ox, oy, oz, dx, dy, dz, tx, ty, tz, ior)


def _one_sample(ws, c: _Consts, cam, u, v, h_pix, s, b_stop: int, work,
                packet_ids):
    """One sample (``s``: its index, or one per ray) for rays with uv (u,
    v), all active, through bounce b_stop - 1. Returns (color (n, 3), rays
    (n,) int64, the rays alive at the end, their paths, the sin-hash seeds
    or None)."""
    jx, jy, draws, seeds = _sampler(c, u, v, h_pix, s)
    color, rays, sel, path = _bounce0(ws, c, cam, u, v, jx, jy, draws, work,
                                      packet_ids)
    sel, path = _bounces(ws, c, sel, path, color, rays, draws, 1, b_stop, work)
    return color, rays, sel, path, seeds


# (pixel, sample) rays a pass of the plain K1 traces at most: on the card,
# where a pass costs its torch launches more than its arithmetic, about one
# 1080p frame; on the CPU, whose passes cost their arithmetic, few enough
# to keep a pass's walk stacks (512 B a ray or more) small
PLAIN_BATCH_RAYS = {"cuda": 1 << 21, "cpu": 1 << 16}


def sample_wave_reference(ws: WorldArrays, cfg: RenderConfig, uv, active,
                          camera_params: dict, samp, rng_key, max_bounces: int,
                          n_samples: int = 1, work: walk.Work | None = None):
    """Plain version of K1 on uv's device, on the plain walks the kernel's
    instantiation runs (K5 under cfg.wide_nodes, K6 for the primary hit
    under cfg.frustum_primary, K9 for the bounces under
    cfg.octant_bounce_walks). Returns (color sum over samples (R, 3) f32,
    rays () int64). ``work`` counts the walks' steps.

    K6's packets are the kernel's warps (pixel_warps): a warp's 8 x 4 pixel
    tile, its active pixels, in every sample.

    Each pixel's path depends only on its pixel and sample, so up to
    PLAIN_BATCH_RAYS[device type] (pixel, sample) rays are traced in one
    pass; the samples' colours are still summed one sample at a time in the
    kernel's order. On the card a pass costs about as much at 30,000 rays as
    at 2 million (its walks' torch launches), so batching the samples of a
    small wave saves most of its time."""
    c = _consts(cfg, samp, rng_key, max_bounces, n_samples, ws.tiered)
    walk.check_walks(ws, c.wide)
    n, dev = uv.shape[0], uv.device
    cam = _pack_camera(camera_params, dev)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((n,), dtype=torch.int64, device=dev)
    idx = active.nonzero()[:, 0]
    u, v = uv[idx, 0], uv[idx, 1]
    h_pix = None
    if c.hash_rng:
        pixel_id = (
            torch.floor(v * c.height).long() * (c.width * 2)
            + torch.floor(u * c.width).long()
        ) & _M32
        key_h = int(_hash_u32(torch.tensor((c.key + 0x9E3779B9) & _M32)))
        h_pix = _hash_u32(pixel_id ^ key_h)
    groups = n_samples // c.fuse
    packets = pixel_warps(n, c.width, c.height, dev)[idx] if c.frustum else None
    m = idx.numel()
    cap = PLAIN_BATCH_RAYS.get(dev.type, PLAIN_BATCH_RAYS["cpu"])
    per = max(1, min(groups, cap // max(1, m)))  # samples a pass
    for sb in range(c.fuse):  # sample fusion's order of summation
        acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
        for g0 in range(0, groups, per):
            k = min(per, groups - g0)
            gs = torch.arange(g0, g0 + k, device=dev)
            col_s, rays_s, *_ = _one_sample(
                ws, c, cam, u.repeat(k), v.repeat(k),
                None if h_pix is None else h_pix.repeat(k),
                (gs * c.fuse + sb).repeat_interleave(m), max_bounces, work,
                None if packets is None else (packets + n * gs[:, None]).reshape(-1))
            for j in range(k):
                acc = acc + col_s[j * m:(j + 1) * m]
            rays[idx] = rays[idx] + rays_s.reshape(k, m).sum(0)
        color[idx] = color[idx] + acc
    return color, rays.sum()


def _sample_params(c: _Consts, ws: WorldArrays, b_start: int,
                   b_stop: int) -> ext.SampleParams:
    return ext.SampleParams(
        c.width, c.height, c.n_samples, c.max_bounces, c.rr_start,
        int(c.hash_rng), c.key, ws.materials.shape[0], ws.lights.shape[0],
        c.fuse,
        b_start, b_stop, c.samp0, c.min_vis, 1e-3,
        (ctypes.c_float * 3)(*c.sky_h), (ctypes.c_float * 3)(*c.sky_d),
        (ctypes.c_float * 3)(*c.ambient),
    )


def _check_tables(ws: WorldArrays) -> None:
    for t in (ws.materials, ws.lights):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 8:
            raise ValueError("materials and lights must be (n, 8) float32")


def _launch_sample(ws: WorldArrays, c: _Consts, uv, active,
                   camera_params: dict, b_stop: int, phase1: bool,
                   count: bool = False):
    """Launch K1 (or, with ``phase1``, K4's phase 1: K1 with a state output;
    with ``count``, the counting K1) in the instantiation the view and
    c.wide, c.frustum and c.octant ask for. Returns (color (R, 3), rays (R,)
    int32, state (13, R) or None)."""
    dev = uv.device
    uvc = uv.to(torch.float32).contiguous()
    act = active.to(torch.uint8).contiguous()
    if uvc.dim() != 2 or uvc.shape[1] != 2 or act.shape != (uvc.shape[0],):
        raise ValueError("uv must be (R, 2) and active (R,)")
    cam = _pack_camera(camera_params, dev)
    view = "tiered" if ws.tiered else "bvh8" if c.wide else "bvh2"
    walk.check_cuda_inputs(ws, uvc, act, cam, ws.materials, ws.lights,
                           view=view)
    _check_tables(ws)
    n = uvc.shape[0]
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    # one int more than the rays: the tiered K1's persistent warps count the
    # warp tiles they take in it (sample_kernel.cu), from zero
    rays = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    state = (torch.empty((STATE_ROWS, n), dtype=torch.float32, device=dev)
             if phase1 else None)
    name = ("sample_wave" + ("_tiered" if ws.tiered else "")
            + ("_wide" if c.wide else "") + ("_phase1" if phase1 else "")
            + ("_frustum" if c.frustum else "") + ("_octant" if c.octant else "")
            + ("_count" if count else ""))
    params = _sample_params(c, ws, 1, b_stop)
    err = getattr(ext.lib(), "rz_" + name)(
        *walk.table_args(ws, view), ws.materials.data_ptr(),
        ws.lights.data_ptr(), cam.data_ptr(), uvc.data_ptr(), act.data_ptr(),
        n, ctypes.byref(params), color.data_ptr(), rays.data_ptr(),
        *((state.data_ptr(),) if phase1 else ()),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    ext.check(err, name)
    ext.LAUNCHES[name] += n > 0  # the entry point skips n == 0
    return color, rays[:n], state


def sample_wave(ws: WorldArrays, cfg: RenderConfig, uv, active,
                camera_params: dict, samp, rng_key, max_bounces: int,
                n_samples: int = 1):
    """Trace ``n_samples`` full samples per pixel (uv (R, 2) in [0, 1],
    active (R,) bool). Returns (color sum over samples (R, 3) f32, rays ()
    int64). K1 on CUDA tensors (its tiered instantiation when ``ws.tiered``,
    its wide one under cfg.wide_nodes, the K6 primary walk under
    cfg.frustum_primary, K9 bounce walks under cfg.octant_bounce_walks), the
    plain version on CPU tensors."""
    with span("rz.k1.launch"):
        if ws.tiered and cfg.wide_nodes:  # megakernel.py:1101-1105
            log.info("wide_nodes ignored: the scene packed the treelet view; "
                     "using the tiered walks")
        if uv.device.type == "cpu":
            return sample_wave_reference(ws, cfg, uv, active, camera_params,
                                         samp, rng_key, max_bounces, n_samples)
        if not uv.is_cuda:
            raise ValueError(f"no K1 for device {uv.device}")
        c = _consts(cfg, samp, rng_key, max_bounces, n_samples, ws.tiered)
        color, rays, _ = _launch_sample(ws, c, uv, active, camera_params,
                                        max_bounces, phase1=False)
        return color, rays.sum(dtype=torch.int64)


def walk_lane_counts(ws: WorldArrays, cfg: RenderConfig, uv, active,
                     camera_params: dict, samp, rng_key, max_bounces: int,
                     n_samples: int = 1, phase1: bool = False):
    """A diagnostic of a K1 form (the one sample_wave launches for ``ws``
    and ``cfg``; with ``phase1``, of the K4 phase-1 form sample_wave_phase1
    launches, one sample) on CUDA tensors: its counting instantiation
    renders the wave and sums, over every step of every walk's node loop,
    the lanes of the warp that take the step and 32 (in a step of K6's
    packet walk, the lanes with a ray in the packet). Returns (color (R, 3),
    rays () int64, active lane-steps, warp-steps x 32); their ratio is the
    walk loop's lane utilisation. No render path calls it."""
    if not uv.is_cuda:
        raise ValueError("the counting K1 runs on CUDA tensors only")
    if phase1:
        b_stop = _split_point(ws, cfg, max_bounces)
        c = _consts(cfg, samp, rng_key, max_bounces, 1)
    else:
        b_stop = max_bounces
        c = _consts(cfg, samp, rng_key, max_bounces, n_samples, ws.tiered)
    sums = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize(uv.device)
    ext.check(ext.lib().rz_walk_lanes(sums, 1), "rz_walk_lanes")  # zero them
    color, rays, _ = _launch_sample(ws, c, uv, active, camera_params, b_stop,
                                    phase1=phase1, count=True)
    torch.cuda.synchronize(uv.device)
    ext.check(ext.lib().rz_walk_lanes(sums, 1), "rz_walk_lanes")
    return color, rays.sum(dtype=torch.int64), int(sums[0]), int(sums[1])


# the K1 forms, by their rz_sample_budget policy id: the regenerating ones,
# then the K9 and K6 forms (the warp-tiled lockstep loop); K4's plain phase
# 1 is id 8 ("phase1"; its K9 and K6 forms are K1's "octant", "frustum" and
# "frustum_octant" instantiations)
BUDGET_POLICIES = ("bvh2", "tiered", "wide", "octant", "tiered_octant",
                   "wide_octant", "frustum", "frustum_octant")
# K4's continuation forms, by their rz_continuation_budget id
CONTINUATION_FORMS = ("continuation", "continuation_octant")


def sample_budget(policy: str) -> dict:
    """The compiled budget of a K1 form (a name of BUDGET_POLICIES: the walk
    policy "bvh2", "tiered" or "wide", with K9 bounce walks "..._octant",
    the K6 primary "frustum", with K9 "frustum_octant"), of K4's plain
    phase 1 ("phase1") or of a K4 continuation form (a name of
    CONTINUATION_FORMS): threads per block, registers per thread, local
    memory per thread in bytes (walk stacks and spills) and resident warps
    per SM (the CUDA occupancy calculator)."""
    out = (ctypes.c_int * 4)()
    if policy in CONTINUATION_FORMS:
        ext.check(ext.lib().rz_continuation_budget(
            CONTINUATION_FORMS.index(policy), out), "rz_continuation_budget")
    else:
        pid = 8 if policy == "phase1" else BUDGET_POLICIES.index(policy)
        ext.check(ext.lib().rz_sample_budget(pid, out), "rz_sample_budget")
    return dict(threads=out[0], regs=out[1], local_bytes=out[2],
                warps_per_sm=out[3])


# ---- K4: the split-bounce wavefront -----------------------------------------

STATE_ROWS = 13  # o xyz, d xyz, throughput rgb, ior, alive, s0, s1


def _state_rows(n: int, sel, path, s0, s1):
    """(13, n) continuation rows (csrc/shade.cuh StateRow): the paths of the
    live rays ``sel``, zeros with alive 0 for the others, the seeds of all."""
    state = torch.zeros((STATE_ROWS, n), dtype=torch.float32, device=s0.device)
    if sel.numel():
        state[:10, sel] = torch.stack(path)
        state[10, sel] = 1.0
    state[11], state[12] = s0, s1
    return state


def _split_point(ws: WorldArrays, cfg: RenderConfig, max_bounces: int) -> int:
    """cfg.split_bounce, checked as sample_wave_split (:937-943) checks it."""
    split_b = int(cfg.split_bounce)
    if not (0 < split_b < max_bounces):
        raise ValueError("split_bounce must be in (0, max_bounces)")
    if cfg.rng != "reference" or ws.tiered or cfg.wide_nodes:
        raise ValueError(
            "split_bounce supports the reference-RNG single-tree BVH2 path"
        )
    return split_b


def sample_wave_phase1_reference(ws: WorldArrays, cfg: RenderConfig, uv,
                                 active, camera_params: dict, samp, rng_key,
                                 max_bounces: int,
                                 work: walk.Work | None = None):
    """Plain version of K4's phase 1: one sample through bounce
    cfg.split_bounce - 1 (the primary hit on K6 under cfg.frustum_primary,
    its packets the kernel's warps, as in sample_wave_reference). Returns
    (color (R, 3), rays () int64, state (13, R)). ``work`` counts the walks'
    steps."""
    split_b = _split_point(ws, cfg, max_bounces)
    walk.check_walks(ws)
    c = _consts(cfg, samp, rng_key, max_bounces, 1)
    n, dev = uv.shape[0], uv.device
    idx = active.nonzero()[:, 0]
    u, v = uv[idx, 0], uv[idx, 1]
    packets = pixel_warps(n, c.width, c.height, dev)[idx] if c.frustum else None
    col, rays, sel, path, (s0, s1) = _one_sample(
        ws, c, _pack_camera(camera_params, dev), u, v, None, 0, split_b, work,
        packets)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    color[idx] = color[idx] + col
    state = torch.zeros((STATE_ROWS, n), dtype=torch.float32, device=dev)
    state[:, idx] = _state_rows(idx.numel(), sel, path, s0, s1)
    return color, rays.sum(), state


def sample_wave_phase1(ws: WorldArrays, cfg: RenderConfig, uv, active,
                       camera_params: dict, samp, rng_key, max_bounces: int):
    """K4's phase 1 (megakernel.py:976-992): one sample of K1 through bounce
    cfg.split_bounce - 1 that also writes the 13 continuation rows, with the
    K6 primary walk under cfg.frustum_primary. Returns (color (R, 3), rays
    () int64, state (13, R) f32). The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if uv.device.type == "cpu":
        return sample_wave_phase1_reference(ws, cfg, uv, active, camera_params,
                                            samp, rng_key, max_bounces)
    if not uv.is_cuda:
        raise ValueError(f"no K4 phase 1 for device {uv.device}")
    split_b = _split_point(ws, cfg, max_bounces)
    c = _consts(cfg, samp, rng_key, max_bounces, 1)
    color, rays, state = _launch_sample(ws, c, uv, active, camera_params,
                                        split_b, phase1=True)
    return color, rays.sum(dtype=torch.int64), state


def continuation_reference(ws: WorldArrays, cfg: RenderConfig, state, order,
                           live, color, rays, samp, rng_key, max_bounces: int,
                           b_start: int, b_stop: int, emit: bool,
                           work: walk.Work | None = None):
    """Plain version of K4's continuation kernel on the state's device: the
    rays of pixels order[:live] (``live`` a count, on any device) resume
    from their rows of ``state`` (13, R), in pixel order, at bounce b_start
    and are traced to b_stop. Each ray's colour (from 0) is added into its
    pixel's row of ``color`` (R, 3) and the rays it traces into ``rays`` (a
    0-d int64), in place; with ``emit`` its rows after b_stop - 1 are
    written back into ``state``. Returns None. ``work`` counts the walks'
    steps."""
    walk.check_depth(ws)
    c = _consts(cfg, samp, rng_key, max_bounces, 1)
    dev = state.device
    pix = order[: int(live)].long()
    sub = state[:, pix]
    m = pix.numel()
    col = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    r = torch.zeros((m,), dtype=torch.int64, device=dev)
    sel = (sub[10] > 0.5).nonzero()[:, 0]
    s0, s1 = sub[11], sub[12]
    samp_f = torch.tensor(c.samp0, dtype=torch.float32, device=dev)
    sel, path = _bounces(ws, c, sel, tuple(sub[k, sel] for k in range(10)),
                         col, r, _ref_draws(s0, s1, samp_f), b_start, b_stop,
                         work)
    color[pix] = color[pix] + col
    rays += r.sum()
    if emit:
        state[:, pix] = _state_rows(m, sel, path, s0, s1)


def _check_split(ws: WorldArrays, cfg: RenderConfig, state, order, live,
                 color, rays):
    """What the continuation kernel reads and writes in place."""
    if ws.tiered or cfg.rng != "reference":
        raise ValueError("the continuation runs the reference-RNG single-tree walks")
    n = state.shape[1] if state.dim() == 2 else -1
    if (state.dtype != torch.float32 or state.dim() != 2
            or state.shape[0] != STATE_ROWS or not state.is_contiguous()):
        raise ValueError("state must be a contiguous (13, R) float32 tensor")
    if order.dtype != torch.int32 or order.shape != (n,):
        raise ValueError("order must be an (R,) int32 tensor")
    if live.dtype != torch.int32 or live.numel() != 1:
        raise ValueError("live must be one int32")
    if color.dtype != torch.float32 or color.shape != (n, 3):
        raise ValueError("color must be an (R, 3) float32 tensor")
    if rays.dtype != torch.int64 or rays.numel() != 1:
        raise ValueError("rays must be one int64")
    walk.check_cuda_inputs(ws, state, order, live, color, rays, ws.materials)
    _check_tables(ws)


def _launch_continuation(ws: WorldArrays, cfg: RenderConfig, state, order,
                         live, color, rays, samp, rng_key, max_bounces: int,
                         b_start: int, b_stop: int, emit: bool,
                         count: bool = False):
    """Launch K4's continuation (with ``count``, its counting form) in the
    instantiation cfg.octant_bounce_walks asks for."""
    _check_split(ws, cfg, state, order, live, color, rays)
    c = _consts(cfg, samp, rng_key, max_bounces, 1)
    n, dev = state.shape[1], state.device
    nxt = torch.empty((1,), dtype=torch.int32, device=dev)  # the slot counter
    name = ("continuation" + ("_octant" if c.octant else "")
            + ("_count" if count else ""))
    params = _sample_params(c, ws, b_start, b_stop)
    err = getattr(ext.lib(), "rz_" + name)(
        *walk.table_args(ws, "bvh2"), ws.materials.data_ptr(), state.data_ptr(),
        n, order.data_ptr(), live.data_ptr(), ctypes.byref(params),
        color.data_ptr(), rays.data_ptr(), nxt.data_ptr(), int(emit),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    ext.check(err, name)
    ext.LAUNCHES[name] += n > 0  # the entry point skips n == 0


def continuation(ws: WorldArrays, cfg: RenderConfig, state, order, live,
                 color, rays, samp, rng_key, max_bounces: int, b_start: int,
                 b_stop: int, emit: bool):
    """K4's continuation kernel (megakernel._make_continuation_kernel
    :743), continuation_reference's contract: resume the rays of pixels
    order[:live] from their rows of ``state`` (13, R) at bounce b_start and
    trace them to b_stop, with K9 bounce walks under
    cfg.octant_bounce_walks; add their colour into ``color`` (R, 3) and
    their rays into ``rays`` (0-d int64) in place, and with ``emit`` write
    their rows back into ``state``. ``order`` (R,) int32 and ``live`` (one
    int32) stay on the device: the kernel reads the count there. The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if state.device.type == "cpu":
        return continuation_reference(ws, cfg, state, order, live, color, rays,
                                      samp, rng_key, max_bounces, b_start,
                                      b_stop, emit)
    if not state.is_cuda:
        raise ValueError(f"no K4 continuation for device {state.device}")
    _launch_continuation(ws, cfg, state, order, live, color, rays, samp,
                         rng_key, max_bounces, b_start, b_stop, emit)


def continuation_lane_counts(ws: WorldArrays, cfg: RenderConfig, state, order,
                             live, color, rays, samp, rng_key,
                             max_bounces: int, b_start: int, b_stop: int,
                             emit: bool):
    """A diagnostic of K4's continuation on CUDA tensors (continuation's
    contract, in place): its counting form traces the rays and sums, over
    every step of every walk's node loop, the lanes of the warp that take
    the step and 32. Returns (active lane-steps, warp-steps x 32). No render
    path calls it."""
    if not state.is_cuda:
        raise ValueError("the counting continuation runs on CUDA tensors only")
    sums = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize(state.device)
    ext.check(ext.lib().rz_continuation_lanes(sums, 1), "rz_continuation_lanes")
    _launch_continuation(ws, cfg, state, order, live, color, rays, samp,
                         rng_key, max_bounces, b_start, b_stop, emit,
                         count=True)
    torch.cuda.synchronize(state.device)
    ext.check(ext.lib().rz_continuation_lanes(sums, 1), "rz_continuation_lanes")
    return int(sums[0]), int(sums[1])


def _stable_partition(bucket, n_buckets: int):
    """(dest, first): dest[i] = slot of ray i under a stable partition by
    bucket id (megakernel.py:847), without argsort, and the first slot of
    the last bucket (one int32 on the device): one 1-D cumsum over the
    bucket-major one-hot (n_buckets, R), flattened, counts for ray i in
    bucket k the rays of the buckets before k plus those of bucket k up to
    i. (A cumsum along dim 0 of an (R, n_buckets) one-hot runs as PyTorch's
    outer-dimension scan on the card: ~0.5 s at R = 2M.)"""
    n = bucket.shape[0]
    ids = torch.arange(n_buckets, dtype=bucket.dtype, device=bucket.device)
    onehot = (ids[:, None] == bucket[None, :]).to(torch.int32).reshape(-1)
    csum = torch.cumsum(onehot, 0, dtype=torch.int32)
    at = bucket.long() * n + torch.arange(n, device=bucket.device)
    first = (csum[(n_buckets - 1) * n - 1] if n else
             torch.zeros((), dtype=torch.int32, device=bucket.device))
    return csum[at] - 1, first


def _compaction_permutation(a, dxf, dyf, dzf, mode: str, origins=None):
    """megakernel._compaction_permutation (:861): a stable partition of the
    wave, alive rays first, dead rays last. Returns int32 (dest, order,
    live): ray i moves to slot dest[i]; slot j holds ray order[j]; the
    first ``live`` slots (a 0-d tensor on the wave's device, never read
    back here) hold the live rays. "rank" keeps pixel order among the
    survivors; "octant" buckets them by direction octant (9 buckets, dead
    last: the live count is where bucket 8 starts); "octcell" first
    sub-orders by a 2x2x2 origin cell (split at the live rays' box centre),
    as two composed partitions. Any other mode is "rank"."""
    n, dev = a.shape[0], a.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if mode in ("octant", "octcell"):
        octv = ((dxf > 0.0).int() + 2 * (dyf > 0.0).int()
                + 4 * (dzf > 0.0).int())
        bucket = torch.where(a, octv, 8)  # dead rays -> bucket 8 (the back)
        if mode == "octcell":

            def mid(v):
                lo = torch.where(a, v, 1e30).min()
                hi = torch.where(a, v, -1e30).max()
                return 0.5 * (lo + hi)

            ox, oy, oz = origins
            cell = ((ox > mid(ox)).int() + 2 * (oy > mid(oy)).int()
                    + 4 * (oz > mid(oz)).int())
            dest1, _ = _stable_partition(cell, 8)
            order1 = torch.empty_like(iota)
            order1[dest1.long()] = iota
            dest2, live = _stable_partition(bucket[order1.long()], 9)
            dest = dest2[dest1.long()]
        else:
            dest, live = _stable_partition(bucket, 9)
    else:
        ia = a.int()
        live = ia.sum(dtype=torch.int32)
        rank_alive = torch.cumsum(ia, 0, dtype=torch.int32) - ia
        da = 1 - ia
        rank_dead = live + torch.cumsum(da, 0, dtype=torch.int32) - da
        dest = torch.where(a, rank_alive, rank_dead)
    order = torch.empty_like(iota)
    order[dest.long()] = iota
    return dest, order, live


def _split(phase1, cont, ws: WorldArrays, cfg: RenderConfig, uv, active,
           camera_params: dict, samp, rng_key, max_bounces: int):
    """sample_wave_split's flow (megakernel.py:1000-1041) over the given
    phase 1 and continuation. The state rows stay in pixel order: each
    compaction gives the permutation (slot -> pixel) and the live count,
    which stay on the device, and the continuation reads its rays' rows
    through them and adds their colour and rays in place. split_every
    re-compacts before every late bounce (the pixel order each time: which
    slot a ray takes changes no pixel's result)."""
    split_b = _split_point(ws, cfg, max_bounces)
    color, rays, state = phase1(ws, cfg, uv, active, camera_params, samp,
                                rng_key, max_bounces)
    starts = (list(range(split_b, max_bounces)) if cfg.split_every
              else [split_b])
    for i, b_start in enumerate(starts):
        b_stop = starts[i + 1] if i + 1 < len(starts) else max_bounces
        _dest, order, live = _compaction_permutation(
            state[10] > 0.5, state[3], state[4], state[5], cfg.split_rebin,
            origins=(state[0], state[1], state[2]),
        )
        cont(ws, cfg, state, order, live, color, rays, samp, rng_key,
             max_bounces, b_start, b_stop, emit=b_stop < max_bounces)
    return color, rays


def sample_wave_split(ws: WorldArrays, cfg: RenderConfig, uv, active,
                      camera_params: dict, samp, rng_key, max_bounces: int):
    """One sample through the split-bounce wavefront (K4,
    megakernel.sample_wave_split :911): phase 1 traces bounces
    0..split_bounce-1 and writes the continuation rows; a sort-free
    permutation (cfg.split_rebin) moves the live rays to the front; the
    continuation kernel resumes them, and with cfg.split_every each later
    bounce gets its own compaction and continuation. Image-identical to
    K1's sample: rays are only permuted between kernels. Returns (color (R,
    3), rays () int64). The kernels on CUDA tensors, the plain versions on
    CPU tensors."""
    return _split(sample_wave_phase1, continuation, ws, cfg, uv, active,
                  camera_params, samp, rng_key, max_bounces)


def sample_wave_split_reference(ws: WorldArrays, cfg: RenderConfig, uv,
                                active, camera_params: dict, samp, rng_key,
                                max_bounces: int):
    """Plain version of sample_wave_split on uv's device."""
    return _split(sample_wave_phase1_reference, continuation_reference, ws,
                  cfg, uv, active, camera_params, samp, rng_key, max_bounces)
