"""The comparison that decides ``correct``.

What the timed path produced: the image read back after each frame of
the window. For a sample of pixels and a sample of frames, both drawn
from the seed, the plain reference (reference/tracer.py) renders the
frame's own image from the scene kind's world at the frame's number
(kinds/: one world built for each distinct world, so a static scene
builds one) and the frame's recorded key (frames.frame_key). What is
compared with it depends on whether the cell accumulates.

Where it does not, each checked readback is the frame's image, and is
compared directly. Where it does, the frame image that the program's
readbacks imply is

    frame 0:  acc_0
    frame j:  (acc_j - acc_{j-1} * (1 - a)) / a,   a = float32(1 / (j + 1)),

the running mean's own update solved for the frame (the accumulator's
float32 rounding, ~1e-7 of a value, grows by 1 / a = j + 1 there, which
stays far under the limits). So every checked frame tests the pack, the
refit, the camera rays, K1 with its walks and shading, and the
accumulation that produced it; and a readback that does not follow from
its predecessor and the frame's true image fails.

Which pixels: the run keeps every frame's values at CANDIDATES times the
pixels it checks, drawn from the seed; after the window, up to three
quarters of the checked ones are the candidates whose reference image
changes most between two other frames (SENSITIVITY_KEYS; by more than
SENSITIVE), the rest the first of the others. The upstream shader draws
the first bounce alike for every pixel and sample (its tempseed is 0 at
bounce 0), so most of a frame (the sky, surfaces whose first bounce
leaves the scene) is the same whatever its samples; a check spread
evenly would see a lost or repeated frame almost nowhere.

The numbers compared (each against the cell's limit, limits/<cell>.json):
- ``frame_mae``: the mean, over checked frames, pixels and channels, of
  |implied - reference|. Paths follow the same draws on both sides, so they
  agree but for the rare path that grazes an edge and takes another
  triangle; a lower precision, a dropped sample or a wrong frame moves
  every pixel.
- ``frame_p90``: the 90th percentile of the same |implied - reference|.
  A path that grazes an edge moves one pixel by much and the mean by a
  little; a lost sample, a wrong key or a lower precision moves most
  pixels by a little, which the mean can leave near its sound readings
  and this quantile cannot.
- ``frame_off_share``: the share of those values off by more than the
  float32 rounding that the implied frame can carry, tau_j = OFF_BASE +
  OFF_PER_FRAME * (j + 1) (four times the accumulator's rounding, ~6e-8 of
  a value, grown by 1 / a = j + 1); without accumulation, with no running
  mean to divide, tau = OFF_BASE + OFF_PER_FRAME for every frame. Only a
  pixel that holds an edge-grazing path passes it in a sound run; a frame
  made from other samples (a lost or repeated frame, a wrong key) passes
  it wherever its samples change the pixel, which the quantile misses
  where most of a frame is sky or fixed by the upstream shader's
  first-bounce draws.
- ``rays_gap``: |the program's traced rays a path - the reference's| / the
  reference's, for the window's first frame, in its world. The program's
  count is the whole frame's (its profiler's record); the reference traces
  ``ray_pixels`` pixels drawn from the seed at the frame's first
  ``ray_samples`` samples, which estimates the frame's mean to about
  0.7 / sqrt(ray_pixels * ray_samples) of it, and equals it when they are
  the whole frame.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import scenes

LIMITS_DIR = os.path.join(scenes.BENCH_DIR, "limits")
SENSITIVITY_KEYS = (1, 2)
CANDIDATES = 16  # pixels kept a frame for each pixel checked
SENSITIVE = 1e-4  # a pixel whose image moves more between those frames
OFF_BASE, OFF_PER_FRAME = 1e-5, 2.4e-7  # frame_off_share's tau_j (see above)


def _rng(seed: int, stream: int):
    """A generator for one use of the seed (any whole number)."""
    return np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, stream])


def sample_pixels(seed: int, width: int, height: int, n: int):
    """n distinct pixels (xs, ys), drawn from the seed."""
    g = _rng(seed, 1)
    idx = g.choice(width * height, size=min(n, width * height), replace=False)
    return idx % width, idx // width


def choose_pixels(score: np.ndarray, n: int) -> np.ndarray:
    """Which of the candidate pixels (in their drawn order) are checked:
    three quarters of ``n`` where ``score`` (how much the reference's image
    of the pixel changes with its samples) is highest, the rest the first
    of the others. Returns indices into the candidates."""
    k = min(int((score > SENSITIVE).sum()), (3 * n) // 4)
    top = np.argsort(-score, kind="stable")[:k]
    rest = np.setdiff1d(np.arange(score.shape[0]), top)[:n - k]
    return np.sort(np.concatenate([top, rest]))


def sample_frames(seed: int, n_frames: int, n: int):
    """Indices of the frames checked: the first, and n - 1 more drawn from
    the seed among the rest (sorted)."""
    g = _rng(seed, 2)
    rest = g.choice(np.arange(1, n_frames), size=min(n - 1, n_frames - 1),
                    replace=False) if n_frames > 1 else []
    return sorted({0, *map(int, rest)})


def implied_frames(values: np.ndarray, idx) -> np.ndarray:
    """The frame images implied by the accumulated readbacks ``values``
    (N, P, 3) at frames ``idx``: (len(idx), P, 3) float64."""
    out = []
    for j in idx:
        acc = values[j].astype(np.float64)
        if j == 0:
            out.append(acc)
            continue
        a = np.float64(np.float32(1.0 / (j + 1)))
        keep = np.float64(np.float32(1.0) - np.float32(a))
        out.append((acc - values[j - 1].astype(np.float64) * keep) / a)
    return np.stack(out)


def numbers(implied: np.ndarray, ref_img: np.ndarray, prog_rays_per_path: float,
            ref_rays_per_path: float, idx, accumulated: bool = True) -> dict:
    """The compared numbers (see the module's docstring); ``idx`` are the
    checked frames' indices in the window, ``implied`` their images as
    the program's readbacks give them (implied_frames where
    ``accumulated``)."""
    err = np.abs(implied - ref_img)
    grown = np.asarray(idx, np.float64) + 1.0 if accumulated else np.ones(len(idx))
    tau = OFF_BASE + OFF_PER_FRAME * grown
    return {
        "frame_mae": float(err.mean()),
        "frame_p90": float(np.quantile(err, 0.9)),
        "frame_off_share": float((err > tau[:, None, None]).mean()),
        "rays_gap": abs(prog_rays_per_path - ref_rays_per_path) / ref_rays_per_path,
    }


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number with a limit at
    or under it, none missing or not finite."""
    out = {k: {"value": nums.get(k), "limit": v} for k, v in limits.items()}
    ok = all(isinstance(e["value"], float) and np.isfinite(e["value"])
             and e["value"] <= e["limit"] for e in out.values())
    return ok, out


def reference(scene, frame: dict, spp: int, pixels, ray_pixels, ray_samples: int,
              keys, device, dtype=torch.float32):
    """The reference's frame images at ``pixels`` (xs, ys) for the frames
    ``keys``, (F, P, 3) float64 numpy, and its traced rays a path over the
    pixels ``ray_pixels`` at the first key's first ``ray_samples``
    samples, in the first frame's world. ``scene`` is the scene arrays of
    every frame, or a list of them, one a key; a world is built once for
    each distinct object among them, one at a time."""
    from benchmark.reference import tracer

    per_frame = list(scene) if isinstance(scene, (list, tuple)) else [scene] * len(keys)
    groups = {}  # one world's scene arrays and its frames' positions
    for i, sc in enumerate(per_frame):
        groups.setdefault(id(sc), (sc, []))[1].append(i)
    img, rays = [None] * len(keys), None
    for sc, pos in groups.values():
        world = tracer.build_world(sc, device, dtype)
        cam = tracer.camera_table(sc["camera"])
        got, _ = tracer.render_frames(world, frame, cam, *pixels, [keys[i] for i in pos],
                                      spp)
        for i, g in zip(pos, got):
            img[i] = g
        if pos[0] == 0:
            _, rays = tracer.render_frames(world, frame, cam, *ray_pixels, keys[:1], spp,
                                           samples=ray_samples)
        del world
    img = torch.stack(img)
    return (img.double().cpu().numpy(),
            float(rays.double().sum().item()) / (rays.numel() * ray_samples))
