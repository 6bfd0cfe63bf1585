"""The plain reference against the program's CPU path, at tiny sizes."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.harness import bench, check, scenes  # noqa: E402
from benchmark.harness.kinds import static  # noqa: E402
from benchmark.reference import bvh, tracer  # noqa: E402


def _config(name, **kw):
    cfg = scenes.load_config(os.path.join(scenes.BENCH_DIR, "configs", name + ".json"))
    cfg = copy.deepcopy(cfg)
    cfg.update(kw)
    return cfg


def _small_field():
    cfg = _config("field", width=32, height=24)
    cfg["grid"] = dict(cfg["grid"], count=12)
    return cfg


def _program_frames(sc, spp, keys, tiered="auto"):
    """The program's frame images for ``keys`` (its CPU path: the plain
    K1 over the packed scene), (F, H, W, 3)."""
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.packing import pack_scene

    fr = sc["frame"]
    traffic = {"spp": spp, "render": {"tiered": tiered}}
    rcfg = bench.render_config(fr, traffic, scenes.num_triangles(sc))
    scene = static.port_scene(sc)
    arrays = pack_scene(scene, rcfg, "cpu")
    cam = scene.camera.device_params()
    out, rays = [], []
    for k in keys:
        img, r = render_radiance_with_stats(arrays, cam, rcfg, rng_key=k)
        out.append(img.numpy())
        rays.append(int(r))
    return np.stack(out), rays


@pytest.mark.parametrize("cfg, spp, keys, tiered", [
    (_config("demo", width=32, height=24), 2, [0, 7], "auto"),
    (_config("demo", width=24, height=16, max_bounces=3), 1, [123], "auto"),
    (_small_field(), 2, [3], "auto"),
    (_small_field(), 1, [5], "on"),
])
def test_reference_matches_program_cpu_path(cfg, spp, keys, tiered):
    sc = scenes.scene_arrays(cfg)
    fr = sc["frame"]
    prog, rays = _program_frames(sc, spp, keys, tiered)
    ys, xs = np.mgrid[0:fr["height"], 0:fr["width"]]
    px = (xs.ravel(), ys.ravel())
    ref, ref_rpp = check.reference(sc, fr, spp, px, px, spp, keys, "cpu")
    ref = ref.reshape(prog.shape)
    # the same draws and the same hits: equal but for float rounding
    assert np.abs(prog - ref).max() < 1e-4
    assert np.abs(prog - ref).mean() < 1e-6
    # the first frame's every path: the same rays, ray for ray
    assert ref_rpp * fr["width"] * fr["height"] * spp == rays[0]


def test_implied_frames_invert_the_running_mean():
    g = np.random.default_rng(0)
    imgs = g.random((6, 5, 3), dtype=np.float32)
    acc, vals = None, []
    for j, img in enumerate(imgs):  # the program's float32 running mean
        if acc is None:
            acc = img
        else:
            a = np.float32(1.0 / (j + 1))
            acc = (acc * (np.float32(1.0) - a) + img * a).astype(np.float32)
        vals.append(acc)
    got = check.implied_frames(np.stack(vals), [0, 2, 5])
    assert np.abs(got - imgs[[0, 2, 5]]).max() < 1e-5


def test_bvh_walk_finds_the_brute_force_hits():
    sc = scenes.scene_arrays(_config("demo", width=40, height=30))
    fr = sc["frame"]
    world = tracer.build_world(sc, "cpu")
    cam = tracer.camera_table(sc["camera"])
    ys, xs = np.mgrid[0:30, 0:40]
    u, v = tracer.pixel_uv(40, 30, xs.ravel(), ys.ravel(), "cpu")
    s = torch.zeros_like(u)
    work = bvh.Work()
    walked = tracer.trace_paths(world, fr, cam, u, v, s, walker=bvh.Walker(world, work))
    brute = tracer.trace_paths(world, fr, cam, u, v, s)
    assert torch.equal(walked[1], brute[1])
    assert (walked[0] - brute[0]).abs().max() < 1e-5
    assert work.visits > 0 and work.tests > 0


def test_control_precision_moves_the_image():
    sc = scenes.scene_arrays(_config("demo", width=32, height=24))
    fr = sc["frame"]
    ys, xs = np.mgrid[0:24, 0:32]
    px = (xs.ravel(), ys.ravel())
    f32, _ = check.reference(sc, fr, 2, px, px, 1, [1], "cpu")
    bf16, _ = check.reference(sc, fr, 2, px, px, 1, [1], "cpu", torch.bfloat16)
    assert np.abs(f32 - bf16).mean() > 1e-3
