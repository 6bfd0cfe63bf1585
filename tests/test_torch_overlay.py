"""The overlays against the JAX package: composite_core for each toggle
(TLAS boxes, BLAS roots, branch boxes, light markers, FPS text, all of
them) with the same operands; the eager apply_overlays against the port's
composite_core and JAX's apply_overlays; the host box sets. Demo scene at
48x32, a random frame, a point light placed in view. Bit for bit, but for
the light marker's anti-aliased ring (the pixels 6-8 px from the light,
where its smoothstep alpha is strictly between 0 and 1): there XLA on the
CPU fuses the blend's products into multiply-adds, and about 30 of its
values differ by one ulp."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import overlay as jov
from rayzen_tpu import packing as jpack
from rayzen_tpu_torch import RenderConfig, demo, overlay, pack_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 48, 32
FPS = 57.3

TOGGLES = {
    "tlas": dict(debug_show_bvh=True),
    "branch": dict(debug_show_bvh=True, debug_bvh_mode=1, debug_selected_blas=1,
                   debug_selected_tri=5),
    "lights": dict(debug_show_lights=True),
    "fps": dict(show_fps_overlay=True),
    "all": dict(debug_show_bvh=True, debug_show_lights=True, show_fps_overlay=True),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    scene = demo.build_demo_scene(W, H)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    cam = scene.camera.device_params()
    # a point light 3 units in front of the camera, beside the demo's lights
    ahead = scene.camera.position + 3.0 * scene.camera.target
    jarrays = jpack.pack_scene(jscene, jcfg)
    lights = np.concatenate([np.asarray(jarrays.lights), np.asarray(
        [[*ahead, 1.0, 1.0, 0.4, 0.1, 5.0]], np.float32)])
    jarrays = dataclasses.replace(jarrays, lights=jnp.asarray(lights))
    arrays = dataclasses.replace(pack_scene(scene, cfg, "cpu"),
                                 lights=torch.from_numpy(lights))
    img = np.random.RandomState(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    vp = (cam["proj"] @ cam["view"]).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jarrays=jarrays, arrays=arrays, cam=cam,
                img=img, vp=vp, lights=lights)


def _jax_core(s, cfg):
    (tc, tcol, tm, ut), (bc, bcol, bm, ub) = jov.build_overlay_inputs(s["jarrays"], cfg)
    return np.asarray(jov.composite_core(
        jnp.asarray(s["img"]), tc, tcol, tm, bc, bcol, bm, jnp.asarray(s["vp"]),
        jnp.asarray(s["lights"]), jnp.float32(FPS), use_t=ut, use_b=ub,
        show_lights=cfg.debug_show_lights, show_fps=cfg.show_fps_overlay,
        width=W, height=H))


def _core(s, cfg):
    (tc, tcol, tm, ut), (bc, bcol, bm, ub) = overlay.build_overlay_inputs(
        s["arrays"], cfg)
    return overlay.composite_core(
        torch.from_numpy(s["img"]), tc, tcol, tm, bc, bcol, bm, s["vp"],
        s["arrays"].lights, FPS, use_t=ut, use_b=ub,
        show_lights=cfg.debug_show_lights, show_fps=cfg.show_fps_overlay,
        width=W, height=H).numpy()


def assert_matches_jax(setup, ours, ref, lights: bool):
    """Equal, or with the light markers on, equal outside the marker's ring
    and within one ulp on it."""
    if not lights:
        np.testing.assert_array_equal(ours, ref)
        return
    clip = setup["vp"] @ np.append(setup["lights"][-1, :3], 1.0)
    screen = (clip[:2] / clip[3] * 0.5 + 0.5) * np.asarray([W, H])
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    dist = np.hypot(xs - screen[0], ys - screen[1])
    ring = (dist > 6.0 - 1e-3) & (dist < 8.0 + 1e-3)
    np.testing.assert_array_equal(ours[~ring], ref[~ring])
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


@pytest.mark.parametrize("toggle", sorted(TOGGLES))
def test_composite_core_matches_jax(setup, toggle):
    cfg = setup["cfg"].replace(**TOGGLES[toggle])
    ours = _core(setup, cfg)
    ref = _jax_core(setup, setup["jcfg"].replace(**TOGGLES[toggle]))
    assert_matches_jax(setup, ours, ref, cfg.debug_show_lights)
    assert (ours != setup["img"]).any(axis=-1).sum() >= 20  # the pass drew


def test_apply_overlays_matches_composite_and_jax(setup):
    """The eager reference equals the composite and JAX's eager reference,
    in both BVH modes."""
    jcam = {k: jnp.asarray(v) for k, v in setup["cam"].items()}
    for toggle in ("all", "branch"):
        knobs = dict(TOGGLES[toggle], show_fps_overlay=True,
                     debug_show_lights=True)
        cfg = setup["cfg"].replace(**knobs)
        eager = overlay.apply_overlays(torch.from_numpy(setup["img"]),
                                       setup["arrays"], setup["cam"], cfg,
                                       fps=FPS).numpy()
        np.testing.assert_array_equal(eager, _core(setup, cfg))
        ref = np.asarray(jov.apply_overlays(
            jnp.asarray(setup["img"]), setup["jarrays"], jcam,
            setup["jcfg"].replace(**knobs),
            fps=FPS))
        assert_matches_jax(setup, eager, ref, cfg.debug_show_lights)


def test_box_sets_and_hsv_match_jax(setup):
    np.testing.assert_array_equal(overlay._EDGES, jov._EDGES)
    np.testing.assert_array_equal(overlay._CORNER_SEL, jov._CORNER_SEL)
    ends = overlay._edge_ends(torch.arange(8))
    np.testing.assert_array_equal(torch.stack(ends, 1).numpy(), overlay._EDGES)
    for h, s_, v in ((0.0, 1.0, 1.0), (1 / 3, 1.0, 1.0), (0.5, 0.0, 0.7),
                     (0.81, 0.4, 0.9)):
        np.testing.assert_array_equal(overlay.hsv2rgb(h, s_, v),
                                      jov.hsv2rgb(h, s_, v))
    pairs = [(overlay.tlas_leaf_boxes(setup["arrays"]),
              jov.tlas_leaf_boxes(setup["jarrays"])),
             (overlay.blas_root_boxes(setup["arrays"]),
              jov.blas_root_boxes(setup["jarrays"]))]
    pairs += [(overlay.blas_branch_boxes(setup["arrays"], i, t),
               jov.blas_branch_boxes(setup["jarrays"], i, t))
              for i, t in ((1, 0), (1, 500), (0, 7), (1, 10**6))]
    for (boxes, colors), (jboxes, jcolors) in pairs:
        assert len(boxes) == len(jboxes)
        for a, b in zip(boxes + colors, jboxes + jcolors):
            np.testing.assert_array_equal(a, b)
