"""The static kind: the configuration's meshes, ``instances`` and ``grid``
as they stand, drawn by one Renderer; its geometry never moves, so every
frame's world is the scene itself."""

from __future__ import annotations

import numpy as np

from .. import scenes


def scene(cfg: dict, overrides: dict) -> dict:
    """The scene arrays; ``grid_count`` replaces a grid's instance count."""
    if "grid_count" in overrides and "grid" in cfg:
        cfg = dict(cfg, grid=dict(cfg["grid"], count=overrides["grid_count"]))
    return scenes.scene_arrays(cfg)


def port_scene(sc: dict):
    """The scene arrays as the program's Scene (the same arrays)."""
    from rayzen_tpu_torch.camera import Camera
    from rayzen_tpu_torch.light import Light
    from rayzen_tpu_torch.material import Material
    from rayzen_tpu_torch.mesh import Mesh
    from rayzen_tpu_torch.scene import GameObject, Scene

    meshes = {k: Mesh(v, np.zeros(v.shape[0], np.int32)) for k, v in sc["meshes"].items()}
    cam = sc["camera"]
    return Scene(
        camera=Camera(position=np.asarray(cam["position"], np.float32),
                      target=np.asarray(cam["target"], np.float32),
                      up=np.asarray(cam["up"], np.float32), fov=float(cam["fov"]),
                      aspect_ratio=cam["aspect"], near_clip=float(cam["near"]),
                      far_clip=float(cam["far"])),
        materials=[Material(tuple(float(x) for x in m[:3]), float(m[3]), float(m[4]),
                            float(m[5]), float(m[6]), float(m[7]))
                   for m in sc["materials"]],
        lights=[Light(tuple(float(x) for x in l[:4]), tuple(float(x) for x in l[4:7]),
                      float(l[7])) for l in sc["lights"]],
        game_objects=[GameObject(meshes[m], x, name=f"{m} {i}", material_override=mo)
                      for i, (m, x, mo) in enumerate(sc["instances"])],
    )


def program(sc: dict, rcfg, device: str):
    from rayzen_tpu_torch.renderer import Renderer

    return Renderer(port_scene(sc), rcfg, async_compile=False, device=device)


def before_dispatch(program, sc: dict, number: int) -> None:
    return None


def world(sc: dict, number: int) -> dict:
    return sc
