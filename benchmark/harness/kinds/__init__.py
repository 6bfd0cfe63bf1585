"""Scene kinds, found by name as the per-layer metrics are.

A configuration file's ``"kind"`` (``static`` where it has none) names
kinds/<kind>.py, which gives:

- ``scene(cfg, overrides)``: the configuration's scene arrays, in the form
  of scenes.scene_arrays (its ``frame`` settings among them), with the
  size ``overrides`` of the CPU tests that belong to the kind;
- ``program(scene, rcfg, device)``: the program object that the frame
  loop dispatches, built through the port's public entry points;
- ``before_dispatch(program, scene, number)``: called before each
  dispatch, the warm-up's too, with the frame's number in the sequence;
  where a kind hands the program that frame's geometry;
- ``world(scene, number)``: the scene arrays that the reference renders
  frame ``number`` from. Frames given the same object share one world.

Every reader of a configuration's scene goes through its kind, so a later
change adds a kind as a file of its own.
"""

from __future__ import annotations

import importlib


class UnknownKind(LookupError):
    pass


def name_of(cfg: dict) -> str:
    return cfg.get("kind", "static")


def load(cfg: dict):
    """The kind module of a configuration."""
    name = name_of(cfg)
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise UnknownKind(f"scene kind {name!r}: no {module}") from None
