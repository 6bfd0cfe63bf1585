"""rayzen_tpu_torch — the rayzen_tpu path tracer on PyTorch and hand-written
CUDA for an NVIDIA H100.

A port of the JAX package beside it (rayzen_tpu, the reference it is tested
against). The numpy scene model and BVH builder are carried over; the
per-frame refit is torch tensor glue; the full-sample path-tracing kernel
(K1) and the walks (K2-K9: BVH2, tiered, wide, frustum and miss-link) are
CUDA C++ kernels in csrc/, built with nvcc at first use (ext.py). The
per-wave path (integrator.trace_wave) runs the staged kernels= variants
on those walks with torch glue between them, or the portable torch walks
(ops/traverse.py). Every kernel has a plain PyTorch version beside it,
which the wrappers run for CPU tensors. Above them, the frame loop
(renderer.Renderer: preview, overlays, picking, the scene cache, the
profiler, chunked scenes) and the CLI and interactive session
(``python -m rayzen_tpu_torch``, cli.py, interactive.py). Deforming meshes
rebuild an LBVH on the device every frame (deform.py, accel/lbvh.py);
frames can be cut into tiles over a list of devices (parallel.py); the C++
SAH builder and OBJ parser (accel/native.py) are built with g++ at first
use.

Importing this package imports torch and numpy only: no jax, and no kernel
build.
"""

from .camera import Camera  # noqa: F401
from .config import RenderConfig  # noqa: F401
from .light import Light  # noqa: F401
from .material import Material  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .scene import GameObject, Scene  # noqa: F401
from .packing import (  # noqa: F401
    SceneArrays, WorldArrays, pack_scene, pack_scene_host, world_geometry,
)
from .integrator import (  # noqa: F401
    render_radiance, render_radiance_with_stats, render_rays,
)
from .renderer import Renderer  # noqa: F401
from .deform import render_deforming, world_from_deforming  # noqa: F401
from .bigscene import partition_scene, render_radiance_chunked  # noqa: F401
from .interactive import InteractiveSession  # noqa: F401
from .parallel import make_mesh, render_radiance_sharded  # noqa: F401
from . import procedural  # noqa: F401

__version__ = "0.1.0"
