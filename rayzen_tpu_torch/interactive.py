"""Live interactive session: input-driven camera + debug toggles between frames.

Port of rayzen_tpu/interactive.py, the same protocol and loops over the
port's Renderer (frames on the card unless the Renderer was built for the
CPU). Frames in flight (``run(pipeline=N)``) are Renderer.render_frame_async
dispatches, resolved oldest first.

Reference behaviors reproduced (RayZen/src/main.cpp):
- WASD movement through ``processInput`` (:696-740) — forward/back/strafe with
  speed * dt (Camera.h:52-64); mouse-drag look with the 0.1 sensitivity and the
  +-89 deg pitch clamp (:727-740, Camera.h:66-85).
- Debounced keyboard toggles (:441-499): F1 path-tracer/editor swap, L light
  markers, B BVH wireframes, N TLAS/BLAS mode.
- Click picking in BLAS-debug mode (:502-552): selects the instance + triangle
  whose traversal branch the overlay visualizes.

The reference is a GLFW window app; on a headless host the session is
stream-driven instead: commands arrive on any text stream (stdin for a human,
a list/StringIO for tests — the "recorded session"), every command renders a
fresh frame through the live Renderer, and each frame is presented by writing
``out_path`` (a PNG whose viewer refreshes, the swap-chain analog) plus a
one-line status readout.

Protocol (one command per line; bare Enter re-renders):
  w / a / s / d [dt]   move (default dt 0.5 s at the reference 2.5 u/s speed)
  look DX DY           mouse-drag analog, pixels; sensitivity 0.1 (Camera.h:80)
  p                    toggle path-tracer <-> preview ("F1", main.cpp:441-460)
  l                    toggle light markers ("L", main.cpp:462-470)
  b                    toggle BVH wireframes ("B", main.cpp:472-481)
  n                    toggle TLAS/BLAS wireframe mode ("N", main.cpp:483-499)
  click X Y            pick at pixel (BLAS-debug picking, main.cpp:502-552)
  save PATH            write the current frame to PATH
  quit                 end the session
"""

from __future__ import annotations

import shlex
import sys
from collections import deque
from typing import IO, Iterable, Optional

import numpy as np

from .image_io import write_png
from .picking import pick, pick_chunks
from .renderer import Renderer


class InteractiveSession:
    """Drives a Renderer from a command stream. See the module docstring for
    the protocol. Mutates camera/toggles *between* frames — no restarts, no
    rebuilds (camera and transforms are per-frame inputs; overlays are a post
    pass)."""

    def __init__(
        self,
        renderer: Renderer,
        out_path: Optional[str] = "live.png",
        status: IO = sys.stdout,
    ):
        self.r = renderer
        self.out_path = out_path
        self.status = status
        self.mode = "auto"  # "auto" follows compile readiness; "preview" forced
        self.frame: Optional[np.ndarray] = None
        self._pending = deque()  # in-flight PendingFrames (pipelined run)

    # -- command handling -------------------------------------------------
    def handle(self, line: str) -> bool:
        """Apply one command and render synchronously. Returns False when the
        session should end."""
        cont, rerender = self._apply(line)
        if cont and rerender:
            self._render()
        return cont

    def _apply(self, line: str) -> tuple:
        """Apply one command's state mutation. Returns (continue, rerender)
        so the session loop can choose sync rendering (handle) or pipelined
        async dispatch (run with pipeline > 1)."""
        parts = shlex.split(line.strip())
        cmd = parts[0].lower() if parts else ""
        r = self.r
        cam = r.scene.camera
        if cmd == "quit":
            return False, False
        elif cmd in ("w", "a", "s", "d"):
            dt = float(parts[1]) if len(parts) > 1 else 0.5
            {
                "w": cam.move_forward,
                "s": cam.move_backward,
                "a": cam.move_left,
                "d": cam.move_right,
            }[cmd](dt)
            r.sync_camera()
        elif cmd == "look" and len(parts) >= 3:
            cam.rotate(float(parts[1]), float(parts[2]))
            r.sync_camera()
        elif cmd == "p":  # F1: path tracer <-> preview (main.cpp:441-460)
            self.mode = "preview" if self.mode != "preview" else "auto"
        elif cmd == "l":
            r.cfg = r.cfg.replace(debug_show_lights=not r.cfg.debug_show_lights)
        elif cmd == "b":
            r.cfg = r.cfg.replace(debug_show_bvh=not r.cfg.debug_show_bvh)
        elif cmd == "n":
            r.cfg = r.cfg.replace(debug_bvh_mode=1 - r.cfg.debug_bvh_mode)
        elif cmd == "click" and len(parts) >= 3:
            xy = (float(parts[1]), float(parts[2]))
            res = (r.cfg.width, r.cfg.height)
            if r.arrays_list is not None:
                # chunked scene: query every chunk, keep the closest hit —
                # picking only chunk 0 silently misses the rest of the scene
                hit = pick_chunks(r.arrays_list, r._camera_params(), xy, res)
            else:
                hit = pick(r.arrays, r._camera_params(), xy, res)
            if hit is None:
                self._say("pick: miss")
            else:
                if hit.get("chunk", 0) == 0:
                    r.cfg = r.cfg.replace(
                        debug_selected_blas=hit["instance"],
                        debug_selected_tri=hit["triangle"],
                    )
                else:
                    # chunked pick indices are local to the winning chunk's
                    # packed arrays, but the wireframe overlay renders from
                    # chunk 0's arrays — highlighting chunk-0 instance
                    # hit["instance"] would outline the WRONG object
                    # (ADVICE r3), so report without selecting.
                    self._say(
                        f"pick: selection overlay unavailable for chunk "
                        f"{hit['chunk']} (overlays draw from chunk 0)"
                    )
                chunk = f" chunk {hit['chunk']}" if "chunk" in hit else ""
                self._say(
                    f"pick: instance {hit['instance']} tri {hit['triangle']}"
                    f"{chunk} t={hit['t']:.3f}"
                )
        elif cmd == "save" and len(parts) >= 2:
            self._drain()  # pipelined mode: resolve in-flight frames first
            if self.frame is None:
                self._render()  # save before any frame: render one to save
            write_png(parts[1], self.frame)
            self._say(f"saved {parts[1]}")
            return True, False
        elif cmd == "":
            pass  # bare Enter: just re-render
        else:
            self._say(f"? unknown command: {line.strip()!r}")
            return True, False
        return True, True

    def _render(self) -> None:
        self.frame = self.r.render_frame(mode=self.mode)
        if self.out_path:
            # level-1 deflate: the live refresh is the swap analog, speed
            # over size (explicit `save` keeps the default level)
            write_png(self.out_path, self.frame, compress_level=1)
        p = self.r.profiler
        cam = self.r.scene.camera
        self._say(
            f"frame {self.r.frame_index - 1} [{self.mode}] "
            f"pos=({cam.position[0]:.2f},{cam.position[1]:.2f},{cam.position[2]:.2f}) "
            f"yaw={cam.yaw:.1f} pitch={cam.pitch:.1f} "
            f"fps={p.fps_ema or 0.0:.1f} "
            f"bvh={'on' if self.r.cfg.debug_show_bvh else 'off'} "
            f"lights={'on' if self.r.cfg.debug_show_lights else 'off'}"
        )

    def _say(self, msg: str) -> None:
        print(msg, file=self.status, flush=True)

    def _dispatch(self) -> None:
        """Dispatch one async frame (pipelined mode), recording the dispatch-
        time status so the resolve can report the camera state the frame
        actually rendered."""
        cam = self.r.scene.camera
        status = (
            f"[{self.mode}] "
            f"pos=({cam.position[0]:.2f},{cam.position[1]:.2f},"
            f"{cam.position[2]:.2f}) "
            f"yaw={cam.yaw:.1f} pitch={cam.pitch:.1f} "
            f"bvh={'on' if self.r.cfg.debug_show_bvh else 'off'} "
            f"lights={'on' if self.r.cfg.debug_show_lights else 'off'}"
        )
        self._pending.append((self.r.render_frame_async(mode=self.mode),
                              status))

    def _resolve_one(self) -> None:
        pf, status = self._pending.popleft()
        self.frame = pf.resolve()
        if self.out_path:
            write_png(self.out_path, self.frame, compress_level=1)
        p = self.r.profiler
        self._say(f"frame {pf.frame_no} {status} fps={p.fps_ema or 0.0:.1f}")

    def _drain(self) -> None:
        while self._pending:
            self._resolve_one()

    # -- session loops ----------------------------------------------------
    def run(self, stream: Iterable[str] = None, pipeline: int = 1) -> int:
        """Consume commands until EOF or 'quit'. Returns frames rendered.

        ``pipeline`` > 1 keeps up to that many frames in flight (async
        dispatch: the host applies the next command and enqueues its frame
        while the card renders the earlier ones). 1 = the strictly
        synchronous loop."""
        stream = stream if stream is not None else sys.stdin
        if pipeline <= 1:
            self._render()  # first frame before any input
            n = 1
            for line in stream:
                if not self.handle(line):
                    break
                n += 1
            return n

        self._dispatch()  # first frame before any input
        n = 1
        for line in stream:
            cont, rerender = self._apply(line)
            if not cont:
                break
            if rerender:
                self._dispatch()
                n += 1
            while len(self._pending) >= pipeline:
                self._resolve_one()
        self._drain()
        return n
