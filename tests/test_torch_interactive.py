"""The port's interactive session and CLI on the CPU, held to the JAX
package's expectations (tests/test_interactive.py, tests/test_runtime.py
TestCli): movement and looks change the frame, the toggles flip the live
config, the preview toggle and quit, a click picks, save writes a PNG, the
pipelined loop renders the synchronous loop's frames and drains before a
save, and ``python -m rayzen_tpu_torch --device cpu`` writes a frame,
path-traced and preview. 32x24, 1 bounce."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from rayzen_tpu_torch import RenderConfig, demo
from rayzen_tpu_torch.cli import main
from rayzen_tpu_torch.interactive import InteractiveSession
from rayzen_tpu_torch.renderer import Renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 32, 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_session(tmp, out_path=None, **knobs):
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=1,
                       cache_dir=str(tmp / "cache"), **knobs)
    r = Renderer(demo.build_small_scene(W, H), cfg, async_compile=False,
                 device="cpu")
    return InteractiveSession(r, out_path=out_path, status=io.StringIO())


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("live")
    return make_session(tmp, out_path=str(tmp / "live.png")), tmp


def test_movement_and_look_change_the_frame(session):
    s, tmp = session
    s.run(io.StringIO("w 0.4\n"))
    first = s.frame.copy()
    assert os.path.exists(str(tmp / "live.png"))
    s.handle("look 40 0")
    assert not np.allclose(first, s.frame)
    pos0 = s.r.scene.camera.position.copy()
    s.handle("d 0.5")
    assert not np.allclose(pos0, s.r.scene.camera.position)


def test_toggles_preview_and_quit(session):
    s, _ = session
    assert not s.r.cfg.debug_show_bvh
    s.handle("b")
    assert s.r.cfg.debug_show_bvh
    s.handle("l")
    assert s.r.cfg.debug_show_lights
    s.handle("n")
    assert s.r.cfg.debug_bvh_mode == 1
    for cmd in ("b", "l", "n"):
        s.handle(cmd)
    assert not (s.r.cfg.debug_show_bvh or s.r.cfg.debug_show_lights)
    assert s.r.cfg.debug_bvh_mode == 0
    s.handle("p")
    assert s.mode == "preview"
    s.handle("p")
    assert s.mode == "auto"
    s.handle("bogus")
    assert "? unknown command" in s.status.getvalue()
    assert s.handle("quit") is False


def test_click_picks_and_save(session):
    s, tmp = session
    s.handle("n")  # BLAS mode: a pick selects the branch to draw
    s.handle("click 16 12")
    text = s.status.getvalue()
    assert "pick: instance" in text
    assert (s.r.cfg.debug_selected_blas, s.r.cfg.debug_selected_tri) != (0, 0) \
        or "tri 0" in text
    s.handle("click 0 23")  # the top-left corner: the sky
    assert "pick: miss" in s.status.getvalue()
    s.handle(f"save {tmp / 'snap.png'}")
    assert os.path.exists(str(tmp / "snap.png"))


def test_pipeline_matches_sync(tmp_path):
    """run(pipeline=3): the same frames, the same final state and a status
    line per frame; a save resolves the frames in flight first."""
    cmds = ["w 0.4", "look 30 0", "d 0.3", "b", "w 0.2"]
    sa = make_session(tmp_path)
    n_sync = sa.run(iter(cmds + ["quit"]))
    sb = make_session(tmp_path)
    n_pipe = sb.run(iter(cmds + ["quit"]), pipeline=3)
    assert n_pipe == n_sync and not sb._pending
    np.testing.assert_array_equal(sa.r.scene.camera.position,
                                  sb.r.scene.camera.position)
    np.testing.assert_array_equal(sa.frame, sb.frame)
    assert sb.status.getvalue().count("frame ") == n_pipe
    sc = make_session(tmp_path)
    snap = tmp_path / "snap.png"
    sc.run(iter(["w 0.4", "look 20 0", "w 0.2", f"save {snap}", "quit"]),
           pipeline=4)
    assert os.path.exists(str(snap)) and not sc._pending


@pytest.mark.parametrize("flags", [["--path-tracer-only", "--frames", "2",
                                    "--show-fps", "--show-lights"],
                                   ["--preview"]], ids=["pt", "preview"])
def test_cli_writes_a_frame(tmp_path, flags):
    out = str(tmp_path / "o.png")
    rc = main(["--device", "cpu", "--width", str(W), "--height", str(H),
               "--bounces", "1", "--out", out, "--log", "error",
               "--cache-dir", str(tmp_path / "cache"), *flags])
    assert rc == 0 and os.path.getsize(out) > 0


def test_python_m_runs_the_cli(tmp_path):
    out = str(tmp_path / "m.png")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "rayzen_tpu_torch", "--device", "cpu",
         "--width", "16", "--height", "12", "--bounces", "1", "--out", out,
         "--cache-dir", str(tmp_path / "cache"), "--log", "error"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert os.path.getsize(out) > 0
