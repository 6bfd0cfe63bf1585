"""dispatch_host_ms: the host's time inside Renderer.render_frame_async,
median over the window's frames (host clock around the call)."""

import statistics


def read(run):
    times = [(f.t_dispatched - f.t_dispatch) * 1e3 for f in run.frames]
    return statistics.median(times) if times else None
