"""frame_roofline.stream: the whole frame's share of the card's peak (%):
the least time of a frame from the algorithm's own work (``work.frame_work``:
every stage's operations, only the pair in and the map out as bytes) at the
published peaks, times the frames traced, over the traced window."""

from benchmark.work import frame_work


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    h, w = run.shape
    bound = frame_work(h, w, run.stereo)["bound_ms"] * run.traced_frames
    return 100.0 * bound / (run.trace.window_s * 1e3)
