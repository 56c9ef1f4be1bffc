"""copy_ms.stream: device time of the copies between host and card (the
pairs in, disp and valid out) a frame in the traced window (ms). The idle
share counts these copies as busy; this says how much of the busy time they
are."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = run.trace.kernel_s(["Memcpy"])
    return 1e3 * s / run.traced_frames if s > 0 else None
