"""Host time in the engine's own spans (``stream.*``, recorded by
``torch.profiler.record_function`` inside ``StreamRunner``), from the traced
window of a run."""

from __future__ import annotations

from typing import Optional


def host_ms_a_frame(run, name: str) -> Optional[float]:
    """Host ms a traced frame in the spans called ``name``, each clipped to
    the traced window; None without a trace or without such spans (an
    engine that records none)."""
    if run.trace is None or not run.traced_frames:
        return None
    lo, hi = run.trace.window
    ns = sum(min(e, hi) - max(s, lo) for n, s, e in run.trace.host
             if n == name and e > lo and s < hi)
    return ns / 1e6 / run.traced_frames if ns > 0 else None
