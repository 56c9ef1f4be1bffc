"""stage_ms.stream: host ms a traced frame in the engine's ``stream.stage``
spans: stacking, pinning and enqueueing the copy in of a batch's frames."""

from benchmark.spans import host_ms_a_frame


def read(run):
    return host_ms_a_frame(run, "stream.stage")
