"""enqueue_ms.stream: host ms a traced frame in the engine's
``stream.enqueue`` spans: every launch of a batch."""

from benchmark.spans import host_ms_a_frame


def read(run):
    return host_ms_a_frame(run, "stream.enqueue")
