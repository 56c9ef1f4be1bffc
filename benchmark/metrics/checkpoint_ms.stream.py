"""checkpoint_ms.stream: host ms a traced frame in the engine's
``stream.checkpoint`` spans, with the pipeline emptied for a checkpoint: the
waits on the card and the deliveries of every batch in flight, and the
manifest written."""

from benchmark.spans import host_ms_a_frame


def read(run):
    return host_ms_a_frame(run, "stream.checkpoint")
