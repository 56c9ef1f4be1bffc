"""Host spans of the port on the profiler's clock.

``span(name)`` marks a stretch of host work. While a ``torch.profiler``
runs it is a ``record_function`` range, so it lands in the same trace as
the card's kernels and copies, on the same clock; with no profiler running
it is one shared null context, and a span costs a flag read. The port's spans, all in ``parallel/stream.py:StreamRunner``:

  stream.collect     pulling one batch's frames from the caller's iterator
                     (``run``)
  stream.stage       stacking, pinning and enqueueing the copy in of a
                     batch's left and right frames (``run``)
  stream.enqueue     every launch of a batch: the pipeline call, the cut of
                     a padded batch and its completion event
  stream.wait        waiting for the oldest enqueued batch's event
  stream.deliver     the caller's ``on_result`` on that batch
  stream.checkpoint  emptying the pipeline (its ``stream.wait`` and
                     ``stream.deliver`` nest inside) and writing the
                     manifest, at ``checkpoint_every``, a ``fail_after``
                     fault and the end of the stream
"""

from __future__ import annotations

from contextlib import nullcontext

from torch.autograd import profiler as _profiler

_OFF = nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else the
    shared null context. Whether a span is recorded is decided when it is
    made: one made before a profiler starts records nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
