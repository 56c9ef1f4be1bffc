"""fps: frames whose disp and valid reached host memory inside the window,
over the time from the first frame handed over to the last such delivery
(host clock). All the work and the time it took; no median of batches."""


def read(run):
    if not getattr(run, "deliveries", None):
        return None
    inside = [(t, n) for t, n in run.deliveries if t <= run.t0 + run.seconds]
    if not inside:
        return None
    return sum(n for _, n in inside) / (inside[-1][0] - run.t0)
