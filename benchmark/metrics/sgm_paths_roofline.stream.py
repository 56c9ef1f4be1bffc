"""sgm_paths_roofline.stream: K2's share of its roofline (%): the frozen
bound of all path directions of a frame at the cell's shape, times the frames
traced, over the device time of the kernels that ``kernels/sgm_paths/``
names."""

from benchmark.devtrace import kernel_names
from benchmark.work import paths_bound_ms


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    k2_s = run.trace.kernel_s(kernel_names(run.bench / "kernels" / "sgm_paths"))
    if k2_s <= 0:
        return None
    h, w = run.shape
    bound = paths_bound_ms(h, w, run.stereo["num_disparities"],
                           run.stereo["num_paths"]) * run.traced_frames
    return 100.0 * bound / (k2_s * 1e3)
