"""K2, the speckle filter's run totals (``stereo/sgm_cuda.py::run_total``
-> ``csrc/speckle_run_total.cu``): the bound of four run totals at the
frame's shapes (``o3r_bench.roofline``) over K2's device time per frame,
by its kernels' names."""

from o3r_bench.roofline import speckle_run_totals_bound_s

UNIT, LAYER, MOVES = "%", "K2", "frames_per_s"
KERNELS = ("run_total_rows_kernel", "run_total_cols_kernel")


def read(summary):
    secs = sum(s for name, (_, s) in summary["kernels"].items()
               if any(k in name for k in KERNELS))
    if secs <= 0 or not summary["frames"]:
        return None
    shp = summary["shapes"]
    bound = speckle_run_totals_bound_s(shp["height"], shp["width"])
    return 100.0 * bound * summary["frames"] / secs
