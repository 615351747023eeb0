"""K1, the SGM path aggregation (``stereo/sgm_cuda.py::aggregate`` ->
``csrc/sgm_aggregate.cu``): the bound of one aggregation at the frame's
shapes (``o3r_bench.roofline``) over K1's device time per aggregation, by
its kernels' names; one aggregation a frame."""

from o3r_bench.roofline import sgm_aggregation_bound_s

UNIT, LAYER, MOVES = "%", "K1", "frames_per_s"
KERNELS = ("sgm_half_kernel", "finish_half_kernel", "sgm_lines_kernel",
           "unpack16_kernel", "round_half_kernel")


def read(summary):
    secs = sum(s for name, (_, s) in summary["kernels"].items()
               if any(k in name for k in KERNELS))
    if secs <= 0 or not summary["frames"]:
        return None
    shp = summary["shapes"]
    bound = sgm_aggregation_bound_s(shp["height"], shp["width"], shp["max_disparity"],
                                    shp["num_paths"], shp["storage_bytes"])
    return 100.0 * bound * summary["frames"] / secs
