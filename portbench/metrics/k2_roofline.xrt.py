"""K2 (`csrc/mfcc_core.cu`) against its bound: the least time of the
profiled launches' products and bytes (`roofline.mfcc_*`, from the
frames given to it, context included) over the profiler's device time
of `mfcc_core` kernels, in %.
Layer: kernels.  Moves: `xrt`."""

from portbench import roofline


def read(run):
    t = run.profile.kernel_s("mfcc_core") if run.profile else 0.0
    rows = run.work["profiled"]["k2_rows"]
    if t <= 0 or rows <= 0:
        return None
    return 100.0 * roofline.bound_s(roofline.mfcc_flops(rows),
                                    roofline.mfcc_bytes(rows)) / t
