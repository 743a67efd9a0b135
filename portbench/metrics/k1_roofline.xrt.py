"""K1 (`csrc/gmm_state_ll.cu`) against its bound: the least time of
the profiled launches' products and bytes (`roofline.gmm_*`, from the
rows scored, the states, K and D) over the profiler's device time of
`gmm_state_ll` kernels, in %.
Layer: kernels.  Moves: `xrt`."""

from portbench import roofline


def read(run):
    t = run.profile.kernel_s("gmm_state_ll") if run.profile else 0.0
    rows = run.work["profiled"]["k1_rows"]
    if t <= 0 or rows <= 0:
        return None
    w = run.work
    b = roofline.bound_s(
        roofline.gmm_flops(rows, w["states"], w["components"], w["dim"]),
        roofline.gmm_bytes(rows, w["states"], w["components"], w["dim"]))
    return 100.0 * b / t
