"""The whole step's share of the chip's float32-accurate peak (165
TFLOP/s): the frontend's and scoring's model FLOPs of the window's
valid frames, counted once from the shapes, over the window's wall
seconds, in %.
Layer: whole step.  Moves: `xrt`."""

from portbench import roofline


def read(run):
    w = run.work
    if w["frames"] <= 0 or run.window_s <= 0:
        return None
    flops = (roofline.frontend_model_flops(w["frames"])
             + roofline.scoring_model_flops(w["frames"], w["gaussians"],
                                            w["dim"]))
    return 100.0 * flops / run.window_s / roofline.F32_FLOP_PER_S
