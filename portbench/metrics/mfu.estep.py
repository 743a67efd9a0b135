"""The E-step's share of the chip's float32-accurate peak (165
TFLOP/s): scoring, the moment sums and the chain forward-backward of
the window's frames (`roofline.estep_model_flops`), counted once from
the shapes, over the window's wall seconds, in %.
Layer: whole step.  Moves: `stats_fps`."""

from portbench import roofline


def read(run):
    w = run.work
    if w["frames"] <= 0 or run.window_s <= 0:
        return None
    flops = roofline.estep_model_flops(w["frames"], w["gaussians"], w["dim"],
                                       w["frame_positions"])
    return 100.0 * flops / run.window_s / roofline.F32_FLOP_PER_S
