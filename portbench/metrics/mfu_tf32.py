"""mfu_tf32 (whole step): C3D's model FLOPs answered inside the window
(its convolutions and fc6–fc8: 77.1e9 a clip at the published widths,
``pbench/c3d_cost.py``) per second of the window, as a share of the
H100's dense TF32 rate, 494.7e12 FLOP/s, the most the card does on
float32 operands on any route."""

from pbench import c3d_cost


def read(run):
    done = run.completed()
    if not done or run.config.get("system") != "c3d_classifier":
        return None
    flops = sum(run.system.model_flops(r) for r in done)
    return 100.0 * flops / (run.window[1] - run.window[0]) / c3d_cost.PEAK_TF32
