"""mfu (whole step): the model FLOPs of the work answered inside the window
(the spectral algorithm at the configuration's geometry, counted by the
frozen ``fft_flops``, plus the digital head's GEMMs) per second of the
window, as a share of the H100's 67e12 float32 FLOP/s.  It counts the
algorithm's work, not what an implementation runs."""

from pbench import yardstick


def read(run):
    done = run.completed()
    if not done:
        return None
    flops = sum(run.system.model_flops(r) for r in done)
    return 100.0 * flops / (run.window[1] - run.window[0]) / yardstick.PEAK_F32
