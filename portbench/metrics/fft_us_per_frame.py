"""fft_us_per_frame (engine and cuFFT): device time of the cuFFT kernels
in the traced window, from the profiler's raw events, per frame answered
in it."""


def is_fft(name: str) -> bool:
    return "fft" in name.lower()


def read(run):
    if run.trace is None:
        return None
    frames = sum(run.system.frames(r) for r in run.answered())
    t = run.trace.device_time_s(is_fft)
    if not frames or t <= 0:
        return None
    return t * 1e6 / frames
