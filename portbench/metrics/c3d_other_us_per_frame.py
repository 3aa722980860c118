"""c3d_other_us_per_frame (trunk glue and head): the device time of every
operation of the traced window that is not one of B4's kernels
(``conv3d*``) nor the benchmark's drawing of the clips (``torch.rand``'s
``distribution_elementwise*`` kernels), per frame answered: the pools,
layout copies, fc6–fc8's GEMMs, copies and memsets."""


def is_other(name: str) -> bool:
    return "conv3d" not in name and "distribution_elementwise" not in name


def read(run):
    if run.trace is None or not run.trace.device or run.config.get("system") != "c3d_classifier":
        return None
    frames = sum(run.system.frames(r) for r in run.answered())
    if not frames:
        return None
    return run.trace.device_time_s(is_other) * 1e6 / frames
