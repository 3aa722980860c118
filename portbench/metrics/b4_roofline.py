"""b4_roofline (kernels): kernel B4's share of its roofline in the C3D
cell.  For each ``classify`` call of the traced window, each
convolution's least time (its operations at the H100's dense TF32 rate,
494.7e12 FLOP/s, or its bytes at 3.35e12 B/s, the larger:
``pbench/c3d_cost.py``), summed, over the device time of every kernel
named ``conv3d*`` (B4's launches: its splits, the gather, the
products).  A float32-correct product takes three TF32 passes, so a
layer bound by operations reads at most a third of it."""

from pbench import c3d_cost


def is_b4(name: str) -> bool:
    return "conv3d" in name


def read(run):
    if run.trace is None or run.config.get("system") != "c3d_classifier":
        return None
    calls = [c for c in run.system.calls if c.get("op") == "classify"]
    t = run.trace.device_time_s(is_b4)
    if not calls or t <= 0:
        return None
    bound = sum(c3d_cost.call_bound_s(run.config["model"], c["clips"]) for c in calls)
    return 100.0 * bound / t
