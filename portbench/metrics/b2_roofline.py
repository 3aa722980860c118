"""b2_roofline (kernels): kernel B2's share of its memory roofline.  Per
batch call of the traced window, the bytes its pooled MAC needs: every
row's window spectra read once (the windows its overlap-save plan needs),
every present tenant's grating read once, every row's outputs written
once; at 3.35e12 B/s, summed, over B2's device time
(``mac_grouped_kernel``)."""

from pbench import yardstick


def is_b2(name: str) -> bool:
    return "mac_grouped_kernel" in name


def batch_bytes(config: dict, rows) -> int:
    H, W = config["frame_hw"]
    O, C, kh, kw, kt = config["kernel_shape"]
    block = config["server"]["window_frames"]
    itemsize = 2 if config["server"]["grating_dtype"] == "bfloat16" else 4
    F = yardstick.spectral_bins(H, W, block, kh, kw, kt)
    windows = sum(n * yardstick.stream_plan(frames, kt, block).n_blocks for _, n, frames in rows)
    tenants = len({name for name, _, _ in rows})
    return yardstick.grouped_mac_bytes(windows, tenants * O, C, F, O, itemsize)


def read(run):
    if run.trace is None:
        return None
    calls = [c for c in getattr(run.system, "calls", []) if "rows" in c]
    t = run.trace.device_time_s(is_b2)
    if not calls or t <= 0:
        return None
    nbytes = sum(batch_bytes(run.config, c["rows"]) for c in calls)
    return 100.0 * nbytes / yardstick.HBM_BW / t
