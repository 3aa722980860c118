"""b1_roofline (kernels): kernel B1's share of its memory roofline.  The
bytes each one-shot ``classify`` call's MAC needs (its clips' spectra,
the grating and the products, each moved once: the frozen ``kernel_cost``
of ``spectral_mac``) at 3.35e12 B/s, summed over the traced window's
calls, over B1's device time there (``mac_c1_kernel`` / ``mac_kernel``)."""

from pbench import yardstick


def is_b1(name: str) -> bool:
    return "mac_c1_kernel" in name or "mac_kernel<" in name


def read(run):
    if run.trace is None or "model" not in run.config:
        return None
    m = run.config["model"]
    F = yardstick.spectral_bins(m["height"], m["width"], m["frames"], m["k_h"], m["k_w"], m["k_t"])
    calls = [c for c in run.system.calls if c.get("op") == "classify"]
    t = run.trace.device_time_s(is_b1)
    if not calls or t <= 0:
        return None
    nbytes = sum(yardstick.spectral_mac_cost(c["clips"], m["num_kernels"], m["in_channels"], F)[1]
                 for c in calls)
    return 100.0 * nbytes / yardstick.HBM_BW / t
