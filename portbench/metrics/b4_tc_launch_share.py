"""b4_tc_launch_share (kernels): the share of kernel B4's launches inside
the window that took a tensor-core route (``wgmma`` or ``igemm``), from
the deltas of its per-route launch counters, which the adapter reads
(``counters()``: ``b4_launches.<route>``).  None where the program has
no such counters."""

TENSOR_CORE_ROUTES = ("wgmma", "igemm")


def read(run):
    before, after = run.counters_before, run.counters_after
    delta = {k.split(".", 1)[1]: after[k] - before.get(k, 0)
             for k in after if k.startswith("b4_launches.")}
    total = sum(delta.values())
    if total <= 0:
        return None
    return 100.0 * sum(delta.get(r, 0) for r in TENSOR_CORE_ROUTES) / total
