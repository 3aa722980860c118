"""batch_size.mean (scheduler): requests completed per batch dispatched
over the window, from the deltas of ``MicrobatchScheduler``'s
``completed`` and ``batches`` counters."""


def read(run):
    a, b = run.counters_before, run.counters_after
    if "batches" not in a:
        return None
    batches = b["batches"] - a["batches"]
    return (b["completed"] - a["completed"]) / batches if batches else None
