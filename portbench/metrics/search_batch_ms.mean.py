"""search_batch_ms.mean (server): the mean duration of the
``VideoSearchServer.search_batch`` calls of the window (host clock, the
benchmark's wrapper)."""

from pbench import stats


def read(run):
    calls = [c for c in getattr(run.system, "calls", []) if "rows" in c]
    if not calls:
        return None
    return stats.mean((c["t1"] - c["t0"]) * 1e3 for c in calls)
