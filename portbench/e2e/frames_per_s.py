"""frames_per_s: every frame of every request or call answered inside the
window, over the window's seconds (host clock)."""


def read(run):
    done = run.completed()
    if not done:
        return None
    return sum(run.system.frames(r) for r in done) / (run.window[1] - run.window[0])
