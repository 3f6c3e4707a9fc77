"""The DataPlane step thread's wait for work a dispatch: the window's
difference of `engine.idle_us` (drains that found nothing, and the wait
for the next submit) and `engine.coalesce_us` (the burst sleep) over
the dispatches of the window (`engine.dispatch_us`' count)."""

from mqbench.readers import delta


def read(run):
    if "engine.idle_us" not in run["registry"]["window"][1]["hist"]:
        return None
    n = delta(run, "engine.dispatch_us.count")
    if n <= 0:
        return None
    wait = (delta(run, "engine.idle_us.total")
            + delta(run, "engine.coalesce_us.total"))
    return wait / n / 1e3
