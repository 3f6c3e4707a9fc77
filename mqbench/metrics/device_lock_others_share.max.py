"""The share of the window for which the DataPlane's device lock was held
by others than the step thread: the window's difference of the totals
of `dataplane.lock_hold_us.read` (the read coalescer),
`.fetch` (state fetches) and `.other` (elections, resyncs, the
warm-up, installs), over the window's microseconds."""

from mqbench.readers import delta

HOLDERS = ("read", "fetch", "other")


def read(run):
    hist = run["registry"]["window"][1]["hist"]
    names = [f"dataplane.lock_hold_us.{h}" for h in HOLDERS]
    if not any(n in hist for n in names):
        return None
    held = sum(delta(run, f"{n}.total") for n in names)
    return 100.0 * held / (run["seconds"] * 1e6)
