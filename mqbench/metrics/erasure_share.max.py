"""The share of the window the controller's segment store spent on its
erasure passes (`store.protect_us`, observed as each pass ends, so a
pass is counted in the window it ends in), over the window's
microseconds."""

from mqbench.readers import delta


def read(run):
    if "store.protect_us" not in run["registry"]["window"][1]["hist"]:
        return None
    return 100.0 * delta(run, "store.protect_us.total") / (
        run["seconds"] * 1e6)
