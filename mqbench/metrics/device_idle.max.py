"""1 - the union of the controller's device operation intervals over
the traced slice of the window, in percent (torch.profiler)."""

from mqbench.readers import idle_pct


def read(run):
    return idle_pct(run)
