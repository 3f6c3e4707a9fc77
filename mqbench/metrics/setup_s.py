"""Process start to the window's first timed request: the cluster's
boot, elections, the controller's warm-up, and the cell's warm
traffic."""


def read(run):
    return run["setup_s"]
