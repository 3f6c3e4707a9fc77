"""Window mean of `engine.dispatch_us`: the DataPlane step thread's host
time to stage and launch one dispatch."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.dispatch_us")
    return None if v is None else v / 1e3
