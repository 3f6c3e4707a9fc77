"""Window mean of `engine.drain_us`: a drain of the DataPlane step thread
that found work, building one dispatch's rounds from the queues."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.drain_us")
    return None if v is None else v / 1e3
