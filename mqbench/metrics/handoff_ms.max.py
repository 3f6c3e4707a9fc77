"""Window mean of `engine.handoff_us`: a launched dispatch handed to the
resolvers, through the in-flight queue's backpressure
(`pipeline_depth` dispatches outstanding at most)."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.handoff_us")
    return None if v is None else v / 1e3
