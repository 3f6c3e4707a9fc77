"""Window mean of `engine.launch_us`: from the device lock held to the
dispatch launched (the engine's step call and the committed fetch
queued behind it). The third part of `engine.dispatch_us`."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.launch_us")
    return None if v is None else v / 1e3
