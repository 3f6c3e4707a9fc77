"""Window mean of `engine.lock_wait_us`: a dispatch's wait for the
DataPlane's device lock, which the read coalescer, the state fetches
and the warm-up also hold. The second part of `engine.dispatch_us`."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.lock_wait_us")
    return None if v is None else v / 1e3
