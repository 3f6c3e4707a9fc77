"""Window mean of `engine.device_us`: the device's span of a timed
dispatch (one in 8), from a CUDA timing event recorded on the stream
before the step to the committed fetch's event after it. Not timed on
the CPU."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.device_us")
    return None if v is None else v / 1e3
