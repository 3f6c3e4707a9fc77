"""Window mean of `engine.stage_us`: a dispatch's staging, each input leaf
copied to the device (through pinned memory on CUDA), before the step
thread asks for the device lock. The first of the three parts of
`engine.dispatch_us`."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "engine.stage_us")
    return None if v is None else v / 1e3
