"""Window mean of `rpc.queue_us`: a request's wait in the controller's RPC
pool, from its connection reading the frame to a pool thread taking
it."""

from mqbench.readers import window_mean


def read(run):
    v = window_mean(run, "rpc.queue_us")
    return None if v is None else v / 1e3
