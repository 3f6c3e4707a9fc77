"""The controller's warm-up of its active-set buckets (`DataPlane.warm`):
the total of `engine.warm_us` at the window's start, in seconds. Part of
`setup_s`."""


def read(run):
    h = run["registry"]["window"][0]["hist"].get("engine.warm_us")
    return None if h is None or h[0] <= 0 else h[1] / 1e6
