"""Messages a dispatch carries: the window's difference of
`produce.messages` over that of `engine.dispatch_us`'s count."""

from mqbench.readers import ratio


def read(run):
    return ratio(run, "produce.messages", "engine.dispatch_us.count")
