"""The controller's own handling of a produce, apart from its wait on its
rounds: the window's difference of `produce.ack_us`' total less that of
`produce.round_wait_us`, over that of `produce.ack_us`' count."""

from mqbench.readers import delta


def read(run):
    if "produce.round_wait_us" not in run["registry"]["window"][1]["hist"]:
        return None
    n = delta(run, "produce.ack_us.count")
    if n <= 0:
        return None
    t = (delta(run, "produce.ack_us.total")
         - delta(run, "produce.round_wait_us.total"))
    return t / n / 1e3
