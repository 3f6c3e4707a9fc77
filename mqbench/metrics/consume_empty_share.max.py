"""The share of the controller's consume answers that carried no message
(a reader at its partition's end): the window's difference of
`consume.empty` over that of `consume.ack_us`' count."""

from mqbench.readers import delta


def read(run):
    if "consume.empty" not in run["registry"]["window"][1]["counters"]:
        return None
    n = delta(run, "consume.ack_us.count")
    if n <= 0:
        return None
    return 100.0 * delta(run, "consume.empty") / n
