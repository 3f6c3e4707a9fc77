"""A request's decode and reply in the controller's RPC transport: the
window's difference of the totals of `rpc.decode_us` (the raw hook and
the frame's decode) and `rpc.reply_us` (the encode, the wait for the
connection's write lock and the write), over that of
`rpc.decode_us`' count."""

from mqbench.readers import delta


def read(run):
    if "rpc.reply_us" not in run["registry"]["window"][1]["hist"]:
        return None
    n = delta(run, "rpc.decode_us.count")
    if n <= 0:
        return None
    t = delta(run, "rpc.decode_us.total") + delta(run, "rpc.reply_us.total")
    return t / n / 1e3
