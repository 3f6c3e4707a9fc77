"""Messages acked inside the window, over the window's seconds: every
request of every producer, taken from the client's side (each ack is
stamped when its answer lands). The comparison later reads every one of
them back."""


def read(run):
    a = run["acks"]
    inside = (a[:, 7] >= run["ws"]) & (a[:, 7] < run["we"])
    return float(a[inside, 4].sum()) / run["seconds"]
