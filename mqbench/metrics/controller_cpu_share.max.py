"""CPU seconds of the controller's process (the in-process broker and
everything it runs: dispatch, settle, replication sender, RPC pool)
over the window's seconds, from /proc/<pid>/stat: cores kept busy."""


def read(run):
    return run["cpu"]["controller_window_s"] / run["seconds"]
