"""Device time of one engine round in the controller's process: the
union of its device operation intervals over the traced slice, over the
rounds the engine ran in that slice (`engine.chain_rounds`' total)."""

from mqbench.readers import delta


def read(run):
    tr = run.get("trace")
    rounds = delta(run, "engine.chain_rounds.total", span="trace")
    if not tr or tr["busy_s"] <= 0 or rounds <= 0:
        return None
    return tr["busy_s"] * 1e3 / rounds
