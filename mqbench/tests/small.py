"""A cell cut to CPU size for the tests: the same code paths, 8
partitions, small rings and batches, a short warm-up."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cell(cell: str) -> tuple[dict, dict]:
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs",
                           f"{cell.rsplit('.', 1)[0]}.json")) as f:
        config = json.load(f)
    wide = config["message_bytes"] > 200
    config["partitions"] = 8
    config["engine"].update(partitions=8, slots=512 if wide else 1024,
                            max_batch=32 if wide else 64, read_batch=64)
    prod = wl["producers"]
    if prod["loop"] == "closed":
        # A batch larger than max_batch spans rounds and may interleave
        # with another batch of its partition: keep one round a batch.
        prod.update(batch=min(prod["batch"], config["engine"]["max_batch"]),
                    in_flight=4)
    else:
        prod.update(rate_msgs_per_s=400, batch_max=32)
    wl["warm_s"] = 1.0
    return config, wl
