"""Device milliseconds a frame in NCCL's kernels on the slowest rank (the
one with most device time outside NCCL). A collective's kernel runs
from its launch until every peer has joined, so it counts their
lateness too."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["nccl_s"] for x in s):
        return None
    slow = max(s, key=lambda x: x["device_s"] - x["nccl_s"])
    return 1e3 * slow["nccl_s"] / slow["units"]
