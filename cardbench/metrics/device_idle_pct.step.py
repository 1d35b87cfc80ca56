"""The share of the traced window of gradient steps in which the device
ran nothing."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["busy_s"] for x in s):
        return None
    slow = max(s, key=lambda x: x["busy_compute_s"])
    return 100.0 * (1.0 - slow["busy_compute_s"] / slow["window_s"])
