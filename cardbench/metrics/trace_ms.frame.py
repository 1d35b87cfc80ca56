"""Device milliseconds a frame in the trace kernel (`trace_kernel` in the
kernel's name), on the rank that spent most."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["trace_s"] for x in s):
        return None
    return max(1e3 * x["trace_s"] / x["units"] for x in s)
