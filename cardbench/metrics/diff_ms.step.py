"""Device milliseconds a gradient step outside the trace kernel: the
differentiable replay, the integrator's ops, `autograd.grad` and the SGD
update."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["device_s"] for x in s):
        return None
    return max(1e3 * (x["device_s"] - x["trace_s"]) / x["units"] for x in s)
