"""Device milliseconds a frame in every kernel but the trace kernel and
NCCL's: the integrator's PyTorch ops, the BSDFs, the lights and the
random streams, on the rank that spent most."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["device_s"] for x in s):
        return None
    return max(1e3 * (x["device_s"] - x["trace_s"] - x["nccl_s"])
               / x["units"] for x in s)
