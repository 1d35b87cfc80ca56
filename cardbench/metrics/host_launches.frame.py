"""Host launch calls a frame: kernel launches, memsets, copies and CUDA
graph launches of the host (the pass loop and the compiled pass), on the
rank that made most."""


def read(t):
    s = t["summaries"]
    if not s or not any(x["host_launches"] for x in s):
        return None
    return max(x["host_launches"] / x["units"] for x in s)
