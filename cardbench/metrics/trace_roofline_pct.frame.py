"""The trace kernel's share of its roofline in a frame: the least time of
the frame's trace work (`roofline.trace_work`, from the reference's
answers for the checked frames' sampled lanes) at the card's float32
peak or memory bandwidth, whichever bounds it, over the kernel's device
time a frame."""
from cardbench import roofline


def read(t):
    s, work, card = t["summaries"], t["work"], t["card"]
    if not s or work is None or not card.get("peak_flops"):
        return None
    per_frame = max(x["trace_s"] / x["units"] for x in s)
    if per_frame <= 0:
        return None
    return 100.0 * roofline.bound_seconds(work, card["peak_flops"]) / per_frame
