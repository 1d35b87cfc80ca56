"""Lanes over processes: `sharding` (the lane mesh, blocks, padding and
lane-windowed draws) and `distributed` (the process group and the
collectives); `worker` is a rank of the multi-process check and of
`tools/scaling_bench.py`."""
