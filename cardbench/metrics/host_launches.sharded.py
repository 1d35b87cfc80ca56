"""`host_launches.frame` read in the lane-sharded frame cells, where it moves
`sharded_samples_per_s`."""
from cardbench import harness

read = harness.load_module("metrics", "host_launches.frame").read
