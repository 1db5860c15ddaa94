"""The benchmark's own code: the import guard, the spec files found by
name, the device checks, statistics, the roofline arithmetic, the
profiler's reading and the seeded weights. Nothing here imports the
program (`nnop_tpu_torch`); the drivers under `port_bench/drivers/` do."""
