"""One driver per kind of cell (workloads/<cell>.json names it). A driver
runs the program under one traffic mix and returns what the harness
reports: its end-to-end numbers, its checks, and what the per-layer
readers read."""
