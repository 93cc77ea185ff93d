"""The benchmark of x264vfw_tpu_torch: one cell of BENCHMARK.json per run
of portbench/run.py.  Everything that belongs to one configuration,
traffic mix, per-layer metric or kernel sits in a file of its own under
configs/, traffic/, metrics/ or rooflines/, found by its name."""
