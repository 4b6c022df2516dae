"""The benchmark's general code.  It knows no cell, configuration, traffic
mix or metric by name: each of those is a file under the benchmark's own
folders, found by the name ``BENCHMARK.json`` gives it."""
