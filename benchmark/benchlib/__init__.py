"""The benchmark's own library: the cells, traffic and configurations
named in BENCHMARK.json, the traffic generator, the closed loop, the
tracing, the work counts and the comparison with the plain reference."""
