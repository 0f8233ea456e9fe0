"""The runtime's internals and the port's benchmarks; not part of its API."""
