"""Benchmarks of the port that are not part of its API."""
