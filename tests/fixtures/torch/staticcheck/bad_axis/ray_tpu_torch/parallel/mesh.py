"""Fixture mesh: two axes only."""

AXIS_ORDER = ("dp", "tp")
