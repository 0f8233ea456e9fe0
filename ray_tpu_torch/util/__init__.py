"""Observability for the serving stack: metrics, trace spans, events."""
