"""Serving: paged KV cache, cache-aware forwards, continuous-batching engine."""
