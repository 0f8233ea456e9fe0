"""Serving: paged KV cache, cache-aware forwards, continuous-batching
engine, the store-backed KV tier, the OpenAI server, prefill/decode
disaggregation and batch inference."""
