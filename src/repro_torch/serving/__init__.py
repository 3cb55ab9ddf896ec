"""Paged KV cache and the continuous-batching serving engine."""
