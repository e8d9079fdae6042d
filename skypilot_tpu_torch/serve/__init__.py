"""Serving: the continuous-batching decode engine and its KV block pool."""
