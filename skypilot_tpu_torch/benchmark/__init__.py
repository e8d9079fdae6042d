"""Serving measurements of the port (``decode_bench``): the counterpart of
the JAX package's ``benchmark/decode_bench.py``, for the port's models and
DecodeEngine on one card."""
