"""Recipes of the port: runnable training entry points
(``python -m skypilot_tpu_torch.recipes.<name>``), counterparts of
``skypilot_tpu/recipes``. They train on synthetic data generated from a
seed (``synthetic_data``), so nothing is downloaded, and run on the card
unless given ``--device cpu``.
"""
