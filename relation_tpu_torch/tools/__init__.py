"""Measurement scripts of relation_tpu_torch (run on a CUDA card)."""
