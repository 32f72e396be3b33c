"""Subpackage of relation_tpu_torch (mirrors relation_tpu/config)."""
