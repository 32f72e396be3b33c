"""Subpackage of relation_tpu_torch (kernels: counterparts of relation_tpu/ops/pallas)."""
