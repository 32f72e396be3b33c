"""Knobs of the JAX package that the port accepts and does not act on, because
they are TPU workarounds (ROADMAP "Standing differences").

TPU.GEOM_EMB_DTYPE="bfloat16" casts the materialised [C, 64, N, N] sinusoid
of JAX's XLA learned-NMS path to bf16 to halve an HBM round trip
(relation_tpu/config/defaults.py:180-189, ops/pallas/geom_bias.py:127-152);
the port's kernels never materialise it and compute in f32. Here the port's
plain version is held to JAX's f32 form at the geometric-bias band, and its
post-softmax attention to JAX's bf16 form within JAX's own bf16-vs-f32 band
(tests/test_models.py::test_geom_bias_bf16_emb_attention_bound).
"""

import jax
import jax.numpy as jnp
import numpy as np

from relation_tpu.ops.pallas.geom_bias import geom_bias_reference as jax_bias
from relation_tpu_torch.ops.kernels.geom_bias import geom_bias_reference
from tests.test_torch_helpers import n, t

ATTN_BAND = 0.05      # post-softmax, JAX's own bf16-vs-f32 bound


def test_geom_emb_dtype_bf16_stays_within_jax_own_band():
    rng = np.random.RandomState(0)
    pos = rng.uniform(-4, 4, (4, 4, 32, 32)).astype(np.float32)
    w = (rng.randn(64, 16) * 0.01).astype(np.float32)
    b = np.zeros(16, np.float32)
    args = (jnp.asarray(pos), jnp.asarray(w), jnp.asarray(b))
    b32 = np.asarray(jax_bias(*args))
    b16 = np.asarray(jax_bias(*args, emb_dtype=jnp.bfloat16))
    got = n(geom_bias_reference(t(pos), t(w), t(b)))
    # the port is JAX's f32 form: the band of the geometric-bias parity tests
    np.testing.assert_allclose(np.exp(got), np.exp(b32), rtol=1e-4, atol=1e-4)
    clear = np.exp(b32) > 0.05
    np.testing.assert_allclose(got[clear], b32[clear], rtol=1e-4, atol=1e-4)
    # and its attention stays within JAX's own bf16 band of JAX's bf16 form
    aff = rng.randn(4, 16, 32, 32).astype(np.float32)
    a_port = np.asarray(jax.nn.softmax(aff + got, axis=-1))
    a16 = np.asarray(jax.nn.softmax(aff + b16, axis=-1))
    a32 = np.asarray(jax.nn.softmax(aff + b32, axis=-1))
    assert np.abs(a32 - a16).max() < ATTN_BAND
    assert np.abs(a_port - a16).max() < ATTN_BAND
