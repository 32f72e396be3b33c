"""Port parity: the full-depth ResNet-101 C4 trunk + dilated C5 of
relation_tpu_torch against relation_tpu, f32, on a 64x64 image, in both
input layouts (s2d planar and NHWC)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import flat_numpy, n, t
from relation_tpu.models.backbone import (ResNet101C4 as JC4,
                                          ResNet101C5 as JC5,
                                          image_to_s2d_planar as j_s2d)
from relation_tpu_torch.convert import from_jax_params
from relation_tpu_torch.models.backbone import (ResNet101C4, ResNet101C5,
                                                conv1_w4, image_to_s2d_planar)


def _bn_jitter(params, rng):
    """Non-trivial frozen-BN statistics (identity BN would hide a fold bug)."""
    flat = flat_numpy(params)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "moving_var":
            flat[k] = (v * rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        elif leaf in ("moving_mean", "beta"):
            flat[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif leaf == "gamma":
            flat[k] = (v * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
    return flat


def _check(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("layout", ["s2d", "nhwc"])
def test_resnet101_c4_c5_full_depth_matches_jax(layout):
    rng = np.random.RandomState(3)
    img = (rng.randn(64, 64, 3) * 40).astype(np.float32)
    x = (np.asarray(j_s2d(img))[None] if layout == "s2d" else img[None])
    jc4, jc5 = JC4(dtype=jnp.float32), JC5(dtype=jnp.float32)
    p4 = jc4.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    c4_j = jc4.apply({"params": p4}, jnp.asarray(x))
    p5 = jc5.init(jax.random.PRNGKey(1), c4_j)["params"]
    flat4, flat5 = _bn_jitter(p4, rng), _bn_jitter(p5, rng)
    c4_j = jc4.apply({"params": _unflat(flat4)}, jnp.asarray(x))
    c5_j = jc5.apply({"params": _unflat(flat5)}, c4_j)

    tc4, tc5 = ResNet101C4(dtype=torch.float32), ResNet101C5()
    tc4.load_state_dict(from_jax_params(flat4, tc4))
    tc5.load_state_dict(from_jax_params(flat5, tc5))
    with torch.inference_mode():
        c4_t = tc4(t(x))
        c5_t = tc5(c4_t)
    _check(n(c4_t.permute(0, 2, 3, 1)), c4_j)
    _check(n(c5_t.permute(0, 2, 3, 1)), c5_j)


def _unflat(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def test_conv1_w4_and_s2d_match_jax(rng):
    from relation_tpu.models.backbone import conv1_w4 as j_w4
    w7 = rng.randn(7, 7, 3, 64).astype(np.float32)
    np.testing.assert_array_equal(
        n(conv1_w4(t(w7.transpose(3, 2, 0, 1)))), np.asarray(j_w4(jnp.asarray(w7))))
    img = rng.randn(8, 12, 3).astype(np.float32)
    np.testing.assert_array_equal(n(image_to_s2d_planar(t(img))),
                                  np.asarray(j_s2d(img)))
    np.testing.assert_array_equal(image_to_s2d_planar(img), np.asarray(j_s2d(img)))
