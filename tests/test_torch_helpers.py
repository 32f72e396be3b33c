"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the same
parameters and inputs through relation_tpu (JAX, CPU) and relation_tpu_torch
(PyTorch, CPU). Holds no tests itself."""

import numpy as np
import torch

torch.set_num_threads(1)
# f32 comparisons: no TF32 anywhere (a no-op on the CPU, stated for the card)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def jax_tiny_family(cfg):
    """(JAX tiny model, synth params) exactly as tests/test_golden_e2e.py
    builds them for the golden fixtures."""
    import jax
    import jax.numpy as jnp
    from relation_tpu.core.trainer import build_model
    from tests.test_golden_e2e import _fixed_input, synth_params

    model = build_model(cfg, tiny=True)
    img, im_info = _fixed_input()
    n0 = max(int(cfg.TEST.FIRST_N) + 1, 8)
    rois0 = jnp.tile(jnp.asarray([[0.0, 0.0, 32.0, 32.0]]), (n0, 1))
    shapes = jax.eval_shape(
        lambda k, i, r, m: model.init(k, i, r, m, n0),
        jax.random.PRNGKey(42), jnp.asarray(img), rois0,
        jnp.asarray(im_info))["params"]
    return model, synth_params(shapes)


def flat_numpy(params):
    """flax param tree -> {'a/b/leaf': numpy array}."""
    from flax.traverse_util import flatten_dict
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def port_model(cfg, params, tiny=True):
    """The port's model on the CPU with the JAX params carried across."""
    from relation_tpu_torch.convert import from_jax_params
    from relation_tpu_torch.core.trainer import build_model
    model = build_model(cfg, tiny=tiny, device="cpu")
    model.load_state_dict(from_jax_params(flat_numpy(params), model))
    return model


def t(x):
    """numpy/JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x):
    """torch tensor -> numpy (f32 for floats)."""
    x = x.detach()
    return (x.float() if x.is_floating_point() else x).numpy()
