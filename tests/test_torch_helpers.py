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


NMS_EDGE_CASES = ("mid_block_stop", "exact_ties", "degenerate",
                  "invalid_class", "staggered_stops")


def nms_edge_case(kind, C, Np, n, seed):
    """(boxesT [C, 4, Np] f32, valid [C, Np] f32, thresh) of one case that a
    chunk-by-chunk NMS kernel can get wrong, n real boxes a class, each a
    jittered copy of one of K objects (fewer objects: more suppression):
    - mid_block_stop: K = n, nearly every box kept, so a max_keep smaller
      than n is reached inside a block, which must still be finished;
    - exact_ties: integer corners, every third box the previous box with its
      +1 height doubled (IoU exactly 0.5 against it, at thresh 0.5);
    - degenerate: a third of the boxes with x2 < x1 or y2 < y1;
    - invalid_class: class 0 all invalid beside full classes;
    - staggered_stops: K = n / 4^(3 - c % 4) in class c, from crowded to
      sparse, so that a max_keep is reached in different chunks (or never)."""
    from relation_tpu_torch.tools.ablate_nms import jittered_objects
    rng = np.random.RandomState(seed)
    thresh = 0.5 if kind == "exact_ties" else 0.7
    bT = np.zeros((C, 4, Np), np.float32)
    valid = np.zeros((C, Np), np.float32)
    for c in range(C):
        K = {"mid_block_stop": n,
             "staggered_stops": max(2, n // 4 ** (3 - c % 4))}.get(kind, n // 8)
        b = jittered_objects(rng, n, K, small=kind == "mid_block_stop")
        if kind == "exact_ties":
            b = np.round(b)
            for i in range(2, n, 3):
                b[i] = b[i - 1]
                b[i, 3] = b[i, 1] + 2 * (b[i - 1, 3] - b[i - 1, 1] + 1) - 1
        if kind == "degenerate":
            for i in np.nonzero(rng.uniform(0, 1, n) < 1 / 3)[0]:
                a = rng.randint(0, 2)
                b[i, a], b[i, a + 2] = b[i, a + 2], b[i, a] - rng.uniform(0, 3)
        bT[c, :, :n] = b.T
        valid[c, :n] = rng.uniform(0, 1, n) > 0.05
    if kind == "invalid_class":
        valid[0] = 0.0
    return bT, valid, thresh
