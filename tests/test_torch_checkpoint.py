"""Port parity of checkpoints: relation_tpu/core/checkpoint.py (JAX, flax
msgpack) against relation_tpu_torch/core/checkpoint.py on the CPU. One file
format serves both packages: each writes, the other reads, and the
parameters, momentum trace and step come back equal; the port's own resume
is bit-exact.

- utils/msgpack.py against flax.serialization, byte for byte, on numpy
  and on torch leaves;
- JAX-written checkpoints and params files read by the port, and the
  port's read by JAX's ``load_params`` / ``restore_checkpoint``;
- the bbox-normalisation fold, the shape check and the reference (MXNet)
  name map against the JAX package's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

import relation_tpu.core.checkpoint as jck
import relation_tpu_torch.core.checkpoint as tck
from relation_tpu_torch.convert import from_jax_params, to_jax_params
from relation_tpu_torch.utils import msgpack
from tests.test_golden_e2e import family_cfg
from tests.test_golden_train import _fixed_batch
from tests.test_torch_helpers import flat_numpy, jax_tiny_family, n, port_model


def _jax_state(cfg, params, fixed_prefixes=None, seed=0):
    """A JAX TrainState over ``params`` without compiling the flax init."""
    from relation_tpu.core.trainer import (TrainState, make_optimizer,
                                           trainable_mask)
    mask = trainable_mask(params, tuple(cfg.network.FIXED_PARAMS
                                        if fixed_prefixes is None
                                        else fixed_prefixes))
    tx = make_optimizer(cfg, 1000, mask)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), rng=jax.random.PRNGKey(seed),
                      tx=tx)


@pytest.fixture(scope="module")
def family():
    """(cfg, JAX model, synth params) of the tiny flagship family."""
    cfg = family_cfg("plain_learn_nms")
    model, params = jax_tiny_family(cfg)
    return cfg, model, params


# --------------------------------------------------------------------------
# msgpack
# --------------------------------------------------------------------------

def _leaves_as(tree, leaves):
    """``tree`` with its float ndarray leaves as torch tensors when
    ``leaves`` is "torch" (the port writes its parameters so)."""
    if leaves == "numpy":
        return tree
    if isinstance(tree, dict):
        return {k: _leaves_as(v, leaves) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float32:
        return torch.from_numpy(tree.copy())
    return tree


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_msgpack_bytes_equal_flax_and_round_trip(family, leaves):
    """The encoder's bytes equal flax.serialization.msgpack_serialize's on
    a params tree with the other leaf kinds of a checkpoint (0-d int32,
    uint32 key, numpy scalar, empty maps, strings, ints of every width,
    floats, bool, nil, a list), its float leaves as ndarrays or as torch
    tensors; the decoder gives flax's tree back, from flax's bytes and from
    its own; bfloat16 travels as its bit pattern."""
    _, _, params = family
    tree = {"step": np.asarray(3, np.int32),
            "params": jax.tree.map(np.asarray, params),
            "opt_state": {"0": {}, "1": {"inner_state": {}}},
            "rng": np.asarray(jax.random.PRNGKey(7)),
            "__meta__": {"roi_method": "pool", "k" * 40: "v" * 300},
            "misc": {"ints": [0, 127, 128, -32, -33, 255, 256, -128, -129,
                              65535, 65536, -32768, -32769, 2 ** 32, -2 ** 40],
                     "f": 1.5, "b": True, "none": None, "scalar": np.float32(2.5),
                     "big": {str(i): i for i in range(20)},
                     "blob": b"\x00\x01" * 200}}
    want = serialization.msgpack_serialize(tree)
    assert msgpack.packb(_leaves_as(tree, leaves)) == want
    back = msgpack.unpackb(want)
    ref = serialization.msgpack_restore(want)
    flat_back, flat_ref = flatten_dict(back), flatten_dict(ref)
    assert set(flat_back) == set(flat_ref)
    for k, v in flat_ref.items():
        got = flat_back[k]
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype and np.array_equal(got, v), k
        else:
            assert type(got) is type(v) and got == v, k
    assert msgpack.packb(back) == want
    bf = torch.randn(3, 5).bfloat16()
    jbf = jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16)
    blob = serialization.msgpack_serialize({"w": jbf})
    assert msgpack.packb({"w": bf}) == blob
    got = msgpack.unpackb(blob)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf)


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_msgpack_chunked_arrays(monkeypatch, leaves):
    """With a small MAX_CHUNK_SIZE flax writes oversized leaves as chunked
    maps: the port decodes them to the whole array, and writes the same
    bytes, from ndarray or torch leaves, with its own limit patched
    alike."""
    rng = np.random.RandomState(0)
    tree = {"a": {"w": rng.randn(37, 11).astype(np.float32),
                  "small": np.arange(3, dtype=np.int64)},
            "top": rng.randn(50).astype(np.float64)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 96)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    back = msgpack.unpackb(blob)
    for path, v in flatten_dict(tree).items():
        got = back
        for p in path:
            got = got[p]
        assert got.dtype == v.dtype and np.array_equal(got, v), path
    assert msgpack.packb(_leaves_as(tree, leaves)) == blob


# --------------------------------------------------------------------------
# each package reads the other's files
# --------------------------------------------------------------------------

def test_jax_files_read_by_the_port(family, tmp_path):
    """A JAX TrainState with a non-zero trace at step 5, written by JAX's
    save_checkpoint and save_params (with __meta__): the port's
    restore_checkpoint gives the parameters of from_jax_params, the trace of
    every trainable leaf, the step and the count; the generator is reseeded
    from the file's key (its seed, 9). load_params reads both formats,
    read_checkpoint_meta the meta."""
    from relation_tpu_torch.core.trainer import create_train_state
    cfg, _, params = family
    state = _jax_state(cfg, params, seed=9)
    rng = np.random.RandomState(1)
    trace = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype),
                         params)
    opt = state.opt_state
    opt = (opt[0], opt[1], (opt[2][0]._replace(trace=trace),
                            opt[2][1]._replace(count=jnp.asarray(5, jnp.int32))),
           opt[3], opt[4])
    state = state.replace(step=jnp.asarray(5, jnp.int32), opt_state=opt)
    ckpt, pfile = str(tmp_path / "j.ckpt"), str(tmp_path / "j.params")
    jck.save_checkpoint(ckpt, state)
    jck.save_params(pfile, state.params, meta={"roi_method": "pool"})

    model = port_model(cfg, jax.tree.map(jnp.zeros_like, params))
    pstate = create_train_state(model, cfg, seed=3)
    tck.restore_checkpoint(ckpt, pstate)
    want = from_jax_params(flat_numpy(params), model)
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    want_trace = from_jax_params(flat_numpy(trace), model)
    assert pstate.trace and all(torch.equal(v, want_trace[k])
                                for k, v in pstate.trace.items())
    assert (pstate.step, pstate.count, pstate.seed) == (5, 5, 9)
    assert torch.equal(pstate.generator.get_state(),
                       torch.Generator().manual_seed(9).get_state())
    for path in (ckpt, pfile):
        sd = tck.load_params(path, model)
        assert all(torch.equal(sd[k], v) for k, v in want.items())
    assert tck.read_checkpoint_meta(pfile) == {"roi_method": "pool"}
    assert tck.read_checkpoint_meta(ckpt) == {}


def _port_steps(cfg, params, steps):
    """A port model, its state, its step function and the last step's
    metrics after ``steps`` CPU train steps on _fixed_batch, priorities from
    the seeded generator."""
    from relation_tpu_torch.core.trainer import create_train_state, make_train_step
    model = port_model(cfg, params)
    state = create_train_state(model, cfg, seed=4)
    step = make_train_step(model, cfg, device="cpu")
    m = None
    for _ in range(steps):
        state, m = step(state, _fixed_batch())
    return model, state, step, m


def test_port_files_read_by_jax(family, tmp_path):
    """Two port steps, saved by the port: JAX's restore_checkpoint (into a
    template state) and load_params (both files) give to_jax_params of the
    port's parameters and trace, the step and the count; the key is
    PRNGKey(seed). JAX's params_from_blob ignores the generator key."""
    cfg, _, params = family
    model, state, _, _ = _port_steps(cfg, params, 2)
    ckpt, pfile = str(tmp_path / "p.ckpt"), str(tmp_path / "p.params")
    tck.save_checkpoint(ckpt, state)
    tck.save_params(pfile, model, meta={"source": "port"})
    want = to_jax_params(model.state_dict())
    sd = model.state_dict()
    want_trace = to_jax_params({k: state.trace.get(k, torch.zeros_like(v))
                                for k, v in sd.items()})
    template = _jax_state(cfg, jax.tree.map(jnp.zeros_like, params))
    restored = jck.restore_checkpoint(ckpt, template)
    got = flat_numpy(restored.params)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    trace = flat_numpy(restored.opt_state[2][0].trace)
    assert all(np.array_equal(trace[k], want_trace[k]) for k in want)
    assert any(np.abs(v).max() > 0 for v in trace.values())
    assert int(restored.step) == 2 and int(restored.opt_state[2][1].count) == 2
    assert np.array_equal(np.asarray(restored.rng),
                          np.asarray(jax.random.PRNGKey(4)))
    for path in (ckpt, pfile):
        loaded = flat_numpy(jck.load_params(path, template.params))
        assert all(np.array_equal(loaded[k], want[k]) for k in want)
    assert jck.read_checkpoint_meta(pfile) == {"source": "port"}


def test_unrestorable_generator_state_warns_and_reseeds(family, tmp_path,
                                                        caplog):
    """A port checkpoint whose generator state the generator refuses (here
    truncated bytes) restores everything else, warns that the draws do not
    continue, and reseeds from the file's key; one with no generator state
    (as the JAX package writes) reseeds without a warning."""
    from relation_tpu_torch.core.trainer import create_train_state
    cfg, _, params = family
    model = port_model(cfg, params)
    ckpt = str(tmp_path / "g.ckpt")
    tck.save_checkpoint(ckpt, create_train_state(model, cfg, seed=6))
    with open(ckpt, "rb") as f:
        payload = msgpack.unpackb(f.read())
    reseeded = torch.Generator().manual_seed(6).get_state()
    for gen, warns in ((payload["torch_generator"][:-8], True), (None, False)):
        if gen is None:
            del payload["torch_generator"]
        else:
            payload["torch_generator"] = gen
        with open(ckpt, "wb") as f:
            f.write(msgpack.packb(payload))
        fresh = create_train_state(port_model(cfg, params), cfg, seed=3)
        caplog.clear()
        with caplog.at_level("WARNING", logger=tck.__name__):
            tck.restore_checkpoint(ckpt, fresh)
        assert fresh.seed == 6
        assert torch.equal(fresh.generator.get_state(), reseeded)
        assert any("not a continuation" in r.getMessage()
                   for r in caplog.records) == warns


def test_port_resume_is_bit_exact(family, tmp_path):
    """2 steps, save, restore into a freshly built model and state (another
    seed, zero weights), step 3: every parameter, trace, the step, the
    count, the seed and the metrics equal those of 3 uninterrupted steps."""
    from relation_tpu_torch.core.trainer import create_train_state, make_train_step
    cfg, _, params = family
    model, state, _, last = _port_steps(cfg, params, 3)
    _, s2, _, _ = _port_steps(cfg, params, 2)
    ckpt = str(tmp_path / "r.ckpt")
    tck.save_checkpoint(ckpt, s2)
    fresh = port_model(cfg, jax.tree.map(jnp.zeros_like, params))
    fs = create_train_state(fresh, cfg, seed=11)
    tck.restore_checkpoint(ckpt, fs)
    fs, again = make_train_step(fresh, cfg, device="cpu")(fs, _fixed_batch())
    assert (fs.step, fs.count, fs.seed) == (state.step, state.count, state.seed)
    a, b = model.state_dict(), fresh.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state.trace[k], fs.trace[k]) for k in state.trace)
    assert {k: float(v) for k, v in again.items()} == \
        {k: float(v) for k, v in last.items()}


# --------------------------------------------------------------------------
# fold, shapes, reference names
# --------------------------------------------------------------------------

def test_fold_matches_jax_and_decode_time_unnormalization():
    """fold_bbox_normalization on the port's [4K, in] weight equals JAX's on
    its [in, 4K] kernel through from_jax_params; folded weights with
    BBOX_NORMALIZATION_PRECOMPUTED off predict what the raw weights predict
    with it on (mirror of tests/test_checkpoint_handoff.py::
    test_fold_matches_decode_time_unnormalization)."""
    from relation_tpu_torch.core.predictor import make_predict_fn
    from tests.test_golden_e2e import _fixed_input
    cfg = family_cfg("plain")
    _, params = jax_tiny_family(cfg)
    means, stds = (0.01, -0.02, 0.05, 0.1), (0.1, 0.1, 0.2, 0.2)
    model = port_model(cfg, params)
    folded = tck.fold_bbox_normalization(model.state_dict(), means, stds)
    want = from_jax_params(flat_numpy(jck.fold_bbox_normalization(
        params, means, stds)), model)
    for k in ("bbox_pred.weight", "bbox_pred.bias"):
        torch.testing.assert_close(folded[k], want[k], rtol=0, atol=0)
    cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS = means, stds
    img, info = _fixed_input()
    ref = make_predict_fn(model, cfg)(img, info)
    raw_cfg = cfg.copy()
    raw_cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED = False
    model.load_state_dict(folded)
    got = make_predict_fn(model, raw_cfg)(img, info)
    assert (n(ref["dets"])[:, 0] >= 0).any()
    for k in ("pred_boxes", "dets"):
        np.testing.assert_allclose(n(got[k]), n(ref[k]), rtol=1e-5, atol=1e-4)


def test_check_parameter_shapes_raises(family):
    cfg, _, params = family
    model = port_model(cfg, params)
    sd = model.state_dict()
    tck.check_parameter_shapes(dict(sd), model)
    first = next(iter(sd))
    for bad, what in (({k: v for k, v in sd.items() if k != first}, "missing"),
                      (dict(sd, extra=torch.zeros(1)), "unexpected"),
                      (dict(sd, **{first: torch.zeros(1, 2, 3)}), "shape")):
        with pytest.raises(ValueError, match=what):
            tck.check_parameter_shapes(bad, model)


def _mxnet_shape(tag, shape):
    if tag == "grouped":
        g, f, e = shape
        return (g * e, f, 1, 1)
    return tuple(shape)


@pytest.mark.parametrize("name", ["plain_learn_nms", "dcn_learn_nms",
                                  "fpn_learn_nms"])
def test_reference_name_map_matches_jax(name):
    """Random arrays under every MXNet name, in MXNet's layouts: the port's
    transform equals the JAX package's converter
    (tools/convert_reference_params.py::convert, the transforms the JAX map's
    tags name) followed by from_jax_params, and every leaf of the model has
    a name. On the C4 family the tags equal the JAX map's; it tags by module
    prefix, so the FPN neck's and tiny pyramid's convs read 'dense' and the
    deformable res5's bare weight 'grouped' there."""
    from tools.convert_reference_params import convert
    cfg = family_cfg(name)
    _, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    sd = model.state_dict()
    names = tck.reference_name_map(model)
    assert sorted(k for k, _ in names.values()) == sorted(sd)
    rng = np.random.RandomState(3)
    raw = {mx: rng.randn(*_mxnet_shape(tag, sd[k].shape)).astype(np.float32)
           for mx, (k, tag) in names.items()}
    jparams, missing, unused = convert(raw, params)
    assert not missing and not unused
    want = from_jax_params(flatten_dict(jparams, sep="/"), model)
    for mx, (k, tag) in names.items():
        got = tck.reference_transform(tag, raw[mx], sd[k].shape)
        np.testing.assert_array_equal(got, n(want[k]), err_msg=f"{mx} {tag}")
    if name == "plain_learn_nms":
        jtags = {mx: tag for mx, (_, tag) in jck.reference_name_map(params).items()}
        assert jtags == {mx: tag for mx, (_, tag) in names.items()}
