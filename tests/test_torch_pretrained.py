"""nkbx's weight files in the port, on the CPU.

- The msgpack reader against ``flax.serialization.msgpack_restore`` on the
  same bytes: float32, bfloat16 (widened to float32, exactly) and integer
  leaves, numpy scalars, empty dicts and arrays, Python scalars (complex
  too), strings and lists of every msgpack length class, and arrays that
  flax writes as ``__msgpack_chunked_array__`` dicts; a truncated file
  raises.
- The pretrained rule: with ``$NKBX_PRETRAINED_DIR`` holding a file written
  by ``nkbx.models.convert.save_params_msgpack``, ``get_model`` with
  ``pretrained: True`` gives the backbone nkbx's ``get_model`` loads (its
  logits equal, f32, 1e-5, with nkbx's head copied over) and keeps its own
  fresh head; with no file it warns, says that it downloads nothing, and
  keeps the random weights; a file that does not fit raises, a shape
  mismatch naming ROADMAP A7.
- ``checkpoint``: a nkbx ``.msgpack`` (``save_model_msgpack``) gives nkbx's
  logits (1e-5); the port's checkpoint directory loads; an orbax directory
  raises.
"""

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from nkbx.models import get_model as jget_model
from nkbx.models.convert import save_params_msgpack
from nkbx.train.checkpoint import save_model_msgpack
from nkbx_torch.models import get_model
from nkbx_torch.models.pretrained import default_filename, read_msgpack

CLASSES = ["a", "b", "c"]
SIZE = 32
CFG = {"task": "single", "model": "resnet_tiny_test"}


def _leaves_equal(got, want, where="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _leaves_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _leaves_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert np.asarray(got).dtype == np.float32, where
            w = w.astype(np.float32)
        else:
            assert np.asarray(got).dtype == w.dtype, where
        assert np.asarray(got).shape == w.shape, where
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "f32": rng.normal(size=(2, 3)).astype(np.float32),
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(4, 5)), jnp.bfloat16)),
            "i32": np.array([1, -2, 3], np.int32), "i64": np.array([2 ** 40, -7], np.int64),
            "u8": np.arange(300, dtype=np.uint16).astype(np.uint8),
            "f64": rng.normal(size=(3,)), "bool": np.array([True, False]),
            "big": rng.normal(size=(70_000,)).astype(np.float32),  # ext 32
            "scalar": np.float32(3.5), "iscalar": np.int64(-9),
            "empty_array": np.zeros((0, 4), np.float32), "empty": {},
            "nested": {"deep": {"x": np.ones((1, 1, 1, 2), np.float32)}, "also_empty": {}},
            **{f"k{i:02d}": np.float32(i) for i in range(20)},  # a map of more than 15
        },
        "batch_stats": {},
        "meta": {"epoch": 3, "acc": 0.5, "flag": True, "off": False, "none": None,
                 "name": "a name longer than thirty-one characters, résumé",
                 "huge": -2 ** 40, "neg": -5, "complex": 1.5 - 2j, "u16": 60_000,
                 "u32": 2 ** 31,
                 "list": [1, 2.5, "x", None] + list(range(20)), "blob": b"\x00\x01" * 200},
    }


def test_reader_matches_flax_msgpack_restore(tmp_path):
    data = flax.serialization.msgpack_serialize(_tree())
    (tmp_path / "t.msgpack").write_bytes(data)
    _leaves_equal(read_msgpack(tmp_path / "t.msgpack"), flax.serialization.msgpack_restore(data))


def test_reader_reassembles_chunked_arrays(tmp_path, monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into a
    ``__msgpack_chunked_array__`` dict of flat chunks."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"w": np.arange(3 * 7 * 5, dtype=np.float32).reshape(3, 7, 5),
                       "b": np.arange(10, dtype=np.float64)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    (tmp_path / "c.msgpack").write_bytes(data)
    got = read_msgpack(tmp_path / "c.msgpack")
    _leaves_equal(got, flax.serialization.msgpack_restore(data))
    _leaves_equal(got, tree)


def test_reader_refuses_a_truncated_file(tmp_path):
    data = flax.serialization.msgpack_serialize(_tree())
    (tmp_path / "cut.msgpack").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="not a readable flax msgpack"):
        read_msgpack(tmp_path / "cut.msgpack")


def _x():
    return np.random.default_rng(3).normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)


def _port_logits(model, head_from=None):
    module = model.module
    if head_from is not None:
        head = head_from["params"]["head"]
        module.head.weight.data = torch.from_numpy(np.asarray(head["kernel"]).T.copy())
        module.head.bias.data = torch.from_numpy(np.asarray(head["bias"]).copy())
    return model(torch.from_numpy(_x())).numpy()


def _converted_file(tmp_path, name="resnet_tiny_test"):
    """A converted backbone file as nkbx's converter writes it: the backbone
    subtree of a model initialised from another seed."""
    donor = jget_model(CFG, CLASSES, input_size=(SIZE, SIZE), seed=5, dtype=jnp.float32)
    tree = {"params": jax.device_get(donor.variables["params"]["backbone"]),
            "batch_stats": jax.device_get(donor.variables["batch_stats"]["backbone"])}
    save_params_msgpack(tree, tmp_path / default_filename(name))
    return tree


def test_pretrained_file_gives_nkbx_logits(tmp_path, monkeypatch):
    tree = _converted_file(tmp_path)
    monkeypatch.setenv("NKBX_PRETRAINED_DIR", str(tmp_path))
    cfg = {**CFG, "pretrained": True}
    jmodel = jget_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=jnp.float32)
    want = np.asarray(jmodel(jnp.asarray(_x())))
    model = get_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    fresh = get_model(CFG, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    assert torch.equal(model.module.head.weight, fresh.module.head.weight)  # the head's own init
    sd = model.module.backbone.state_dict()
    np.testing.assert_array_equal(sd["ConvBN_0.BatchNorm_0.running_var"].numpy(),
                                  tree["batch_stats"]["ConvBN_0"]["BatchNorm_0"]["var"])
    np.testing.assert_allclose(_port_logits(model, jmodel.variables), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("env", ["unset", "empty-dir"])
def test_absent_pretrained_file_warns_and_keeps_random_weights(tmp_path, monkeypatch, env):
    if env == "unset":
        monkeypatch.delenv("NKBX_PRETRAINED_DIR", raising=False)
    else:
        monkeypatch.setenv("NKBX_PRETRAINED_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="no converted checkpoint .* downloads nothing"):
        model = get_model({**CFG, "pretrained": True}, CLASSES, input_size=(SIZE, SIZE),
                          dtype=torch.float32, device="cpu")
    fresh = get_model(CFG, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    want = fresh.module.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.module.state_dict().items())


def test_pretrained_file_that_does_not_fit_raises(tmp_path, monkeypatch):
    tree = _converted_file(tmp_path)
    monkeypatch.setenv("NKBX_PRETRAINED_DIR", str(tmp_path))
    cfg = {**CFG, "pretrained": True}
    kernel = tree["params"]["ConvBN_0"]["Conv_0"]["kernel"]
    tree["params"]["ConvBN_0"]["Conv_0"]["kernel"] = np.zeros(kernel.shape[:-1] + (8,),
                                                              np.float32)
    save_params_msgpack(tree, tmp_path / default_filename("resnet_tiny_test"))
    with pytest.raises(ValueError, match="shape mismatch .*A7"):
        get_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    del tree["batch_stats"]["ConvBN_0"]
    tree["params"]["ConvBN_0"]["Conv_0"]["kernel"] = kernel
    save_params_msgpack(tree, tmp_path / default_filename("resnet_tiny_test"))
    with pytest.raises(ValueError, match="does not fit the model"):
        get_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    (tmp_path / default_filename("resnet_tiny_test")).write_bytes(b"\xc1 not msgpack")
    with pytest.raises(ValueError, match="not a readable flax msgpack"):
        get_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")


def test_msgpack_checkpoint_gives_nkbx_logits(tmp_path):
    donor = jget_model(CFG, CLASSES, input_size=(SIZE, SIZE), seed=7, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32),
        jax.device_get(donor.variables))
    path = tmp_path / "best.msgpack"
    save_model_msgpack(path, variables)
    cfg = {**CFG, "checkpoint": str(path)}
    want = np.asarray(jget_model(cfg, CLASSES, input_size=(SIZE, SIZE),
                                 dtype=jnp.float32)(jnp.asarray(_x())))
    model = get_model(cfg, CLASSES, input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(_port_logits(model), want, atol=1e-5, rtol=0)


def test_port_checkpoint_directory_loads_and_orbax_raises(tmp_path):
    from nkbx_torch.train import TrainState
    from nkbx_torch.train.checkpoint import save_checkpoint, save_weights

    model = get_model(CFG, CLASSES, input_size=(SIZE, SIZE), seed=3, dtype=torch.float32,
                      device="cpu")
    save_checkpoint(tmp_path / "best", TrainState.create(model), epoch=0)
    save_weights(tmp_path / "best.pt", model.module)
    want = model(torch.from_numpy(_x()))
    for ckpt in ("best", "best.pt"):
        got = get_model({**CFG, "checkpoint": str(tmp_path / ckpt)}, CLASSES,
                        input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
        assert torch.equal(got(torch.from_numpy(_x())), want)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        get_model({**CFG, "checkpoint": str(tmp_path / "orbax")}, CLASSES,
                  input_size=(SIZE, SIZE), dtype=torch.float32, device="cpu")
