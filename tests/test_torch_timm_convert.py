"""The port's timm-layout converter, its msgpack writer and the pos_embed
resample on load, against nkbx's, on the CPU.

- Every registry name whose timm-layout replica (``nkbx/models/torch_ref.py``
  ``build_replica``) holds at most 100M values, at full size, and narrow
  replicas of the families' larger names (ConvNeXt, Swin, EfficientNetV2,
  ViT, unicom), seeded random values in every tensor: the port's
  ``convert_torch_state_dict`` (or the family's converter) builds nkbx's
  tree leaf for leaf, exactly, in nkbx's map order, and the full-size
  trees map through ``from_jax_variables``'s rule onto the port's backbone
  at the name's input size.
  Also Swin's pre-0.9 layout and ConvNeXt's old ``norm``. The name tables
  equal nkbx's and every name of ``list_backbones()`` dispatches.
- ``convert_reference_checkpoint``, single- and multi-task, equals nkbx's.
- The msgpack writer: its bytes are ``flax.serialization.to_bytes``'s
  (chunked arrays too), flax's ``msgpack_restore`` and the port's reader
  read them back, and nkbx's ``load_pretrained_into`` takes a converted
  file.
- The CLI in a subprocess on a replica's ``.pth`` (wrapped, ``module.``
  prefixed) writes the bytes nkbx's converter writes; its refusals.
- ``resample_pos_embed`` equals nkbx's at 197 -> 577 and 196 -> 256; a
  224-grid ViT file loaded into a 384 model through ``pretrained=True``
  gives nkbx's ``pos_embed`` exactly and nkbx's logits (f32, 5e-4).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.serialization
from nkbx.models import convert as jconvert
from nkbx.models import get_model as jget_model
from nkbx.models.registry import list_backbones as jlist_backbones
from nkbx.models.torch_ref import (TimmConvNeXt, TimmEfficientNetV2, TimmSwin, TimmViT,
                                   UnicomViTReplica, build_replica)
from nkbx_torch.models import convert as tconvert
from nkbx_torch.models import create_backbone, get_model, list_backbones
from nkbx_torch.models import pretrained as tpretrained
from nkbx_torch.models.pretrained import default_filename, read_msgpack, write_msgpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_LIMIT = 100_000_000  # values of a replica converted at full size


def _assert_same_tree(got, want, where="root", ordered=True):
    """Same maps (in the same order where ``ordered``), leaves equal in
    dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        assert (list(got) == list(want)) if ordered else (sorted(got) == sorted(want)), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}", ordered)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where


@functools.lru_cache(maxsize=None)
def _pool():
    return np.random.default_rng(0).standard_normal(1 << 24, dtype=np.float32)


def _random_sd(module, seed=0):
    """A numpy state dict of ``module``'s names and shapes: each floating
    tensor a window of one pool of seeded normal values, at an offset of its
    own (views, so a full-size net costs no copies); integer buffers zero."""
    pool, out = _pool(), {}
    rng = np.random.default_rng(seed)
    for k, v in module.state_dict().items():
        n = v.numel()
        if not v.dtype.is_floating_point:
            out[k] = np.zeros(tuple(v.shape), np.int64)
        elif n < pool.size:
            start = int(rng.integers(0, pool.size - n))
            out[k] = pool[start:start + n].reshape(tuple(v.shape))
        else:
            out[k] = np.resize(pool, tuple(v.shape))
    return out


@functools.lru_cache(maxsize=None)
def _sizes():
    sizes = {}
    for name in jlist_backbones():
        with torch.device("meta"):
            sizes[name] = sum(v.numel() for v in build_replica(name).state_dict().values())
    return sizes


FULL = [n for n in jlist_backbones() if not n.startswith(
    ("convnext_large", "convnext_xlarge", "efficientnetv2_l", "swin_base_patch4_window12",
     "swin_large", "vit_large", "unicom"))]


def _port_shapes(tree):
    """{port state-dict name: shape} of a converted tree, through
    ``from_jax_variables``'s per-leaf rule on zero-stride stand-ins (no
    copies)."""
    out = {}

    def walk(node, prefix, rule):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,), rule)
            else:
                proxy = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), value.shape,
                                                        (0,) * value.ndim)
                leaf, arr = rule(prefix + (key,), proxy)
                out[".".join(prefix + (leaf,))] = tuple(arr.shape)

    walk(tree["params"], (), tconvert._leaf)
    walk(tree["batch_stats"], (), tconvert._stat_leaf)
    return out


@pytest.mark.parametrize("name", FULL)
def test_full_size_replica_converts_as_nkbx(name):
    """The tree equals nkbx's and fits the port's backbone built at the
    name's own input size."""
    assert _sizes()[name] <= FULL_LIMIT
    with torch.device("meta"):
        sd = _random_sd(build_replica(name), seed=len(name))
        size = 384 if name.endswith("_384") else 224
        backbone = create_backbone(name, dtype=torch.float32, img_size=(size, size))
    got = tconvert.convert_torch_state_dict(name, sd)
    _assert_same_tree(got, jconvert.convert_torch_state_dict(name, sd))
    assert _port_shapes(got) == {k: tuple(v.shape) for k, v in backbone.state_dict().items()}


def test_the_rest_are_over_the_full_size_limit():
    assert sorted(set(jlist_backbones()) - set(FULL)) == sorted(
        n for n, size in _sizes().items() if size > FULL_LIMIT)


def _narrow_cases():
    v2 = (("fused", 1, 3, 1, 1, 8, 0.0), ("fused", 4, 3, 2, 2, 16, 0.0),
          ("mb", 4, 3, 2, 2, 24, 0.25))
    return {
        "convnext": (lambda: TimmConvNeXt((1, 1, 2, 1), (8, 16, 24, 32)),
                     "convert_convnext_state_dict", ((1, 1, 2, 1),)),
        "swin": (lambda: TimmSwin(16, (1, 1, 2, 1), (1, 2, 2, 4)),
                 "convert_swin_state_dict", ((1, 1, 2, 1),)),
        "efficientnetv2": (lambda: TimmEfficientNetV2(v2, stem_width=8),
                           "convert_efficientnetv2_state_dict", (v2,)),
        "vit": (lambda: TimmViT(64, 2, 8, img=32), "convert_vit_state_dict", (64, 2, 4)),
        "unicom": (lambda: UnicomViTReplica(64, 2, 8, 32, img=32), "convert_unicom_state_dict",
                   (64, 2, 4)),
    }


def _renamed(sd, family):
    """The older layouts: Swin's merge after stage i at layers.{i}.downsample
    (pre-0.9 timm), ConvNeXt's final LayerNorm as ``norm``."""
    out = {}
    for k, v in sd.items():
        if family == "swin" and ".downsample." in k:
            i = int(k.split(".")[1])
            k = k.replace(f"layers.{i}.", f"layers.{i - 1}.", 1)
        elif family == "convnext" and k.startswith("head.norm."):
            k = k[len("head."):]
        out[k] = v
    return out


@pytest.mark.parametrize("family", sorted(_narrow_cases()))
def test_narrow_replica_converts_as_nkbx(family):
    build, fn, args = _narrow_cases()[family]
    sd = _random_sd(build(), seed=3)
    layouts = [sd] + ([_renamed(sd, family)] if family in ("swin", "convnext") else [])
    def tree(module, layout):
        return dict(zip(("params", "batch_stats"), getattr(module, fn)(layout, *args)))

    for i, layout in enumerate(layouts):
        got = tree(tconvert, layout)
        _assert_same_tree(got, tree(jconvert, layout))
        if i:  # the same tree as the newer layout's
            _assert_same_tree(got, tree(tconvert, sd))


def test_name_tables_equal_nkbx_and_every_name_dispatches():
    for table in ("_RESNET_SPECS", "_MBV3_STAGES", "_VIT_SPECS", "_UNICOM_SPECS",
                  "_EFFNET_STAGES", "_CONVNEXT_SPECS", "_DENSENET_CONFIGS", "_SWIN_SPECS",
                  "_EFFNETV2_SPECS"):
        assert getattr(tconvert, table) == getattr(jconvert, table), table
    for name in tconvert._EFFNETV2_SPECS:
        assert tconvert._effnetv2_spec(name) == jconvert._effnetv2_spec(name)
    for name in list_backbones():
        with pytest.raises(KeyError):  # a family converter, asking for its first key
            tconvert.convert_torch_state_dict(name, {})
    with pytest.raises(NotImplementedError, match="no timm-layout converter"):
        tconvert.convert_torch_state_dict("resnet9000", {})


def _reference_sd(task, seed=5):
    sd = {f"emb_model.{k}": v for k, v in _random_sd(build_replica("resnet_tiny_test")).items()}
    rng = np.random.default_rng(seed)
    heads = {"": 3} if task == "single" else {"size": 2, "color": 4}
    for t, n in heads.items():
        pre = "classifier.1" if task == "single" else f"classifier.{t}.1"
        sd[f"{pre}.weight"] = rng.standard_normal((n, 512), dtype=np.float32)
        sd[f"{pre}.bias"] = rng.standard_normal(n, dtype=np.float32)
    return sd


@pytest.mark.parametrize("task", ["single", "multi"])
def test_reference_checkpoint_converts_as_nkbx(task):
    sd = _reference_sd(task)
    got = tconvert.convert_reference_checkpoint("resnet_tiny_test", sd)
    _assert_same_tree(got, jconvert.convert_reference_checkpoint("resnet_tiny_test", sd))
    with pytest.raises(ValueError, match="emb_model"):
        tconvert.convert_reference_checkpoint("resnet_tiny_test", {"x": np.zeros(1)})


# --- the msgpack writer ------------------------------------------------------------------


def _converted(name="resnet_tiny_test"):
    return tconvert.convert_torch_state_dict(name, _random_sd(build_replica(name)))


def test_writer_writes_flax_bytes(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((5, 3), dtype=np.float32).T,  # a strided view
                       "i": np.arange(300, dtype=np.int64), "s": np.asarray(np.float32(2.5)),
                       "e": np.zeros((0, 4), np.float32), "empty": {},
                       **{f"k{i:02d}": np.full(i, i, np.float32) for i in range(20)},
                       "a key longer than thirty-one characters": np.ones(2, np.int32),
                       "big": rng.standard_normal(70_000, dtype=np.float32)},
            "batch_stats": {}}
    path = tmp_path / "t.msgpack"
    write_msgpack(tree, path)
    data = path.read_bytes()
    assert data == flax.serialization.to_bytes(tree)
    _assert_same_tree(read_msgpack(path), tree)
    _assert_same_tree(flax.serialization.msgpack_restore(data), tree)
    with pytest.raises(TypeError, match="maps and numpy arrays"):
        write_msgpack({"params": {"x": "text"}}, path)
    # arrays over the chunk size go as flax's chunk dicts
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tpretrained, "MAX_CHUNK_SIZE", 64)
    chunked = {"params": {"w": np.arange(105, dtype=np.float32).reshape(3, 7, 5).transpose(2, 0,
                                                                                           1)}}
    write_msgpack(chunked, path)
    assert path.read_bytes() == flax.serialization.to_bytes(chunked)
    _assert_same_tree(read_msgpack(path), chunked)


def test_nkbx_loads_a_converted_file(tmp_path):
    converted = _converted()
    path = tmp_path / "resnet_tiny_test.msgpack"
    write_msgpack(converted, path)
    model = jget_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                       input_size=(32, 32), dtype=jnp.float32)
    loaded = jconvert.load_pretrained_into(model.variables, path)
    # nkbx rebuilds the maps in its model's order
    _assert_same_tree(jax.device_get(loaded["params"]["backbone"]), converted["params"],
                      ordered=False)
    _assert_same_tree(jax.device_get(loaded["batch_stats"]["backbone"]),
                      converted["batch_stats"], ordered=False)


def test_cli_writes_nkbx_bytes(tmp_path):
    name = "resnet_tiny_test"
    sd = _random_sd(build_replica(name), seed=7)
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "r.pth")
    env = {**os.environ, "NKBX_PRETRAINED_DIR": str(tmp_path / "pre"), "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.models.convert", "--model", name,
                           "--weights", str(tmp_path / "r.pth")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "pre" / default_filename(name)
    assert f"wrote {out}" in proc.stdout
    jconvert.save_params_msgpack(jconvert.convert_torch_state_dict(name, sd), tmp_path / "j")
    assert out.read_bytes() == (tmp_path / "j").read_bytes()


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("NKBX_PRETRAINED_DIR", raising=False)
    for argv, match in ((["--model", "resnet50"], "downloads nothing"),
                        (["--model", "resnet50", "--to-torch"], "--to-torch requires --weights"),
                        (["--model", "resnet50", "--weights", "x.pth",
                          "--reference-checkpoint"], "requires --out")):
        if "--reference-checkpoint" in argv:
            name = "resnet_tiny_test"
            torch.save({f"emb_model.{k}": torch.from_numpy(v)
                        for k, v in _random_sd(build_replica(name)).items()}, tmp_path / "x.pth")
            argv = ["--model", name, "--weights", str(tmp_path / "x.pth"),
                    "--reference-checkpoint"]
        with pytest.raises(SystemExit, match=match):
            tconvert.main(argv)
    ref = _reference_sd("multi")
    torch.save({k: torch.from_numpy(v) for k, v in ref.items()}, tmp_path / "ref.pth")
    tconvert.main(["--model", "resnet_tiny_test", "--weights", str(tmp_path / "ref.pth"),
                   "--reference-checkpoint", "--out", str(tmp_path / "ref.msgpack")])
    _assert_same_tree(read_msgpack(tmp_path / "ref.msgpack"),
                      jconvert.convert_reference_checkpoint("resnet_tiny_test", ref))


# --- pos_embed resampling ----------------------------------------------------------------


@pytest.mark.parametrize("n_old,n_new", [(197, 577), (196, 256), (50, 145), (577, 197)])
def test_resample_matches_nkbx(n_old, n_new):
    stored = np.random.default_rng(n_old).standard_normal((1, n_old, 32), dtype=np.float32)
    got = tconvert.resample_pos_embed(stored, n_new)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, n_new, 32)
    np.testing.assert_array_equal(got.numpy(), jconvert.resample_pos_embed(stored, n_new))
    if n_old % 2:  # the class token passes through
        np.testing.assert_array_equal(got.numpy()[:, 0], stored[:, 0])


def test_adapt_raises_with_nkbx_words():
    with pytest.raises(ValueError, match="no prefix length makes both grids square"):
        tconvert.resample_pos_embed(np.zeros((1, 197, 8), np.float32), 150)
    target = {"a.pos_embed": torch.zeros(1, 5, 8), "a.w": torch.zeros(3)}
    with pytest.raises(ValueError, match=r"shape mismatch at a\.w: checkpoint holds \(4,\)"):
        tconvert.adapt_variables_tree({"a.pos_embed": torch.zeros(1, 17, 8),
                                       "a.w": torch.zeros(4)}, target)
    with pytest.raises(ValueError, match="checkpoint is missing a.w"):
        tconvert.adapt_variables_tree({"a.pos_embed": torch.zeros(1, 5, 8)}, target)
    out = tconvert.adapt_variables_tree({"a.pos_embed": torch.ones(1, 17, 8),
                                         "a.w": torch.zeros(3)}, target)
    assert out["a.pos_embed"].shape == (1, 5, 8) and torch.equal(out["a.pos_embed"][:, 0],
                                                                 torch.ones(1, 8))


def test_224_grid_file_loads_into_a_384_vit_with_nkbx_logits(tmp_path, monkeypatch):
    """vit_small_patch32_224's converted weights (50 tokens) as
    vit_small_patch32_384's pretrained file: both frameworks resample to 145
    tokens on load; with nkbx's head copied over the logits agree (f32, 5e-4,
    the port's logits tolerance through 12 blocks). The replica's values are
    brought to timm's init scale (LayerNorm scales near 1, the rest
    normal(0.02)): at unit-normal weights 12 blocks amplify rounding past any
    tolerance."""
    src = "vit_small_patch32_224"
    sd = _random_sd(build_replica(src), seed=9)
    sd = {k: (1 + 0.1 * v if "norm" in k and k.endswith("weight") else 0.02 * v)
          for k, v in sd.items()}
    converted = tconvert.convert_torch_state_dict(src, sd)
    write_msgpack(converted, tmp_path / default_filename("vit_small_patch32_384"))
    monkeypatch.setenv("NKBX_PRETRAINED_DIR", str(tmp_path))
    cfg = {"task": "single", "model": "vit_small_patch32_384", "pretrained": True}
    jmodel = jget_model(cfg, list("abc"), input_size=(384, 384), dtype=jnp.float32)
    model = get_model(cfg, list("abc"), input_size=(384, 384), dtype=torch.float32, device="cpu")
    pos = model.module.backbone.pos_embed.detach()
    assert tuple(pos.shape) == (1, 145, 384)
    np.testing.assert_array_equal(pos.numpy(), jconvert.resample_pos_embed(
        converted["params"]["pos_embed"], 145))
    head = jmodel.variables["params"]["head"]
    model.module.head.weight.data = torch.from_numpy(np.asarray(head["kernel"]).T.copy())
    model.module.head.bias.data = torch.from_numpy(np.asarray(head["bias"]).copy())
    x = np.random.default_rng(3).normal(size=(2, 384, 384, 3)).astype(np.float32)
    want = np.asarray(jmodel(jnp.asarray(x)))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, atol=5e-4, rtol=0)
