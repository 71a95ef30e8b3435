"""The port's reverse converter (``nkbx_torch/models/reverse.py``, the
templates of ``nkbx_torch/models/torch_ref.py``, ``to_jax_variables`` and
``--to-torch``) against nkbx's (``nkbx/models/reverse.py``), on the CPU;
mirrors ``tests/test_reverse_convert.py``.

- Every registry name: the port's template has nkbx's ``build_replica``
  keys, shapes, dtypes and order (built on the meta device).
- Every name whose replica holds at most 30M values, at full size, seeded
  values (windows of one pool): the port's ``reverse_torch_state_dict`` of
  the converted tree is nkbx's, array for array and bit for bit, with the
  same ``skipped``; it gives back the torch file exactly; and
  ``to_jax_variables(from_jax_variables(tree))`` is the tree. Narrow
  replicas of the five families (ConvNeXt, Swin, EfficientNetV2, ViT,
  unicom) take the same check through ``reverse_state_dict`` against nkbx's
  reverse with its template and converter swapped for the narrow ones. The
  larger names share these converters (held to nkbx's, name by name, in
  ``test_torch_timm_convert.py``) and templates (held here), so their
  reverse is nkbx's too.
- ``reverse_reference_checkpoint``, single and multi-task, is nkbx's.
- The CLI in a subprocess on a port ``best.pt``, on ``weights/best/`` with
  ``--ema``, and on an nkbx ``.msgpack`` (with and without ``--ema``)
  writes what nkbx's reverse writes from the same weights; a ViT's
  ``best.pt`` through ``--to-torch`` and back gives bit-equal logits.
- An orbax directory and a missing EMA shadow raise with nkbx's words; a
  converter that duplicates or drops elements, and leaves the converter
  never makes, fail loudly; a trained synthesised leaf warns.
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nkbx.models.convert as jconvert
import nkbx.models.reverse as jreverse
from nkbx.models.registry import list_backbones as jlist_backbones
from nkbx.models.torch_ref import build_replica as jbuild_replica
from nkbx_torch.models import convert as tconvert
from nkbx_torch.models import get_model
from nkbx_torch.models import reverse as treverse
from nkbx_torch.models import torch_ref as tref
from nkbx_torch.models.pretrained import write_msgpack
from nkbx_torch.train.checkpoint import save_checkpoint
from nkbx_torch.train.state import TrainState

REPO = Path(__file__).resolve().parent.parent
FULL_LIMIT = 30_000_000


@functools.lru_cache(maxsize=None)
def _pool():
    return np.random.default_rng(0).standard_normal(1 << 24, dtype=np.float32)


def _random_sd(template, seed=0):
    """Seeded numpy values of ``template``'s names and shapes: each floating
    tensor a window of one pool, integer buffers zero."""
    pool, rng, out = _pool(), np.random.default_rng(seed), {}
    for k, v in template.items():
        n = v.numel()
        if not v.dtype.is_floating_point:
            out[k] = np.zeros(tuple(v.shape), np.int64)
        else:
            start = int(rng.integers(0, pool.size - n))
            out[k] = pool[start:start + n].reshape(tuple(v.shape))
    return out


def _meta(build):
    with torch.device("meta"):
        return build().state_dict()


@functools.lru_cache(maxsize=None)
def _sizes():
    return {n: sum(v.numel() for v in _meta(functools.partial(jbuild_replica, n)).values())
            for n in jlist_backbones()}


FULL = [n for n in jlist_backbones() if not n.startswith(
    ("convnext_small", "convnext_base", "convnext_large", "convnext_xlarge", "efficientnet_b5",
     "efficientnet_b6", "efficientnet_b7", "efficientnetv2_m", "efficientnetv2_l", "resnet101",
     "resnet152", "resnext101", "wide_resnet", "swin_small", "swin_base", "swin_large",
     "vit_base", "vit_large", "deit_base", "unicom"))]


@pytest.mark.parametrize("name", jlist_backbones())
def test_template_is_nkbx_replica(name):
    got = _meta(functools.partial(tref.build_replica, name))
    want = _meta(functools.partial(jbuild_replica, name))
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in want)


def test_full_list_is_the_names_under_the_limit():
    assert sorted(FULL) == sorted(n for n, s in _sizes().items() if s <= FULL_LIMIT)


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _same_tree(got, want, where="root"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    else:
        assert np.asarray(got).shape == np.asarray(want).shape, where
        assert np.array_equal(np.asarray(got), np.asarray(want)), where


def _heads(name):
    spec = tconvert._VIT_SPECS.get(name) or tconvert._UNICOM_SPECS.get(name)
    return spec[2] if spec else None


@pytest.mark.parametrize("name", FULL)
def test_full_size_reverse_is_nkbx(name):
    sd = _random_sd(treverse.template_state_dict(name), seed=len(name))
    tree = tconvert.convert_torch_state_dict(name, sd)
    got, skipped = treverse.reverse_torch_state_dict(name, tree)
    want, want_skipped = jreverse.reverse_torch_state_dict(name, tree)
    _same(got, want)
    assert skipped == want_skipped
    for k, v in got.items():  # back to the torch file, exactly
        assert np.array_equal(v, sd[k]), k
    assert all(k.split(".")[0] in ("head", "fc", "classifier") or "num_batches" in k
               or k.endswith(("relative_position_index", "attn_mask")) for k in skipped)
    port = tconvert.from_jax_variables(tree)
    _same_tree(tconvert.to_jax_variables(port, n_heads=_heads(name)), tree)


def _narrow():
    v2 = (("fused", 1, 3, 1, 1, 8, 0.0), ("fused", 4, 3, 2, 2, 16, 0.0),
          ("mb", 4, 3, 2, 2, 24, 0.25))
    return {
        "convnext": (lambda m: m.TimmConvNeXt((1, 1, 2, 1), (8, 16, 24, 32)),
                     lambda c, sd: c.convert_convnext_state_dict(sd, (1, 1, 2, 1))),
        "swin": (lambda m: m.TimmSwin(16, (1, 1, 2, 1), (1, 2, 2, 4)),
                 lambda c, sd: c.convert_swin_state_dict(sd, (1, 1, 2, 1))),
        "efficientnetv2": (lambda m: m.TimmEfficientNetV2(v2, stem_width=8),
                           lambda c, sd: c.convert_efficientnetv2_state_dict(sd, v2)),
        "vit": (lambda m: m.TimmViT(64, 2, 8, img=32),
                lambda c, sd: c.convert_vit_state_dict(sd, 64, 2, 4)),
        "unicom": (lambda m: m.UnicomViTReplica(64, 2, 8, 32, img=32),
                   lambda c, sd: c.convert_unicom_state_dict(sd, 64, 2, 4)),
    }


@pytest.mark.parametrize("family", sorted(_narrow()))
def test_narrow_reverse_is_nkbx(family, monkeypatch):
    from nkbx.models import torch_ref as jref

    build, conv = _narrow()[family]
    template = _meta(lambda: build(tref))
    sd = _random_sd(template, seed=7)

    def forward(module):
        return lambda s: dict(zip(("params", "batch_stats"), conv(module, s)))

    tree = forward(tconvert)(sd)
    got, skipped = treverse.reverse_state_dict(template, forward(tconvert), tree, family)
    monkeypatch.setattr(jreverse, "template_state_dict",
                        lambda name: build(jref).state_dict())
    monkeypatch.setattr(jconvert, "convert_torch_state_dict", lambda name, s: forward(jconvert)(s))
    want, want_skipped = jreverse.reverse_torch_state_dict(family, tree)
    _same(got, want)
    assert skipped == want_skipped
    assert all(np.array_equal(v, sd[k]) for k, v in got.items())
    heads = 4 if family in ("vit", "unicom") else None
    _same_tree(tconvert.to_jax_variables(tconvert.from_jax_variables(tree), heads), tree)


@pytest.mark.parametrize("task", ["single", "multi"])
def test_reference_checkpoint_reverse_is_nkbx(task):
    name = "resnet_tiny_test"
    sd = {f"emb_model.{k}": v for k, v in _random_sd(treverse.template_state_dict(name)).items()}
    rng = np.random.default_rng(3)
    for t, n in ({"": 3} if task == "single" else {"size": 2, "color": 4}).items():
        pre = "classifier.1" if task == "single" else f"classifier.{t}.1"
        sd[f"{pre}.weight"] = rng.standard_normal((n, 128), dtype=np.float32)
        sd[f"{pre}.bias"] = rng.standard_normal(n, dtype=np.float32)
    variables = tconvert.convert_reference_checkpoint(name, sd)
    got, skipped = treverse.reverse_reference_checkpoint(name, variables)
    want, want_skipped = jreverse.reverse_reference_checkpoint(name, variables)
    _same(got, want)
    assert skipped == want_skipped and all(k.startswith("emb_model.") for k in skipped)
    assert all(np.array_equal(v, sd[k]) for k, v in got.items())
    with pytest.raises(ValueError, match="'backbone' subtree"):
        treverse.reverse_reference_checkpoint(name, {"params": variables["params"]["backbone"]})


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "nkbx_torch.models.convert", "--to-torch",
                           *map(str, args)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def _port_model(name, classes=("a", "b", "c")):
    size = (32, 32) if name == "resnet_tiny_test" else (224, 224)
    return get_model({"model": name}, list(classes), input_size=size, device="cpu",
                     dtype=torch.float32).module


def _torch_file(path):
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


def test_cli_on_best_pt_and_an_ema_checkpoint_dir(tmp_path):
    name = "resnet_tiny_test"
    module = _port_model(name)
    torch.save(module.state_dict(), tmp_path / "best.pt")
    r = _cli("--model", name, "--weights", tmp_path / "best.pt", "--out", tmp_path / "a.pth")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "load with strict=False" in r.stdout and "not emitted" in r.stdout
    want, _ = jreverse.reverse_reference_checkpoint(name, tconvert.to_jax_variables(module))
    _same(_torch_file(tmp_path / "a.pth"), want)

    state = TrainState.create(module, ema=True)
    with torch.no_grad():
        for p in state.ema_module.parameters():
            p.mul_(0.5)
    save_checkpoint(tmp_path / "weights" / "best", state, epoch=0)
    r = _cli("--model", name, "--weights", tmp_path / "weights" / "best", "--out",
             tmp_path / "ema.pth", "--ema")
    assert r.returncode == 0, r.stderr[-2000:]
    want, _ = jreverse.reverse_reference_checkpoint(
        name, tconvert.to_jax_variables(state.ema_module))
    _same(_torch_file(tmp_path / "ema.pth"), want)
    assert not np.array_equal(want["classifier.1.weight"],
                              module.head.weight.detach().numpy())


def test_cli_on_an_nkbx_msgpack(tmp_path):
    name = "resnet_tiny_test"
    module = _port_model(name)
    variables = tconvert.to_jax_variables(module)
    ema = {k: {"kernel": v["kernel"] * 0.5, "bias": v["bias"]} if k == "head" else v
           for k, v in variables["params"].items()}
    write_msgpack({"params": variables["params"], "batch_stats": variables["batch_stats"],
                   "ema_params": ema, "ema_batch_stats": variables["batch_stats"]},
                  tmp_path / "w.msgpack")
    for flag, params in (((), variables["params"]), (("--ema",), ema)):
        out = tmp_path / f"m{len(flag)}.pth"
        r = _cli("--model", name, "--weights", tmp_path / "w.msgpack", "--out", out, *flag)
        assert r.returncode == 0, r.stderr[-2000:]
        want, _ = jreverse.reverse_reference_checkpoint(
            name, {"params": params, "batch_stats": variables["batch_stats"]})
        _same(_torch_file(out), want)
    # a bare backbone tree becomes a timm-layout backbone file
    write_msgpack({"params": variables["params"]["backbone"],
                   "batch_stats": variables["batch_stats"]["backbone"]}, tmp_path / "bb.msgpack")
    r = _cli("--model", name, "--weights", tmp_path / "bb.msgpack", "--out", tmp_path / "bb.pth")
    assert r.returncode == 0, r.stderr[-2000:]
    want, _ = jreverse.reverse_torch_state_dict(name, {
        "params": variables["params"]["backbone"],
        "batch_stats": variables["batch_stats"]["backbone"]})
    _same(_torch_file(tmp_path / "bb.pth"), want)


def test_vit_best_pt_round_trip_gives_bit_equal_logits(tmp_path):
    name = "vit_tiny_patch16_224"
    module = _port_model(name).eval()
    torch.save(module.state_dict(), tmp_path / "best.pt")
    r = _cli("--model", name, "--weights", tmp_path / "best.pt", "--out", tmp_path / "v.pth")
    assert r.returncode == 0, r.stderr[-2000:]
    back = tconvert.convert_reference_checkpoint(name, _torch_file(tmp_path / "v.pth"))
    again = _port_model(name).eval()
    again.load_state_dict(tconvert.from_jax_variables(back, reference=again))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 224, 224, 3),
                                                                  dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(module(x), again(x))


def test_refusals(tmp_path):
    name = "resnet_tiny_test"
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        treverse.load_weights(tmp_path / "orbax")
    torch.save(_port_model(name).state_dict(), tmp_path / "best.pt")
    with pytest.raises(ValueError, match="holds no separate EMA shadow"):
        treverse.load_weights(tmp_path / "best.pt", ema=True)
    state = TrainState.create(_port_model(name))
    save_checkpoint(tmp_path / "best", state, epoch=0)
    with pytest.raises(ValueError, match="holds no separate EMA shadow"):
        treverse.load_weights(tmp_path / "best", ema=True)
    r = _cli("--model", name, "--weights", tmp_path / "best.pt")
    assert r.returncode != 0 and "--to-torch requires --weights" in r.stderr
    r = _cli("--model", name, "--weights", tmp_path / "orbax", "--out", tmp_path / "x.pth")
    assert r.returncode != 0 and "orbax" in r.stderr
    with pytest.raises(ValueError, match="n_heads"):
        tconvert.to_jax_variables(_port_model("vit_tiny_patch16_224").state_dict())


def test_a_converter_that_is_not_a_permutation_fails_loudly():
    name = "resnet_tiny_test"
    template = treverse.template_state_dict(name)
    sd = _random_sd(template)
    tree = tconvert.convert_torch_state_dict(name, sd)

    def duplicating(s):
        out = tconvert.convert_torch_state_dict(name, s)
        out["params"]["ConvBN_0"]["BatchNorm_0"]["bias"] = s["bn1.weight"]
        return out

    with pytest.raises(ValueError, match="re-places torch elements"):
        treverse.reverse_state_dict(template, duplicating, tree, name)

    def dropping(s):
        out = tconvert.convert_torch_state_dict(name, s)
        out["params"]["ConvBN_0"]["BatchNorm_0"]["bias"] = s["bn1.bias"][:-1]
        return out

    cut = tconvert.convert_torch_state_dict(name, sd)
    cut["params"]["ConvBN_0"]["BatchNorm_0"]["bias"] = sd["bn1.bias"][:-1]
    with pytest.raises(ValueError, match="partially consumed"):
        treverse.reverse_state_dict(template, dropping, cut, name)
    extra = tconvert.convert_torch_state_dict(name, sd)
    extra["params"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="never produces"):
        treverse.reverse_torch_state_dict(name, extra)


def test_a_trained_synthesised_leaf_warns():
    name = "unicom ViT-B/32"  # its patch conv has no bias: the converter makes zeros
    template = {k: v for k, v in treverse.template_state_dict(name).items()
                if k.startswith(("patch_embed", "pos_embed"))}

    def forward(s):
        params = {"patch_embed": {"kernel": s["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
                                  "bias": np.zeros(768, np.float32)},
                  "pos_embed": s["pos_embed"]}
        return {"params": params, "batch_stats": {}}

    tree = forward(_random_sd(template))
    tree["params"]["patch_embed"]["bias"] = np.ones(768, np.float32)
    with pytest.warns(UserWarning, match="synthesizes it"):
        out, _ = treverse.reverse_state_dict(template, forward, tree, name)
    assert sorted(out) == ["patch_embed.proj.weight", "pos_embed"]
