"""The port's export layer against nkbx's, on the CPU.

- ``disable_fused()``: inside it both gates (``resolve_fused``,
  ``fused_mlp_mode``) choose the plain version against a flag of True and
  the ``NKBX_FUSED_*`` overrides; outside they behave as before.
- Bundles against nkbx's: a tiny ResNet (``resnet_tiny_test``, 32 px;
  ``dynamic`` batch, none, and all at 32 and 64 px), a tiny Swin (window 2)
  and a tiny ViT (both ``batch``), nkbx's variables perturbed and carried
  across with ``from_jax_variables``. The same numpy-seeded normalised
  batches go through nkbx's ``export_model`` + ``TPUServingModule`` and the
  port's ``export_model`` + ``ServingModule(path)`` at batch 1, 5, the
  bucket (8) and 11 (a chunk of 8 and one of 3): f32 logits within 5e-4 of
  the largest; the port's bundle against its eager module within 1e-5; the
  metadata has nkbx's keys.
- Fused bundles: a tiny Swin, ViT and ConvNeXt (this one under
  ``NKBX_FUSED_LN_MLP=0``) exported with ``fused_attention=True`` hold
  ``nkbx_torch::*`` nodes; reloaded in a fresh process they serve the
  portable bundle's logits within 1e-5. ``fused_attention`` with a dynamic
  shape, ``dynamic="all"`` for a transformer and a StableHLO bundle
  written by nkbx raise ValueError.
- ``ExportedModel`` (``get_model``'s ``scripted: True``) through
  ``build_eval_step`` and ``val_epoch``; the serving benchmark CLI.
- The export CLI: every flag of ``export.py``; stablehlo, savedmodel,
  tflite and ``--quantize`` refused by name; ``--to serving`` and ``--to
  torchscript`` (reloaded with ``torch.jit.load``, within 1e-5 of the
  module) from a config; ``--to onnx`` where ``onnx`` is installed.
- The shipped ``eval_config.py`` and ``inference_config.py`` with only their
  paths (and workers) edited, ``scripted: True`` kept, through ``python -m
  nkbx_torch.eval`` and ``python -m nkbx_torch.inference --device cpu`` on
  a bundle: metrics and labels equal to the rebuilt model's.
- The trainer's ``export_serving``: a tiny run writes ``best.nkbx`` and
  ``last.nkbx``; with EMA on, ``best.nkbx`` serves the logits of the model
  that ``best.pt`` loads.
"""

import csv
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.export import TPUServingModule
from nkbx.export import export_model as jexport_model
from nkbx.models import get_model as jget_model
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.swin import SwinTransformer as JSwin
from nkbx.models.vit import ViT as JViT
from nkbx_torch.export import ExportedModel, ServingModule, export_model, load_exported
from nkbx_torch.export.__main__ import main as export_main
from nkbx_torch.export.__main__ import parse_args
from nkbx_torch.export.serving import main as serving_main
from nkbx_torch.models import get_model
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.convert import from_jax_variables
from nkbx_torch.models.convnext import ConvNeXt
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.models.vit import ViT
from nkbx_torch.ops import attention as A
from nkbx_torch.ops import disable_fused, fused_force_disabled
from nkbx_torch.ops import mlp as M

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CLASSES = ["a", "b", "c"]
BUCKET = 8
REQUESTS = (1, 5, BUCKET, 11)
NKBX_KEYS = {"description", "author", "date", "version", "batch", "imgsz", "layout", "task",
             "classes"}


# --- disable_fused -------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"NKBX_FUSED_ATTENTION": "1", "NKBX_FUSED_MLP": "1"}])
def test_disable_fused_sends_both_gates_to_plain(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = torch.zeros(4, 32)
    assert not fused_force_disabled()
    assert A.resolve_fused(True, x) and M.fused_mlp_mode(True, x, 128) == "ln"
    with disable_fused():
        assert fused_force_disabled()
        assert not A.resolve_fused(True, x) and not A.resolve_fused(None, x)
        assert M.fused_mlp_mode(True, x, 128) is None
        with disable_fused():  # nests
            assert fused_force_disabled()
        assert fused_force_disabled()
    assert not fused_force_disabled()
    assert A.resolve_fused(True, x) and M.fused_mlp_mode(True, x, 128) == "ln"
    assert A.resolve_fused(False, x) == bool(env)  # the override still beats the flag
    assert A.resolve_fused(None, x, auto=False) == bool(env)


# --- the nets on both sides -----------------------------------------------------------


def _perturbed(variables, seed=1):
    rng = np.random.default_rng(seed)

    def perturb(path, p):  # running variances kept positive
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


@functools.lru_cache(maxsize=None)
def _nets(family):
    """(nkbx ClassificationModel, port ClassificationModel, size) with the
    same perturbed weights."""
    if family == "resnet":
        donor = jget_model({"model": "resnet_tiny_test"}, CLASSES, input_size=(32, 32),
                           dtype=jnp.float32)
        jmodel = JModel(donor.module, _perturbed(donor.variables), CLASSES, "single",
                        donor.emb_size)
        port = get_model({"model": "resnet_tiny_test"}, CLASSES, input_size=(32, 32),
                         dtype=torch.float32, device="cpu")
        module, size = port.module, 32
    else:
        if family == "swin":
            jbackbone = JSwin(window=2, dtype=jnp.float32, embed_dim=16, depths=(2, 2),
                              n_heads=(1, 2))
            backbone = SwinTransformer(window=2, dtype=torch.float32, img_size=(32, 32),
                                       embed_dim=16, depths=(2, 2), n_heads=(1, 2))
            size = 32
        else:
            tiny = dict(patch_size=16, dim=128, depth=2, n_heads=2)
            jbackbone, size = JViT(dtype=jnp.float32, **tiny), 64
            backbone = ViT(dtype=torch.float32, img_size=(size, size), **tiny)
        jmodule = JSingle(backbone=jbackbone, n_classes=3)
        variables = _perturbed(jmodule.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3)), train=False))
        jmodel = JModel(jmodule, variables, CLASSES, "single", backbone.num_features)
        module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(jmodel.variables, reference=module))
    port = ClassificationModel(module.eval(), CLASSES, "single", 0, (size, size), torch.float32,
                               CPU)
    return jmodel, port, size


def _batch(n, size, seed=0):
    """A normalised-looking f32 NHWC batch."""
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("family,dynamic", [("resnet", "batch"), ("resnet", "none"),
                                            ("resnet", "all"), ("swin", "batch"),
                                            ("vit", "batch")])
def test_bundle_matches_nkbx(family, dynamic, tmp_path):
    jmodel, port, size = _nets(family)
    shape = (BUCKET, size, size, 3)
    jpath, jmeta = jexport_model(jmodel, shape, tmp_path / "nkbx.nkbx", dynamic=dynamic)
    path, meta = export_model(port, shape, tmp_path / "port.nkbx", dynamic=dynamic)
    assert set(jmeta) == NKBX_KEYS and set(meta) == NKBX_KEYS | {"format"}
    assert {k: meta[k] for k in ("batch", "imgsz", "layout", "task", "classes")} == \
        {k: jmeta[k] for k in ("batch", "imgsz", "layout", "task", "classes")}
    theirs = TPUServingModule(str(jpath), warm_up_on_load=False)
    ours = ServingModule(path, device="cpu", warm_up_on_load=False)
    assert ours.buckets == theirs.buckets == ([BUCKET] if dynamic == "none"
                                              else [1, 2, 4, BUCKET])
    assert ours.dtype == torch.float32 and ours.imgsz == (size, size)
    sizes = (size, 2 * size) if dynamic == "all" else (size,)
    for hw in sizes:
        for n in REQUESTS:
            x = _batch(n, hw, seed=n)
            got = ours(x)
            assert got.shape == (n, 3) and got.device == CPU
            assert _rel(got, theirs(x)) <= 5e-4, (hw, n)
            with torch.no_grad():
                eager = port.module(torch.from_numpy(x))
            assert _rel(got, eager) <= 1e-5, (hw, n)


def test_dynamic_all_refuses_transformers_and_fused_needs_static_shapes(tmp_path):
    for family in ("swin", "vit"):
        _, port, size = _nets(family)
        with pytest.raises(ValueError, match="CNN backbones"):
            export_model(port, (2, size, size, 3), tmp_path / "x.nkbx", dynamic="all")
    _, port, _ = _nets("resnet")
    for dynamic in ("batch", "all"):
        with pytest.raises(ValueError, match="requires dynamic='none'"):
            export_model(port, (2, 32, 32, 3), tmp_path / "x.nkbx", dynamic=dynamic,
                         fused_attention=True)
    assert not (tmp_path / "x.nkbx").exists()


def test_stablehlo_bundle_and_other_files_are_refused(tmp_path):
    jmodel, _, _ = _nets("resnet")
    jpath, _ = jexport_model(jmodel, (2, 32, 32, 3), tmp_path / "nkbx.nkbx", dynamic="none")
    with pytest.raises(ValueError, match="StableHLO bundle written by nkbx"):
        load_exported(jpath, "cpu")
    with pytest.raises(ValueError, match="StableHLO"):
        ServingModule(str(jpath), device="cpu")
    junk = tmp_path / "junk.nkbx"
    junk.write_bytes(b"PK\x03\x04 not a bundle at all")
    with pytest.raises(ValueError, match="not a .nkbx serving bundle"):
        load_exported(junk, "cpu")


# --- fused bundles ---------------------------------------------------------------------

_RELOAD = """
import json, sys
import numpy as np
import torch
from nkbx_torch.export import ServingModule
out = {}
for name, size in json.loads(sys.argv[1]):
    x = np.random.default_rng(3).normal(size=(5, size, size, 3)).astype(np.float32)
    fused = ServingModule(f"{name}_fused.nkbx", device="cpu")
    portable = ServingModule(f"{name}_portable.nkbx", device="cpu")
    ops = sorted({str(n.target) for n in fused.program.graph.nodes
                  if str(n.target).startswith("nkbx_torch.")})
    a, b = fused(x), portable(x)
    out[name] = [ops, float((a - b).abs().max() / b.abs().max()), fused.buckets]
print(json.dumps(out))
"""

FUSED = {"swin": ["nkbx_torch.ln_mlp.default", "nkbx_torch.window_attention.default"],
         "vit": ["nkbx_torch.attention.default", "nkbx_torch.ln_mlp.default"],
         "convnext": ["nkbx_torch.mlp.default"]}


@pytest.fixture(scope="module")
def fused_bundles(tmp_path_factory):
    """A fused (fused_attention=True, static batch 4) and a portable bundle
    of each tiny net, the fused flags on; reloaded in a fresh process."""
    tmp = tmp_path_factory.mktemp("fused")
    gen = torch.Generator().manual_seed(0)
    nets = {
        "swin": (SwinTransformer(window=2, dtype=torch.float32, img_size=(32, 32), embed_dim=16,
                                 depths=(2, 2), n_heads=(1, 2), fused_attention=True,
                                 fused_mlp=True), 32, {}),
        "vit": (ViT(dtype=torch.float32, img_size=(64, 64), patch_size=16, dim=128, depth=2,
                    n_heads=2, fused_attention=True, fused_mlp=True), 64, {}),
        "convnext": (ConvNeXt(dtype=torch.float32, depths=(1, 1), dims=(16, 32),
                              fused_mlp=True), 64, {"NKBX_FUSED_LN_MLP": "0"}),
    }
    graphs = {}
    for name, (backbone, size, env) in nets.items():
        backbone.reset_parameters(gen)
        model = ClassificationModel(SingletaskClassifier(backbone, 3, generator=gen).eval(),
                                    CLASSES, "single", 0, (size, size), torch.float32, CPU)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            export_model(model, (4, size, size, 3), tmp / f"{name}_fused.nkbx", dynamic="none",
                         fused_attention=True)
            export_model(model, (4, size, size, 3), tmp / f"{name}_portable.nkbx")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _, program = load_exported(tmp / f"{name}_portable.nkbx", "cpu")
        graphs[name] = sorted({str(n.target) for n in program.graph.nodes
                               if str(n.target).startswith("nkbx_torch.")})
    proc = subprocess.run([sys.executable, "-c", _RELOAD,
                           json.dumps([[n, s] for n, (_, s, _) in nets.items()])], cwd=tmp,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), graphs


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_bundle_keeps_registered_ops_and_reloads_in_a_fresh_process(name, fused_bundles):
    reloaded, portable_graphs = fused_bundles
    ops, rel, buckets = reloaded[name]
    assert ops == FUSED[name]
    assert portable_graphs[name] == []  # the portable bundle holds no op of ours
    assert buckets == [4]
    assert rel <= 1e-5


# --- ExportedModel and the serving CLI -------------------------------------------------


@pytest.fixture(scope="module")
def resnet_bundle(tmp_path_factory):
    _, port, _ = _nets("resnet")
    path, _ = export_model(port, (BUCKET, 32, 32, 3), tmp_path_factory.mktemp("rb") / "m.nkbx")
    return path


def test_exported_model_takes_the_eval_path(resnet_bundle):
    from nkbx_torch.train import get_loss
    from nkbx_torch.train.engine import EpochCollector, build_eval_step, build_predict_fn, val_epoch

    model = get_model({"scripted": True, "checkpoint": str(resnet_bundle)}, None, device="cpu")
    assert isinstance(model, ExportedModel)
    assert (model.classes, model.task, model.dtype, model.device, model.input_size) == \
        (CLASSES, "single", torch.float32, CPU, (32, 32))
    assert model.module.eval() is model.module and not model.module.training
    assert next(model.module.parameters()).device == CPU
    _, port, _ = _nets("resnet")
    x = _batch(6, 32, seed=9)
    with torch.no_grad():
        want = port.module(torch.from_numpy(x))
    assert _rel(model(torch.from_numpy(x)), want) <= 1e-5
    assert _rel(build_predict_fn(model)(torch.from_numpy(x)), want) <= 1e-5

    # val_epoch over two batches of 5, the last padded, finds its device itself
    images = np.random.default_rng(0).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(10) % 3

    class Loader:
        def __len__(self):
            return 2

        def epoch(self, _):
            for i in (0, 5):
                yield {"image": images[i:i + 5], "label": labels[i:i + 5],
                       "mask": np.array([True] * 5 if i == 0 else [True] * 4 + [False])}

    from nkbx_torch.transforms import Compose, Normalize

    norm = Compose([Normalize()])
    criterion = get_loss({"task": "single", "type": "CrossEntropyLoss"}, device="cpu")
    out = val_epoch(types.SimpleNamespace(module=model.module), Loader(),
                    build_eval_step(model, criterion, augment_fn=norm.device_apply),
                    epoch_logger=EpochCollector("single"), progress=False)
    assert len(out["predictions"]) == 9 and len(out["running_loss"]) == 2
    with torch.no_grad():
        want = port.module(norm.device_apply(torch.from_numpy(images[:9]))).argmax(-1)
    assert out["predictions"] == want.tolist()


def test_serving_cli_prints_one_row_per_bucket(resnet_bundle):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serving_main([str(resnet_bundle), "--sweep", "--iters", "2", "--device", "cpu"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["batch_size"] for r in rows] == [1, 2, 4, BUCKET]
    assert all(r["p50_ms"] > 0 and r["pipelined_images_per_sec"] > 0 for r in rows)
    assert "pad_miss_vs_prev_ms" in rows[1] and "pad_miss_vs_prev_ms" not in rows[0]
    buf = io.StringIO()
    with redirect_stdout(buf):
        serving_main([str(resnet_bundle), "--batch-size", "4", "--iters", "2", "--device",
                      "cpu"])
    assert json.loads(buf.getvalue())["batch_size"] == 4


# --- the export CLI -------------------------------------------------------------------

_EXPORT_FLAGS = ["-cfg", "c.py", "--to", "serving", "-w", "w.pt", "--dynamic", "none",
                 "--input-shape", "4", "64", "64", "3", "--save_path", "out", "--half",
                 "--opset", "13", "--fused-attention", "--sim", "--device", "cpu", "-v"]


def test_export_cli_takes_every_flag_of_export_py():
    args = parse_args(_EXPORT_FLAGS)
    assert (args.to, args.dynamic, args.input_shape, args.half, args.opset, args.fused_attention,
            args.sim, args.device, args.verbose) == ("serving", "none", [4, 64, 64, 3], True,
                                                     13, True, True, "cpu", True)
    defaults = parse_args(["-cfg", "c.py", "--to", "torchscript", "-w", "w.pt"])
    assert (defaults.dynamic, defaults.input_shape, defaults.half, defaults.save_path,
            defaults.device) == ("batch", [32, 224, 224, 3], False, ".", None)


@pytest.mark.parametrize("fmt", ["stablehlo", "savedmodel", "tflite"])
def test_export_cli_refuses_the_jax_lowerings_by_name(fmt):
    with pytest.raises(NotImplementedError, match=f"--to {fmt} has no counterpart"):
        parse_args(["-cfg", "c.py", "--to", fmt, "-w", "w.pt"])


def test_export_cli_refuses_quantize_and_misplaced_fused_attention():
    with pytest.raises(NotImplementedError, match="--quantize"):
        parse_args(["-cfg", "c.py", "--to", "onnx", "-w", "w.pt", "--quantize", "dynamic"])
    with pytest.raises(SystemExit):
        parse_args(["-cfg", "c.py", "--to", "serving", "-w", "w.pt", "--fused-attention"])
    with pytest.raises(SystemExit):
        parse_args(["-cfg", "c.py", "--to", "torchscript", "-w", "w.pt", "--dynamic", "none",
                    "--fused-attention"])


def _write_images(root, n_per_class=4, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    for c in range(3):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(n_per_class):
            img = rng.integers(0, 256, (int(rng.integers(24, 60)), 40, 3)) + 40 * (c - 1)
            cv2.imwrite(str(root / f"c{c}" / f"{i}.png"), np.clip(img, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """A train config (ImageFolder of 12 PNGs, resnet_tiny_test, 32 px) and
    the port weights it exports."""
    tmp = tmp_path_factory.mktemp("cli")
    _write_images(tmp / "train")
    _, port, _ = _nets("resnet")
    torch.save(port.module.state_dict(), tmp / "best.pt")
    cfg = tmp / "cfg.py"
    cfg.write_text(f"""import nkbx.transforms as T

enable_mixed_precision = False
task = "single"
experiment = {{"local": {{"path": "{tmp / 'run'}"}}}}
train_data = {{"type": "ImageFolder", "root": "{tmp / 'train'}", "batch_size": 4,
              "num_workers": 1}}
train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.Normalize()])
model = {{"task": "single", "model": "resnet_tiny_test", "pretrained": True}}
""")
    return tmp, cfg, port


def test_export_cli_serving_and_torchscript(cli_workspace, capsys):
    tmp, cfg, port = cli_workspace
    common = ["-cfg", str(cfg), "-w", str(tmp / "best.pt"), "--input-shape", "4", "32", "32",
              "3", "--save_path", str(tmp / "out"), "--device", "cpu"]
    path = export_main(parse_args(common + ["--to", "serving", "-v"]))
    assert path == tmp / "out" / "best.nkbx"
    assert "serving export success" in capsys.readouterr().out
    serving = ServingModule(path, device="cpu")
    assert serving.classes == ["c0", "c1", "c2"] and serving.buckets == [1, 2, 4]
    x = _batch(3, 32, seed=4)
    with torch.no_grad():
        want = port.module(torch.from_numpy(x))
    assert _rel(serving(x), want) <= 1e-5

    pt = export_main(parse_args(common + ["--to", "torchscript"]))
    assert pt == tmp / "out" / "best.pt"
    extra = {"config.txt": ""}
    traced = torch.jit.load(str(pt), map_location="cpu", _extra_files=extra)
    meta = json.loads(extra["config.txt"])
    assert meta["layout"] == "NCHW" and meta["classes"] == ["c0", "c1", "c2"]
    with torch.no_grad():
        got = traced(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(got, want) <= 1e-5


def test_export_cli_onnx(cli_workspace):
    pytest.importorskip("onnx", reason="onnx is not installed: --to onnx raises naming it")
    tmp, cfg, _ = cli_workspace
    path = export_main(parse_args(["-cfg", str(cfg), "-w", str(tmp / "best.pt"), "--to", "onnx",
                                   "--input-shape", "2", "32", "32", "3", "--save_path",
                                   str(tmp / "onnx"), "--device", "cpu"]))
    assert path.exists() and Path(str(path) + ".json").exists()


def test_export_onnx_names_the_missing_package(cli_workspace):
    if importlib.util.find_spec("onnx") is not None:
        pytest.skip("onnx is installed here")
    from nkbx_torch.export import export_onnx

    _, _, port = cli_workspace
    with pytest.raises(ImportError, match="'onnx' package"):
        export_onnx(port, "x.onnx", (2, 32, 32, 3))


# --- the shipped eval and inference configs on a bundle -------------------------------


def _shipped(name, edits, path):
    text = (ROOT / "configs" / f"{name}.py").read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def shipped_run(tmp_path_factory):
    """A run directory (classes.json, weights/best.pt and, through the
    export CLI, weights/best.nkbx at the shipped configs' 128 px), an
    annotated CSV over PNG files and a flat folder of the val images."""
    import cv2

    tmp = tmp_path_factory.mktemp("shipped")
    images, rows = tmp / "images", ["path,fold,label"]
    images.mkdir()
    rng = np.random.default_rng(5)
    for i in range(14):
        c = i % 2
        img = np.clip(rng.integers(0, 256, (int(rng.integers(60, 140)), 100, 3))
                      + (60 if c else -60), 0, 255).astype(np.uint8)
        cv2.imwrite(str(images / f"{i}.png"), img)
        rows.append(f"{i}.png,{'val' if i >= 4 else 'train'},{['first', 'second'][c]}")
    (tmp / "annotations.csv").write_text("\n".join(rows) + "\n")
    folder = tmp / "unknown"
    folder.mkdir()
    for i in range(4, 14):
        (folder / f"{i}.png").write_bytes((images / f"{i}.png").read_bytes())
    run = tmp / "run"
    (run / "weights").mkdir(parents=True)
    classes = ["first", "second"]
    (run / "classes.json").write_text(json.dumps(classes))
    model = get_model({"model": "resnet_tiny_test"}, classes, input_size=(128, 128), seed=3,
                      dtype=torch.bfloat16, device="cpu")
    torch.save(model.module.state_dict(), run / "weights" / "best.pt")
    cfg = tmp / "train.py"
    cfg.write_text(f"""import nkbx.transforms as T

task = "single"
train_data = {{"type": "AnnotatedSingletaskDataset", "annotations_file": "{tmp}/annotations.csv",
              "image_base_dir": "{images}", "target_column": "label", "fold": "train",
              "batch_size": 4, "num_workers": 1}}
train_pipeline = T.Compose([T.LongestMaxSize(128), T.PadIfNeeded(128, 128), T.Normalize()])
model = {{"task": task, "model": "resnet_tiny_test"}}
""")
    export_main(parse_args(["-cfg", str(cfg), "-w", str(run / "weights" / "best.pt"), "--to",
                            "serving", "--input-shape", "64", "128", "128", "3", "--save_path",
                            str(run / "weights"), "--device", "cpu"]))
    return tmp, run


REBUILT = ('model = {\n    "scripted": True,\n'
           '    "checkpoint": f"{train_run_path}/weights/best.nkbx",\n}',
           'model = {"task": task, "model": "resnet_tiny_test",\n'
           '         "checkpoint": f"{train_run_path}/weights/best.pt"}')


def _paths(tmp, run, save):
    return [('annotations_path = "data/annotations.csv"',
             f'annotations_path = "{tmp}/annotations.csv"'),
            ('image_base_dir = "data/images"', f'image_base_dir = "{tmp}/images"'),
            ('train_run_path = "data/runs/train_singletask_run_1"', f'train_run_path = "{run}"'),
            ('"folder_path": "data/unknown_images"', f'"folder_path": "{tmp}/unknown"'),
            ('"num_workers": 8', '"num_workers": 2'),
            ('save_path = "data/runs/val_singletask_run_1"', f'save_path = "{save}"'),
            ('save_path = "data/runs/infer_singletask_run_1"', f'save_path = "{save}"')]


def _edits(text_name, tmp, run, save, rebuilt):
    text = (ROOT / "configs" / f"{text_name}.py").read_text()
    return [e for e in _paths(tmp, run, save) if e[0] in text] + ([REBUILT] if rebuilt else [])


def test_shipped_eval_config_runs_on_its_bundle(shipped_run):
    from nkbx_torch import eval as teval
    from nkbx_torch.utils import load_config

    tmp, run = shipped_run
    got = {}
    for rebuilt in (False, True):
        save = tmp / f"eval_{rebuilt}"
        cfg = _shipped("eval_config", _edits("eval_config", tmp, run, save, rebuilt),
                       tmp / f"eval_{rebuilt}.py")
        assert load_config(cfg).model.get("scripted", False) is (not rebuilt)
        teval.main(["-cfg", str(cfg), "--device", "cpu"])
        got[rebuilt] = json.loads((save / "metrics.json").read_text())
    assert got[False]["epoch_acc"] == pytest.approx(got[True]["epoch_acc"], rel=1e-6)
    assert np.mean(got[False]["loss"]) == pytest.approx(np.mean(got[True]["loss"]), rel=1e-5)


def test_shipped_inference_config_runs_on_its_bundle(shipped_run):
    from nkbx_torch import inference as tinference

    tmp, run = shipped_run
    rows = {}
    for rebuilt in (False, True):
        save = tmp / f"infer_{rebuilt}"
        cfg = _shipped("inference_config", _edits("inference_config", tmp, run, save, rebuilt),
                       tmp / f"infer_{rebuilt}.py")
        tinference.main(["-cfg", str(cfg), "--device", "cpu"])
        with open(save / "inference_annotations.csv", newline="") as f:
            rows[rebuilt] = list(csv.reader(f))
    assert rows[False] == rows[True] and len(rows[False]) == 11


# --- the trainer's export_serving ------------------------------------------------------


def test_trainer_export_serving_takes_the_weights_of_best_pt(tmp_path):
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_local_experiment
    from nkbx_torch.train import get_loss
    from nkbx_torch.train.trainer import train
    from nkbx_torch.transforms import Compose, LongestMaxSize, Normalize, PadIfNeeded
    from nkbx_torch.utils import Config

    _write_images(tmp_path / "train", n_per_class=3)
    _write_images(tmp_path / "val", n_per_class=2, seed=1)
    pipe = Compose([LongestMaxSize(32), PadIfNeeded(32, 32), Normalize()])
    cfg = Config({
        "task": "single", "n_epochs": 2, "seed": 0, "enable_mixed_precision": False,
        "train_data": {"type": "ImageFolder", "root": str(tmp_path / "train"), "batch_size": 4,
                       "shuffle": True, "num_workers": 1, "drop_last": False},
        "val_data": {"type": "ImageFolder", "root": str(tmp_path / "val"), "batch_size": 4,
                     "shuffle": False, "num_workers": 1},
        "train_pipeline": pipe, "val_pipeline": pipe,
        "model": {"task": "single", "model": "resnet_tiny_test"},
        "optimizer": {"type": "sgd", "lr": 0.5},
        "criterion": {"task": "single", "type": "CrossEntropyLoss"},
        "experiment": {"comet": None, "local": {"path": str(tmp_path / "run")}},
        "model_ema_decay": 0.5, "export_serving": True,
    })
    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    classes = train_loader.dataset.classes
    val_loader = get_dataset({**cfg.val_data, "classes": classes}, cfg.val_pipeline)
    model = get_model(cfg.model, classes, input_size=(32, 32), dtype=torch.float32,
                      device="cpu")
    exp = get_local_experiment(cfg.experiment["local"])
    state = train(model, train_loader, val_loader, get_loss(cfg.criterion, device="cpu"), None,
                  exp, cfg)
    weights = exp.path / "weights"
    x = _batch(5, 32, seed=2)
    for name in ("best", "last"):
        assert (weights / f"{name}.nkbx").is_file()
        serving = ServingModule(weights / f"{name}.nkbx", device="cpu")
        assert serving.buckets == [1, 2, 4] and serving.classes == classes
        loaded = get_model({"model": "resnet_tiny_test", "checkpoint": str(weights / f"{name}.pt")},
                           classes, input_size=(32, 32), dtype=torch.float32, device="cpu")
        with torch.no_grad():
            want = loaded.module(torch.from_numpy(x))
        assert _rel(serving(x), want) <= 1e-5, name
    # best.pt is the EMA shadow, not the raw weights the run trained
    with torch.no_grad():
        raw = state.module.eval()(torch.from_numpy(x))
    assert _rel(ServingModule(weights / "last.nkbx", device="cpu")(x), raw) > 1e-3
