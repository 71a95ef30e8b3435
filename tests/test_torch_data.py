"""The port's data path and epoch metrics against nkbx's, on the CPU.

- Host transforms (``nkbx_torch.transforms``): each pipeline's host stage
  against nkbx's on the same images and draws, exact through cv2; the
  numpy bilinear resize (the path where neither cv2 nor PIL is installed)
  within one uint8 level of cv2's INTER_LINEAR and equal to the native
  decoder's resize; ``output_size`` equal.
- Decoding: the numpy BMP reader against cv2, exact (24- and 32-bit,
  bottom-up and top-down, row padding); the header probe of
  ``image_size`` against PIL; the port's native decoder (built from its
  copy of decode.cpp) against nkbx's committed library, exact bytes, in
  both modes and with crops.
- The samplers: the same draws from the same seeds.
- The loader: batches (images, labels, masks) equal to nkbx's loader from
  the same files, config and seed, over two epochs, on the native and the
  Python decode paths, resumed mid-epoch, and split over two processes;
  the CSV datasets equal with and without pandas.
- Metrics: balanced accuracy equal to sklearn's and ROC-AUC within 1e-12
  across binary, multiclass and missing-class cases; the bounded path on
  torch tensors equal to nkbx's ``bounded_*``.
- Config loading: every shipped config loads (every device op of nkbx is
  ported), ``sys.modules`` keeps its ``nkbx`` entries.
- Logging: the PNG writer against cv2's decoder; without comet_ml a Comet section
  warns as nkbx does.
"""

import builtins
import os
import struct
import sys
import warnings
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.metrics import balanced_accuracy_score, roc_auc_score

import nkbx.native as jnative
import nkbx.transforms as JT
from nkbx import metrics as jmetrics
from nkbx.data import loader as jloader
from nkbx.data import sampler as jsampler
from nkbx.data.datasets import ImageFolderDataset as JImageFolder
from nkbx_torch import metrics as tmetrics
from nkbx_torch import native as tnative
from nkbx_torch import transforms as T
from nkbx_torch.data import datasets as tdatasets
from nkbx_torch.data import loader as tloader
from nkbx_torch.data import sampler as tsampler
from nkbx_torch.logging.experiment import get_comet_experiment, write_png
from nkbx_torch.transforms import host as thost
from nkbx_torch.utils import load_config, read_py_config

ROOT = Path(__file__).resolve().parents[1]


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


# --- host transforms -----------------------------------------------------------------

HOST_PIPELINES = [
    lambda M: [M.LongestMaxSize(32), M.PadIfNeeded(32, 32)],
    lambda M: [M.LongestMaxSize(40), M.PadIfNeeded(48, 48, border_mode=0, value=(10, 20, 30))],
    lambda M: [M.SmallestMaxSize(24), M.CenterCrop(20, 20)],
    lambda M: [M.Resize(17, 23)],
    lambda M: [M.PadIfNeeded(96, 96, border_mode=4), M.RandomCrop(40, 50)],
    lambda M: [M.PadIfNeeded(100, 80, border_mode=1), M.CenterCrop(90, 120)],
]


@pytest.mark.parametrize("make", HOST_PIPELINES)
def test_host_stage_matches_nkbx(make):
    rng = np.random.default_rng(0)
    port, ref = T.Compose(make(T)), JT.Compose(make(JT))
    assert port.output_size() == ref.output_size()
    for i, (h, w) in enumerate([(45, 70), (90, 31), (20, 20), (64, 128)]):
        img = _image(rng, h, w)
        got = port.host_apply(img, np.random.default_rng((1, i)))
        want = ref.host_apply(img, np.random.default_rng((1, i)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((45, 70), (32, 50)), ((20, 33), (64, 17)), ((7, 5), (7, 13)),
                                     ((100, 100), (33, 33))])
def test_numpy_resize_is_within_one_level_of_cv2(src, dst):
    img = _image(np.random.default_rng(1), *src)
    got = thost.resize_bilinear(img, *dst)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_host_stage_without_cv2_or_pil_is_within_one_level(monkeypatch):
    monkeypatch.setattr(thost, "resizer", lambda: "numpy")
    rng = np.random.default_rng(2)
    make = HOST_PIPELINES[0]
    for h, w in [(45, 70), (90, 31)]:
        img = _image(rng, h, w)
        got = T.Compose(make(T)).host_apply(img)
        want = JT.Compose(make(JT)).host_apply(img)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_numpy_resize_equals_the_native_decoder(tmp_path):
    """resize_bilinear is decode.cpp's resize_bilinear in numpy."""
    img = _image(np.random.default_rng(3), 37, 53)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img[:, :, ::-1])
    out, status = tnative.NativeDecodePool(1).decode_batch([path], 24, 31,
                                                             mode=tnative.MODE_STRETCH)
    assert status[0] == 0
    np.testing.assert_array_equal(out[0], thost.resize_bilinear(img, 24, 31))


def test_unported_device_ops_raise_a9_and_host_after_device_raises():
    pipe = T.Compose([T.LongestMaxSize(32), T.MotionBlur(), T.Normalize()])
    assert [type(t).__name__ for t in pipe.device_transforms] == ["MotionBlur", "Normalize"]
    with pytest.raises(NotImplementedError, match="not a device op of nkbx"):
        T.Compose([T.LongestMaxSize(32), type("Blur", (T.Transform,), {"stage": "device"})()])
    with pytest.raises(ValueError, match="geometry must come before"):
        T.Compose([T.HorizontalFlip(), T.Resize(8, 8)])
    assert set(T.__all__) >= set(JT.__all__)


# --- decoding ------------------------------------------------------------------------


def _bmp(path, img, bpp=24, top_down=False):
    """An uncompressed BMP written by hand (cv2 and PIL write bottom-up)."""
    h, w = img.shape[:2]
    ch = bpp // 8
    px = img[:, :, ::-1]
    if ch == 4:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=2)
    stride = (w * ch + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * ch] = px.reshape(h, w * ch)
    if not top_down:
        rows = rows[::-1]
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, rows.size,
                       2835, 2835, 0, 0)
    Path(path).write_bytes(header + info + rows.tobytes())


@pytest.mark.parametrize("h,w", [(5, 7), (33, 41), (16, 16)])
def test_bmp_reader_matches_cv2(tmp_path, h, w):
    img = _image(np.random.default_rng(h * w), h, w)
    cases = [("cv2.bmp", None), ("b24.bmp", (24, False)), ("b32.bmp", (32, False)),
             ("t24.bmp", (24, True))]
    for name, spec in cases:
        path = tmp_path / name
        if spec is None:
            cv2.imwrite(str(path), img[:, :, ::-1])
        else:
            _bmp(path, img, *spec)
        want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(tdatasets.read_bmp(path), want, err_msg=name)
        np.testing.assert_array_equal(want, img, err_msg=name)


def test_decoding_without_cv2_or_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(tdatasets, "decoder", lambda: "numpy (BMP only)")
    img = _image(np.random.default_rng(4), 9, 11)
    cv2.imwrite(str(tmp_path / "a.bmp"), img[:, :, ::-1])
    cv2.imwrite(str(tmp_path / "a.png"), img[:, :, ::-1])
    np.testing.assert_array_equal(tdatasets.imread_rgb(tmp_path / "a.bmp"), img)
    with pytest.raises(IOError, match="neither cv2 nor PIL"):
        tdatasets.imread_rgb(tmp_path / "a.png")


def test_image_size_header_probe_matches_pil(tmp_path):
    img = _image(np.random.default_rng(5), 37, 61)
    for ext in (".bmp", ".png", ".jpg", ".webp"):
        path = tmp_path / f"a{ext}"
        cv2.imwrite(str(path), img[:, :, ::-1])
        with Image.open(path) as im:
            assert tdatasets.image_size(path) == (im.size[1], im.size[0]), ext
    _bmp(tmp_path / "t.bmp", img, 24, top_down=True)
    assert tdatasets.image_size(tmp_path / "t.bmp") == (37, 61)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Nine files of varied sizes in JPEG, PNG and BMP."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(6)
    paths = []
    for i in range(9):
        path = root / f"{i}{('.jpg', '.png', '.bmp')[i % 3]}"
        cv2.imwrite(str(path), _image(rng, int(rng.integers(20, 90)), int(rng.integers(20, 90))))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("mode", [0, 1])
def test_native_decoder_matches_nkbx_bytes(image_files, mode):
    """The same decode.cpp, built by the port, gives nkbx's library's bytes;
    BMP is neither's and reports a failure status in both."""
    crops = np.full((len(image_files), 4), -1, np.int32)
    crops[1] = (2, 3, 15, 19)
    for c in (None, crops):
        got, gs = tnative.NativeDecodePool(2).decode_batch(image_files, 24, 40, crops=c, mode=mode)
        want, ws = jnative.NativeDecodePool(2).decode_batch(image_files, 24, 40, crops=c, mode=mode)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(got, want)
    assert list(gs[2::3]) != [0] * 3 and list(gs[:2]) == [0, 0]


# --- samplers ------------------------------------------------------------------------


def test_samplers_draw_what_nkbx_draws():
    labels = np.random.default_rng(7).integers(0, 4, 50)
    pairs = [(tsampler.SequentialSampler(50, 3), jsampler.SequentialSampler(50, 3)),
             (tsampler.ShuffleSampler(50, 3), jsampler.ShuffleSampler(50, 3)),
             (tsampler.ImbalancedDatasetSampler(labels=labels, seed=3),
              jsampler.ImbalancedDatasetSampler(labels=labels, seed=3)),
             (tsampler.ImbalancedDatasetSampler(labels=np.stack([labels, labels % 2], 1),
                                                num_samples=30, seed=5),
              jsampler.ImbalancedDatasetSampler(labels=np.stack([labels, labels % 2], 1),
                                                num_samples=30, seed=5))]
    for port, ref in pairs:
        assert len(port) == len(ref)
        for epoch in range(3):
            np.testing.assert_array_equal(port.indices(epoch), ref.indices(epoch))


# --- the loader ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageFolder of 3 classes x 5 files in JPEG, PNG and BMP."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(8)
    for c in range(3):
        (root / f"c{c}").mkdir()
        for i in range(5):
            img = _image(rng, int(rng.integers(30, 70)), int(rng.integers(30, 70)))
            cv2.imwrite(str(root / f"c{c}" / f"{i}{('.jpg', '.png', '.bmp')[i % 3]}"), img)
    return root


LOADER_PIPELINES = [
    lambda M: [M.LongestMaxSize(32), M.PadIfNeeded(32, 32), M.Normalize()],  # native path
    lambda M: [M.Resize(24, 28), M.HorizontalFlip(), M.Normalize()],  # native, stretch mode
    lambda M: [M.PadIfNeeded(80, 80), M.RandomCrop(30, 30), M.Normalize()],  # Python path
]


def _both(folder, make, **data):
    data = {"type": "ImageFolder", "root": str(folder), "batch_size": 4, "shuffle": True,
            "num_workers": 3, "drop_last": False, "seed": 11, **data}
    return (tloader.get_dataset(data, T.Compose(make(T))),
            jloader.get_dataset(data, JT.Compose(make(JT))))


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("make", LOADER_PIPELINES)
def test_loader_batches_match_nkbx(folder, make):
    port, ref = _both(folder, make)
    assert (port._native is None) == (ref._native is None)
    assert port.decoder.startswith("native") == (port._native is not None)
    assert len(port) == len(ref) == 4
    for epoch in range(2):
        _same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)))
    _same_batches(list(port.epoch(1, start_batch=2)), list(ref.epoch(1, start_batch=2)))
    last = list(port.epoch(0))[-1]
    assert last["mask"].tolist() == [True, True, True, False]


def test_loader_python_path_matches_the_native_path(folder):
    port, _ = _both(folder, LOADER_PIPELINES[0])
    native = list(port.epoch(0))
    port._native = None
    python = list(port.epoch(0))
    for a, b in zip(native, python):
        assert np.abs(a["image"].astype(int) - b["image"].astype(int)).max() <= 1
        np.testing.assert_array_equal(a["label"], b["label"])


def test_loader_split_over_processes_matches_nkbx(folder):
    for pi in range(2):
        kw = dict(pipeline=None, batch_size=4, shuffle=True, seed=2, process_index=pi,
                  process_count=2, image_size=None)
        port = tloader.DataLoader(tdatasets.ImageFolderDataset(folder), **kw)
        ref = jloader.DataLoader(JImageFolder(folder), **kw)
        np.testing.assert_array_equal(port._local_indices(1), ref._local_indices(1))
        assert len(port) == len(ref)


@pytest.fixture(scope="module")
def csv_file(folder, tmp_path_factory):
    rows = ["path,fold,kind,size"]
    for i, p in enumerate(sorted(folder.rglob("*.*"))):
        rows.append(f"{p},{('train', 'val')[i % 2]},{('a', 'b', 'c')[i % 3]},{i % 2}")
    path = tmp_path_factory.mktemp("csv") / "table.csv"
    path.write_text("\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("pandas", [True, False])
def test_csv_datasets_match_nkbx(csv_file, monkeypatch, pandas):
    from nkbx.data import datasets as jdatasets

    ref_s = jdatasets.AnnotatedSingletaskDataset(csv_file, "kind", fold="train")
    ref_m = jdatasets.AnnotatedMultitaskDataset(csv_file, ["size", "kind"], fold="val")
    if not pandas:  # import pandas raises, as where it is not installed
        real_import = builtins.__import__

        def no_pandas(name, *args, **kwargs):
            if name == "pandas":
                raise ImportError("no pandas")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_pandas)
    port_s = tdatasets.AnnotatedSingletaskDataset(csv_file, "kind", fold="train")
    port_m = tdatasets.AnnotatedMultitaskDataset(csv_file, ["size", "kind"], fold="val")
    monkeypatch.undo()
    for port, ref in ((port_s, ref_s), (port_m, ref_m)):
        assert port.classes == ref.classes and len(port) == len(ref)
        assert port.flat_index() == ref.flat_index()
        np.testing.assert_array_equal(np.asarray(port.get_labels()), np.asarray(ref.get_labels()))
        for i in range(len(port)):
            assert port.label_at(i) == ref.label_at(i)
    np.testing.assert_array_equal(port_s.read(0)[0], ref_s.read(0)[0])


# --- metrics -------------------------------------------------------------------------


def _epoch(seed, n, c, absent=()):
    rng = np.random.default_rng(seed)
    classes = [k for k in range(c) if k not in absent]
    gt = rng.choice(classes, n)
    logits = rng.normal(size=(n, c))
    logits[np.arange(n), gt] += 1.0
    conf = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    conf[:5] = np.round(conf[:5], 1)  # ties
    return gt, conf


METRIC_CASES = [(0, 40, 2, ()), (1, 60, 5, ()), (2, 60, 5, (1, 3)), (3, 30, 2, (0,)),
                (4, 50, 4, (0, 1, 2))]


@pytest.mark.parametrize("seed,n,c,absent", METRIC_CASES)
def test_exact_metrics_match_sklearn_and_nkbx(seed, n, c, absent):
    gt, conf = _epoch(seed, n, c, absent)
    pred = conf.argmax(1)
    assert tmetrics.balanced_accuracy(gt, pred) == balanced_accuracy_score(gt, pred)
    results = {"confidences": conf.tolist(), "predictions": pred.tolist(),
               "ground_truth": gt.tolist(), "running_loss": [0.5, 0.25]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tmetrics.compute_targetwise_metrics(results)
        want = jmetrics.compute_targetwise_metrics(results)
    assert got["epoch_acc"] == want["epoch_acc"] and got["epoch_loss"] == want["epoch_loss"]
    np.testing.assert_allclose(got["epoch_roc_auc"], want["epoch_roc_auc"], rtol=0, atol=1e-12)
    for k in set(gt) if c > 2 and len(set(gt)) > 1 else []:
        assert abs(tmetrics.roc_auc(gt == k, conf[:, k]) - roc_auc_score(gt == k, conf[:, k])) \
            <= 1e-12


def test_missing_class_warns():
    gt, conf = _epoch(2, 60, 5, (1, 3))
    with pytest.warns(UserWarning, match="less than number of classes"):
        tmetrics._roc_auc(gt, conf)


@pytest.mark.parametrize("seed,n,c,absent", METRIC_CASES)
def test_bounded_metrics_match_nkbx(seed, n, c, absent):
    gt, conf = _epoch(seed, n, c, absent)
    conf = conf.astype(np.float32)
    pred = conf.argmax(1)
    mask = np.ones(n, bool)
    mask[-3:] = False
    state = tmetrics.make_bounded_state(c)
    jstate = jmetrics.make_bounded_state(c)
    for half in (slice(0, n // 2), slice(n // 2, n)):
        args = (conf[half], pred[half], gt[half], mask[half])
        tmetrics.bounded_update(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                                torch.tensor(0.5))
        jstate = jmetrics.bounded_update(jstate, *(jnp.asarray(a) for a in args), 0.5)
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]), err_msg=k)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tmetrics.bounded_targetwise_metrics(state)
        want = jmetrics.bounded_targetwise_metrics(jstate)
    assert got["epoch_acc"] == want["epoch_acc"] and got["epoch_loss"] == want["epoch_loss"]
    np.testing.assert_array_equal(got["epoch_roc_auc"], want["epoch_roc_auc"])


# --- configs and logging -------------------------------------------------------------

CONFIGS = sorted((ROOT / "configs").glob("*.py"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_configs_load_or_name_a9(path):
    before = {k: v for k, v in sys.modules.items() if k == "nkbx" or k.startswith("nkbx.")}
    cfg = load_config(path)  # every device op of nkbx is ported: no config names A9
    pipes = [getattr(cfg, k) for k in ("train_pipeline", "val_pipeline",
                                      "inference_pipeline") if k in cfg]
    assert pipes and all(isinstance(p, T.Compose) for p in pipes)
    assert all(p.output_size() is not None for p in pipes)
    after = {k: v for k, v in sys.modules.items() if k == "nkbx" or k.startswith("nkbx.")}
    assert after.keys() == before.keys() and all(after[k] is before[k] for k in before)
    assert sys.modules["nkbx.transforms"] is JT


def test_eval_and_inference_configs_load():
    for name in ("eval_config", "inference_config"):
        cfg = load_config(ROOT / "configs" / f"{name}.py")
        assert cfg.enable_mixed_precision in (True, False)


def test_read_py_config_returns_an_import_line(tmp_path):
    path = tmp_path / "port_cfg_probe.py"
    path.write_text("import nkbx.transforms as T\npipe = T.Compose([T.Resize(8, 8)])\n")
    line = read_py_config(path)
    scope = {}
    exec(line, scope)
    assert line == "import port_cfg_probe as cfg"
    assert isinstance(scope["cfg"].pipe, T.Compose) and scope["cfg"].pipe.output_size() == (8, 8)
    del sys.modules["port_cfg_probe"]


@pytest.mark.parametrize("port_first", [False, True], ids=["nkbx_first", "port_first"])
def test_config_importing_a_sibling_loads_as_under_nkbx(tmp_path, port_first):
    """A config that imports a sibling module of its directory (nkbx puts
    the directory on sys.path) gives the same values under the port as
    under nkbx, in either load order, each side's pipeline built from its
    own transforms."""
    from nkbx.utils.config import load_config as nkbx_load_config

    sib = f"sib_aug_{int(port_first)}"
    (tmp_path / f"{sib}.py").write_text(
        "import nkbx.transforms as T\nSIZE = 16\n"
        "def pipe():\n    return T.Compose([T.Resize(SIZE, SIZE), T.HorizontalFlip(p=0.5)])\n")
    path = tmp_path / "cfg_with_sibling.py"
    path.write_text(f"import {sib}\ntrain_pipeline = {sib}.pipe()\n"
                    f"n_epochs = {sib}.SIZE // 8\nbatch_size = {sib}.SIZE * 4\n")
    loads = [load_config, nkbx_load_config]
    got, want = (f(path) for f in (loads if port_first else loads[::-1]))
    if not port_first:
        got, want = want, got
    assert got.asdict().keys() == want.asdict().keys()
    assert (got.n_epochs, got.batch_size) == (want.n_epochs, want.batch_size) == (2, 64)
    assert isinstance(got.train_pipeline, T.Compose)
    assert isinstance(want.train_pipeline, JT.Compose)
    assert ([type(t).__name__ for t in got.train_pipeline.transforms]
            == [type(t).__name__ for t in want.train_pipeline.transforms])
    assert got.train_pipeline.output_size() == (16, 16)
    assert sys.modules[sib].T is JT  # nkbx's sibling stays nkbx's after the port's load
    del sys.modules[sib]


def test_config_loaded_from_a_script_in_its_folder_keeps_main_and_plain_siblings(tmp_path):
    """A script run as the main module from the config's folder loads the
    config: while the config runs, ``__main__`` is still the script and a
    sibling that holds no transforms is still the script's own module (the
    loader re-imports only siblings holding transforms), and a sibling that
    holds transforms names the port's."""
    import subprocess

    (tmp_path / "helper_plain.py").write_text("MARK = 'as imported'\n")
    (tmp_path / "helper_aug.py").write_text("import nkbx.transforms as T\n")
    (tmp_path / "cfg_main.py").write_text(
        "import sys\nimport __main__\nimport helper_aug\nimport helper_plain\n"
        "main_mark = __main__.MARK\nmain_is_script = sys.modules['__main__'] is __main__\n"
        "helper_mark = helper_plain.MARK\naug_module = helper_aug.T.__name__\n")
    (tmp_path / "run_cfg.py").write_text(
        "import sys\nMARK = 'the script'\nimport helper_plain\n"
        "helper_plain.MARK = 'set by the script'\n"
        "from nkbx_torch.utils import load_config\n"
        "cfg = load_config('cfg_main.py')\n"
        "print(cfg.main_mark, cfg.main_is_script, cfg.helper_mark, cfg.aug_module, sep='|')\n"
        "print(sys.modules['__main__'].MARK, sys.modules['helper_plain'] is helper_plain,\n"
        "      'helper_aug' in sys.modules, 'nkbx' in sys.modules, sep='|')\n")
    proc = subprocess.run([sys.executable, "run_cfg.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-2:] == [
        "the script|True|set by the script|nkbx_torch.transforms", "the script|True|False|False"]


def test_png_writer_round_trips(tmp_path):
    img = _image(np.random.default_rng(9), 13, 17)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"))[:, :, ::-1], img)
    write_png(tmp_path / "g.png", img[:, :, 0])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE),
                                  img[:, :, 0])


def test_comet_absent_warns_and_returns_none(monkeypatch):
    """nkbx's behaviour without comet_ml: None for no section; for a section,
    nkbx's warning and None (the trainer then logs locally only)."""
    assert get_comet_experiment(None) is None
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # the import raises ImportError
    with pytest.warns(UserWarning, match="^comet_ml is not installed; continuing with local "
                                         "logging only$"):
        assert get_comet_experiment({"comet_api_cfg_path": "x.yml", "name": "x"}) is None


@pytest.fixture(scope="module")
def yolo_yaml(tmp_path_factory):
    """Four JPEG images with two boxes each, one of them under the box-size
    filter in image 3, and a YOLO yaml over them."""
    import yaml

    root = tmp_path_factory.mktemp("yolo")
    rng = np.random.default_rng(12)
    (root / "train" / "images").mkdir(parents=True)
    (root / "train" / "labels").mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(root / "train" / "images" / f"{i}.jpg"), _image(rng, 80, 100))
        w = 0.02 if i == 3 else 0.3
        (root / "train" / "labels" / f"{i}.txt").write_text(
            f"{i % 2} 0.3 0.4 0.35 0.5\n{(i + 1) % 2} 0.7 0.6 {w} 0.4\n")
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump({"path": str(root), "train": "train/images",
                                    "val": "train/images", "names": ["a", "b"]}))
    return path


@pytest.mark.parametrize("backgrounds", [False, True])
def test_yolo_dataset_and_its_native_loader_match_nkbx(yolo_yaml, backgrounds):
    from nkbx.data import datasets as jdatasets

    kw = dict(annotations_file=str(yolo_yaml), fold="train", generate_backgrounds=backgrounds,
              background_generating_prob=1.0, seed=3)
    port, ref = tdatasets.AnnotatedYOLODataset(**kw), jdatasets.AnnotatedYOLODataset(**kw)
    assert port.classes == ref.classes and port.list_bbox == ref.list_bbox
    np.testing.assert_array_equal(port.flat_index()[1], ref.flat_index()[1])
    np.testing.assert_array_equal(port.read(1)[0], ref.read(1)[0])
    pipes = [M.Compose([M.LongestMaxSize(32), M.PadIfNeeded(32, 32), M.Normalize()])
             for M in (T, JT)]
    loaders = [mod.DataLoader(ds, pipeline=p, batch_size=4, num_workers=2)
               for mod, ds, p in ((tloader, port, pipes[0]), (jloader, ref, pipes[1]))]
    assert loaders[0]._native is not None and loaders[0]._native["crops"] is not None
    _same_batches(list(loaders[0].epoch(0)), list(loaders[1].epoch(0)))


def test_groups_and_inference_datasets_match_nkbx(folder, tmp_path):
    import pickle

    from nkbx.data import datasets as jdatasets

    root = tmp_path / "groups"
    files = []
    for fine in ("c0", "c1", "c2"):
        (root / "images_lr" / fine).mkdir(parents=True)
        for p in sorted((folder / fine).iterdir()):
            (root / "images_lr" / fine / p.name).write_bytes(p.read_bytes())
            files.append(f"x/{fine}/{p.name}")
    (root / "ann.pkl").write_bytes(pickle.dumps(files))
    (root / "groups.pkl").write_bytes(pickle.dumps({"g0": ["c0", "c2"], "g1": ["c1"]}))
    kw = dict(root=str(root), ann_file="ann.pkl", dict_path=str(root / "groups.pkl"))
    port, ref = tdatasets.GroupsDataset(**kw), jdatasets.GroupsDataset(**kw)
    assert port.classes == ref.classes and port.samples == ref.samples
    port_i = tdatasets.InferDataset(folder / "c1")
    ref_i = jdatasets.InferDataset(folder / "c1")
    assert port_i.imgs == ref_i.imgs and port_i.label_at(0) == ref_i.label_at(0)
    batches = [list(mod.get_inference_dataset({"folder_path": str(folder / "c1"),
                                               "batch_size": 2}, p).epoch(0))
               for mod, p in ((tloader, T.Compose([T.Resize(16, 16)])),
                              (jloader, JT.Compose([JT.Resize(16, 16)])))]
    _same_batches(*batches)
