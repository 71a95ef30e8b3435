"""The port's det_cls_val against ``metrics/det_cls_val.py``, on the CPU.

- ``box_iou`` and the trapezoid AP (``auc``) against nkbx's and sklearn's.
- A YOLO-layout fixture (4 PNG images, 2 classes, one image without a box)
  and a detections CSV with matches of the right and the wrong class, false
  positives, a miss and a detection under the confidence floor: the
  detector-only evaluation, and the detector + classifier evaluation with a
  TorchScript ``.pt`` classifier (a port ``resnet_tiny_test`` with a
  background class, exported with ``--to torchscript``) that both tools
  load, give the same predictions.csv, gt.csv, every column of the sweep
  and every AP (1e-9). The port's ``.nkbx`` bundle of the same weights
  labels the crops as the ``.pt`` does.
- The flat YAML reader against ``yaml.safe_load`` on the forms ultralytics
  data files use; the CLI on a bundle (``--device cpu``); the detector
  route refused.
"""

import csv
import importlib.util
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from nkbx_torch import det_cls_val as port
from nkbx_torch.export.bundle import export_model
from nkbx_torch.export.torchscript import export_torchscript
from nkbx_torch.models import get_model
from nkbx_torch.utils.flat_yaml import load_yaml, parse_flat_yaml

ROOT = Path(__file__).resolve().parents[1]


def _nkbx_module():
    spec = importlib.util.spec_from_file_location("nkbx_metrics_det_cls_val",
                                                  ROOT / "metrics" / "det_cls_val.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


theirs = _nkbx_module()


def test_box_iou_matches_nkbx():
    rng = np.random.default_rng(0)
    a, b = rng.random((9, 4)) * 100, rng.random((6, 4)) * 100
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(port.box_iou(a, b), theirs.box_iou(a, b))
    assert port.box_iou(np.empty((0, 4)), b).shape == (0, 6)
    assert port.img2label_path(Path("/d/val/images/p.png")) == Path("/d/val/labels/p.txt")
    assert port.generate_color("dog") == theirs.generate_color("dog")


def test_auc_matches_sklearn():
    from sklearn.metrics import auc

    rng = np.random.default_rng(1)
    down = np.sort(rng.random(40))[::-1]
    up = np.sort(rng.random(40))
    y = rng.random(40)
    for x in (down, up, np.repeat(down[:20], 2)):
        assert port.auc(x, y) == pytest.approx(auc(x, y), abs=1e-12)
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        port.auc(rng.random(10), y[:10])


def _write_fixture(root):
    """4 PNGs (one without boxes), labels, and detections of every kind."""
    rng = np.random.default_rng(3)
    (root / "val" / "images").mkdir(parents=True)
    (root / "val" / "labels").mkdir(parents=True)
    gts = {0: ["0 0.3 0.3 0.3 0.3", "1 0.7 0.7 0.3 0.3"], 1: ["1 0.5 0.5 0.5 0.4"],
           2: ["0 0.25 0.6 0.3 0.5", "0 0.75 0.4 0.3 0.4", "1 0.5 0.15 0.2 0.2"], 3: []}
    for i, lines in gts.items():
        cv2.imwrite(str(root / "val" / "images" / f"{i}.png"),
                    rng.integers(0, 256, (80 + 10 * i, 100, 3), dtype=np.uint8))
        (root / "val" / "labels" / f"{i}.txt").write_text("".join(f"{ln}\n" for ln in lines))
    img = [str(root / "val" / "images" / f"{i}.png") for i in range(4)]
    rows = ["image_path,xmin,ymin,xmax,ymax,conf,detection_label",
            f"{img[0]},0.16,0.14,0.44,0.46,0.91,0",   # match, right class
            f"{img[0]},0.55,0.56,0.86,0.84,0.62,0",   # match, wrong class
            f"{img[0]},0.0,0.0,0.1,0.1,0.35,1",       # false positive
            f"{img[1]},0.26,0.31,0.74,0.69,0.77,1",   # match
            f"{img[1]},0.3,0.3,0.7,0.7,0.05,1",       # under the confidence floor
            f"{img[2]},0.1,0.35,0.4,0.85,0.58,0",     # match
            f"{img[2]},0.62,0.2,0.88,0.6,0.44,1",     # match, wrong class
            f"{img[2]},0.4,0.8,0.6,1.0,0.83,1",       # false positive
            f"{img[3]},0.2,0.2,0.5,0.5,0.66,0"]       # an image without boxes
    (root / "det.csv").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "val": "val/images", "nc": 2, "names": ["cat", "dog"]}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcv")
    cfg = _write_fixture(root)
    model = get_model({"model": "resnet_tiny_test"}, ["cat", "dog", "background"],
                      input_size=(32, 32), seed=2, dtype=torch.float32, device="cpu")
    pt, _ = export_torchscript(model, root / "cls.pt", (4, 32, 32, 3))
    bundle, _ = export_model(model, (8, 32, 32, 3), root / "cls.nkbx")
    return root, cfg, pt, bundle


def _rows(path):
    with open(path, newline="") as f:
        return [[float(v) if v.replace(".", "", 1).replace("-", "").isdigit() else v
                 for v in row] for row in csv.reader(f)]


def _eval(module, cfg, root, out, classifier=None, **kw):
    out.mkdir()
    ev = module.Evaluator(dataset_cfg=cfg, detections_csv=str(root / "det.csv"),
                          classification_model_path=None if classifier is None else str(classifier),
                          cls_inf_size=32, min_det_conf_threshold=0.1, match_iou=0.5, **kw)
    return ev.eval(out)


@pytest.mark.parametrize("with_classifier", [False, True])
def test_evaluation_matches_nkbx(with_classifier, fixture, tmp_path):
    root, cfg, pt, _ = fixture
    cls = pt if with_classifier else None
    want = _eval(theirs, cfg, root, tmp_path / "nkbx", cls)
    got = _eval(port, cfg, root, tmp_path / "port", cls, device="cpu")
    for name in ("predictions.csv", "gt.csv"):
        assert _rows(tmp_path / "port" / name) == _rows(tmp_path / "nkbx" / name), name
    m = want["metrics"]
    assert list(got["metrics"]) == list(m.columns)
    for col in m.columns:
        np.testing.assert_allclose(got["metrics"][col], m[col].to_numpy(), rtol=0, atol=1e-9,
                                   err_msg=col)
    assert got["det_ap"] == pytest.approx(want["det_ap"], abs=1e-9)
    assert got["det_lb_aps"].keys() == want["det_lb_aps"].keys() == {"cat", "dog"}
    for k in want["det_lb_aps"]:
        assert got["det_lb_aps"][k] == pytest.approx(want["det_lb_aps"][k], abs=1e-9)
    if with_classifier:
        assert got["det_cls_ap"] == pytest.approx(want["det_cls_ap"], abs=1e-9)
        for k in want["det_cls_lb_aps"]:
            assert got["det_cls_lb_aps"][k] == pytest.approx(want["det_cls_lb_aps"][k],
                                                             abs=1e-9)
    else:
        assert got["det_cls_ap"] is None and want["det_cls_ap"] is None
    assert (tmp_path / "port" / "PR_curves.png").exists()  # matplotlib is installed here


def test_bundle_classifier_labels_as_the_torchscript_one(fixture, tmp_path):
    root, cfg, pt, bundle = fixture
    labels = {}
    for name, cls in (("pt", pt), ("bundle", bundle)):
        _eval(port, cfg, root, tmp_path / name, cls, device="cpu")
        with open(tmp_path / name / "predictions.csv", newline="") as f:
            labels[name] = [r["classifier_label"] for r in csv.DictReader(f)]
    assert labels["pt"] == labels["bundle"] and len(labels["pt"]) == 8


def test_cli_on_a_bundle_and_the_refused_detector(fixture, tmp_path, capsys):
    root, cfg, _, bundle = fixture
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(cfg))
    res = port.main(["--config", str(data), "--detections", str(root / "det.csv"),
                     "--weights_classifier", str(bundle), "--img_size", "32", "-pad",
                     "--output_folder", str(tmp_path / "out"), "--device", "cpu"])
    assert np.isfinite(res["det_ap"]) and np.isfinite(res["det_cls_ap"])
    for name in ("predictions.csv", "gt.csv", "metrics.csv"):
        assert (tmp_path / "out" / name).exists()
    assert "detection + classification" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ultralytics"):
        port.Evaluator(dataset_cfg=cfg, detection_model_path="yolo.pt")


YAML_FORMS = {
    "mapping": """
        # ultralytics data file
        path: .          # dataset root
        train: [data1/train/images/, data2/]
        val: [data_val/val/images/]
        nc: 2
        names:
          0: cat
          1: dog
        download: https://example.com/set.zip
    """,
    "list": """
        path: /data/yolo
        train: train/images
        val: val/images
        names: [cat, dog, "bird"]
    """,
    "flow-mapping": """
        path: '.'
        train: images/train
        val: images/val
        nc: 3
        names: {0: cat, 1: dog, 2: bird}
    """,
    "block-list": """
        path: ../datasets/x
        train:
          - a/images
          - b/images
        val: c/images
        names:
          - person
          - car
    """,
}


@pytest.mark.parametrize("form", sorted(YAML_FORMS))
def test_flat_yaml_reader_matches_safe_load(form, tmp_path):
    text = textwrap.dedent(YAML_FORMS[form])
    assert parse_flat_yaml(text) == yaml.safe_load(text)
    (tmp_path / "d.yaml").write_text(text)
    assert load_yaml(tmp_path / "d.yaml") == yaml.safe_load(text)


def test_flat_yaml_reader_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="unsupported"):
        parse_flat_yaml("names: [a,\n  b]\n")
    with pytest.raises(ValueError, match="unsupported"):
        parse_flat_yaml("path: x\n  nested: 1\n")
