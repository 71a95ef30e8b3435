"""Compound detector + classifier evaluation in the port (counterpart of
``metrics/det_cls_val.py``).

The detections come from a precomputed CSV (``--detections``) in the
``predictions.csv`` schema this tool writes (image_path, xmin..ymax
normalised, conf, detection_label); ``--weights_detector`` raises:
``ultralytics`` is not a dependency of the port. The classifier is a port
``.nkbx`` bundle served by :class:`~nkbx_torch.export.ServingModule` or a
TorchScript ``.pt`` (``python -m nkbx_torch.export --to torchscript``, NCHW),
run on ``--device`` (default ``cuda``). The greedy IoU matching, the
40-threshold precision/recall sweep and the per-class AP are nkbx's. It
needs neither pandas nor sklearn: CSVs go through ``csv``, the AP is the
trapezoid rule over the sweep (sklearn's ``auc``); the data YAML is read
with PyYAML where it imports, else with
:func:`nkbx_torch.utils.flat_yaml.parse_flat_yaml`; the three figures are
drawn where matplotlib imports, else skipped with a logged note.

    python -m nkbx_torch.det_cls_val --config data.yaml \\
        --detections runs/det/predictions.csv \\
        --weights_classifier runs/train/weights/best.nkbx \\
        --output_folder runs/det_cls_val -pad [--device cpu]

It writes ``predictions.csv``, ``gt.csv`` and ``metrics.csv`` to the output
folder and prints the APs.
"""

from __future__ import annotations

import argparse
import colorsys
import csv
import hashlib
import logging
from collections import defaultdict
from pathlib import Path

import numpy as np

log = logging.getLogger("nkbx_torch.det_cls_val")

DET_COLUMNS = ["xmin", "ymin", "xmax", "ymax", "conf", "detection_label"]


def img2label_path(img_path):
    """YOLO convention: dir/images/x.jpg -> dir/labels/x.txt."""
    img_path = Path(img_path)
    return img_path.parent.parent / "labels" / img_path.with_suffix(".txt").name


def generate_color(parameter_name):
    """Deterministic per-label plot colour from an md5 hash."""
    hash_int = int(hashlib.md5(parameter_name.encode()).hexdigest(), 16)
    hue = (hash_int % 360) / 360.0
    rgb = colorsys.hls_to_rgb(hue, 0.5, 0.9)
    return "#{:02x}{:02x}{:02x}".format(int(rgb[0] * 255), int(rgb[1] * 255), int(rgb[2] * 255))


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def auc(x, y) -> float:
    """Area under y(x) by the trapezoid rule, x monotonic either way
    (sklearn.metrics.auc's contract: a decreasing x counts positive, a
    non-monotonic one raises)."""
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, but "
                         f"x.shape = {x.shape[0]}")
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1.0
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def _write_csv(path, columns, index=False):
    """A {name: values} table as a CSV (with pandas' unnamed index column
    when ``index``)."""
    names = list(columns)
    n = len(next(iter(columns.values()))) if columns else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            w.writerow(([i] if index else []) + [_cell(columns[k][i]) for k in names])


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


class Evaluator:
    def __init__(self, dataset_cfg: dict, classification_model_path=None,
                 detection_model_path=None, detections_csv=None, is_detector_single_class=False,
                 min_det_conf_threshold=0.1, nms_iou=0.2, match_iou=0.5, cls_inf_size=192,
                 pad=False, cls_batch=64, device=None):
        from nkbx_torch.core.runtime import resolve_device

        self.dataset_cfg = dataset_cfg
        self.is_detector_single_class = is_detector_single_class
        self.min_det_conf_threshold = min_det_conf_threshold
        self.nms_iou = nms_iou
        self.match_iou = match_iou
        self.cls_batch = cls_batch
        if detection_model_path is not None:
            raise NotImplementedError("--weights_detector needs ultralytics, which nkbx_torch does "
                                      "not use; pass --detections with a detections CSV")
        self.detections_csv = detections_csv
        self.classifier = None
        if classification_model_path is not None:
            self.device = resolve_device(device)
            if str(classification_model_path).endswith(".pt"):
                self._load_torchscript(classification_model_path, cls_inf_size)
                self.classifier = self._classify_torch
            else:
                from nkbx_torch.export import ServingModule

                serving = ServingModule(classification_model_path, warm_up_on_load=False,
                                        device=self.device)
                self.classifier = lambda batch: serving(batch).float().cpu().numpy()
            import nkbx_torch.transforms as T

            resizing = ([T.LongestMaxSize(cls_inf_size),
                         T.PadIfNeeded(cls_inf_size, cls_inf_size, border_mode=0, value=0)]
                        if pad else [T.Resize(cls_inf_size, cls_inf_size)])
            self.classifier_preprocess = T.Compose(
                resizing + [T.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))])
        self.all_images, self.all_labels = self.process_yolo_dataset_cfg()

    # ------------------------------------------------------------------ data

    def process_yolo_dataset_cfg(self):
        """Val images and their label files from an ultralytics data YAML:
        a txt list, an images dir, or a dir holding ``images/``."""
        self.base_path = Path(self.dataset_cfg["path"])
        val_paths = self.dataset_cfg["val"]
        if not isinstance(val_paths, list):
            val_paths = [val_paths]
        self.nc = self.dataset_cfg["nc"]
        names = self.dataset_cfg["names"]
        self.names = ({i: nm for i, nm in enumerate(names)} if isinstance(names, list)
                      else dict(names))
        all_images, all_labels = [], []
        for val_path in val_paths:
            p = self.base_path / val_path
            if p.is_file() and p.suffix == ".txt":
                with open(p, "r") as f:
                    image_paths = [Path(line.strip()) for line in f if line.strip()]
            elif p.is_dir() and p.name == "images":
                image_paths = sorted(p.iterdir())
            elif p.is_dir() and (p / "images").exists():
                image_paths = sorted((p / "images").iterdir())
            else:
                raise ValueError(f"Unsupported yolo dataset path: {p}")
            all_images.extend(image_paths)
            all_labels.extend(img2label_path(i) for i in image_paths)
        return all_images, all_labels

    # ------------------------------------------------------------- inference

    def _load_torchscript(self, path, size):
        """A TorchScript classifier (NCHW) on the device; a static-batch
        trace is found by probing, and every call pads and chunks to it."""
        import torch

        self._torch_classifier = torch.jit.load(str(path), map_location=self.device)
        self._torch_classifier.eval()

        def probe(bs):
            try:
                with torch.no_grad():
                    out = self._torch_classifier(torch.zeros(bs, 3, size, size,
                                                             device=self.device))
                if isinstance(out, (tuple, list)):
                    out = out[0]
                return out.shape[0] == bs
            except RuntimeError:
                return False

        self._torch_trace_batch = None
        if not (probe(1) and probe(2)):
            trace_b = next((b for b in range(1, 1025) if probe(b)), None)
            if trace_b is None:
                raise RuntimeError(f"TorchScript classifier {path} rejects every batch size "
                                   f"1..1024 at spatial size {size}: re-export it with "
                                   f"--input-shape B {size} {size} 3")
            self._torch_trace_batch = trace_b

    def _classify_torch(self, batch_nhwc):
        import torch

        x = batch_nhwc.float().permute(0, 3, 1, 2).contiguous()
        step = self._torch_trace_batch or x.shape[0]
        outs = []
        with torch.no_grad():
            for i in range(0, x.shape[0], step):
                chunk = x[i:i + step]
                k = chunk.shape[0]
                if k < step:
                    chunk = torch.cat([chunk, chunk.new_zeros((step - k, *chunk.shape[1:]))])
                out = self._torch_classifier(chunk)
                if isinstance(out, (tuple, list)):  # multi-task traces
                    out = out[0]
                outs.append(out[:k])
        return torch.cat(outs).float().cpu().numpy()

    def _load_detections_csv(self):
        by_img = defaultdict(list)
        with open(self.detections_csv, newline="") as f:
            for row in csv.DictReader(f):
                by_img[str(Path(row["image_path"]))].append([float(row[k]) for k in DET_COLUMNS])
        return {k: np.asarray(v, dtype=np.float64) for k, v in by_img.items()}

    def classify_crops(self, image_path, boxes_n):
        """Classify the crops of normalised boxes in one batch."""
        import torch

        from nkbx_torch.data.datasets import imread_rgb

        img = imread_rgb(image_path)
        img_h, img_w = img.shape[:2]
        boxes = boxes_n.copy()
        boxes[:, [0, 2]] *= img_w
        boxes[:, [1, 3]] *= img_h
        crops = []
        for x1, y1, x2, y2 in boxes.astype(int):
            x1, y1 = max(0, x1), max(0, y1)
            x2, y2 = min(img_w, max(x2, x1 + 1)), min(img_h, max(y2, y1 + 1))
            crops.append(self.classifier_preprocess.host_apply(img[y1:y2, x1:x2]))
        if not crops:
            return np.empty(0, dtype=int)
        batch = torch.from_numpy(np.stack(crops)).to(self.device)
        logits = self.classifier(self.classifier_preprocess.device_apply(batch))
        return np.asarray(logits).argmax(axis=1)

    def process_image(self, image_path, label_path, det_by_img):
        try:
            preds = det_by_img.get(str(Path(image_path)), np.empty((0, 6)))
            preds = preds[preds[:, 4] >= self.min_det_conf_threshold]
            gt_boxes = []
            with open(label_path, "r") as lf:
                for line in lf:
                    class_label, xc, yc, w, h = map(float, line.split())
                    gt_boxes.append([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2, class_label])
            gt_boxes = np.stack(gt_boxes) if gt_boxes else np.empty((0, 5))
        except Exception as e:
            logging.error(f"Error processing {label_path}: {e}")
            return {}
        cls = self.classify_crops(image_path, preds[:, :4]) if self.classifier is not None else None
        return {"detector_preds": preds, "classifier_preds": cls, "gt_boxes": gt_boxes}

    # ------------------------------------------------------------------ eval

    def eval(self, output_folder):
        """Match, sweep, AP; writes the CSVs (and the figures where
        matplotlib imports); returns {"det_ap", "det_cls_ap", "det_lb_aps",
        "det_cls_lb_aps", "metrics"} with ``metrics`` a {column: array}."""
        output_folder = Path(output_folder)
        det_by_img = self._load_detections_csv() if self.detections_csv else {}
        with_cls = self.classifier is not None
        pred_cols = DET_COLUMNS + (["classifier_label"] if with_cls else [])
        pred_paths, pred_rows, gt_paths, gt_rows = [], [], [], []
        for img_path, lb_path in zip(self.all_images, self.all_labels):
            results = self.process_image(img_path, lb_path, det_by_img)
            if not results:
                continue
            for i, det in enumerate(results["detector_preds"]):
                row = [det[0], det[1], det[2], det[3], det[-2], int(det[-1])]
                if with_cls:
                    row.append(int(results["classifier_preds"][i]))
                pred_paths.append(str(img_path))
                pred_rows.append(row)
            for gt in results["gt_boxes"]:
                gt_paths.append(str(img_path))
                gt_rows.append([gt[0], gt[1], gt[2], gt[3], int(gt[4])])
        gt_cols = ["xmin", "ymin", "xmax", "ymax", "label"]
        _write_csv(output_folder / "predictions.csv",
                   {"image_path": pred_paths,
                    **{c: [r[j] for r in pred_rows] for j, c in enumerate(pred_cols)}})
        _write_csv(output_folder / "gt.csv",
                   {"image_path": gt_paths,
                    **{c: [r[j] for r in gt_rows] for j, c in enumerate(gt_cols)}})
        logging.info(f"Saved predictions to {output_folder}")

        n_pred_cols = len(pred_cols)
        pred_info_all = np.asarray(pred_rows, dtype=np.float64).reshape(-1, n_pred_cols)
        gt_info_all = np.asarray(gt_rows, dtype=np.float64).reshape(-1, 5)
        pred_paths, gt_paths = np.asarray(pred_paths, dtype=object), np.asarray(gt_paths,
                                                                               dtype=object)
        # greedy IoU matching: each prediction matches its argmax-IoU GT above match_iou
        matched_dets, unmatched_dets, unmatched_gts, matched_gts = [], [], [], []
        for img_path in dict.fromkeys(gt_paths.tolist()):
            gt_info = gt_info_all[gt_paths == img_path]
            pred_info = pred_info_all[pred_paths == img_path]
            iou = box_iou(pred_info[:, :4], gt_info[:, :4])
            gt_idxs = []
            for i in range(len(pred_info)):
                if iou.shape[1] == 0:
                    unmatched_dets.append(pred_info[i])
                    continue
                gt_idx = int(np.argmax(iou[i]))
                if iou[i, gt_idx] > self.match_iou:
                    matched_dets.append(np.concatenate([pred_info[i], gt_info[gt_idx]]))
                    matched_gts.append(gt_info[gt_idx])
                    gt_idxs.append(gt_idx)
                else:
                    unmatched_dets.append(pred_info[i])
            for j, gt_box in enumerate(gt_info):
                if j not in gt_idxs:
                    unmatched_gts.append(gt_box)
        matched_dets = np.stack(matched_dets) if matched_dets else np.empty((0, n_pred_cols + 5))
        unmatched_dets = np.stack(unmatched_dets) if unmatched_dets else np.empty((0, n_pred_cols))
        unmatched_gts = np.stack(unmatched_gts) if unmatched_gts else np.empty((0, 5))
        matched_gts = np.stack(matched_gts) if matched_gts else np.empty((0, 5))

        # the 40-threshold confidence sweep
        thresholds = np.linspace(self.min_det_conf_threshold, 0.95, num=40, endpoint=True)
        gt_labels = set(gt_info_all[:, 4].astype(int).tolist())
        skip_labels = [label for i, label in self.names.items() if i not in gt_labels]
        n_gt = len(matched_gts) + len(unmatched_gts)
        metrics = defaultdict(list)
        fp_label = self.nc  # the classifier's background class index
        gt_lb_idx = n_pred_cols + 4  # the GT label's column in matched rows
        cls_idx = 6
        for thr in thresholds:
            m_thr = matched_dets[matched_dets[:, 4] > thr]
            u_thr = unmatched_dets[unmatched_dets[:, 4] > thr]
            metrics["det_pr"].append(len(m_thr) / (len(m_thr) + len(u_thr) + 1e-6))
            metrics["det_recall"].append(len(m_thr) / (n_gt + 1e-6))
            metrics["threshold"].append(thr)
            if with_cls:
                # drop what the classifier calls background (the false-positive filter)
                u_cls = u_thr[u_thr[:, cls_idx] != fp_label]
                m_cls = m_thr[m_thr[:, cls_idx] != fp_label]
                metrics["det_cls_pr"].append(len(m_cls) / (len(u_cls) + len(m_cls) + 1e-6))
                metrics["det_cls_recall"].append(len(m_cls) / (n_gt + 1e-6))
                lb_cls_m = m_cls[m_cls[:, cls_idx] == m_cls[:, gt_lb_idx]]
                lb_cls_u = m_cls[m_cls[:, cls_idx] != m_cls[:, gt_lb_idx]]
            if not self.is_detector_single_class:
                lb_det_m = m_thr[m_thr[:, 5] == m_thr[:, gt_lb_idx]]
                lb_det_u = m_thr[m_thr[:, 5] != m_thr[:, gt_lb_idx]]
            for i, label in self.names.items():
                if label in skip_labels:
                    continue
                n_gt_i = (matched_gts[:, 4] == i).sum() + (unmatched_gts[:, 4] == i).sum()
                if not self.is_detector_single_class:
                    tp = (lb_det_m[:, 5] == i).sum()
                    fp = (lb_det_u[:, 5] == i).sum() + (u_thr[:, 5] == i).sum()
                    metrics[f"{label}_det_pr"].append(tp / (tp + fp + 1e-6))
                    metrics[f"{label}_det_recall"].append(tp / (n_gt_i + 1e-6))
                if with_cls:
                    tp = (lb_cls_m[:, cls_idx] == i).sum()
                    fp = (lb_cls_u[:, cls_idx] == i).sum() + (u_cls[:, cls_idx] == i).sum()
                    metrics[f"{label}_det_cls_pr"].append(tp / (tp + fp + 1e-6))
                    metrics[f"{label}_det_cls_recall"].append(tp / (n_gt_i + 1e-6))
        metrics = {k: np.asarray(v, dtype=np.float64) for k, v in metrics.items()}
        _write_csv(output_folder / "metrics.csv", metrics, index=True)

        det_ap = auc(metrics["det_recall"], metrics["det_pr"])
        det_cls_ap = auc(metrics["det_cls_recall"], metrics["det_cls_pr"]) if with_cls else None
        det_lb_aps, det_cls_lb_aps = {}, {}
        for label in self.names.values():
            if label in skip_labels:
                continue
            if not self.is_detector_single_class:
                det_lb_aps[label] = auc(metrics[f"{label}_det_recall"],
                                        metrics[f"{label}_det_pr"])
            if with_cls:
                det_cls_lb_aps[label] = auc(metrics[f"{label}_det_cls_recall"],
                                            metrics[f"{label}_det_cls_pr"])
        self._plot(output_folder, metrics, skip_labels, det_ap, det_cls_ap, det_lb_aps,
                   det_cls_lb_aps)

        if with_cls:
            print(f"Single class metrics AP: detection {det_ap:.3f}, detection + "
                  f"classification {det_cls_ap:.3f}")
        else:
            print(f"Single class metrics AP: detection {det_ap:.3f}")
        for label in self.names.values():
            if label in skip_labels:
                continue
            parts = []
            if not self.is_detector_single_class:
                parts.append(f"detection {det_lb_aps[label]:.3f}")
            if with_cls:
                parts.append(f"detection + classification {det_cls_lb_aps[label]:.3f}")
            if parts:
                print(f"Class {label} metrics AP: " + ", ".join(parts))
        return {"det_ap": det_ap, "det_cls_ap": det_cls_ap, "det_lb_aps": det_lb_aps,
                "det_cls_lb_aps": det_cls_lb_aps, "metrics": metrics}

    # ------------------------------------------------------------------ plots

    def _plot(self, out, metrics, skip_labels, det_ap, det_cls_ap, det_lb_aps, det_cls_lb_aps):
        """PR_curves.png, recall_curves.png and precision_curves.png, where
        matplotlib imports."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            log.info("matplotlib is not installed: the PR, recall and precision figures are "
                     "not drawn")
            return
        with_cls = self.classifier is not None
        labels = [lb for lb in self.names.values() if lb not in skip_labels]
        at = f"@{self.match_iou:.2f}"

        def series(x_of, y_of, with_ap):
            """(x, y, marker, legend label, colour) of every curve."""
            rows = [(x_of("det"), y_of("det"), "o", "Single class detection"
                     + (f" AP{at}={det_ap:.3f}" if with_ap else ""),
                     generate_color("Single_class"))]
            if with_cls:
                rows.append((x_of("det_cls"), y_of("det_cls"), "x",
                             "Single class detection + classification"
                             + (f" AP{at}={det_cls_ap:.3f}" if with_ap else ""),
                             generate_color("Single class" if with_ap else "Single_class")))
            for label in labels:
                if not self.is_detector_single_class:
                    rows.append((x_of(f"{label}_det"), y_of(f"{label}_det"), "o",
                                 f"{label} Detection"
                                 + (f" AP{at}={det_lb_aps[label]:.3f}" if with_ap else ""),
                                 generate_color(label)))
                if with_cls:
                    rows.append((x_of(f"{label}_det_cls"), y_of(f"{label}_det_cls"), "x",
                                 f"{label} Detection + classification"
                                 + (f" AP{at}={det_cls_lb_aps[label]:.3f}" if with_ap else ""),
                                 generate_color(label)))
            return rows

        def figure(rows, title, xlabel, ylabel, fname):
            fig, ax = plt.subplots(figsize=(8, 8))
            for x, y, marker, lbl, color in rows:
                ax.plot(x, y, marker=marker, linestyle="-", label=lbl, color=color)
            ax.set_title(title)
            ax.set_xlabel(xlabel)
            ax.set_ylabel(ylabel)
            ax.legend()
            ax.set_xlim([0.0, 1.0])
            ax.set_ylim([0.0, 1.0])
            ax.grid(True)
            fig.savefig(Path(out) / fname)
            plt.close(fig)

        map_txt = f"mAP{at}"
        if det_lb_aps:
            map_txt += f": det {np.mean(list(det_lb_aps.values())):.3f}"
        if det_cls_lb_aps:
            map_txt += f" det+cls {np.mean(list(det_cls_lb_aps.values())):.3f}"
        figure(series(lambda k: metrics[f"{k}_recall"], lambda k: metrics[f"{k}_pr"], True),
               f"Precision-Recall Curve, {map_txt}", "Recall", "Precision", "PR_curves.png")
        thr = metrics["threshold"]
        figure(series(lambda k: thr, lambda k: metrics[f"{k}_recall"], False), "Recall Curve",
               "threshold", "Recall", "recall_curves.png")
        figure(series(lambda k: thr, lambda k: metrics[f"{k}_pr"], False), "Precision Curve",
               "threshold", "Precision", "precision_curves.png")


def main(argv=None):
    from nkbx_torch.utils.flat_yaml import load_yaml

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(
        description="Validation of detection and detection+classification results.")
    parser.add_argument("--config", type=str, required=True, help="ultralytics data YAML")
    parser.add_argument("--weights_detector", type=str, default=None,
                        help="YOLO detector weights: not taken by the port (needs ultralytics)")
    parser.add_argument("--detections", type=str, default=None,
                        help="precomputed detections CSV (image_path, xmin..ymax normalized, "
                             "conf, detection_label)")
    parser.add_argument("--detector_single_class", action="store_true")
    parser.add_argument("--weights_classifier", type=str, default=None,
                        help="classifier: a port .nkbx serving bundle, or a TorchScript .pt "
                             "(python -m nkbx_torch.export --to torchscript)")
    parser.add_argument("--iou_threshold", type=float, default=0.5, help="match IoU")
    parser.add_argument("--img_size", type=int, default=192)
    parser.add_argument("--nms_iou_threshold", type=float, default=0.2)
    parser.add_argument("--conf_threshold", type=float, default=0.1)
    parser.add_argument("--output_folder", type=str, default="runs/predict")
    parser.add_argument("-pad", action="store_true",
                        help="LongestMaxSize+Pad instead of Resize for crops")
    parser.add_argument("--device", type=str, default=None,
                        help="where the classifier runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if not (args.weights_detector or args.detections):
        parser.error("need --detections (or --weights_detector, which the port does not take)")
    output_folder = Path(args.output_folder)
    output_folder.mkdir(exist_ok=True, parents=True)
    evaluator = Evaluator(
        dataset_cfg=load_yaml(args.config),
        classification_model_path=args.weights_classifier,
        detection_model_path=args.weights_detector,
        detections_csv=args.detections,
        is_detector_single_class=args.detector_single_class,
        min_det_conf_threshold=args.conf_threshold,
        nms_iou=args.nms_iou_threshold,
        match_iou=args.iou_threshold,
        cls_inf_size=args.img_size,
        pad=args.pad,
        device=args.device,
    )
    return evaluator.eval(output_folder)


if __name__ == "__main__":
    main()
