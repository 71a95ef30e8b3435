"""Dataset readers (counterpart of ``nkbx/data/datasets.py``): CSV single-
and multi-task, ImageFolder, YOLO-bbox crops, Groups and folder inference,
with nkbx's config keys and scan order. Each emits uint8 RGB HWC numpy
images and integer labels.

A reader implements ``__len__``, ``read(idx, rng=None) -> (image, label)``,
``get_labels()``, ``flat_index() -> (paths, crops)`` (the native decoder's
batch index), ``label_at(idx)`` and ``classes`` / ``class_to_idx`` /
``idx_to_class``.

Images decode through cv2, then PIL, as nkbx's do (:func:`decoder` names
the one this host has). Where neither is installed, :func:`read_bmp` reads
uncompressed 24- and 32-bit BMP files with numpy, and any other file raises.
CSV tables go through pandas where it is installed, else through the
``csv`` module with pandas' number inference (:func:`read_table`).
"""

from __future__ import annotations

import csv
import functools
import glob
import io
import os
import pickle as pkl
import struct
import threading
import zipfile
from pathlib import Path

import numpy as np

from nkbx_torch.utils import get_classes_configs, load_classes

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


@functools.lru_cache(maxsize=None)
def decoder() -> str:
    """The library that decodes single images on this host: "cv2", "PIL"
    or "numpy (BMP only)"."""
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            return name
        except ImportError:
            continue
    return "numpy (BMP only)"


def read_bmp(path) -> np.ndarray:
    """An uncompressed 24- or 32-bit BMP (BI_RGB, or BI_BITFIELDS with BGRA
    masks) as uint8 RGB HWC."""
    data = Path(path).read_bytes()
    if data[:2] != b"BM" or len(data) < 54:
        raise IOError(f"{path} is not a BMP file")
    offset, = struct.unpack_from("<I", data, 10)
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    bgra = (0x00FF0000, 0x0000FF00, 0x000000FF)
    if bpp not in (24, 32) or not (compression == 0 or (
            compression == 3 and bpp == 32 and struct.unpack_from("<III", data, 54) == bgra)):
        raise IOError(f"{path}: only uncompressed 24/32-bit BMP is read without cv2 or PIL "
                      f"(got {bpp} bits, compression {compression})")
    h, w, ch = abs(height), width, bpp // 8
    stride = (w * ch + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset).reshape(h, stride)
    img = rows[:, :w * ch].reshape(h, w, ch)[:, :, 2::-1]  # BGR(A) -> RGB
    return np.ascontiguousarray(img if height < 0 else img[::-1])  # positive height: bottom-up


def imread_rgb(path) -> np.ndarray:
    """Decode an image file to uint8 RGB HWC: cv2, else PIL, else the numpy
    BMP reader."""
    lib = decoder()
    if lib == "cv2":
        import cv2

        img = cv2.imread(str(path))
        if img is None:
            raise IOError(f"cv2 failed to read {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if lib == "PIL":
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    if Path(path).suffix.lower() != ".bmp":
        raise IOError(f"cannot decode {path}: neither cv2 nor PIL is installed, and without "
                      "them only uncompressed BMP is read")
    return read_bmp(path)


def _jpeg_size(f):
    f.seek(2)
    while True:
        marker = f.read(2)
        if len(marker) < 2 or marker[0] != 0xFF:
            return None
        while marker[1] == 0xFF:  # fill bytes
            marker = marker[1:] + f.read(1)
        length, = struct.unpack(">H", f.read(2))
        if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">xHH", f.read(5))
            return h, w
        f.seek(length - 2, 1)


def image_size(path):
    """(height, width) from the file's header: BMP, PNG and JPEG without any
    library, other formats through PIL."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head[:2] == b"BM":
            w, h = struct.unpack_from("<ii", head, 18)
            return abs(h), w
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            w, h = struct.unpack_from(">II", head, 16)
            return h, w
        if head[:2] == b"\xff\xd8":
            size = _jpeg_size(f)
            if size is not None:
                return size
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def _column(values):
    """A CSV column as pandas infers it: int64, else float64, else str."""
    for kind in (int, float):
        try:
            return np.asarray([kind(v) for v in values])
        except ValueError:
            continue
    return np.asarray(values, dtype=object)


def read_table(path):
    """A CSV file as {column: numpy array}: pandas where installed, else the
    ``csv`` module."""
    try:
        import pandas as pd
    except ImportError:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        names = list(rows[0]) if rows else []
        return {c: _column([r[c] for r in rows]) for c in names}
    table = pd.read_csv(path)
    return {c: table[c].values for c in table.columns}


def _select_fold(table, fold):
    keep = table["fold"] == fold
    return {c: v[keep] for c, v in table.items()}


def _paths(table, image_base_dir):
    if image_base_dir is not None:
        return [str(Path(image_base_dir) / p) for p in table["path"]]
    return [str(p) for p in table["path"]]


class AnnotatedSingletaskDataset:
    """CSV-table single-target dataset: columns ``path``, ``fold`` and
    ``target_column``; rows filtered by ``fold``; classes given or inferred
    as the sorted unique values; ``image_base_dir`` prefixes the paths."""

    def __init__(self, annotations_file, target_column, fold="test",
                 image_base_dir=None, classes=None, **kwargs):
        self.table = _select_fold(read_table(annotations_file), fold)
        self.target_column = target_column
        if classes is not None:
            self.classes = load_classes(classes)
        else:
            self.classes = np.sort(np.unique(self.table[target_column])).tolist()
        self.class_to_idx, self.idx_to_class = get_classes_configs(self.classes)
        self.paths = _paths(self.table, image_base_dir)
        self.labels = np.asarray([self.class_to_idx[v] for v in self.table[target_column]],
                                 dtype=np.int64)

    def __len__(self):
        return len(self.paths)

    def read(self, idx, rng=None):
        return imread_rgb(self.paths[idx]), int(self.labels[idx])

    def get_labels(self):
        return self.table[self.target_column]

    def flat_index(self):
        return self.paths, None

    def label_at(self, idx):
        return int(self.labels[idx])


class AnnotatedMultitaskDataset:
    """CSV-table multi-target dataset: ``target_names`` sorted, classes per
    target given or inferred, labels ``{target: int}``."""

    def __init__(self, annotations_file, target_names, fold="test",
                 image_base_dir=None, classes=None, **kwargs):
        self.table = _select_fold(read_table(annotations_file), fold)
        self.target_names = [*sorted(target_names)]
        if classes is not None:
            self.classes = load_classes(classes)
        else:
            self.classes = {t: np.sort(np.unique(self.table[t])).tolist()
                            for t in self.target_names}
        self.class_to_idx, self.idx_to_class = get_classes_configs(self.classes)
        self.paths = _paths(self.table, image_base_dir)
        self.labels = {t: np.asarray([self.class_to_idx[t][v] for v in self.table[t]],
                                     dtype=np.int64) for t in self.target_names}

    def __len__(self):
        return len(self.paths)

    def read(self, idx, rng=None):
        return imread_rgb(self.paths[idx]), self.label_at(idx)

    def get_labels(self):
        return np.stack([self.table[t] for t in self.target_names], axis=1)

    def flat_index(self):
        return self.paths, None

    def label_at(self, idx):
        return {t: int(self.labels[t][idx]) for t in self.target_names}


class ImageFolderDataset:
    """torchvision-ImageFolder layout: root/<class>/<img>."""

    def __init__(self, root, **kwargs):
        self.root = Path(root)
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"No class directories under {root}")
        self.class_to_idx, self.idx_to_class = get_classes_configs(self.classes)
        self.samples = []
        for cls in self.classes:
            for p in sorted((self.root / cls).rglob("*")):
                if p.suffix.lower() in IMG_EXTENSIONS:
                    self.samples.append((str(p), self.class_to_idx[cls]))
        self.imgs = self.samples  # torchvision alias

    def __len__(self):
        return len(self.samples)

    def read(self, idx, rng=None):
        path, label = self.samples[idx]
        return imread_rgb(path), label

    def get_labels(self):
        return np.asarray([lb for _, lb in self.samples])

    def flat_index(self):
        return [p for p, _ in self.samples], None

    def label_at(self, idx):
        return self.samples[idx][1]


class AnnotatedYOLODataset:
    """YOLO detection dataset as bbox-crop classification samples: an
    ultralytics YAML (``path``/``train``/``val``/``test``/``names``, optional
    ``download``), ``images/`` beside ``labels/``, xywhn to clipped xyxy,
    the ``min_box_size`` filter, and optional ``<GENERATED>_background``
    crops that miss every true box (up to 1000 placements an image,
    probability 1/n_classes by default)."""

    ATTEMPTS = 1000

    def __init__(self, annotations_file, fold="train", image_base_dir=None,
                 min_box_size=5, generate_backgrounds=False,
                 background_generating_prob=None, background_crop_sizes=(0.1, 0.3),
                 seed=0, **kwargs):
        from nkbx_torch.utils.flat_yaml import load_yaml

        if fold not in ("train", "val", "test"):
            raise ValueError(f"Got fold equals {fold}")
        self.fold = fold
        self.min_box_size = min_box_size
        if not os.path.exists(annotations_file):
            raise FileNotFoundError(f"Annotations file {annotations_file} does not exist.")
        self.yaml_data = load_yaml(annotations_file)  # PyYAML, else the flat reader

        names = self.yaml_data["names"]
        self.idx_to_class = ({i: lb for i, lb in enumerate(names)} if isinstance(names, list)
                             else dict(names))
        if set(self.idx_to_class) != set(range(len(self.idx_to_class))):
            raise ValueError("Class indices should form range(0, num_classes) without skips")
        self.classes = [self.idx_to_class[i] for i in range(len(self.idx_to_class))]
        self.class_to_idx = {lb: i for i, lb in self.idx_to_class.items()}
        if generate_backgrounds:
            bg_lb = "<GENERATED>_background"
            self.class_to_idx[bg_lb] = len(self.classes)
            self.idx_to_class[len(self.classes)] = bg_lb
            self.classes.append(bg_lb)
        if background_generating_prob is None:
            background_generating_prob = 1 / len(self.classes)

        folds = self.yaml_data[fold]
        if not isinstance(folds, list):
            folds = [folds]
        base = Path(image_base_dir) if image_base_dir is not None else Path("/")
        image_dirs = [base / self.yaml_data["path"] / p for p in folds]
        if len(image_dirs) == 1 and "download" in self.yaml_data and not image_dirs[0].is_dir():
            self._download(self.yaml_data["download"], base / self.yaml_data["path"])
        img_paths = self.scan_img_files(image_dirs)

        rng = np.random.default_rng(seed)
        self.list_bbox = []
        for image_filename in sorted(img_paths):
            image_filename = Path(image_filename)
            if image_filename.suffix.lower() not in IMG_EXTENSIONS:
                continue
            labels_dir = image_filename.parent.parent / "labels"
            if not labels_dir.is_dir():
                raise FileNotFoundError(f"Directory {labels_dir} does not exist")
            txt_file = labels_dir / (image_filename.stem + ".txt")
            if not txt_file.is_file():
                continue
            with open(txt_file, "r") as fp:
                lines = [ln for ln in fp.read().splitlines() if ln.strip()]
            img_h, img_w = image_size(image_filename)
            boxes = []
            for line in lines:
                parts = line.split()
                label = int(parts[0])
                box = self.bbox_xywhn2xyxy(*map(float, parts[1:5]), (img_h, img_w))
                boxes.append(box)
                if self._box_ok(*box):
                    self.list_bbox.append((str(image_filename), box, label))
            if generate_backgrounds and rng.random() <= background_generating_prob:
                bg = self._place_background(rng, img_h, img_w, boxes, background_crop_sizes)
                if bg is not None:
                    self.list_bbox.append((str(image_filename), bg,
                                           self.class_to_idx["<GENERATED>_background"]))

    @staticmethod
    def _download(url, dest, retries: int = 3):
        """Fetch and extract the dataset's zip, with retries."""
        import time

        import requests

        last_err = None
        for attempt in range(retries):
            try:
                r = requests.get(url, timeout=120)
                r.raise_for_status()
                zipfile.ZipFile(io.BytesIO(r.content)).extractall(dest)
                return
            except (requests.RequestException, zipfile.BadZipFile, OSError) as e:
                last_err = e
                time.sleep(2**attempt)
        raise RuntimeError(f"Failed to download {url} after {retries} attempts") from last_err

    def scan_img_files(self, img_dirs):
        """Directories recursed, .txt lists expanded (ultralytics convention)."""
        files = []
        for p in img_dirs if isinstance(img_dirs, list) else [img_dirs]:
            p = Path(p)
            if p.is_dir():
                files += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p) as t:
                    parent = str(p.parent) + os.sep
                    for x in t.read().strip().splitlines():
                        files.append(x.replace("./", parent) if x.startswith("./") else x)
            else:
                raise FileNotFoundError(f"{p} does not exist")
        imgs = sorted(x for x in files if x.lower().endswith(IMG_EXTENSIONS))
        if not imgs:
            raise FileNotFoundError(f"No images found in {img_dirs}")
        return imgs

    @staticmethod
    def bbox_xywhn2xyxy(x_center, y_center, width, height, image_size):
        ih, iw = image_size
        x_min = int(np.clip(int((x_center - width / 2) * iw), 0, iw))
        y_min = int(np.clip(int((y_center - height / 2) * ih), 0, ih))
        x_max = int(np.clip(int((x_center + width / 2) * iw), 0, iw))
        y_max = int(np.clip(int((y_center + height / 2) * ih), 0, ih))
        return (x_min, y_min, x_max, y_max)

    @staticmethod
    def bbox_intersect(b1, b2):
        if b1[2] < b2[0] or b2[2] < b1[0]:
            return False
        if b1[3] < b2[1] or b2[3] < b1[1]:
            return False
        return True

    def _box_ok(self, x_min, y_min, x_max, y_max):
        return (x_max - x_min) >= self.min_box_size and (y_max - y_min) >= self.min_box_size

    def _place_background(self, rng, img_h, img_w, true_boxes, crop_sizes):
        """A background crop that misses every true box, or None."""
        for _ in range(self.ATTEMPTS):
            size = rng.uniform(*crop_sizes)
            max_x = int(img_w * (1 - size))
            max_y = int(img_h * (1 - size))
            if max_x <= 0 or max_y <= 0:
                continue
            x1 = int(rng.integers(0, max_x))
            y1 = int(rng.integers(0, max_y))
            box = (x1, y1, x1 + int(img_w * size), y1 + int(img_h * size))
            if not self._box_ok(*box):
                continue
            if any(self.bbox_intersect(box, tb) for tb in true_boxes):
                continue
            return box
        return None

    _DECODE_CACHE_SIZE = 32

    def __len__(self):
        return len(self.list_bbox)

    def read(self, idx, rng=None):
        path, (x_min, y_min, x_max, y_max), label = self.list_bbox[idx]
        img = self._cached_decode(path)
        return img[y_min:y_max, x_min:x_max], int(label)

    def _cached_decode(self, path):
        """Decode through a small LRU keyed by path (``list_bbox`` is sorted
        by file, so an image with K boxes decodes once an epoch); safe for
        the loader's threads. Crops are slices of the cached array."""
        if not hasattr(self, "_decode_lock"):
            self._decode_cache = {}
            self._decode_lock = threading.Lock()
        with self._decode_lock:
            img = self._decode_cache.pop(path, None)
            if img is not None:
                self._decode_cache[path] = img
                return img
        img = imread_rgb(path)
        with self._decode_lock:
            self._decode_cache[path] = img
            while len(self._decode_cache) > self._DECODE_CACHE_SIZE:
                self._decode_cache.pop(next(iter(self._decode_cache)))
        return img

    def get_labels(self):
        return np.asarray([label for _, _, label in self.list_bbox])

    def flat_index(self):
        """(paths, xyxy crops) for the native decoder, which crops before it
        resizes."""
        paths = [p for p, _, _ in self.list_bbox]
        crops = np.asarray([box for _, box, _ in self.list_bbox], dtype=np.int32)
        return paths, crops

    def label_at(self, idx):
        return int(self.list_bbox[idx][2])


class GroupsDataset:
    """Fine-to-coarse relabelling: a pickled file list and a pickled
    {group: [fine labels]} dict; images under ``root/images_lr/<label>/``."""

    def __init__(self, root, ann_file, dict_path, **kwargs):
        self.data_prefix = root
        with open(Path(root, ann_file), "rb") as f:
            data = pkl.load(f)
        with open(Path(dict_path), "rb") as f:
            group_dict = pkl.load(f)
        inv_group = {v_i: k for k, v in group_dict.items() for v_i in v}
        self.class_to_idx = {k: i for i, k in enumerate(group_dict.keys())}
        self.idx_to_class = {i: k for k, i in self.class_to_idx.items()}
        self.classes = list(self.class_to_idx.keys())
        self.samples = []
        for sample in data:
            sample = Path(sample)
            orig_label = sample.parent.name
            img_path = Path(root, "images_lr", orig_label, sample.name)
            if not img_path.is_file():
                raise FileNotFoundError(f"File {img_path} does not exist.")
            self.samples.append((str(img_path), self.class_to_idx[inv_group[orig_label]]))

    def __len__(self):
        return len(self.samples)

    def read(self, idx, rng=None):
        path, label = self.samples[idx]
        return imread_rgb(path), label

    def get_labels(self):
        return np.asarray([lb for _, lb in self.samples])

    def flat_index(self):
        return [p for p, _ in self.samples], None

    def label_at(self, idx):
        return self.samples[idx][1]


class InferDataset:
    """A flat folder for inference: ``read`` returns (image, path)."""

    def __init__(self, folder_path, **kwargs):
        self.folder = Path(folder_path)
        self.imgs = sorted(str(p) for p in self.folder.iterdir()
                           if p.suffix.lower() in IMG_EXTENSIONS)

    def __len__(self):
        return len(self.imgs)

    def read(self, idx, rng=None):
        return imread_rgb(self.imgs[idx]), self.imgs[idx]

    def get_labels(self):
        raise NotImplementedError("InferDataset has no labels")

    def flat_index(self):
        return self.imgs, None

    def label_at(self, idx):
        return self.imgs[idx]
