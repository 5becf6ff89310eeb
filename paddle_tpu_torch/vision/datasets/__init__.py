"""Vision datasets of the port (counterpart of
`paddle_tpu/vision/datasets/__init__.py`; ref `python/paddle/vision/datasets/`).

Nothing is downloaded: datasets read local files when present (same on-disk
formats as the reference) and raise FileNotFoundError, with the JAX
package's text, otherwise. `FakeData` gives deterministic synthetic data
for tests and benches: sample ``idx`` is drawn from ``RandomState(idx)``,
so both packages give the same images. Samples are numpy; the DataLoader's
collate makes the Tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from paddle_tpu_torch.io import Dataset


class FakeData(Dataset):
    """Deterministic synthetic images + labels (for tests and warm-up benches)."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=10,
                 transform=None, dtype="float32"):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(self.dtype)
        label = np.array(rng.randint(0, self.num_classes), np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


    def __len__(self):
        return self.size


class MNIST(Dataset):
    """MNIST from local idx files (ref: `vision/datasets/mnist.py`)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None,
                 root=os.path.expanduser("~/.cache/paddle_tpu/mnist")):
        self.transform = transform
        name = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(root,
                                                f"{name}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(root,
                                                f"{name}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"MNIST files not found at {image_path}; no network egress — "
                "place idx .gz files locally or use vision.datasets.FakeData")
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[:, :, None]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


FashionMNIST = MNIST


class Cifar10(Dataset):
    """CIFAR-10 from a local tar.gz (ref: `vision/datasets/cifar.py`)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None,
                 root=os.path.expanduser("~/.cache/paddle_tpu")):
        data_file = data_file or os.path.join(root, "cifar-10-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"CIFAR archive not found at {data_file}; no network egress — "
                "place it locally or use vision.datasets.FakeData")
        self.transform = transform
        images, labels = [], []
        with tarfile.open(data_file) as tar:
            names = [m for m in tar.getmembers()
                     if ("data_batch" in m.name if mode == "train"
                         else "test_batch" in m.name)]
            for m in sorted(names, key=lambda m: m.name):
                d = pickle.load(tar.extractfile(m), encoding="bytes")
                images.append(d[b"data"])
                labels.extend(d[b"labels"])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0).astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None,
                 root=os.path.expanduser("~/.cache/paddle_tpu")):
        data_file = data_file or os.path.join(root, "cifar-100-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"CIFAR-100 archive not found at {data_file}; no egress")
        self.transform = transform
        with tarfile.open(data_file) as tar:
            name = "train" if mode == "train" else "test"
            for m in tar.getmembers():
                if m.name.endswith(name):
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    self.images = d[b"data"].reshape(-1, 3, 32, 32)
                    self.labels = np.asarray(d[b"fine_labels"], np.int64)


class DatasetFolder(Dataset):
    """Images under class-named subfolders (ref `vision/datasets/folder.py`)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise RuntimeError("PIL unavailable; use .npy images") from e

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


class Flowers(Dataset):
    """Flowers-102 from a local extracted directory (ref:
    `vision/datasets/flowers.py` — the reference downloads jpg/labels/setid
    .mat archives; no egress here, so point `data_file` at a directory
    containing jpg/ plus imagelabels.npy + setid .npy splits, or any folder
    of class-subdir images via DatasetFolder semantics)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        if data_file is None or not os.path.isdir(data_file):
            raise FileNotFoundError(
                "Flowers needs a local data directory (no network egress): "
                "either the extracted 102flowers layout (jpg/ + "
                "imagelabels.npy + setid_{train,valid,test}.npy) or a "
                "class-per-subdir image folder")
        jpg = os.path.join(data_file, "jpg")
        labels_npy = os.path.join(data_file, "imagelabels.npy")
        if os.path.isdir(jpg) and os.path.exists(labels_npy):
            self._images = sorted(
                os.path.join(jpg, f) for f in os.listdir(jpg)
                if f.lower().endswith((".jpg", ".jpeg", ".png")))
            labels = np.load(labels_npy).astype(np.int64) - 1
            split_npy = os.path.join(data_file, f"setid_{mode}.npy")
            if os.path.exists(split_npy):
                idx = np.load(split_npy).astype(np.int64) - 1
            else:
                idx = np.arange(len(self._images))
            self._images = [self._images[i] for i in idx]
            self._labels = labels[idx]
        else:
            folder = DatasetFolder(data_file, transform=None)
            self._images = [s[0] for s in folder.samples]
            self._labels = np.asarray([s[1] for s in folder.samples], np.int64)

    def __getitem__(self, idx):
        from PIL import Image
        img = np.asarray(Image.open(self._images[idx]).convert("RGB"))
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self._labels[idx])

    def __len__(self):
        return len(self._images)


class VOC2012(Dataset):
    """VOC2012 segmentation pairs from a local VOCdevkit tree (ref:
    `vision/datasets/voc2012.py`; no egress — point `data_file` at
    .../VOC2012 containing JPEGImages/, SegmentationClass/ and
    ImageSets/Segmentation/{train,val,trainval}.txt)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        if data_file is None or not os.path.isdir(data_file):
            raise FileNotFoundError(
                "VOC2012 needs a local VOCdevkit/VOC2012 directory "
                "(no network egress)")
        split = {"train": "train", "test": "val", "valid": "val",
                 "trainval": "trainval"}.get(mode, "train")
        list_file = os.path.join(data_file, "ImageSets", "Segmentation",
                                 f"{split}.txt")
        with open(list_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        self._pairs = [
            (os.path.join(data_file, "JPEGImages", n + ".jpg"),
             os.path.join(data_file, "SegmentationClass", n + ".png"))
            for n in names]

    def __getitem__(self, idx):
        from PIL import Image
        img_p, seg_p = self._pairs[idx]
        img = np.asarray(Image.open(img_p).convert("RGB"))
        seg = np.asarray(Image.open(seg_p))
        if self.transform is not None:
            img = self.transform(img)
        return img, seg

    def __len__(self):
        return len(self._pairs)
