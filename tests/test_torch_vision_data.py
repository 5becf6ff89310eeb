"""`paddle_tpu_torch.vision.datasets` and `.vision.transforms` held
against the JAX package's on the CPU, bit for bit.

The datasets read tiny files written here in their on-disk formats (MNIST
idx .gz, the CIFAR pickled tar.gz, a class-per-folder tree of .npy
images); nothing is downloaded, and a missing file raises the JAX text.
Every transform and functional runs on both packages after the same
``random.seed``, on a uint8 HWC image and a float32 image, HWC and CHW.
`Resize` of uint8 takes PIL's path when PIL imports and the numpy
bilinear when it does not; both branches are held (the second with the
import blocked).
"""
import gzip
import io as _io
import pickle
import random
import struct
import sys
import tarfile

import numpy as np
import pytest

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as jT

import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as tT
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    with tdevice.device_scope("cpu"):
        yield


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _equal(a, b):
    assert hasattr(a, "numpy") == hasattr(b, "numpy")
    x, y = _np(a), _np(b)
    assert x.dtype == y.dtype and x.shape == y.shape, (x.shape, y.shape)
    np.testing.assert_array_equal(x, y)


def _both(fn, seed):
    """``fn(package)`` for each package after ``random.seed(seed)``; both
    must leave the stream at the same place (the same draws were made)."""
    random.seed(seed)
    j = fn(jT)
    after_j = random.random()
    random.seed(seed)
    t = fn(tT)
    assert random.random() == after_j
    return j, t


# ------------------------------------------------------------- datasets


def test_fakedata_equal():
    for kw in ({}, {"image_shape": (1, 5, 7), "num_classes": 3,
                    "dtype": "float64"}):
        j = jds.FakeData(size=6, **kw)
        t = tds.FakeData(size=6, **kw)
        assert len(j) == len(t) == 6
        for i in (0, 3, 5):
            for a, b in zip(j[i], t[i]):
                _equal(a, b)
    j = jds.FakeData(4, (3, 6, 6), transform=jT.Transpose((1, 2, 0)))
    t = tds.FakeData(4, (3, 6, 6), transform=tT.Transpose((1, 2, 0)))
    _equal(j[2][0], t[2][0])


def _idx_gz(path, magic, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_mnist_from_local_idx_files(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 4, 4)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    _idx_gz(tmp_path / "train-images-idx3-ubyte.gz", 2051, imgs)
    _idx_gz(tmp_path / "train-labels-idx1-ubyte.gz", 2049, labels)
    tf = lambda m: m.Normalize(127.5, 127.5, data_format="HWC")
    j = jds.MNIST(root=str(tmp_path), transform=tf(jT))
    t = tds.MNIST(root=str(tmp_path), transform=tf(tT))
    assert len(j) == len(t) == 5
    for i in range(5):
        _equal(j[i][0], t[i][0])
        assert j[i][1] == t[i][1] == labels[i]
    assert tds.FashionMNIST is tds.MNIST
    msgs = []
    for m in (jds, tds):
        with pytest.raises(FileNotFoundError) as e:
            m.MNIST(root=str(tmp_path), mode="test")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _cifar_tar(path, batches):
    with tarfile.open(path, "w:gz") as tar:
        for name, d in batches:
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tar.addfile(info, _io.BytesIO(raw))


def test_cifar_from_local_archives(tmp_path):
    rng = np.random.RandomState(1)

    def batch(n):
        return {b"data": rng.randint(0, 256, (n, 3 * 32 * 32)).astype(
            np.uint8), b"labels": rng.randint(0, 10, n).tolist()}
    _cifar_tar(tmp_path / "c10.tar.gz",
               [("cifar-10-batches-py/data_batch_2", batch(2)),
                ("cifar-10-batches-py/data_batch_1", batch(3)),
                ("cifar-10-batches-py/test_batch", batch(2))])
    for mode, n in (("train", 5), ("test", 2)):
        j = jds.Cifar10(str(tmp_path / "c10.tar.gz"), mode=mode)
        t = tds.Cifar10(str(tmp_path / "c10.tar.gz"), mode=mode)
        assert len(j) == len(t) == n
        for i in range(n):
            _equal(j[i][0], t[i][0])
            assert j[i][1] == t[i][1]
    fine = {b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
            b"fine_labels": [4, 99, 0]}
    _cifar_tar(tmp_path / "c100.tar.gz", [("cifar-100-python/train", fine)])
    j = jds.Cifar100(str(tmp_path / "c100.tar.gz"))
    t = tds.Cifar100(str(tmp_path / "c100.tar.gz"))
    np.testing.assert_array_equal(j.labels, t.labels)
    np.testing.assert_array_equal(j.images, t.images)
    for m in (jds, tds):
        with pytest.raises(FileNotFoundError, match="no network egress"):
            m.Cifar10(str(tmp_path / "absent.tar.gz"))


def test_folder_flowers_and_voc_over_local_trees(tmp_path):
    rng = np.random.RandomState(2)
    for c in ("cat", "dog"):
        (tmp_path / "f" / c).mkdir(parents=True)
        for k in range(2):
            np.save(tmp_path / "f" / c / f"{k}.npy",
                    rng.randint(0, 256, (4, 4, 3)).astype(np.uint8))
    (tmp_path / "f" / "notes.txt").write_text("ignored")
    j = jds.DatasetFolder(str(tmp_path / "f"))
    t = tds.ImageFolder(str(tmp_path / "f"))
    assert j.class_to_idx == t.class_to_idx and len(j) == len(t) == 4
    assert [s[1] for s in j.samples] == [s[1] for s in t.samples]
    for i in range(4):
        _equal(j[i][0], t[i][0])
    fj = jds.Flowers(str(tmp_path / "f"))
    ft = tds.Flowers(str(tmp_path / "f"))
    assert fj._images == ft._images
    np.testing.assert_array_equal(fj._labels, ft._labels)
    for m in (jds, tds):
        with pytest.raises(FileNotFoundError, match="no network egress"):
            m.Flowers(None)
        with pytest.raises(FileNotFoundError, match="no network egress"):
            m.VOC2012(str(tmp_path / "absent"))


# ----------------------------------------------------------- transforms

_U8 = (np.random.RandomState(3).rand(24, 20, 3) * 255).astype(np.uint8)
_F32 = np.random.RandomState(4).rand(24, 20, 3).astype(np.float32)
_CHW = np.random.RandomState(5).rand(3, 16, 12).astype(np.float32)

_RANDOM = {
    "random_crop": lambda m: m.RandomCrop(12),
    "random_crop_pad": lambda m: m.RandomCrop((10, 8), padding=2),
    "hflip": lambda m: m.RandomHorizontalFlip(0.5),
    "vflip": lambda m: m.RandomVerticalFlip(0.5),
    "rrc": lambda m: m.RandomResizedCrop(14),
    "rrc_rect": lambda m: m.RandomResizedCrop((9, 13), scale=(0.5, 1.0)),
    "brightness": lambda m: m.BrightnessTransform(0.4),
    "contrast": lambda m: m.ContrastTransform(0.4),
    "saturation": lambda m: m.SaturationTransform(0.4),
    "hue": lambda m: m.HueTransform(0.1),
    "color_jitter": lambda m: m.ColorJitter(0.4, 0.4, 0.4, 0.1),
    "rotation": lambda m: m.RandomRotation(30),
    "rotation_expand": lambda m: m.RandomRotation((10, 50), expand=True,
                                                  fill=7),
    "erasing": lambda m: m.RandomErasing(prob=1.0, value=3),
    "compose": lambda m: m.Compose([m.RandomResizedCrop(16),
                                    m.RandomHorizontalFlip(),
                                    m.ColorJitter(0.2, 0.2, 0.2, 0.05),
                                    m.Transpose()]),
}
_FIXED = {
    "resize": lambda m: m.Resize((11, 7)),
    "resize_int": lambda m: m.Resize(10),
    "center_crop": lambda m: m.CenterCrop((10, 30)),
    "transpose": lambda m: m.Transpose(),
    "grayscale1": lambda m: m.Grayscale(1),
    "grayscale3": lambda m: m.Grayscale(3),
    "to_tensor": lambda m: m.ToTensor(),
    "to_tensor_hwc": lambda m: m.ToTensor("HWC"),
    "normalize_hwc": lambda m: m.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                           data_format="HWC"),
}


@pytest.mark.parametrize("img", ["u8", "f32"])
@pytest.mark.parametrize("name", sorted(_RANDOM) + sorted(_FIXED))
def test_transform_equal_under_the_same_seed(name, img):
    arr = {"u8": _U8, "f32": _F32}[img]
    make = _RANDOM.get(name) or _FIXED[name]
    for seed in (0, 1, 2):
        j, t = _both(lambda m: make(m)(arr.copy()), seed)
        _equal(j, t)


def test_chw_tensor_paths_equal():
    for fn in (lambda m: m.Normalize([0.5, 0.5, 0.5], [0.2, 0.3, 0.4])(
                   m.ToTensor()(_CHW.transpose(1, 2, 0))),
               lambda m: m.Normalize(0.5, 0.25)(_CHW),
               lambda m: m.to_tensor(_CHW.transpose(1, 2, 0)),
               lambda m: m.normalize(_CHW, [0.1, 0.2, 0.3], [1, 2, 3])):
        j, t = _both(fn, 0)
        _equal(j, t)


def test_functionals_equal():
    cases = [
        lambda m: m.resize(_U8, (9, 31)),
        lambda m: m.hflip(_F32), lambda m: m.vflip(_U8),
        lambda m: m.center_crop(_U8, 7), lambda m: m.crop(_F32, 2, 3, 5, 9),
        lambda m: m.pad(_U8, 3, fill=9), lambda m: m.pad(_F32, (1, 2, 3, 4)),
        lambda m: m.adjust_brightness(_U8, 1.3),
        lambda m: m.adjust_contrast(_F32 * 255, 0.7),
        lambda m: m.adjust_saturation(_U8, 1.8),
        lambda m: m.adjust_hue(_U8, -0.3),
        lambda m: m.adjust_hue(_U8[..., :1], 0.2),
        lambda m: m.to_grayscale(_U8, 3),
        lambda m: m.erase(_U8, 1, 2, 5, 6, 0),
        lambda m: m.rotate(_U8, 33), lambda m: m.rotate(_F32, -71, expand=True,
                                                        center=(3, 4), fill=1),
    ]
    for fn in cases:
        j, t = _both(fn, 0)
        _equal(j, t)


def test_resize_numpy_branch_without_pil(monkeypatch):
    """With PIL unimportable both packages resize uint8 by the numpy
    bilinear (the card's machine has no PIL)."""
    with_pil = tT.Resize((13, 9))(_U8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for make in (lambda m: m.Resize((13, 9))(_U8),
                 lambda m: m.RandomResizedCrop(15)(_U8),
                 lambda m: m.Resize(6)(_U8[..., :1])):
        j, t = _both(make, 4)
        _equal(j, t)
    no_pil = tT.Resize((13, 9))(_U8)
    assert no_pil.dtype == np.uint8 and no_pil.shape == with_pil.shape
    assert not np.array_equal(no_pil, with_pil)
