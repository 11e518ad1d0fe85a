"""PyTorch port, ``vision.transforms`` and ``vision.datasets`` against the
JAX package's on the same numpy inputs and the same files (CPU).

Each random transform runs under the same ``random.seed`` in both
packages: the outputs must be equal (uint8 exactly, float within 1e-6).
The datasets read files the tests write (a CIFAR pickle tarball, MNIST
idx files, a Flowers layout, a VOC tree, an ImageFolder tree): the same
samples and labels as the reference's classes; ``DatasetFolder`` also
through the port's ``DataLoader`` with 2 workers, and the examples that
read an image tree."""

import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as JT
from paddle_tpu_torch.io import DataLoader
import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as TT


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if hasattr(v, "_value"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _img(seed, h=37, w=29, dtype="uint8"):
    rs = np.random.RandomState(seed)
    if dtype == "uint8":
        return rs.randint(0, 256, (h, w, 3)).astype("uint8")
    return rs.rand(h, w, 3).astype("float32")


TRANSFORMS = {
    "Resize_int": lambda T: T.Resize(20),
    "Resize_hw_nearest": lambda T: T.Resize((50, 23), "nearest"),
    "Resize_down_bilinear": lambda T: T.Resize((13, 11)),
    "CenterCrop": lambda T: T.CenterCrop(17),
    "RandomCrop_pad": lambda T: T.RandomCrop(40, padding=4,
                                             pad_if_needed=True),
    "RandomCrop_reflect": lambda T: T.RandomCrop((20, 15), padding=(2, 3),
                                                 padding_mode="reflect"),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(24),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.5),
    "Pad_edge": lambda T: T.Pad((1, 2, 3, 4), padding_mode="edge"),
    "Pad_const": lambda T: T.Pad(3, fill=7),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform(0.4),
    "SaturationTransform": lambda T: T.SaturationTransform(0.4),
    "HueTransform": lambda T: T.HueTransform(0.2),
    "ColorJitter": lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.1),
    "Grayscale": lambda T: T.Grayscale(3),
    "RandomRotation": lambda T: T.RandomRotation(30),
    "RandomRotation_expand": lambda T: T.RandomRotation(
        (10, 60), expand=True, fill=3),
    "RandomAffine": lambda T: T.RandomAffine(15, translate=(0.1, 0.2),
                                             scale=(0.8, 1.2), shear=10),
    "RandomAffine_bilinear": lambda T: T.RandomAffine(
        20, shear=(-5, 5, -8, 8), interpolation="bilinear"),
    "RandomPerspective": lambda T: T.RandomPerspective(prob=1.0),
    "RandomPerspective_bilinear": lambda T: T.RandomPerspective(
        prob=1.0, interpolation="bilinear"),
    "RandomErasing": lambda T: T.RandomErasing(prob=1.0, value=9),
    "Transpose": lambda T: T.Transpose(),
    "ToTensor": lambda T: T.ToTensor(),
    "ToTensor_hwc": lambda T: T.ToTensor(data_format="HWC"),
    "Normalize": lambda T: T.Normalize([127.5] * 3, [127.5] * 3,
                                       data_format="HWC"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_transform_matches_reference_under_one_seed(name, dtype):
    make = TRANSFORMS[name]
    for seed in range(3):
        img = _img(seed, dtype=dtype)
        random.seed(seed)
        want = make(JT)(img)
        random.seed(seed)
        got = make(TT)(img)
        _same(got, want)


def test_to_tensor_and_normalize_types():
    """``ToTensor`` gives a CPU float32 CHW torch tensor; ``Normalize`` a
    tensor for a tensor and numpy for numpy; ``RandomErasing`` erases a
    CHW tensor in place of a copy."""
    img = _img(5)
    t = TT.ToTensor()(img)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert t.device.type == "cpu" and tuple(t.shape) == (3, 37, 29)
    n = TT.Normalize([0.5] * 3, [0.25] * 3)(t)
    assert isinstance(n, torch.Tensor)
    _same(n, JT.Normalize([0.5] * 3, [0.25] * 3)(JT.ToTensor()(img)))
    assert isinstance(TT.Normalize(0.5, 0.25, data_format="HWC")(
        img.astype("float32")), np.ndarray)
    random.seed(1)
    e = TT.RandomErasing(prob=1.0, value=0.0)(t)
    random.seed(1)
    _same(e, JT.RandomErasing(prob=1.0, value=0.0)(JT.ToTensor()(img)))
    assert float(t.min()) >= 0 and not torch.equal(e, t)


def test_reference_pipeline_matches():
    """The reference's own pipeline (``tests/test_vision.py``): Resize,
    RandomCrop, flips, ColorJitter, ToTensor, Normalize; the functional
    ops of its module, one by one."""
    def pipe(T):
        return T.Compose([T.Resize(40), T.RandomCrop(32),
                          T.RandomHorizontalFlip(), T.ColorJitter(0.2, 0.2),
                          T.ToTensor(),
                          T.Normalize([0.485, 0.456, 0.406],
                                      [0.229, 0.224, 0.225])])

    for seed in range(4):
        img = _img(seed + 10, 48, 56)
        random.seed(seed)
        want = pipe(JT)(img)
        random.seed(seed)
        _same(pipe(TT)(img), want)
    img = _img(20)
    for fname, args in (("resize", ((31, 17),)), ("crop", (3, 4, 10, 12)),
                        ("center_crop", (15,)), ("hflip", ()), ("vflip", ()),
                        ("pad", (2,)), ("to_grayscale", ()),
                        ("adjust_brightness", (1.3,)),
                        ("adjust_contrast", (0.7,)),
                        ("adjust_saturation", (1.4,)),
                        ("adjust_hue", (-0.3,)), ("rotate", (33.0,)),
                        ("affine", (10.0, (2, -3), 1.1, (5.0, 2.0))),
                        ("perspective", ([[0, 0], [28, 0], [28, 36], [0, 36]],
                                         [[2, 1], [26, 3], [27, 33],
                                          [1, 35]])),
                        ("erase", (2, 3, 5, 6, 0))):
        _same(getattr(TT, fname)(img, *args), getattr(JT, fname)(img, *args))


# ------------------------------------------------------------------ datasets
def _check_dataset(jd, td, n=None):
    assert len(td) == len(jd)
    for i in range(len(jd) if n is None else n):
        (ji, jl), (ti, tl) = jd[i], td[i]
        _same(ti, ji)
        assert int(tl) == int(jl) and np.asarray(tl).dtype == \
            np.asarray(jl).dtype


def test_cifar_tarball_and_directory(tmp_path):
    rs = np.random.RandomState(0)
    tar_path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        for name in ["data_batch_%d" % i for i in range(1, 6)] + \
                ["test_batch"]:
            blob = pickle.dumps({b"data": rs.randint(0, 256, (4, 3072))
                                 .astype("uint8"),
                                 b"labels": list(rs.randint(0, 10, 4))})
            info = tarfile.TarInfo("cifar-10-batches-py/" + name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    for mode in ("train", "test"):
        _check_dataset(jds.Cifar10(str(tar_path), mode=mode),
                       tds.Cifar10(str(tar_path), mode=mode))
    d = tmp_path / "c100"
    d.mkdir()
    for name in ("train", "test"):
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (3, 3072))
                         .astype("uint8"),
                         b"fine_labels": list(rs.randint(0, 100, 3))}, f)
    tf_ = TT.Compose([TT.RandomHorizontalFlip(), TT.ToTensor()])
    jf = JT.Compose([JT.RandomHorizontalFlip(), JT.ToTensor()])
    for mode in ("train", "test"):
        td, jd = tds.Cifar100(str(d), mode=mode, transform=tf_), \
            jds.Cifar100(str(d), mode=mode, transform=jf)
        for i in range(len(jd)):
            random.seed(i)
            ji, jl = jd[i]
            random.seed(i)
            ti, tl = td[i]
            _same(ti, ji)
            assert int(tl) == int(jl)
    with pytest.raises(RuntimeError):
        tds.Cifar10(None, download=True)
    with pytest.raises(RuntimeError):
        tds.Cifar10(str(tmp_path / "missing.tar.gz"))


def _idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for s in arr.shape:
            f.write(struct.pack(">I", s))
        f.write(arr.tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_idx_files(tmp_path, cls):
    rs = np.random.RandomState(1)
    imgs = rs.randint(0, 256, (6, 28, 28)).astype("uint8")
    labels = rs.randint(0, 10, 6).astype("uint8")
    ip, lp = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    _idx(ip, imgs, 2051)
    _idx(lp, labels, 2049)
    _check_dataset(getattr(jds, cls)(ip, lp), getattr(tds, cls)(ip, lp))
    with pytest.raises(RuntimeError):
        getattr(tds, cls)(None, None, download=True)
    _idx(lp, labels, 1234)
    with pytest.raises(RuntimeError, match="magic"):
        getattr(tds, cls)(ip, lp)


def test_flowers_layout(tmp_path):
    import scipy.io as sio
    from PIL import Image

    rs = np.random.RandomState(2)
    d = tmp_path / "jpg"
    d.mkdir()
    for k in range(1, 7):
        Image.fromarray(rs.randint(0, 256, (12, 10, 3)).astype("uint8")) \
            .save(d / f"image_{k:05d}.jpg")
    sio.savemat(tmp_path / "labels.mat",
                {"labels": np.array([[3, 1, 2, 3, 1, 2]])})
    sio.savemat(tmp_path / "setid.mat", {"trnid": np.array([[1, 3, 5]]),
                                         "valid": np.array([[2]]),
                                         "tstid": np.array([[4, 6]])})
    args = (str(d), str(tmp_path / "labels.mat"), str(tmp_path / "setid.mat"))
    for mode in ("train", "valid", "test"):
        _check_dataset(jds.Flowers(*args, mode=mode),
                       tds.Flowers(*args, mode=mode))
    with pytest.raises(RuntimeError):
        tds.Flowers(None, download=True)


def test_voc_tree(tmp_path):
    rs = np.random.RandomState(3)
    root = tmp_path / "VOCdevkit" / "VOC2012"
    for sub in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
        (root / sub).mkdir(parents=True)
    names = ["a1", "b2", "c3"]
    (root / "ImageSets/Segmentation/train.txt").write_text(
        "\n".join(names) + "\n")
    (root / "ImageSets/Segmentation/val.txt").write_text("c3\n")
    for n in names:
        np.save(root / "JPEGImages" / f"{n}.npy",
                rs.randint(0, 256, (9, 7, 3)).astype("uint8"))
        np.save(root / "SegmentationClass" / f"{n}.npy",
                rs.randint(0, 21, (9, 7)).astype("uint8"))
    for mode in ("train", "valid"):
        jd = jds.VOC2012(str(tmp_path), mode=mode)
        td = tds.VOC2012(str(tmp_path), mode=mode)
        assert len(td) == len(jd)
        for i in range(len(jd)):
            for a, b in zip(td[i], jd[i]):
                _same(a, b)
    with pytest.raises(RuntimeError):
        tds.VOC2012(None)
    with pytest.raises(ValueError):
        tds.VOC2012(str(tmp_path), mode="nope")


def _tree(root, classes=3, per=5, hw=20, seed=4):
    rs = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per):
            np.save(os.path.join(d, f"{i}.npy"),
                    rs.randint(0, 256, (hw, hw, 3)).astype("uint8"))
    with open(os.path.join(root, "class_0", "notes.txt"), "w") as f:
        f.write("not an image")
    return root


def test_folder_datasets_and_loader(tmp_path):
    """``DatasetFolder`` / ``ImageFolder`` / ``make_dataset`` /
    ``default_loader`` (``.npy`` and PIL) as the reference; both folders
    through the port's ``DataLoader`` with 2 workers and the reference's
    transforms give the samples' batches in order."""
    from PIL import Image

    root = _tree(str(tmp_path / "tree"))
    Image.fromarray(np.full((6, 5, 3), 40, np.uint8)).save(
        os.path.join(root, "class_2", "x.png"))
    jd, td = jds.DatasetFolder(root), tds.DatasetFolder(root)
    assert td.classes == jd.classes and td.class_to_idx == jd.class_to_idx
    assert td.samples == jd.samples and td.targets == jd.targets
    _check_dataset(jd, td)
    ji, ti = jds.ImageFolder(root), tds.ImageFolder(root)
    assert ti.samples == ji.samples
    for i in range(len(ji)):
        _same(ti[i][0], ji[i][0])
    from paddle_tpu.vision.datasets import folder as jfolder
    from paddle_tpu_torch.vision.datasets import folder as tfolder

    assert tfolder.make_dataset(root, td.class_to_idx, (".png",)) == \
        jfolder.make_dataset(root, jd.class_to_idx, (".png",))
    _same(tfolder.default_loader(os.path.join(root, "class_2", "x.png")),
          jfolder.default_loader(os.path.join(root, "class_2", "x.png")))
    flat = tmp_path / "flat"
    flat.mkdir()
    np.save(flat / "a.npy", np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no class folders"):
        tds.DatasetFolder(str(flat))
    tf_ = TT.Compose([TT.Resize(16), TT.CenterCrop(12), TT.Transpose(),
                      TT.Normalize([127.5] * 3, [127.5] * 3)])
    ds = tds.DatasetFolder(root, transform=tf_,
                           is_valid_file=lambda p: p.endswith(".npy"))
    loader = DataLoader(ds, batch_size=4, num_workers=2)
    seen = 0
    for xb, yb in loader:
        assert isinstance(xb, torch.Tensor) and tuple(xb.shape[1:]) == \
            (3, 12, 12)
        for k in range(xb.shape[0]):
            img, lbl = ds[seen + k]
            np.testing.assert_array_equal(xb[k].numpy(), img)
            assert int(yb[k]) == lbl
        seen += xb.shape[0]
    assert seen == len(ds) == 15
    images = tds.ImageFolder(root, transform=tf_,
                             is_valid_file=lambda p: p.endswith(".npy"))
    got = [b for (b,) in DataLoader(images, batch_size=4, num_workers=2)]
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.stack(
        [images[i][0] for i in range(len(images))]))


def test_resnet50_example_reads_an_image_folder(tmp_path):
    """``examples/train_resnet50.py --data``: the reference's Compose over
    an ImageFolder through 4 loader workers, 2 steps on the CPU (f32)."""
    from paddle_tpu_torch.examples import train_resnet50 as ex

    root = _tree(str(tmp_path / "rn"), classes=2, per=2, hw=230)
    out = ex.main(["--data", root, "--steps", "1", "--batch-size", "2",
                   "--amp", "O0", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all() and out["data"] == root


def test_imagefolder_example_on_a_tiny_tree(tmp_path):
    from paddle_tpu_torch.examples import train_imagefolder as ex

    root = ex.synthesize_tree(str(tmp_path / "tiny"), n_per_class=6)
    out = ex.main([root, "--epochs", "1", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all()
    assert 0.0 <= out["eval"]["acc"] <= 1.0
