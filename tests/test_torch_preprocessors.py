"""The port's host preprocessors (`data/preprocessors.py`) against the JAX
package's: every preprocessor, element by element through a dataset and
whole batches through ``apply_batch``, from the same seeds on the same
images — uint8 outputs equal, float outputs within 1e-6."""

import io
import sys

import numpy as np
import pytest

from differential_equations_resnet_tpu.data import pipeline as jax_pipeline
from differential_equations_resnet_tpu.data import preprocessors as jax_pre
from differential_equations_resnet_tpu_torch.data import pipeline
from differential_equations_resnet_tpu_torch.data import preprocessors as pre

FLOAT_TOL = 1e-6


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


def images_of(dtype, n=5, shape=(16, 12, 3), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (n, *shape)).astype(np.uint8)
    return rng.uniform(0, 1, (n, *shape)).astype(np.float32)


# (id, constructor arguments) of every preprocessor with ``apply_batch``.
BATCHED = [
    ("one-hot", "ConvertLabelsToOneHot", dict(num_classes=10)),
    ("crop", "RandomCrop", dict(scale=0.75, seed=3)),
    ("crop-whole", "RandomCrop", dict(scale=1.0, seed=4)),
    ("resize", "Resize", dict(target_size=(10, 7))),
    ("resize-up", "Resize", dict(target_size=(21, 30))),
    ("resize-aspect", "Resize", dict(target_size=(20, 20), preserve_aspect_ratio=True)),
    ("resize-same", "Resize", dict(target_size=(16, 12))),
    ("pad", "ResizeWithPad", dict(target_size=(20, 20))),
    ("pad-wide", "ResizeWithPad", dict(target_size=(9, 30))),
    ("flip", "RandomFlipLeftRight", dict(seed=5)),
    ("brightness", "RandomBrightness", dict(max_delta=0.3, seed=6)),
    ("saturation", "RandomSaturation", dict(lower=0.2, upper=1.8, seed=7)),
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name,cls,kwargs", BATCHED, ids=[b[0] for b in BATCHED])
def test_preprocessor_matches_jax_per_element_and_batched(name, cls, kwargs, dtype):
    images = images_of(dtype)
    labels = np.arange(5, dtype=np.int64) * 2
    port, ref = getattr(pre, cls)(**kwargs), getattr(jax_pre, cls)(**kwargs)
    got = list(port(pipeline.NumpyDataset.from_tensor_slices((images, labels))))
    want = list(ref(jax_pipeline.NumpyDataset.from_tensor_slices((images, labels))))
    assert len(got) == len(want) == 5
    for (gi, gl), (wi, wl) in zip(got, want):
        assert_same(gi, wi)
        assert_same(gl, wl)
    # A second draw from the same objects: the generators advance alike.
    port, ref = getattr(pre, cls)(**kwargs), getattr(jax_pre, cls)(**kwargs)
    for _ in range(2):
        (gi, gl), (wi, wl) = port.apply_batch(images, labels), ref.apply_batch(images, labels)
        assert_same(gi, wi)
        assert_same(gl, wl)


def test_unpack_images_labels_matches_jax():
    images = images_of("uint8", n=3)
    elements = {"image": images, "filename": np.array(["a", "b", "c"]), "label": np.arange(3)}
    got = list(pre.UnpackImagesLabels()(pipeline.NumpyDataset.from_tensor_slices(elements)))
    want = list(jax_pre.UnpackImagesLabels()(
        jax_pipeline.NumpyDataset.from_tensor_slices(elements)))
    for (gi, gl), (wi, wl) in zip(got, want):
        assert_same(gi, wi)
        assert gl == wl


def encoded(image, fmt):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image.squeeze(-1) if image.shape[-1] == 1 else image).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,channels", [("PNG", 3), ("PNG", 1), ("JPEG", 3), ("PNG", None),
                                          ("PNG", 4)])
@pytest.mark.parametrize("cls,kwargs", [("DecodeImages", {}), ("DecodeJPEGImages", {"ratio": 2})])
def test_decoders_match_jax(fmt, channels, cls, kwargs):
    rng = np.random.default_rng(1)
    shape = (9, 7, 1) if channels == 1 else (9, 7, 3)
    data = [encoded(rng.integers(0, 256, shape).astype(np.uint8), fmt) for _ in range(3)]
    labels = np.arange(3)
    port = getattr(pre, cls)(channels=channels, **kwargs)
    ref = getattr(jax_pre, cls)(channels=channels, **kwargs)
    got = list(port(pipeline.NumpyDataset.from_generator(lambda: iter(zip(data, labels)))))
    want = list(ref(jax_pipeline.NumpyDataset.from_generator(lambda: iter(zip(data, labels)))))
    for (gi, gl), (wi, wl) in zip(got, want):
        assert_same(gi, wi)
        assert gl == wl


def test_decoding_without_pillow_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    for module in (pre, jax_pre):
        with pytest.raises(RuntimeError, match="Image decoding requires Pillow"):
            module._decode_image_bytes(b"not an image", 3)


@pytest.mark.parametrize("size", [(7, 5), (16, 12), (33, 40)])
def test_resize_functions_match_jax(size):
    images = images_of("uint8", n=3, shape=(16, 12, 3), seed=2)
    assert_same(pre.resize_bilinear(images[0], size), jax_pre.resize_bilinear(images[0], size))
    assert_same(pre.resize_bilinear_batch(images, size),
                jax_pre.resize_bilinear_batch(images, size))


def test_hsv_conversions_match_jax():
    rgb = images_of("float32", n=4, shape=(6, 6, 3), seed=3)
    rgb[0, 0, 0] = 0.0  # a black pixel and a grey one: no hue
    rgb[0, 0, 1] = 0.5
    hsv = pre.rgb_to_hsv(rgb)
    assert_same(hsv, jax_pre.rgb_to_hsv(rgb))
    assert_same(pre.hsv_to_rgb(hsv), jax_pre.hsv_to_rgb(hsv))
    np.testing.assert_allclose(pre.hsv_to_rgb(hsv), rgb, atol=1e-6)
