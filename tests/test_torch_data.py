"""The port's data modules against the JAX package's: the NumPy pipeline and
CIFAR-10 loaders (copies, so equal outputs for equal seeds), and the
on-device augmentations given the same drawn parameters."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from differential_equations_resnet_tpu.data import cifar10 as jax_cifar10
from differential_equations_resnet_tpu.data import jit_augment as jax_aug
from differential_equations_resnet_tpu.data import pipeline as jax_pipeline
from differential_equations_resnet_tpu_torch.data import cifar10, jit_augment as aug, pipeline


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core, and small CPU
    convolutions slow down many times over when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_streams_equal(got, want, count):
    for _ in range(count):
        a, b = next(got), next(want)
        if isinstance(b, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def arrays(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 4, 4, 3)).astype(np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


class _Batched:
    """A preprocessor with ``apply_batch`` (takes the vectorized path)."""

    def apply_batch(self, x, y):
        return x[:, ::-1], y


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, repeat=True, drop_remainder=True, seed=0),
    dict(shuffle=True, repeat=True, drop_remainder=False, seed=3),
    dict(shuffle=False, repeat=False, drop_remainder=False, seed=None),
    dict(shuffle=True, repeat=True, drop_remainder=False, seed=5, preprocessors=(_Batched(),)),
    dict(shuffle=True, repeat=True, drop_remainder=True, seed=7,
         preprocessors=(lambda ds: ds.map(lambda x, y: (x + 1, y)),)),
])
def test_dataset_from_arrays_streams_match_jax(kwargs):
    """The same seed gives the same batches in the same order, over epoch
    boundaries, on the vectorized and the per-element paths."""
    x, y = arrays()
    batches = 12 if kwargs["repeat"] else 4
    got = iter(pipeline.create_dataset_from_arrays(x, y, 16, **kwargs))
    want = iter(jax_pipeline.create_dataset_from_arrays(x, y, 16, **kwargs))
    assert_streams_equal(got, want, batches)
    if not kwargs["repeat"]:
        assert next(got, None) is None and next(want, None) is None


OPERATORS = {
    "map": lambda ds: ds.map(lambda x, y: (x * 2, y + 1)),
    "filter": lambda ds: ds.filter(lambda x, y: y % 3 == 0),
    "shuffle": lambda ds: ds.shuffle(7, seed=11),
    "repeat": lambda ds: ds.repeat(3),
    "batch": lambda ds: ds.batch(8),
    "batch_drop": lambda ds: ds.batch(8, drop_remainder=True),
    "prefetch": lambda ds: ds.prefetch(3),
    "take": lambda ds: ds.take(9),
    "shard": lambda ds: ds.shard(3, 1),
    "apply": lambda ds: ds.apply(lambda d: d.shuffle(5, seed=2).batch(4)),
}


@pytest.mark.parametrize("name", OPERATORS)
def test_numpy_dataset_operator_matches_jax(name):
    x, y = arrays(30)
    got = list(OPERATORS[name](pipeline.NumpyDataset.from_tensor_slices((x, y))))
    want = list(OPERATORS[name](jax_pipeline.NumpyDataset.from_tensor_slices((x, y))))
    assert len(got) == len(want) > 0
    assert_streams_equal(iter(got), iter(want), len(want))


def test_numpy_dataset_dict_and_single_elements_match_jax():
    x, y = arrays(10)
    for make in (lambda m: m.NumpyDataset.from_tensor_slices({"x": x, "y": y}).batch(4),
                 lambda m: m.NumpyDataset.from_tensor_slices(x).batch(3),
                 lambda m: m.NumpyDataset.from_generator(lambda: iter(range(5))).map(lambda v: v * v)):
        got, want = list(make(pipeline)), list(make(jax_pipeline))
        assert len(got) == len(want)
        assert_streams_equal(iter(got), iter(want), len(want))
    assert list(pipeline.NumpyDataset.from_tensor_slices(x).as_numpy_iterator())[0].shape == (4, 4, 3)


def test_prefetch_propagates_a_producer_error():
    def gen():
        yield 1
        raise KeyError("source failed")

    with pytest.raises(KeyError, match="source failed"):
        list(pipeline.NumpyDataset.from_generator(gen).prefetch(2))


@pytest.mark.parametrize("num_train,num_test,seed", [(256, 64, 0), (100, 10, 7)])
def test_synthetic_cifar10_is_byte_equal(num_train, num_test, seed):
    got = cifar10.synthetic_cifar10(num_train, num_test, seed)
    want = jax_cifar10.synthetic_cifar10(num_train, num_test, seed)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got[4] == want[4]
    assert got[0].shape == (num_train, 32, 32, 3) and got[0].dtype == np.uint8


def write_cifar_fixture(directory, rows=3, seed=0):
    """The python-pickle CIFAR-10 release's layout, a few rows a batch."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (rows, 3072)).astype(np.uint8),
             b"labels": [int(v) for v in rng.integers(0, 10, rows)]}
        with open(os.path.join(directory, name), "wb") as f:
            pickle.dump(d, f)
    with open(os.path.join(directory, "batches.meta"), "wb") as f:
        pickle.dump({b"label_names": [f"name{i}".encode() for i in range(10)]}, f)
    return directory


def test_build_cifar10_dataset_matches_jax(tmp_path):
    directory = write_cifar_fixture(str(tmp_path / "cifar-10-batches-py"))
    got = cifar10.build_cifar10_dataset(directory)
    want = jax_cifar10.build_cifar10_dataset(directory)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[0].shape == (15, 32, 32, 3) and got[2].shape == (3, 32, 32, 3)
    assert got[4] == want[4] == [f"name{i}" for i in range(10)]
    d = cifar10.unpickle(os.path.join(directory, "test_batch"))
    assert d[b"data"].shape == (3, 3072)


def test_fetch_returns_an_extracted_directory_and_find_reads_the_env(tmp_path, monkeypatch):
    """fetch_cifar10's early return (no network): an extracted release is
    returned as it is; find_cifar10_directory honours CIFAR10_DIR."""
    batches = write_cifar_fixture(str(tmp_path / "cifar-10-batches-py"))
    assert cifar10.fetch_cifar10(str(tmp_path)) == batches
    monkeypatch.setenv("CIFAR10_DIR", batches)
    assert cifar10.find_cifar10_directory() == batches
    monkeypatch.setenv("CIFAR10_DIR", str(tmp_path / "missing"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    (tmp_path / "elsewhere").mkdir()
    monkeypatch.chdir(tmp_path / "elsewhere")
    assert cifar10.find_cifar10_directory() is None
    monkeypatch.chdir(tmp_path)
    assert cifar10.find_cifar10_directory() == "./cifar-10-batches-py"


# -- on-device augmentation ---------------------------------------------------------------


def images(n=5, h=8, w=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.float32)


def both(fn_jax, fn_port, x, atol=0.0):
    want = np.asarray(fn_jax(jnp.asarray(x)))
    got = fn_port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    return got


def test_flip_matches_jax():
    x, key = images(), jax.random.key(1)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (len(x),)))
    assert 0 < flip.sum() < len(x)
    both(lambda a: jax_aug.random_flip_left_right(key, a),
         lambda t: aug.apply_flip(t, torch.tensor(flip)), x)


@pytest.mark.parametrize("max_delta", [0.5, 0.1])
def test_brightness_matches_jax(max_delta):
    x, key = images(seed=2), jax.random.key(2)
    deltas = np.asarray(jax.random.uniform(key, (len(x),), minval=-max_delta, maxval=max_delta))
    both(lambda a: jax_aug.random_brightness(key, a, max_delta),
         lambda t: aug.apply_brightness(t, torch.tensor(deltas)), x)


def jax_offsets(key, n, high_top, high_left):
    kt, kl = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.randint(kt, (n,), 0, high_top))),
            torch.tensor(np.asarray(jax.random.randint(kl, (n,), 0, high_left))))


@pytest.mark.parametrize("scale", [0.9, 0.5])
def test_random_crop_matches_jax(scale):
    x, key = images(h=10, w=7, seed=3), jax.random.key(3)
    side = int(7 * scale)
    tops, lefts = jax_offsets(key, len(x), 10 - side + 1, 7 - side + 1)
    got = both(lambda a: jax_aug.random_crop(key, a, scale),
               lambda t: aug.apply_crop(t, tops, lefts, side, side), x)
    assert got.shape == (len(x), side, side, 3)


@pytest.mark.parametrize("padding", [4, 1])
def test_pad_random_crop_matches_jax(padding):
    x, key = images(seed=4), jax.random.key(4)
    tops, lefts = jax_offsets(key, len(x), 2 * padding + 1, 2 * padding + 1)
    both(lambda a: jax_aug.pad_random_crop(key, a, padding),
         lambda t: aug.apply_pad_crop(t, tops, lefts, padding), x)


def test_hsv_round_trip_matches_jax():
    x = images(n=6, seed=5) / 255.0
    x[0] = 0.5  # grey: zero saturation, hue 0
    x[1, ..., 0] = x[1, ..., 1]  # ties between channels
    for fn_jax, fn_port in ((jax_aug._rgb_to_hsv, aug._rgb_to_hsv),
                            (lambda a: jax_aug._hsv_to_rgb(jax_aug._rgb_to_hsv(a)),
                             lambda t: aug._hsv_to_rgb(aug._rgb_to_hsv(t)))):
        both(fn_jax, fn_port, x, atol=1e-5)


def test_saturation_matches_jax():
    """Tolerance 1e-5 on the unit scale before rounding: a value within it
    of a half step may round the other way, so at most one grey level."""
    x, key = images(seed=6), jax.random.key(6)
    factors = np.asarray(jax.random.uniform(key, (len(x),), minval=0.5, maxval=1.5))
    got = both(lambda a: jax_aug.random_saturation(key, a),
               lambda t: aug.apply_saturation(t, torch.tensor(factors)), x, atol=1.0)
    want = np.asarray(jax_aug.random_saturation(key, jnp.asarray(x)))
    assert np.mean(got != want) < 1e-3


def test_standard_cifar_augment_matches_jax_with_the_same_draws():
    """compose applies each transform in order; given the parameters JAX's
    keys drew, the port's chain gives the same images."""
    x, key = images(seed=7), jax.random.key(7)
    k_crop, k_flip, k_bright = jax.random.split(key, 3)
    tops, lefts = jax_offsets(k_crop, len(x), 9, 9)
    flip = torch.tensor(np.asarray(jax.random.bernoulli(k_flip, 0.5, (len(x),))))
    deltas = torch.tensor(np.asarray(
        jax.random.uniform(k_bright, (len(x),), minval=-0.2, maxval=0.2)))
    both(lambda a: jax_aug.standard_cifar_augment(brightness_delta=0.2)(key, a),
         lambda t: aug.apply_brightness(aug.apply_flip(aug.apply_pad_crop(t, tops, lefts, 4), flip),
                                        deltas), x)


def test_compose_draws_in_order_from_one_generator():
    x = torch.from_numpy(images(seed=8))
    chain = aug.standard_cifar_augment(brightness_delta=0.3)
    got = chain(torch.Generator().manual_seed(5), x)
    g = torch.Generator().manual_seed(5)
    want = aug.random_brightness(g, aug.random_flip_left_right(g, aug.pad_random_crop(g, x, 4)), 0.3)
    assert torch.equal(got, want)
    assert torch.equal(aug.compose()(g, x), x)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 6), padding=st.integers(0, 4))
def test_augment_properties(seed, n, padding):
    """Shape kept, values on the 0-255 integer grid, and each image
    transformed on its own: a flipped-or-not window of its own padded
    image, whatever the others drew."""
    x = torch.from_numpy(images(n=n, h=6, w=5, seed=seed % 1000))
    g = torch.Generator().manual_seed(seed)
    tops, lefts = aug.draw_offsets(g, n, 2 * padding + 1, 2 * padding + 1)
    flip = aug.draw_flip(g, n)
    out = aug.apply_flip(aug.apply_pad_crop(x, tops, lefts, padding), flip)
    assert out.shape == x.shape
    padded = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    for i in range(n):
        window = padded[i, tops[i]:tops[i] + 6, lefts[i]:lefts[i] + 5]
        assert torch.equal(out[i], window.flip(1) if flip[i] else window)
        alone = aug.apply_flip(aug.apply_pad_crop(x[i:i + 1], tops[i:i + 1], lefts[i:i + 1], padding),
                               flip[i:i + 1])
        assert torch.equal(alone[0], out[i])
    bright = aug.random_brightness(g, out, 0.5)
    sat = aug.random_saturation(g, out)
    for t in (bright, sat):
        assert t.shape == x.shape
        assert float(t.min()) >= 0 and float(t.max()) <= 255
        assert torch.equal(t, torch.round(t))
