"""The port's records (`data/records.py`) against the JAX package's: the
same arrays and image trees give byte-identical record files from either
package's Python or C++ writer, each package reads the other's files, and
the record datasets give the same element and batch streams for a seed."""

import io
import os

import numpy as np
import pytest

from differential_equations_resnet_tpu.data import preprocessors as jax_pre
from differential_equations_resnet_tpu.data import records as jax_records
from differential_equations_resnet_tpu_torch.data import preprocessors as pre
from differential_equations_resnet_tpu_torch.data import records
from differential_equations_resnet_tpu_torch.examples import bottleneck_resnet_records

PACKAGES = {"jax": jax_records, "torch": records}


def image_arrays(n=7, shape=(8, 6, 3), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *shape)).astype(np.uint8),
            rng.integers(0, 257, n).astype(np.int64))


def write_png_tree(root, n=10, seed=0, size=(12, 10)):
    """PNGs named `<label>_<n>.png` in ``root`` and one subdirectory."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        folder = root if i % 2 else os.path.join(root, "sub")
        Image.fromarray(arr).save(os.path.join(folder, f"{i % 4}_{i}.png"))


def files_of(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


@pytest.mark.parametrize("label,filename,data,encoding,shape", [
    (3, "", bytes(range(24)), records.ENCODING_RAW, (2, 4, 3)),
    (256, "7_cat.png", b"\x89PNG fake", records.ENCODING_IMAGE_BYTES, (0, 0, 0)),
    (0, "ünïcode_name.jpg", b"", records.ENCODING_IMAGE_BYTES, (0, 0, 0)),
])
def test_write_record_is_byte_identical(label, filename, data, encoding, shape):
    got, want = io.BytesIO(), io.BytesIO()
    records.write_record(got, label, filename, data, encoding, shape)
    jax_records.write_record(want, label, filename, data, encoding, shape)
    assert got.getvalue() == want.getvalue()
    payload = got.getvalue()[12:]
    parsed, jax_parsed = records.parse_record(payload), jax_records.parse_record(payload)
    assert parsed.keys() == jax_parsed.keys()
    for key in parsed:
        np.testing.assert_array_equal(np.asarray(parsed[key]), np.asarray(jax_parsed[key]))


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
def test_write_arrays_is_byte_identical_across_packages_and_writers(tmp_path, use_native):
    """Two shards (5 + 2 records) from each package, by the Python or the
    C++ writer, are the same bytes as the JAX package's Python writer's."""
    images, labels = image_arrays()
    want_paths = jax_records.RecordGenerator().write_arrays(
        images, labels, str(tmp_path / "want"), num_files_per_record=5, use_native=False)
    for name, package in PACKAGES.items():
        paths = package.RecordGenerator().write_arrays(
            images, labels, str(tmp_path / name), num_files_per_record=5, use_native=use_native)
        assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in want_paths]
        assert files_of(tmp_path / name) == files_of(tmp_path / "want")


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_each_package_reads_the_others_records(tmp_path, writer, reader):
    images, labels = image_arrays(seed=1)
    (path,) = PACKAGES[writer].RecordGenerator().write_arrays(
        images, labels, str(tmp_path), num_files_per_record=100)
    got = list(PACKAGES[reader].read_record_file(path))
    assert [r["label"] for r in got] == labels.tolist()
    assert all(r["filename"] == "" for r in got)
    np.testing.assert_array_equal(np.stack([r["image"] for r in got]), images)


@pytest.mark.parametrize("corrupt,match", [
    (lambda b: b[:-3], "truncated"),
    (lambda b: b[:-1] + bytes([b[-1] ^ 1]), "CRC mismatch"),
    (lambda b: b"NOPE" + b[4:], "not a DERT record file"),
    (lambda b: b[:4] + b"\x02\x00\x00\x00" + b[8:], "unsupported record version"),
])
def test_python_reader_errors_match_jax(tmp_path, corrupt, match):
    images, labels = image_arrays(n=2)
    (path,) = records.RecordGenerator().write_arrays(images, labels, str(tmp_path))
    with open(path, "rb") as f:
        data = corrupt(f.read())
    with open(path, "wb") as f:
        f.write(data)
    for package in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            list(package.read_record_file(path))


@pytest.mark.parametrize("raw", [False, True], ids=["encoded", "raw"])
@pytest.mark.parametrize("split", [0.25, None], ids=["split", "no-split"])
def test_convert_gives_the_same_records_for_a_seed(tmp_path, raw, split):
    write_png_tree(str(tmp_path / "images"))
    for name, package in PACKAGES.items():
        gen = package.RecordGenerator()
        gen.convert(str(tmp_path / "images"), str(tmp_path / name), prefix="p",
                    num_files_per_record=3, train_val_split=split, store_raw_arrays=raw, seed=5)
        sizes = ((gen.train_dataset_size, gen.val_dataset_size) if split is not None
                 else (gen.dataset_size,))
        assert sizes == ((8, 2) if split is not None else (10,))  # round(2.5) == 2
    # The file walk's order is the file system's, the same for both.
    assert files_of(tmp_path / "torch") == files_of(tmp_path / "jax")
    assert len(files_of(tmp_path / "torch")) == 4  # shards of 3: 3 + 1, or 4


def creator_kwargs(paths, **overrides):
    kwargs = dict(record_paths=paths, batch_size=3, shuffle=True, shuffle_buffer_size=4,
                  repeat=True, num_epochs=2, seed=7, prefetch=2)
    kwargs.update(overrides)
    return kwargs


def streams(tmp_path, **overrides):
    """(port stream, JAX stream) of record datasets over the same shards,
    each with its own package's preprocessors."""
    images, labels = image_arrays(n=11, seed=2)
    paths = records.RecordGenerator().write_arrays(
        images, labels, str(tmp_path), num_files_per_record=4)
    out = []
    for package, preprocessors in ((records, pre), (jax_records, jax_pre)):
        chain = [preprocessors.UnpackImagesLabels(),
                 preprocessors.RandomFlipLeftRight(seed=3),
                 preprocessors.ConvertLabelsToOneHot(257)]
        out.append(package.RecordDatasetCreator(
            **creator_kwargs(paths, preprocessors=chain, **overrides)).create_dataset())
    return out


@pytest.mark.parametrize("overrides", [
    {},
    dict(batch_size=None, num_epochs=1, prefetch=None),
    dict(shuffle=False, shuffle_buffer_size=None, num_epochs=1),
    dict(repeat=False, seed=11),
])
def test_record_dataset_streams_match_jax(tmp_path, overrides):
    """Element and batch streams, seeded shard and element shuffles, repeat
    and prefetch: the same elements in the same order, to the end."""
    got, want = streams(tmp_path, **overrides)
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_generator_and_input_function_match_jax(tmp_path):
    images, labels = image_arrays(n=6, seed=4)
    paths = records.RecordGenerator().write_arrays(images, labels, str(tmp_path),
                                                   num_files_per_record=2)
    got = records.RecordDatasetCreator(**creator_kwargs(paths, repeat=False))
    want = jax_records.RecordDatasetCreator(**creator_kwargs(paths, repeat=False))
    for a, b in zip(list(got.create_generator()), list(want.create_generator())):
        for key in ("image", "label", "filename"):
            np.testing.assert_array_equal(a[key], b[key])
    assert len(list(got.create_input_function()())) == len(list(want.create_input_function()()))


@pytest.mark.parametrize("kwargs,match", [
    (dict(record_paths=["a", "a"]), "not unique"),
    (dict(record_paths=[]), "No record_paths"),
    (dict(record_paths=["a"], shuffle_buffer_size=None), "shuffle buffer size"),
])
def test_creator_validation_matches_jax(kwargs, match):
    overrides = dict(kwargs)
    paths = overrides.pop("record_paths")
    for package in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            package.RecordDatasetCreator(**creator_kwargs(paths, **overrides))


def test_path_helpers_match_jax(tmp_path):
    write_png_tree(str(tmp_path), n=6)
    (tmp_path / "shards").mkdir()
    for name in ("b.dert", "a.dert", "c.other"):
        (tmp_path / "shards" / name).write_bytes(b"")
    for helper, args in ((records.get_subdirectories, (str(tmp_path),)),
                         (records.get_image_paths, ([str(tmp_path), str(tmp_path / "sub")],)),
                         (records.get_record_paths, (str(tmp_path / "shards"),))):
        assert helper(*args) == getattr(jax_records, helper.__name__)(*args)
    for path in records.get_image_paths([str(tmp_path)]):
        assert (records.get_image_class_from_file_name(path)
                == jax_records.get_image_class_from_file_name(path))


def test_records_example_trains_and_evaluates_on_the_cpu(monkeypatch):
    """The port's records example, run as a user runs it with ``--device
    cpu`` (ResNet-50 at 32x32, one step at batch 2), on its synthetic PNG
    tree and, with Pillow hidden, on raw-array records."""
    argv = ["--device", "cpu", "--image-size", "32", "--batch-size", "2", "--steps", "1"]
    history = bottleneck_resnet_records.main(argv)
    assert history["train"][-1]["step"] == 1 and np.isfinite(history["eval"][-1]["mean_loss"])
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    history = bottleneck_resnet_records.main(argv)
    assert np.isfinite(history["train"][-1]["mean_loss"])
