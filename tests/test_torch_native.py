"""The port's native record codec and threaded loader (`native/`) against
the JAX package's: the C++ sources are the same, the port builds them into
build/native/ (keyed by a hash of source and flags), and both give the same
bytes, records, batches and errors."""

import difflib
import os
import struct
import zlib

import numpy as np
import pytest

from differential_equations_resnet_tpu.data import records as jax_records
from differential_equations_resnet_tpu.native import codec as jax_codec
from differential_equations_resnet_tpu.native import loader as jax_loader
from differential_equations_resnet_tpu_torch.data import records
from differential_equations_resnet_tpu_torch.native import codec, loader
from differential_equations_resnet_tpu_torch.ops.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "differential_equations_resnet_tpu", "native")
CODECS = {"jax": jax_codec, "torch": codec}
LOADERS = {"jax": jax_loader, "torch": loader}


def shards(tmp_path, n=40, shape=(4, 4, 3), per_shard=10, seed=0):
    """Raw shards of ``n`` seeded images with labels 0..n-1: (paths, images,
    labels)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, *shape)).astype(np.uint8)
    labels = np.arange(n, dtype=np.int64)
    paths = records.RecordGenerator().write_arrays(images, labels, str(tmp_path),
                                                   num_files_per_record=per_shard)
    return paths, images, labels


def test_sources_are_the_jax_packages_and_build_into_build_native():
    """The loader is a verbatim copy; the codec is the JAX package's with
    lines added (the bounds checks of `test_codec_bounds_what_the_file_claims`)
    and none changed or removed.  Both build with g++ into build/native/,
    through the builder the CUDA kernels use."""
    native = {name: source for name, source in _build.SOURCES.items() if source.compiler == "g++"}
    assert sorted(native) == ["dert_codec", "dert_loader"]
    _build.build(native)
    for name, source in native.items():
        with open(source.path) as f, open(os.path.join(JAX_NATIVE, source.path.name)) as g:
            ours, theirs = f.read().splitlines(), g.read().splitlines()
        if name == "dert_loader":
            assert ours == theirs
        else:
            ops = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False).get_opcodes()
            assert {tag for tag, *_ in ops} == {"equal", "insert"}, source.path.name
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_ROOT / "native"
        assert path.parent.parts[-2:] == ("build", "native")
        assert path.name.startswith(f"lib{name}-") and path.is_file()
        assert _build.build([name]) == {name: 0.0}  # built once, then found by its hash
    assert codec.native_codec_available() and loader.native_loader_available()


def broken_sources(tmp_path, monkeypatch):
    """A source that is not C++ beside one that is, both building under
    ``tmp_path``: (names, build directory)."""
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    (tmp_path / "fine.cc").write_text("extern \"C\" int fine() { return 1; }\n")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    for name in ("broken", "fine"):
        monkeypatch.setitem(_build.SOURCES, name, _build.Source(
            tmp_path / f"{name}.cc", "g++", _build.CXX_FLAGS, "native"))
    return ["broken", "fine"], tmp_path / "build" / "native"


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """The other sources of the call still build; the failed one leaves no
    half-written library."""
    names, out = broken_sources(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cc") as info:
        _build.build(names)
    assert "error" in str(info.value)  # the compiler's own output
    assert [p.name for p in out.glob("*.so")] == [_build.library_path("fine").name]


def test_a_missing_compiler_raises_before_any_build_starts(tmp_path, monkeypatch):
    """Without g++ the build raises `RuntimeError` (on which the codec and
    loader report themselves unavailable) and starts no compiler."""
    names, out = broken_sources(tmp_path, monkeypatch)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ was not found"):
        _build.build(names)
    assert not out.exists() or list(out.iterdir()) == []


def test_the_loader_pins_its_buffers_where_torch_sees_a_card(tmp_path, monkeypatch):
    """On a CPU-only machine the batches are NumPy arrays; where torch sees
    a CUDA device each batch is filled into a pinned torch buffer."""
    paths, images, labels = shards(tmp_path, n=12, per_shard=6)
    asked = []
    real_empty = loader.torch.empty

    def empty(*args, **kwargs):
        asked.append(kwargs.pop("pin_memory", False))
        return real_empty(*args, **kwargs)  # this machine cannot pin

    monkeypatch.setattr(loader.torch, "empty", empty)
    for card in (False, True):
        monkeypatch.setattr(loader.torch.cuda, "is_available", lambda: card)
        it = loader.NativeRecordLoader(paths, (4, 4, 3), batch_size=4, repeat=False,
                                       shuffle_files=False, num_threads=1)
        got = list(it)
        it.close()
        np.testing.assert_array_equal(np.concatenate([b[0] for b in got]), images)
        np.testing.assert_array_equal(np.concatenate([b[1] for b in got]), labels)
        assert (len(asked) > len(got) and all(asked)) if card else asked == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_native_writers_are_byte_identical_and_read_back(tmp_path, writer):
    images = np.random.default_rng(1).integers(0, 256, (9, 6, 5, 3)).astype(np.uint8)
    labels = np.random.default_rng(2).integers(0, 257, 9).astype(np.int64)
    path, want = str(tmp_path / "native.dert"), str(tmp_path / "python.dert")
    assert CODECS[writer].write_raw_shard(path, images, labels)
    jax_records.RecordGenerator().write_arrays(images, labels, str(tmp_path / "py"),
                                               use_native=False)
    with open(path, "rb") as f, open(str(tmp_path / "py" / "arrays_0000.dert"), "rb") as g:
        assert f.read() == g.read()
    for reader in CODECS.values():
        assert reader.count_records(path) == 9
        got_images, got_labels = reader.read_raw_shard(path, (6, 5, 3))
        np.testing.assert_array_equal(got_images, images)
        np.testing.assert_array_equal(got_labels, labels)


def corrupt_payload(path):
    with open(path, "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))


def malicious_header(path):
    """One record whose header claims 48 data bytes it does not carry."""
    payload = struct.pack("<IH", 7, 0) + struct.pack("<BHHHQ", 0, 4, 4, 3, 48)
    record = struct.pack("<QI", len(payload), zlib.crc32(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"DERT" + struct.pack("<I", 1) + record)


def bad_magic(path):
    with open(path, "r+b") as f:
        f.write(b"NOPE")


def huge_payload_length(path):
    """The first record's payload length (outside the CRC) set to 2^60."""
    with open(path, "r+b") as f:
        f.seek(8)
        f.write(struct.pack("<Q", 1 << 60))


CORRUPTIONS = {
    "crc": (corrupt_payload, "CRC mismatch"),
    "magic": (bad_magic, "bad magic"),
    "header": (malicious_header, "truncated"),
    "length": (huge_payload_length, "truncated"),
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_codec_and_loader_errors_match_jax(tmp_path, corruption):
    """The same ValueError from the codec's bulk read and the loader of
    both packages.  Where a record claims more than the file or its payload
    holds, the JAX package's codec is not asked: it reads past the payload
    or allocates what the length says (2^60 bytes aborts the process);
    the port's raises as the loaders do."""
    corrupt, match = CORRUPTIONS[corruption]
    (path, *_), _, _ = shards(tmp_path, n=3)
    corrupt(path)
    errors = {}
    for name in ("jax", "torch"):
        if corruption in ("crc", "magic") or name == "torch":
            with pytest.raises(ValueError, match=match) as error:
                CODECS[name].read_raw_shard(path, (4, 4, 3))
            errors[name, "codec"] = str(error.value)
        with pytest.raises(ValueError, match=match) as error:
            list(LOADERS[name].NativeRecordLoader([path], (4, 4, 3), batch_size=2, repeat=False))
        errors[name, "loader"] = str(error.value)
    assert errors["torch", "loader"] == errors["jax", "loader"]
    assert errors["torch", "codec"] == errors.get(("jax", "codec"), errors["torch", "codec"])


def test_codec_bounds_what_the_file_claims(tmp_path):
    """A repaired fault of the C++ codec: a record whose payload is shorter
    than its fields claim (a valid CRC over 21 bytes that announce 48 data
    bytes) made the bulk read copy 48 bytes from past the payload, and a
    payload length past the end of the file made it allocate that length.
    Both are now 'truncated record' errors; intact shards read as before."""
    for corrupt in (malicious_header, huge_payload_length):
        (path, *_), _, _ = shards(tmp_path / corrupt.__name__, n=3)
        corrupt(path)
        with pytest.raises(ValueError, match="truncated record"):
            codec.read_raw_shard(path, (4, 4, 3))
    (path,), images, labels = shards(tmp_path / "intact", n=3)
    got_images, got_labels = codec.read_raw_shard(path, (4, 4, 3))
    np.testing.assert_array_equal(got_images, images)
    np.testing.assert_array_equal(got_labels, labels)


def test_shape_and_encoding_mismatches_match_jax(tmp_path):
    (path, *_), _, _ = shards(tmp_path, n=3)
    for name in ("jax", "torch"):
        with pytest.raises(ValueError, match="shape mismatch"):
            CODECS[name].read_raw_shard(path, (4, 4, 1))
        with pytest.raises(ValueError, match="shape mismatch"):
            list(LOADERS[name].NativeRecordLoader([path], (2, 4, 3), batch_size=2, repeat=False))


def batches_of(name, paths, **kwargs):
    it = LOADERS[name].NativeRecordLoader(paths, (4, 4, 3), **kwargs)
    try:
        if kwargs.get("repeat", True) and kwargs.get("num_epochs") is None:
            return [next(it) for _ in range(9)]  # an endless stream: its first 9 batches
        return list(it)
    finally:
        it.close()


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=7, repeat=False, shuffle_files=False),
    dict(batch_size=7, repeat=True, num_epochs=2, shuffle_files=False),
    dict(batch_size=8, repeat=False, shuffle_files=True, seed=3),
    dict(batch_size=8, repeat=False, shuffle_files=True, shuffle_buffer_size=16, seed=4),
    dict(batch_size=5, repeat=True, shuffle_files=True, shuffle_buffer_size=9, seed=5),
], ids=["in-order", "two-epochs", "file-shuffle", "reservoir", "repeat-forever"])
def test_loader_batches_at_one_thread_match_jax(tmp_path, kwargs):
    """At one thread the order is deterministic, shuffled or not: the same
    batches as the JAX package's loader, short last batch included."""
    paths, images, labels = shards(tmp_path)
    got = batches_of("torch", paths, num_threads=1, **kwargs)
    want = batches_of("jax", paths, num_threads=1, **kwargs)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi, images[gl])  # each image with its label
    if not kwargs.get("shuffle_files"):
        order = np.concatenate([b[1] for b in got])
        np.testing.assert_array_equal(order[:40], labels)


@pytest.mark.parametrize("threads", [2, 4])
def test_loader_with_threads_gives_the_same_multiset_as_jax(tmp_path, threads):
    paths, images, labels = shards(tmp_path, n=60)
    key = lambda batches: sorted(int(l) for _, ls in batches for l in ls)
    for name in ("jax", "torch"):
        got = batches_of(name, paths, batch_size=16, repeat=True, num_epochs=2,
                         shuffle_files=True, shuffle_buffer_size=20, seed=1, num_threads=threads)
        assert key(got) == sorted(labels.tolist() * 2)
        for gi, gl in got:
            np.testing.assert_array_equal(gi, images[gl])


@pytest.mark.parametrize("shuffle", [False, True])
def test_create_native_dataset_matches_jax(tmp_path, shuffle):
    """`create_native_dataset` at one thread (shuffling off, or seeded
    file and reservoir shuffles): the same finite stream as the JAX
    package's, two epochs."""
    paths, _, _ = shards(tmp_path)
    kwargs = dict(batch_size=6, repeat=True, num_epochs=2, shuffle=shuffle,
                  shuffle_buffer_size=12 if shuffle else None, seed=9)
    got = list(records.RecordDatasetCreator(paths, **kwargs).create_native_dataset(
        (4, 4, 3), num_threads=1))
    want = list(jax_records.RecordDatasetCreator(paths, **kwargs).create_native_dataset(
        (4, 4, 3), num_threads=1))
    assert len(got) == len(want) == 14  # 80 records: 13 batches of 6 and one of 2
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError, match="requires a batch_size"):
        records.RecordDatasetCreator(paths, batch_size=None, shuffle=False).create_native_dataset(
            (4, 4, 3))


def test_creator_reads_native_written_shards_through_the_bulk_codec(tmp_path, monkeypatch):
    """`create_dataset` takes the bulk C++ read for array-written shards,
    and the Python codec where the native codec is unavailable: the same
    elements either way."""
    paths, images, labels = shards(tmp_path, n=12, per_shard=5)
    creator = records.RecordDatasetCreator(paths, batch_size=None, repeat=False, shuffle=False)
    calls = []
    read = codec.read_raw_shard
    monkeypatch.setattr(codec, "read_raw_shard", lambda *a, **k: calls.append(a) or read(*a, **k))
    native = list(creator.create_dataset())
    assert len(calls) == 3
    monkeypatch.setattr(codec, "read_raw_shard", lambda *a, **k: None)
    python = list(creator.create_dataset())
    for a, b, image, label in zip(native, python, images, labels):
        np.testing.assert_array_equal(a["image"], image)
        np.testing.assert_array_equal(b["image"], image)
        assert a["label"] == b["label"] == label
