"""Sharded binary record IO — the TFRecord replacement.

Port of `differential_equations_resnet_tpu/data/records.py`, kept in the
port so that it imports no JAX; the same arrays give the same bytes in
either package, and each package reads the other's files.  Rebuild of
`dataset_utils/tfrecord_generator.py` (writer) and
`dataset_utils/tfrecord_dataset_creator.py` (reader) on a TF-free, fixed
binary format designed so a native (C++) reader is trivial:

File layout:  magic "DERT" | uint32 version | records...
Record:       uint64 payload_len | uint32 crc32(payload) | payload
Payload:      uint32 label
              uint16 filename_len | filename utf-8
              uint8  encoding      (0 = raw uint8 HWC tensor, 1 = encoded
                                    image bytes e.g. JPEG/PNG)
              uint16 height | uint16 width | uint16 channels  (0s if unknown)
              uint64 data_len | data bytes

All integers little-endian.  Elements come out of the reader as
``{'image': ..., 'filename': str, 'label': int}`` dicts — feed through
`UnpackImagesLabels` / `DecodeImages` exactly as in the reference pipeline.
"""

from __future__ import annotations

import glob
import os
import pathlib
import random
import struct
import zlib
from math import ceil
from typing import Iterator, List, Optional, Sequence

import numpy as np

from differential_equations_resnet_tpu_torch.data.pipeline import NumpyDataset
from differential_equations_resnet_tpu_torch.data.preprocessors import _decode_image_bytes
from differential_equations_resnet_tpu_torch.native import codec as native_codec
from differential_equations_resnet_tpu_torch.native.loader import NativeRecordLoader

MAGIC = b"DERT"
VERSION = 1

_HEADER = struct.Struct("<QI")          # payload_len, crc32
_META = struct.Struct("<IH")            # label, filename_len
_SHAPE = struct.Struct("<BHHHQ")        # encoding, h, w, c, data_len

ENCODING_RAW = 0
ENCODING_IMAGE_BYTES = 1


def write_record(fp, label: int, filename: str, data: bytes, encoding: int, shape=(0, 0, 0)):
    name = filename.encode("utf-8")
    payload = (
        _META.pack(label, len(name))
        + name
        + _SHAPE.pack(encoding, shape[0], shape[1], shape[2], len(data))
        + data
    )
    fp.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
    fp.write(payload)


def parse_record(payload: bytes) -> dict:
    label, name_len = _META.unpack_from(payload, 0)
    off = _META.size
    filename = payload[off : off + name_len].decode("utf-8")
    off += name_len
    encoding, h, w, c, data_len = _SHAPE.unpack_from(payload, off)
    off += _SHAPE.size
    data = payload[off : off + data_len]
    if encoding == ENCODING_RAW:
        image = np.frombuffer(data, dtype=np.uint8).reshape(h, w, c)
    else:
        image = data  # encoded bytes; decode with DecodeImages/DecodeJPEGImages
    return {"image": image, "filename": filename, "label": label}


def read_record_file(path: str) -> Iterator[dict]:
    with open(path, "rb") as fp:
        magic = fp.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a DERT record file (magic={magic!r}).")
        (version,) = struct.unpack("<I", fp.read(4))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported record version {version}.")
        while True:
            header = fp.read(_HEADER.size)
            if not header:
                return
            payload_len, crc = _HEADER.unpack(header)
            payload = fp.read(payload_len)
            if len(payload) != payload_len:
                raise ValueError(f"{path}: truncated record.")
            if zlib.crc32(payload) != crc:
                raise ValueError(f"{path}: CRC mismatch (corrupt record).")
            yield parse_record(payload)


class RecordGenerator:
    """Convert an image directory tree into sharded record files with
    filename-derived integer labels (parity with `TFRecordGenerator`,
    dataset_utils/tfrecord_generator.py:30-170)."""

    def convert(
        self,
        input_directory: str,
        output_directory: str,
        prefix: str = "",
        suffix: str = "dert",
        num_files_per_record: int = 1000,
        train_val_split: Optional[float] = 0.25,
        store_raw_arrays: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        image_paths = get_image_paths(get_subdirectories(input_directory))
        rng = random.Random(seed)
        if train_val_split is not None:
            rng.shuffle(image_paths)
            n_val = int(round(len(image_paths) * train_val_split))
            val_paths, train_paths = image_paths[:n_val], image_paths[n_val:]
            self.train_dataset_size = len(train_paths)
            self.val_dataset_size = len(val_paths)
            self._convert(
                train_paths,
                os.path.join(output_directory, "train"),
                prefix + "_train",
                suffix,
                num_files_per_record,
                store_raw_arrays,
            )
            self._convert(
                val_paths,
                os.path.join(output_directory, "val"),
                prefix + "_val",
                suffix,
                num_files_per_record,
                store_raw_arrays,
            )
        else:
            rng.shuffle(image_paths)
            self.dataset_size = len(image_paths)
            self._convert(
                image_paths,
                output_directory,
                prefix,
                suffix,
                num_files_per_record,
                store_raw_arrays,
            )

    def _convert(self, image_paths, output_directory, prefix, suffix,
                 num_files_per_record, store_raw_arrays):
        pathlib.Path(output_directory).mkdir(parents=True, exist_ok=True)
        num_shards = ceil(len(image_paths) / num_files_per_record) if image_paths else 0
        for shard in range(num_shards):
            chunk = image_paths[
                shard * num_files_per_record : (shard + 1) * num_files_per_record
            ]
            path = os.path.join(output_directory, f"{prefix}_{shard:04d}.{suffix}")
            with open(path, "wb") as fp:
                fp.write(MAGIC + struct.pack("<I", VERSION))
                for image_path in chunk:
                    self._convert_sample(fp, image_path, store_raw_arrays)

    def _convert_sample(self, fp, image_path, store_raw_arrays):
        label = get_image_class_from_file_name(image_path)
        filename = os.path.basename(image_path)
        if store_raw_arrays:
            with open(image_path, "rb") as f:
                arr = _decode_image_bytes(f.read(), channels=None)
            write_record(
                fp, label, filename, arr.tobytes(), ENCODING_RAW, arr.shape
            )
        else:
            with open(image_path, "rb") as f:
                write_record(fp, label, filename, f.read(), ENCODING_IMAGE_BYTES)

    def write_arrays(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        output_directory: str,
        prefix: str = "arrays",
        suffix: str = "dert",
        num_files_per_record: int = 1000,
        use_native: bool = True,
    ) -> List[str]:
        """Write in-memory (N, H, W, C) uint8 arrays as sharded records —
        the NumPy-native ingestion path (no file-per-image needed).  Uses the
        C++ codec when it builds (native/dert_codec.cc), else pure Python."""
        pathlib.Path(output_directory).mkdir(parents=True, exist_ok=True)
        native_write = native_codec.write_raw_shard if use_native else None
        paths = []
        num_shards = ceil(len(images) / num_files_per_record)
        for shard in range(num_shards):
            sl = slice(shard * num_files_per_record, (shard + 1) * num_files_per_record)
            path = os.path.join(output_directory, f"{prefix}_{shard:04d}.{suffix}")
            if native_write is not None and native_write(
                path, np.ascontiguousarray(images[sl], np.uint8), labels[sl]
            ):
                paths.append(path)
                continue
            with open(path, "wb") as fp:
                fp.write(MAGIC + struct.pack("<I", VERSION))
                for img, label in zip(images[sl], labels[sl]):
                    img = np.ascontiguousarray(img, dtype=np.uint8)
                    write_record(
                        fp, int(label), "", img.tobytes(), ENCODING_RAW, img.shape
                    )
            paths.append(path)
        return paths


class RecordDatasetCreator:
    """Reader with the same pipeline semantics as `TFRecordDatasetCreator`
    (dataset_utils/tfrecord_dataset_creator.py:24-122): shard-name shuffle,
    flat-map over shards, preprocessor chain, element shuffle, repeat, batch,
    prefetch; consumable as a dataset or a generator."""

    def __init__(
        self,
        record_paths: Sequence[str],
        batch_size: Optional[int],
        preprocessors: Optional[Sequence] = None,
        repeat: bool = True,
        num_epochs: Optional[int] = None,
        shuffle: bool = True,
        shuffle_buffer_size: Optional[int] = None,
        num_parallel_reads: Optional[int] = None,
        num_parallel_calls: Optional[int] = None,
        prefetch: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        if len(record_paths) != len(set(record_paths)):
            raise ValueError(f"record_paths {record_paths} are not unique.")
        if len(record_paths) == 0:
            raise ValueError("No record_paths specified.")
        if shuffle and shuffle_buffer_size is None:
            raise ValueError("If using shuffle, please specify a shuffle buffer size.")
        self.record_paths = [os.path.abspath(p) for p in record_paths]
        self.batch_size = batch_size
        self.preprocessors = preprocessors
        self.repeat = repeat
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.shuffle_buffer_size = shuffle_buffer_size
        self.num_parallel_reads = num_parallel_reads
        self.num_parallel_calls = num_parallel_calls
        self.prefetch = prefetch
        self.seed = seed

    def _process(self) -> NumpyDataset:
        paths = list(self.record_paths)
        seed = self.seed

        def read_shard(path):
            """Bulk native read for uniform raw shards; per-record Python
            parse otherwise, and where the native codec does not build.  A
            corrupt shard raises ValueError either way."""
            first = next(read_record_file(path), None)
            # The bulk reader drops filenames, so only engage it for
            # array-written shards (empty names).
            if (first is not None and isinstance(first["image"], np.ndarray)
                    and first["filename"] == ""):
                result = native_codec.read_raw_shard(path, first["image"].shape)
                if result is not None:
                    for img, label in zip(*result):
                        yield {"image": img, "filename": "", "label": int(label)}
                    return
            yield from read_record_file(path)

        def gen():
            order = list(paths)
            if self.shuffle:
                random.Random(seed).shuffle(order)
            for path in order:
                yield from read_shard(path)

        dataset = NumpyDataset.from_generator(gen)
        for preprocessor in self.preprocessors or []:
            dataset = preprocessor(dataset)
        if self.shuffle:
            dataset = dataset.shuffle(self.shuffle_buffer_size, seed=self.seed)
        if self.repeat:
            dataset = dataset.repeat(self.num_epochs)
        if self.batch_size is not None:
            dataset = dataset.batch(self.batch_size)
        if self.prefetch is not None:
            dataset = dataset.prefetch(self.prefetch)
        return dataset

    def create_native_dataset(
        self,
        image_shape,
        num_threads: int = 4,
        ring_capacity: int = 4096,
        verify_crc: bool = True,
    ) -> NumpyDataset:
        """Batches via the C++ threaded loader (native/dert_loader.cc):
        shard-parallel reads, bounded-ring prefetch, per-epoch file shuffle,
        reservoir record shuffle — the role tf.data's C++ runtime plays in
        the reference (tfrecord_dataset_creator.py:35-36,66-71).

        Raw fixed-`image_shape` shards only; the Python preprocessor chain
        is bypassed (apply further transforms with `.map` on the returned
        dataset).  Raises RuntimeError when the native library cannot build
        — use `create_dataset()` as the portable path.  Where torch sees a
        CUDA device, each batch's images are in page-locked memory
        (`NativeRecordLoader`)."""

        if self.batch_size is None:
            raise ValueError("create_native_dataset requires a batch_size.")
        paths = list(self.record_paths)
        batch_size = self.batch_size
        # Same epoch semantics as create_dataset(): repeat=False -> one pass,
        # repeat=True -> num_epochs passes (None = forever).
        if not self.repeat:
            num_epochs = 1
        else:
            num_epochs = self.num_epochs  # None -> infinite
        shuffle = bool(self.shuffle)
        shuffle_buffer = int(self.shuffle_buffer_size or 0) if shuffle else 0
        # Deterministic order when not shuffling: no shard permutation and a
        # single worker (parallel workers interleave records nondeterministically).
        threads = num_threads if shuffle else 1
        seed = int(self.seed or 0)
        shape = tuple(image_shape)

        def source():
            loader = NativeRecordLoader(
                paths,
                shape,
                batch_size=batch_size,
                repeat=self.repeat,
                num_epochs=num_epochs,
                shuffle_files=shuffle,
                verify_crc=verify_crc,
                num_threads=threads,
                shuffle_buffer_size=shuffle_buffer,
                seed=seed,
                ring_capacity=ring_capacity,
            )
            try:
                yield from loader
            finally:
                loader.close()

        return NumpyDataset.from_generator(source)

    def create_dataset(self) -> NumpyDataset:
        return self._process()

    def create_input_function(self):
        def _input_function():
            return iter(self._process())

        return _input_function

    def create_generator(self) -> Iterator:
        yield from self._process()


def get_record_paths(directory: str, extension: str = "dert") -> List[str]:
    """Parity with `get_tfrecord_paths`
    (dataset_utils/tfrecord_dataset_creator.py:124-126)."""
    return sorted(glob.glob(os.path.join(directory, "*." + extension)))


def get_subdirectories(directory: str, include_top: bool = True) -> List[str]:
    subdirectories = [directory] if include_top else []
    for dirpath, dirnames, _ in os.walk(top=directory, topdown=True):
        subdirectories += [os.path.join(dirpath, d) for d in dirnames]
    return subdirectories


def get_image_paths(
    directories: Sequence[str], extensions=("jpg", "jpeg", "png")
) -> List[str]:
    image_paths: List[str] = []
    if extensions is None:
        for directory in directories:
            image_paths += glob.glob(os.path.join(directory, "*"))
    else:
        for directory in directories:
            for extension in extensions:
                image_paths += glob.glob(os.path.join(directory, "*." + extension))
    return image_paths


def get_image_class_from_file_name(image_path: str, separator: str = "_") -> int:
    """Class ID from the start of the file name (reference
    tfrecord_generator.py:211-217)."""
    return int(os.path.basename(image_path).split(separator)[0])
