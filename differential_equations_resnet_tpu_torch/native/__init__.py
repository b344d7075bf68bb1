"""Native (C++) components: the DERT record codec and the threaded
prefetching batch loader, built with g++ into ``build/native/`` at first
use."""

from differential_equations_resnet_tpu_torch.native.codec import (
    native_codec_available,
    read_raw_shard,
    write_raw_shard,
)
from differential_equations_resnet_tpu_torch.native.loader import (
    NativeRecordLoader,
    native_loader_available,
)

__all__ = [
    "NativeRecordLoader",
    "native_codec_available",
    "native_loader_available",
    "read_raw_shard",
    "write_raw_shard",
]
