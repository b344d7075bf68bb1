"""Weights and data made from the seed, on the device, in a few large calls.

Every cell draws its inputs here and hands the same to the program and to
the reference: the weights as a flat dict from parameter name (the port's
``state_dict`` key: the tree path joined by "__") to tensor, the images and
labels as uint8 and int64 tensors.  One seed always gives the same numbers
on one device: each draw has its own `torch.Generator`, seeded from the
run's seed and the draw's name.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, Tuple

import torch


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one named draw of one run."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") % (2 ** 63))
    return g


# -- parameter trees --------------------------------------------------------

def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of a parameter tree (dicts, lists,
    NamedTuples), names joined by "__" as the port's ``state_dict`` keys;
    None leaves skipped."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field, value in zip(tree._fields, tree):
            yield from leaves(value, f"{prefix}__{field}" if prefix else field)
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, f"{prefix}__{key}" if prefix else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from leaves(value, f"{prefix}__{i}" if prefix else str(i))


def rebuild(tree, fn: Callable[[str, torch.Tensor], torch.Tensor], prefix: str = ""):
    """The tree with each tensor leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[rebuild(v, fn, f"{prefix}__{f}" if prefix else f)
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, f"{prefix}__{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, fn, f"{prefix}__{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return tree


_ANTISYM_FIELDS = ("a", "b", "c", "d", "cross")


def _is_stacked(name: str) -> bool:
    """A leaf of a stack of identity blocks, with a leading layer axis."""
    parts = name.split("__")
    return "blocks" in parts or "identity_blocks" in parts


def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """How a leaf starts: ("normal", stddev) for a He truncated normal
    (stddev sqrt(2 / fan_in), truncated at two standard deviations),
    ("zeros", 0) or ("ones", 0).  Kernels: fan_in is every axis but the
    output one (and the layer axis of a stack); the free parameters of an
    antisymmetric 3x3 kernel: 9 * C."""
    field = name.rsplit("__", 1)[-1]
    if field in ("bias", "offset"):
        return "zeros", 0.0
    if field == "scale":
        return "ones", 0.0
    body = shape[1:] if _is_stacked(name) else shape
    if field in _ANTISYM_FIELDS:
        channels = body[-1]
        return "normal", math.sqrt(2.0 / (9 * channels))
    if field == "kernel":
        return "normal", math.sqrt(2.0 / math.prod(body[:-1]))
    raise ValueError(f"no init rule for the leaf {name!r}")


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 dense_lower: Callable[[str], bool] = lambda name: False) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` drawn from ``seed`` on ``device``: one
    truncated-normal draw for all the normal leaves, each a scaled view of
    it.  A dense-lower antisymmetric ``cross`` leaf (``dense_lower(name)``)
    keeps only its strictly lower (c_in > c_out) entries, as the layout
    holds."""
    rules = {name: init_rule(name, shape) for name, shape in shapes.items()}
    normal = [n for n, (kind, _) in rules.items() if kind == "normal"]
    total = sum(math.prod(shapes[n]) for n in normal)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(seed, "weights", device))
    out, offset = {}, 0
    for name, shape in shapes.items():
        kind, std = rules[name]
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = buf[offset:offset + n].view(shape) * std
            offset += n
            if dense_lower(name):
                c = shape[-1]
                leaf = leaf * torch.ones(c, c, device=device).tril(-1)
            out[name] = leaf
    return out


# -- data -------------------------------------------------------------------

def images_and_labels(count: int, image_shape, num_classes: int, seed: int, purpose: str,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``count`` uint8 images (N, H, W, C) and int64 labels, uniform, drawn
    on ``device``."""
    g = generator(seed, purpose, device)
    images = torch.randint(0, 256, (count, *image_shape), generator=g, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, num_classes, (count,), generator=g, device=device)
    return images, labels
