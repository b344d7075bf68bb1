"""The plain reference: the cells' models, their training steps and their
serving forward in plain PyTorch, from the published descriptions.

It imports nothing of the port and takes nothing the port made: it gets the
weights and data the benchmark drew from the seed (`perfbench.weights`),
works out the antisymmetric kernels from the packed parameters again
(`antisym_from_packed`, `antisym_from_dense_lower`: frozen copies of the
port's `ops/antisymmetric.py` materializations), replays the feed's order
(the device-resident epoch's shuffle and augmentation from the epoch's
generator, `perfbench.frozen`; or the host pipeline's permutation), and runs
its own forward, loss, gradients and Adam.
Activations are NCHW here, the weights the port's HWIO layouts by name.

Precision: fp32 with TF32 off for matmuls and cuDNN (`precision`), or, for
the control, TF32 on.

- Single-block ODE-ResNet (Haber & Ruthotto, arXiv:1705.03341): the input
  less ``subtract_mean`` over ``divide_by_stddev``, a 3x3 stem conv with
  bias and relu, L forward-Euler layers ``y + h * relu(conv3x3(y, K_l) +
  b_l)`` with antisymmetric K_l, global average pooling, a dense head.
  With more than one stage (He et al.'s CIFAR layout, arXiv:1512.03385
  section 4.2), each later stage opens with a conv block ``relu(conv_kxk(y,
  stride)) + conv_1x1(y, stride)``, each conv with bias, before its Euler
  layers.
- ResNet-50 v1 (He et al., arXiv:1512.03385) with antisymmetric 3x3
  mid-convs: zero pad 3, 7x7/2 VALID conv, batch norm, relu, zero pad 1,
  3x3/2 max pool; bottleneck blocks 1x1 (strided in v1), 3x3, 1x1, each
  with bias and batch norm (eps 1e-3; running statistics 0.99 old + 0.01
  batch, biased variance), projection shortcuts with batch norm; global
  average pooling and a dense head.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import frozen

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99
ADAM_BETAS = (0.9, 0.999)

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool):
    """matmul and cuDNN TF32 set to ``tf32`` inside, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


# -- antisymmetric kernels (frozen copies of the port's materializations) ----

def _diag_blocks(a, b, c, d, gamma: float, axis: int) -> torch.Tensor:
    g = torch.full_like(a, gamma)
    return torch.stack([torch.stack([a, b, c], dim=axis),
                        torch.stack([d, g, -d], dim=axis),
                        torch.stack([-c, -b, -a], dim=axis)], dim=axis)


def cross_pairs(channels: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_in, c_out) of the packed cross blocks: c_in > c_out, ordered by
    c_out, then c_in."""
    co, ci = torch.triu_indices(channels, channels, offset=1, device=device)
    return ci, co


def antisym_from_packed(a, b, c, d, cross, gamma: float) -> torch.Tensor:
    """Stacked packed parameters ((L, C) a-d, (L, 3, 3, C(C-1)/2) cross) ->
    dense (L, 3, 3, C, C) HWIO kernels: diagonal blocks [[a, b, c], [d, g,
    -d], [-c, -b, -a]], cross blocks at (c_in > c_out) and their mirrors
    -rot180 at (c_out, c_in)."""
    layers, channels = a.shape
    kernel = a.new_zeros((layers, 3, 3, channels, channels))
    idx = torch.arange(channels, device=a.device)
    kernel[:, :, :, idx, idx] = _diag_blocks(a, b, c, d, gamma, 1)
    if channels > 1:
        ci, co = cross_pairs(channels, a.device)
        kernel[:, :, :, ci, co] = cross
        kernel[:, :, :, co, ci] = -cross.flip(1, 2)
    return kernel


def antisym_from_dense_lower(a, b, c, d, cross, gamma: float) -> torch.Tensor:
    """The dense-lower layout ((..., 3, 3, C, C) cross, strictly lower
    entries used) -> the full (..., 3, 3, C, C) HWIO kernel."""
    channels = a.shape[-1]
    lower = torch.ones(channels, channels, dtype=torch.bool, device=a.device).tril(-1)
    diag = _diag_blocks(a, b, c, d, gamma, a.dim() - 1)
    w = torch.where(lower, cross, 0.0)
    kernel = w - w.flip(-4, -3).transpose(-1, -2)
    return kernel + diag[..., None] * torch.eye(channels, device=a.device, dtype=a.dtype)


# -- layers -------------------------------------------------------------------

def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, hwio: torch.Tensor, bias: Optional[torch.Tensor], stride: int = 1,
         same: bool = True) -> torch.Tensor:
    """NCHW convolution by an HWIO kernel, TF "SAME" (or VALID) padding."""
    k = hwio.shape[0]
    if same:
        top, bottom = _same_pad(x.shape[2], k, stride)
        left, right = _same_pad(x.shape[3], hwio.shape[1], stride)
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, hwio.permute(3, 2, 0, 1), bias, stride=stride)


def batch_norm(x, scale, offset, mean, var, train: bool):
    """(y, (new mean, new var)) of a channel batch norm of NCHW ``x``."""
    if train:
        bvar, bmean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        new = (BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * bmean.detach(),
               BN_MOMENTUM * var + (1 - BN_MOMENTUM) * bvar.detach())
    else:
        bmean, bvar, new = mean, var, (mean, var)
    shape = (1, -1, 1, 1)
    y = (x - bmean.view(shape)) * torch.rsqrt(bvar.view(shape) + BN_EPSILON)
    return y * scale.view(shape) + offset.view(shape), new


def normalize(images: torch.Tensor, model: dict) -> torch.Tensor:
    """NHWC images (0-255) -> the normalized NCHW fp32 input."""
    x = images.to(torch.float32)
    for key, op in (("subtract_mean", torch.sub), ("divide_by_stddev", torch.div)):
        if model.get(key) is not None:
            x = op(x, torch.as_tensor(model[key], dtype=torch.float32, device=x.device))
    return x.permute(0, 3, 1, 2)


def head(p: Params, y: torch.Tensor) -> torch.Tensor:
    return y.mean(dim=(2, 3)) @ p["head__kernel"] + p["head__bias"]


# -- the single-block ODE-ResNet ------------------------------------------------

def check_single_block(model: dict) -> None:
    wanted = dict(kernel_type="antisymmetric", kernel_size=3, integrator="euler",
                  use_batch_norm=False, include_top=True)
    for key, value in wanted.items():
        if model[key] != value:
            raise NotImplementedError(f"the reference runs {key}={value!r}, not {model[key]!r}")
    if model["num_stages"] < 2 or list(model["strides"][0]) != [1, 1] or \
            any(model["use_max_pooling"][:model["num_stages"] - 1]):
        raise NotImplementedError("the reference runs a stride-1 first stage and no pooling")
    if any(sh != sw for sh, sw in (plan.strides for plan in frozen.stage_plans(model))):
        raise NotImplementedError("the reference runs square strides")


def single_block_logits(p: Params, state: Params, images, model: dict, train: bool):
    check_single_block(model)
    if model["num_stages"] > 2:
        return _multi_stage_logits(p, state, images, model)
    y = torch.relu(conv(normalize(images, model), p["stem__kernel"], p["stem__bias"]))
    s = "stages__0__blocks__"
    kernels = antisym_from_packed(*(p[s + f] for f in "abcd"), p[s + "cross"], model["gamma"])
    h = float(model["h"])
    for layer in range(kernels.shape[0]):
        y = y + h * torch.relu(conv(y, kernels[layer], p[s + "bias"][layer]))
    return head(p, y), state


def _multi_stage_logits(p: Params, state: Params, images, model: dict):
    """The single-block model of more than one stage: after the stem, each
    stage's conv block (where its plan has one), then its Euler layers."""
    y = torch.relu(conv(normalize(images, model), p["stem__kernel"], p["stem__bias"]))
    h = float(model["h"])
    for stage, plan in enumerate(frozen.stage_plans(model)):
        s = f"stages__{stage}__"
        if plan.has_conv_block:
            stride = plan.strides[0]
            y = torch.relu(conv(y, p[s + "conv_main__kernel"], p[s + "conv_main__bias"], stride)) \
                + conv(y, p[s + "conv_shortcut__kernel"], p[s + "conv_shortcut__bias"], stride)
        if plan.num_identity:
            s += "blocks__"
            kernels = antisym_from_packed(*(p[s + f] for f in "abcd"), p[s + "cross"],
                                          model["gamma"])
            for layer in range(kernels.shape[0]):
                y = y + h * torch.relu(conv(y, kernels[layer], p[s + "bias"][layer]))
    return head(p, y), state


# -- ResNet-50 v1 with antisymmetric mid-convs ---------------------------------------

def _bottleneck(x, p: Params, st: Params, prefix: str, layer: Optional[int], stride: int,
                model: dict, train: bool, new_state: Params):
    """One block's main path (v1: the first 1x1 strided)."""
    def leaf(name):
        t = p[prefix + name]
        return t if layer is None else t[layer]

    def bn(y, name):
        mean, var = st[f"{prefix}{name}__mean"], st[f"{prefix}{name}__var"]
        if layer is not None:
            mean, var = mean[layer], var[layer]
        y, (m, v) = batch_norm(y, leaf(name + "__scale"), leaf(name + "__offset"), mean, var, train)
        new_state.setdefault(f"{prefix}{name}__mean", []).append(m)
        new_state.setdefault(f"{prefix}{name}__var", []).append(v)
        return y

    if model["version"] != 1:
        raise NotImplementedError("the reference runs ResNet v1")
    mid = antisym_from_dense_lower(*(leaf("conv2__" + f) for f in "abcd"), leaf("conv2__cross"),
                                   model["gamma"])
    y = torch.relu(bn(conv(x, leaf("conv1__kernel"), leaf("conv1__bias"), stride), "bn1"))
    y = torch.relu(bn(conv(y, mid, leaf("conv2__bias")), "bn2"))
    return bn(conv(y, leaf("conv3__kernel"), leaf("conv3__bias")), "bn3")


def check_bottleneck(model: dict) -> None:
    if model["kernel_type"] != "antisymmetric" or not model["use_batch_norm"] or \
            any(f[1] is not None for f in model["filters_per_block"]):
        raise NotImplementedError("the reference runs antisymmetric mid-convs with batch norm")


def bottleneck_logits(p: Params, state: Params, images, model: dict, train: bool):
    check_bottleneck(model)
    new_state: Dict[str, List[torch.Tensor]] = {}
    x = F.pad(normalize(images, model), (3, 3, 3, 3))
    x = conv(x, p["stem__kernel"], p["stem__bias"], 2, same=False)
    x, (m, v) = batch_norm(x, p["stem_bn__scale"], p["stem_bn__offset"],
                           state["stem_bn__mean"], state["stem_bn__var"], train)
    new_state["stem_bn__mean"], new_state["stem_bn__var"] = [m], [v]
    x = F.max_pool2d(F.pad(torch.relu(x), (1, 1, 1, 1)), 3, 2)
    for stage, blocks in enumerate(model["blocks_per_stage"]):
        s = f"stages__{stage}__"
        stride = 1 if stage == 0 else 2
        main = _bottleneck(x, p, state, s + "conv_block__", None, stride, model, train, new_state)
        short = conv(x, p[s + "shortcut__kernel"], p[s + "shortcut__bias"], stride)
        short, (m, v) = batch_norm(short, p[s + "bn_shortcut__scale"], p[s + "bn_shortcut__offset"],
                                   state[s + "bn_shortcut__mean"], state[s + "bn_shortcut__var"],
                                   train)
        new_state[s + "bn_shortcut__mean"], new_state[s + "bn_shortcut__var"] = [m], [v]
        x = torch.relu(main + short)
        for layer in range(blocks - 1):
            x = torch.relu(x + _bottleneck(x, p, state, s + "identity_blocks__", layer, 1, model,
                                           train, new_state))
    stacked = {k: (v[0] if k in state and state[k].shape == v[0].shape else torch.stack(v))
               for k, v in new_state.items()}
    return head(p, x), stacked


LOGITS = {"single_block": single_block_logits, "bottleneck": bottleneck_logits}


def initial_state(shapes: Dict[str, Tuple[int, ...]], device) -> Params:
    """The running statistics at the start: mean 0, variance 1."""
    return {n: (torch.zeros if n.endswith("__mean") else torch.ones)(s, device=device)
            for n, s in shapes.items()}


def probabilities(family: str, model: dict, weights: Params, state: Params, images,
                  block: int = 1024, tf32: bool = False) -> torch.Tensor:
    """The eval-mode softmax of ``images`` (NHWC, 0-255), in blocks of
    ``block`` rows."""
    out = []
    with torch.no_grad(), precision(tf32):
        for i in range(0, len(images), block):
            logits, _ = LOGITS[family](weights, state, images[i:i + block], model, False)
            out.append(torch.softmax(logits, dim=-1))
    return torch.cat(out)


# -- training ---------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, -1).gather(1, labels[:, None]).mean()


def _mean_norm_row(family: str, model: dict, g: Params) -> List[float]:
    """The per-layer gradient mean norms the port logs: the stem kernel's
    norm over its size, then each antisymmetric 3x3 kernel's norm over its
    free degrees of freedom 4C + 9C(C-1)/2, in layer order; a single-block
    stage's conv block gives its main kernel's norm over its size before
    the stage's stack."""
    def mean_norm(name):
        return torch.linalg.vector_norm(g[name]) / g[name].numel()

    row = [mean_norm("stem__kernel")]

    def antisym(prefix, stacked):
        leaves = [g[prefix + f] for f in ("a", "b", "c", "d", "cross")]
        channels = leaves[0].shape[-1]
        free = 4 * channels + 9 * channels * (channels - 1) // 2
        dims = lambda t: tuple(range(1 if stacked else 0, t.dim()))
        sq = sum(torch.sum(t * t, dim=dims(t)) for t in leaves)
        return (torch.sqrt(sq) / free).reshape(-1)

    if family == "single_block":
        for stage, plan in enumerate(frozen.stage_plans(model)):
            if plan.has_conv_block:
                row.append(mean_norm(f"stages__{stage}__conv_main__kernel"))
            if plan.num_identity:
                row.append(antisym(f"stages__{stage}__blocks__", True))
    else:
        for stage, blocks in enumerate(model["blocks_per_stage"]):
            row.append(antisym(f"stages__{stage}__conv_block__conv2__", False))
            if blocks > 1:
                row.append(antisym(f"stages__{stage}__identity_blocks__conv2__", True))
    return torch.cat([r.reshape(-1) for r in row]).tolist()


def leaf_norms(tensors: Params) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def resident_batches(features, labels, data_seed: int, batch: int, augment):
    """``at(t) -> (images, labels)``: the device-resident epoch's batch at
    global step t when every epoch is one step: its generator seeded
    `frozen.fold_in`(data_seed, t) draws the permutation on the card, then
    the augmentation."""
    def at(t: int):
        gen = torch.Generator(device=features.device)
        gen.manual_seed(frozen.fold_in(data_seed, t))
        idx = torch.randperm(features.shape[0], generator=gen, device=features.device)[:batch]
        x = features.index_select(0, idx).to(torch.float32)
        return (augment(gen, x) if augment is not None else x), labels.index_select(0, idx)

    return at


def streamed_batches(features, labels, data_seed: int, batch: int):
    """``at(t) -> (images, labels)``: the host pipeline's batch t, one
    permutation of the set from NumPy's ``default_rng(data_seed)`` taken
    in turn, no augmentation."""
    perm = torch.from_numpy(np.random.default_rng(data_seed).permutation(features.shape[0]))

    def at(t: int):
        idx = perm[t * batch:(t + 1) * batch].to(features.device)
        return features.index_select(0, idx).to(torch.float32), labels.index_select(0, idx)

    return at


def first_steps(family: str, model: dict, weights: Params, state: Params, batches,
                lr: float, eps: float, steps: int = 3, tf32: bool = False,
                half_batch: bool = False) -> dict:
    """The readings of the first ``steps`` steps of training from
    ``weights`` on ``batches(t)``.  Returns {"loss": [...], "grad": the
    first gradient's norm by leaf, "row": the first step's gradient mean
    norms, "change": the parameters' change after ``steps`` by leaf, "bn":
    the running statistics' change after the first step by leaf}.
    ``half_batch`` plants a fault: the loss over the first half of each
    batch only."""
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    state = {n: s.clone() for n, s in state.items()}
    first = dict(state)
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    out: dict = {"loss": []}
    names = list(params)
    with precision(tf32):
        for t in range(steps):
            x, y = batches(t)
            if half_batch:
                x, y = x[:len(x) // 2], y[:len(y) // 2]
            logits, state = LOGITS[family](params, state, x, model, True)
            loss = cross_entropy(logits, y)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            out["loss"].append(float(loss.detach()))
            if t == 0:
                out["grad"] = leaf_norms(grads)
                out["row"] = _mean_norm_row(family, model, grads)
                out["bn"] = leaf_norms({n: state[n] - first[n] for n in state})
            adam(params, grads, m, v, t + 1, lr, eps)
    out["change"] = leaf_norms({n: params[n].detach() - weights[n] for n in names})
    return out


def adam(params: Params, grads: Params, m: Params, v: Params, t: int, lr: float, eps: float):
    """One Adam step: lr * m_hat / (sqrt(v_hat) + eps)."""
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n]
            m[n].mul_(b1).add_(g, alpha=1 - b1)
            v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
            p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
