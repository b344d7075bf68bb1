"""The port's int8 ops (`ops.quantize`) against the JAX package's: quantized
operands and int32 accumulators bit for bit, rescaled outputs to 1e-6, and
the three int8 training steps in all four backward modes, forward and
gradients to 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops import quantize as jax_q
from differential_equations_resnet_tpu.ops.antisymmetric import materialize_3x3
from differential_equations_resnet_tpu_torch.ops import quantize as q

from torch_parity import both_packed, norm_rel, packed_leaves

MODES = ["ste", "dgrad", "wgrad", "full"]
OUT_TOL = 1e-6   # the rescaled conv output, norm-relative
STEP_TOL = 1e-5  # the training steps' outputs and gradients, norm-relative


def same(got: torch.Tensor, want) -> None:
    """Bit-identical values and the same dtype."""
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def operands(seed, shape=(2, 9, 7, 8), kernel=(3, 3, 8, 16), scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (scale * rng.standard_normal(kernel)).astype(np.float32),
            rng.standard_normal(kernel[-1]).astype(np.float32))


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_weight_and_activation_quantization_is_bit_identical(stacked):
    """kq and scale (per c_out and per tensor, with a zero output channel,
    one kernel or an (L, ...) stack) and y_q, s_y are the JAX package's,
    the zero channel's scale and a zero tensor's included: tiny / 127 is
    subnormal, which XLA flushes to 0, and so does the port."""
    _, k, b = operands(0, kernel=(4, 3, 3, 8, 16) if stacked else (3, 3, 8, 16))
    k[..., 3] = 0.0
    for jax_fn, fn in ((jax_q.quantize_kernel_per_cout, q.quantize_kernel_per_cout),
                       (jax_q.quantize_kernel_per_tensor, q.quantize_kernel_per_tensor)):
        want = jax_fn(jnp.asarray(k), jnp.asarray(b))
        got = fn(torch.from_numpy(k), torch.from_numpy(b))
        same(got.kernel_q, want.kernel_q)
        same(got.scale.contiguous(), want.scale)
        same(got.bias, want.bias)
    y = np.random.default_rng(1).standard_normal((2, 5, 5, 8)).astype(np.float32) * 40
    yq, s_y = q.quantize_activations_per_tensor(torch.from_numpy(y))
    want_yq, want_s = jax_q.quantize_activations_per_tensor(jnp.asarray(y))
    same(yq, want_yq)
    same(s_y, want_s)
    zq, zs = q.quantize_activations_per_tensor(torch.zeros(2, 3))
    want_zq, want_zs = jax_q.quantize_activations_per_tensor(jnp.zeros((2, 3)))
    same(zq, want_zq)
    same(zs, want_zs)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_accumulators_are_bit_identical(k, stride):
    """`_dynamic_int8_conv_parts` at stride 1 and 2 (TF SAME: the extra
    row and column after the image, 9x7 input): the int8 operands and the
    int32 accumulator equal XLA's int8 conv, the rescaled output to 1e-6."""
    x, kern, b = operands(k + stride, kernel=(k, k, 8, 16))
    qp_j = jax_q.quantize_kernel_per_cout(jnp.asarray(kern), jnp.asarray(b))
    qp = q.quantize_kernel_per_cout(torch.from_numpy(kern), torch.from_numpy(b))
    strides = (stride, stride)
    want_z, want_yq, want_s = jax_q._dynamic_int8_conv_parts(jnp.asarray(x), qp_j, strides)
    z, yq, s_y = q._dynamic_int8_conv_parts(torch.from_numpy(x), qp, strides)
    same(yq, want_yq)
    same(s_y, want_s)
    want_acc = jax.lax.conv_general_dilated(
        want_yq, qp_j.kernel_q, strides, "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    same(q.int8_conv_same(yq, qp.kernel_q, strides), want_acc)
    assert z.shape == want_z.shape and norm_rel(z, want_z) <= OUT_TOL
    assert norm_rel(q.dynamic_int8_conv_same(torch.from_numpy(x), qp, strides), want_z) <= OUT_TOL


@pytest.mark.parametrize("k", [1, 3, 5])
def test_wgrad_taps_equal_the_jax_conv_form(k):
    """The port's tap-form weight-gradient correlation equals the JAX
    package's conv form (`_int8_wgrad`) exactly, and its own tap form."""
    rng = np.random.default_rng(k)
    yq = rng.integers(-127, 128, (3, 6, 5, 8)).astype(np.int8)
    gq = rng.integers(-127, 128, (3, 6, 5, 16)).astype(np.int8)
    got = q._int8_wgrad(torch.from_numpy(yq), torch.from_numpy(gq), (k, k))
    same(got, jax_q._int8_wgrad(jnp.asarray(yq), jnp.asarray(gq), (k, k)))
    same(got, jax_q._int8_wgrad_taps(jnp.asarray(yq), jnp.asarray(gq), (k, k)))


@pytest.mark.parametrize("m,k,n", [(3, 5, 3), (17, 8, 8), (40, 72, 12), (2, 0, 8)])
def test_int8_matmul_pads_exactly(m, k, n):
    """Zero padding to the card GEMM's shapes (M > 16, K and N multiples
    of 8, K = 0 included) leaves the int32 product exact."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b_t = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = q.int8_matmul(torch.from_numpy(a), torch.from_numpy(b_t))
    same(got, a.astype(np.int32) @ b_t.astype(np.int32).T)


def test_transposed_kernel():
    """The adjoint's kernel: rot180 and the channel swap; for a per-tensor
    quantized antisymmetric kernel exactly its negation."""
    _, k, _ = operands(2, kernel=(5, 3, 4, 6))
    kq = q.quantize_kernel_per_cout(torch.from_numpy(k)).kernel_q
    same(q.transpose_int8_kernel(kq), jax_q.transpose_int8_kernel(jnp.asarray(kq.numpy())))
    jax_params, _ = both_packed(packed_leaves(np.random.default_rng(3), 8))
    antisym = np.array(materialize_3x3(jax_params))
    kq = q.quantize_kernel_per_tensor(torch.from_numpy(antisym)).kernel_q
    same(q.transpose_int8_kernel(kq), -kq.numpy())


STEPS = {
    "euler": (lambda y, k, b, **kw: jax_q.euler_relu_step_int8(y, k, b, 0.3, **kw),
              lambda y, k, b, **kw: q.euler_relu_step_int8(y, k, b, 0.3, **kw)),
    "conv": (jax_q.conv_int8_same, q.conv_int8_same),
    "field": (jax_q.conv_relu_field_int8, q.conv_relu_field_int8),
}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step", sorted(STEPS))
def test_training_steps_match_jax(step, mode, k):
    """Forward (and the relu mask it implies) and (dy, dk, db) at a random
    cotangent, the port's autograd Function against the JAX custom VJP, in
    every backward mode at k = 3 and 5, to 1e-5 norm-relative."""
    rng = np.random.default_rng([sorted(STEPS).index(step), MODES.index(mode), k])
    y = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    kern = (0.2 * rng.standard_normal((k, k, 8, 8))).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    cot = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    jax_fn, fn = STEPS[step]
    want, vjp = jax.vjp(lambda *a: jax_fn(*a, backward=mode), *map(jnp.asarray, (y, kern, b)))
    want_grads = vjp(jnp.asarray(cot))
    leaves = [torch.tensor(v, requires_grad=True) for v in (y, kern, b)]
    out = fn(*leaves, backward=mode)
    out.backward(torch.from_numpy(cot))
    assert norm_rel(out, want) <= STEP_TOL
    if step != "conv":  # the relu masks: where the step moved y, or the field is > 0
        base = y if step == "euler" else 0.0
        np.testing.assert_array_equal(out.detach().numpy() > base, np.asarray(want) > base)
    for leaf, w in zip(leaves, want_grads):
        assert norm_rel(leaf.grad, w) <= STEP_TOL


def test_validation_errors_match_jax():
    y, k, b = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="bias"):
        q.euler_relu_step_int8(y, k, None, 0.1)
    with pytest.raises(ValueError, match="backward must be one of"):
        q.conv_int8_same(y, k, b, backward="bogus")
    with pytest.raises(ValueError, match="per_tensor"):
        q.conv_relu_field_int8(y, k, b, weight_scale="per_cout", backward="wgrad")
    with pytest.raises(ValueError, match="odd spatial"):
        q.conv_int8_same(y, torch.zeros(2, 2, 2, 2), b, backward="full")
    with pytest.raises(ValueError, match="weight_scale"):
        q.euler_relu_step_int8(y, k, b, 0.1, weight_scale="per_row")
    # per-c_out scales train in 'ste', and an even kernel does too.
    out = q.conv_int8_same(y, torch.zeros(2, 2, 2, 2), b, weight_scale="per_cout")
    assert out.shape == (1, 4, 4, 2)
