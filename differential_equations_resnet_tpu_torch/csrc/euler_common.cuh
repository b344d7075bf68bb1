// Device code shared by the fused Euler kernels (fused_euler_fwd.cu and
// fused_euler_bwd.cu): operand rounding, the zero-padded shared-memory state
// and the register-tiled 3x3 convolution of one block's pixels.
//
// Padded state layout: padded pixel (r, q) of an (H+2) x (W+2) image starts at
// ((r * (W + 2)) + q) * S floats; the image sits at r, q in [1, H] x [1, W];
// border and channel padding (S - C floats a pixel) are 0.  Kernels are laid
// out (9C x C), tap-major (row-major over the 3x3 window) then c_in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deqres {

constexpr int kMaxSmemBytes = 232448;  // per block, sm_90
constexpr int kMaxThreads = 512;

// In bf16 mode every conv operand is rounded to bf16 (round to nearest even)
// and the sums stay fp32, which is `a.astype(bf16) @ b.astype(bf16)` with
// `preferred_element_type=f32`.
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// relu that keeps a NaN, as jnp.maximum(z, 0) and torch.relu do.
__device__ __forceinline__ float relu(float z) { return z <= 0.f ? 0.f : z; }

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The whole padded buffer: x's image in the interior, zeros elsewhere.
__device__ inline void fill_state(const float* __restrict__ x, float* ypad, int H,
                                  int W, int C, int S) {
  const int Wp = W + 2;
  const int n = (H + 2) * Wp * S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pp = i / S, c = i - pp * S;
    const int r = pp / Wp, q = pp - r * Wp;
    float v = 0.f;
    if (c < C && r >= 1 && r <= H && q >= 1 && q <= W) {
      v = x[((r - 1) * W + (q - 1)) * C + c];
    }
    ypad[i] = v;
  }
}

// Layer l's (9C x C) kernel into shared memory, operands rounded as the mode says.
template <bool BF16>
__device__ inline void load_kernel(const float* __restrict__ K, int l, int C, float* Ks) {
  const int n = 9 * C * C;
  const float* src = K + static_cast<size_t>(l) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) Ks[i] = operand<BF16>(src[i]);
}

template <bool BF16>
__device__ inline void load_layer(const float* __restrict__ K,
                                  const float* __restrict__ bias, int l, int C,
                                  float* Ks, float* bs) {
  load_kernel<BF16>(K, l, C, Ks);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    bs[i] = bias[static_cast<size_t>(l) * C + i];
  }
}

// acc[k][co] += sum over the 9 taps and the C inputs of the padded source's
// window at corner[k] times Ks: the 3x3 "SAME" convolution of P pixels of one
// thread, C outputs each, fed from shared memory (float4 reads of the
// source, float4 reads of a kernel row).
template <int C, int P, bool BF16>
__device__ __forceinline__ void conv_accumulate(const float* src, const int (&corner)[P],
                                                int Wp, int S, const float* Ks,
                                                float (&acc)[P][C]) {
  static_assert(C % 4 == 0, "float4 path");
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * Wp + tap % 3) * S;
    const float* kt = Ks + tap * C * C;
#pragma unroll
    for (int ci = 0; ci < C; ci += 4) {
      float4 v[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        v[k] = *reinterpret_cast<const float4*>(src + corner[k] + toff + ci);
        v[k].x = operand<BF16>(v[k].x);
        v[k].y = operand<BF16>(v[k].y);
        v[k].z = operand<BF16>(v[k].z);
        v[k].w = operand<BF16>(v[k].w);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* krow = kt + (ci + q) * C;
#pragma unroll
        for (int co = 0; co < C; co += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + co);
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float a = lane(v[k], q);
            acc[k][co + 0] = fmaf(a, kv.x, acc[k][co + 0]);
            acc[k][co + 1] = fmaf(a, kv.y, acc[k][co + 1]);
            acc[k][co + 2] = fmaf(a, kv.z, acc[k][co + 2]);
            acc[k][co + 3] = fmaf(a, kv.w, acc[k][co + 3]);
          }
        }
      }
    }
  }
}

// Register-resident pixel ownership: thread t owns pixels t, t + T, ...;
// corner[k] is the offset of pixel k's 3x3 window (tap 0, 0) in the padded
// state.
template <int P>
__device__ __forceinline__ void own_pixels(int HW, int W, int Wp, int S, int (&corner)[P],
                                           bool (&own)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    own[k] = p < HW;
    const int pc = own[k] ? p : 0;
    corner[k] = ((pc / W) * Wp + pc % W) * S;
  }
}

}  // namespace deqres
