// Fused L-layer forward-Euler integrator, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_euler_fwd_kernel`
// (differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:146,
// launched by `_fused_euler_dense_fwd_impl` at :168).  For an NHWC fp32 batch
// x (B, H, W, C), dense HWIO kernels K (L, 3, 3, C, C) and biases b (L, C):
//
//     y_0 = x,   y_{l+1} = y_l + h * relu(conv3x3_same(y_l, K_l) + b_l)
//
// The conv is the contraction of the Pallas kernel's im2col matmul: for each
// output channel, sum over the 9 taps (row-major) and then over the input
// channels, in fp32.  In bf16 mode every patch element and every kernel element
// is rounded to bf16 (round to nearest even) before the multiply and the sum
// stays fp32, which is `patches.astype(bf16) @ K.astype(bf16)` with
// `preferred_element_type=f32`.  The fp32 mode is true fp32: FFMA on the CUDA
// cores, no TF32.
//
// What bounds it on an H100: operations.  The work is 2*L*B*H*W*9*C^2 FLOP
// (9.66 GFLOP at B=32, L=64, 32x32, C=16) on the fp32 CUDA cores, while the
// bytes it must move are y in, y out and the kernels: about 4.8 MB at the same
// shape.
//
// What the design does about that bound: one thread block per image keeps the
// zero-padded state (H+2)(W+2)C in shared memory for all L layers, next to
// layer l's kernel (9C*C) and bias, so y is read from device memory once and
// written once and each layer is FFMA work fed from shared memory.  Each
// thread holds z for its pixels x all C outputs in registers; the state is
// updated in place after a barrier.  The per-pixel channel stride is padded
// from C to C+4 floats where that still fits, so that the float4 reads of
// eight neighbouring pixels fall on distinct banks.  Shapes the
// register-resident variant does not cover (other C, more pixels) take a
// staged variant that parks the new state in the output buffer between the
// two barriers of a layer.
//
// Known weakness: one block per image fills only B of the 132 SMs (32 at
// batch 32, one at batch 1).  Splitting an image over several blocks (rows
// with a halo exchange) is later work, as is a tiled variant for states
// larger than one SM's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // per block, sm_90
constexpr int kMaxThreads = 512;

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

// Zero-padded state: padded pixel (r, q) at ((r * (W + 2)) + q) * S floats;
// the image sits at r, q in [1, H] x [1, W]; border and channel padding are 0.
__device__ void fill_state(const float* __restrict__ x, float* ypad, int H,
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

__device__ void write_state(const float* ypad, float* __restrict__ out, int H,
                            int W, int C, int S) {
  const int Wp = W + 2;
  for (int i = threadIdx.x; i < H * W * C; i += blockDim.x) {
    const int p = i / C, c = i - p * C;
    const int r = p / W, q = p - r * W;
    out[i] = ypad[((r + 1) * Wp + q + 1) * S + c];
  }
}

// Layer l's kernel (9C x C, tap-major then c_in) and bias into shared memory.
template <bool BF16>
__device__ void load_layer(const float* __restrict__ K,
                           const float* __restrict__ bias, int l, int C,
                           float* Ks, float* bs) {
  const int n = 9 * C * C;
  const float* src = K + static_cast<size_t>(l) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) Ks[i] = operand<BF16>(src[i]);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    bs[i] = bias[static_cast<size_t>(l) * C + i];
  }
}

// Register-resident variant: thread t owns pixels t, t + T, ..., and holds
// z for P pixels x C outputs in registers between the layer's two barriers.
template <int C, int P, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    euler_fwd_resident(const float* __restrict__ x, const float* __restrict__ K,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int H, int W, int L, int S, float h) {
  static_assert(C % 4 == 0, "float4 path");
  extern __shared__ float4 smem4[];
  float* ypad = reinterpret_cast<float*>(smem4);
  const int Wp = W + 2, HW = H * W;
  float* Ks = ypad + (H + 2) * Wp * S;
  float* bs = Ks + 9 * C * C;
  const size_t img = static_cast<size_t>(blockIdx.x) * HW * C;

  fill_state(x + img, ypad, H, W, C, S);
  load_layer<BF16>(K, bias, 0, C, Ks, bs);

  int corner[P];  // offset of the pixel's 3x3 window (tap 0, 0)
  bool own[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    own[k] = p < HW;
    const int pc = own[k] ? p : 0;
    corner[k] = ((pc / W) * Wp + pc % W) * S;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    float acc[P][C];
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int co = 0; co < C; ++co) acc[k][co] = bs[co];
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * Wp + tap % 3) * S;
      const float* kt = Ks + tap * C * C;
#pragma unroll
      for (int ci = 0; ci < C; ci += 4) {
        float4 v[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          v[k] = *reinterpret_cast<const float4*>(ypad + corner[k] + toff + ci);
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
    __syncthreads();  // every thread has read layer l's state and kernel
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!own[k]) continue;
      float* yp = ypad + corner[k] + (Wp + 1) * S;
#pragma unroll
      for (int co = 0; co < C; co += 4) {
        float4 y = *reinterpret_cast<float4*>(yp + co);
        y.x += h * relu(acc[k][co + 0]);
        y.y += h * relu(acc[k][co + 1]);
        y.z += h * relu(acc[k][co + 2]);
        y.w += h * relu(acc[k][co + 3]);
        *reinterpret_cast<float4*>(yp + co) = y;
      }
    }
    if (l + 1 < L) load_layer<BF16>(K, bias, l + 1, C, Ks, bs);
    __syncthreads();
  }
  write_state(ypad, out + img, H, W, C, S);
}

// Staged variant, for any C: one (pixel, output channel) per work item.  The
// new state goes to this image's slice of `out` until every thread has read
// the old one, then back into shared memory; `out` ends up holding y_L.
template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    euler_fwd_staged(const float* __restrict__ x, const float* __restrict__ K,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int H, int W, int C, int L, float h) {
  extern __shared__ float4 smem4[];
  float* ypad = reinterpret_cast<float*>(smem4);
  const int Wp = W + 2, HW = H * W;
  float* Ks = ypad + (H + 2) * Wp * C;
  float* bs = Ks + 9 * C * C;
  const size_t img = static_cast<size_t>(blockIdx.x) * HW * C;
  float* stage = out + img;

  fill_state(x + img, ypad, H, W, C, C);
  load_layer<BF16>(K, bias, 0, C, Ks, bs);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    for (int i = threadIdx.x; i < HW * C; i += blockDim.x) {
      const int p = i / C, co = i - p * C;
      const float* win = ypad + ((p / W) * Wp + p % W) * C;
      float acc = bs[co];
      for (int tap = 0; tap < 9; ++tap) {
        const float* yv = win + ((tap / 3) * Wp + tap % 3) * C;
        const float* kc = Ks + tap * C * C + co;
        for (int ci = 0; ci < C; ++ci) {
          acc = fmaf(operand<BF16>(yv[ci]), kc[ci * C], acc);
        }
      }
      stage[i] = win[(Wp + 1) * C + co] + h * relu(acc);
    }
    __syncthreads();  // every thread has read layer l's state and kernel
    for (int i = threadIdx.x; i < HW * C; i += blockDim.x) {
      const int p = i / C, c = i - p * C;
      ypad[((p / W + 1) * Wp + p % W + 1) * C + c] = stage[i];
    }
    if (l + 1 < L) load_layer<BF16>(K, bias, l + 1, C, Ks, bs);
    __syncthreads();
  }
  write_state(ypad, stage, H, W, C, C);
}

struct Launch {
  const float* x;
  const float* K;
  const float* bias;
  float* out;
  int B, H, W, C, L, S, threads, smem;
  float h;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C, int P, bool BF16>
cudaError_t launch_resident(const Launch& a) {
  auto kernel = euler_fwd_resident<C, P, BF16>;
  cudaError_t err = prepare(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.threads, a.smem, a.stream>>>(a.x, a.K, a.bias, a.out, a.H, a.W,
                                                a.L, a.S, a.h);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_staged(const Launch& a) {
  auto kernel = euler_fwd_staged<BF16>;
  cudaError_t err = prepare(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.threads, a.smem, a.stream>>>(a.x, a.K, a.bias, a.out, a.H, a.W,
                                                a.C, a.L, a.h);
  return cudaGetLastError();
}

template <int C, bool BF16>
cudaError_t dispatch_p(const Launch& a, int P) {
  if constexpr (C == 32) {
    // P = 4 would hold 128 accumulators a thread: staged path instead.
    return P == 1 ? launch_resident<C, 1, BF16>(a) : launch_resident<C, 2, BF16>(a);
  } else {
    switch (P) {
      case 1: return launch_resident<C, 1, BF16>(a);
      case 2: return launch_resident<C, 2, BF16>(a);
      default: return launch_resident<C, 4, BF16>(a);
    }
  }
}

template <bool BF16>
cudaError_t dispatch_c(const Launch& a, int P) {
  switch (a.C) {
    case 4: return dispatch_p<4, BF16>(a, P);
    case 8: return dispatch_p<8, BF16>(a, P);
    case 16: return dispatch_p<16, BF16>(a, P);
    default: return dispatch_p<32, BF16>(a, P);
  }
}

long long smem_bytes(int H, int W, int C, int S) {
  return 4LL * ((H + 2LL) * (W + 2LL) * S + 9LL * C * C + C);
}

// Pixels per thread of the register-resident variant, or 0 where the staged
// variant runs instead.
int resident_pixels(int H, int W, int C) {
  if (C != 4 && C != 8 && C != 16 && C != 32) return 0;
  const int max_p = C == 32 ? 2 : 4;
  for (int p = 1; p <= max_p; p *= 2) {
    if ((H * W + p - 1) / p <= kMaxThreads) return p;
  }
  return 0;
}

// Floats between neighbouring pixels of the shared-memory state.
int state_stride(int H, int W, int C) {
  const bool padded = resident_pixels(H, W, C) > 0 &&
                      smem_bytes(H, W, C, C + 4) <= kMaxSmemBytes;
  return padded ? C + 4 : C;
}

}  // namespace

extern "C" {

// 1 where the register-resident variant runs, 0 for the staged one, -1 for a
// shape the kernel cannot hold in one block's shared memory.
int deqres_euler_fwd_variant(int H, int W, int C) {
  if (H < 1 || W < 1 || C < 1 || smem_bytes(H, W, C, C) > kMaxSmemBytes) return -1;
  return resident_pixels(H, W, C) > 0 ? 1 : 0;
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous fp32 tensors: x and out (B, H, W,
// C), K (L, 3, 3, C, C), bias (L, C).
int deqres_euler_fwd(const float* x, const float* K, const float* bias, float* out,
                     int B, int H, int W, int C, int L, float h, int bf16,
                     void* stream) {
  const int variant = deqres_euler_fwd_variant(H, W, C);
  if (variant < 0 || B < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int S = state_stride(H, W, C);
  Launch a{x, K, bias, out, B, H, W, C, L, S, kMaxThreads,
           static_cast<int>(smem_bytes(H, W, C, S)), h,
           static_cast<cudaStream_t>(stream)};
  if (variant == 0) {
    return static_cast<int>(bf16 ? launch_staged<true>(a) : launch_staged<false>(a));
  }
  const int P = resident_pixels(H, W, C);
  a.threads = ((H * W + P - 1) / P + 31) / 32 * 32;
  return static_cast<int>(bf16 ? dispatch_c<true>(a, P) : dispatch_c<false>(a, P));
}

}  // extern "C"
