// Backward of the fused L-layer forward-Euler integrator, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_euler_bwd_kernel`
// (differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:216,
// launched by `_fused_euler_dense_bwd_impl` at :290).  For the forward
//
//     y_0 = x,   y_{l+1} = y_l + h * relu(z_l),   z_l = conv3x3_same(y_l, K_l) + b_l
//
// and a cotangent g of y_L it returns, from x alone (no saved trajectory):
//
//     g_z  = h * 1[z_l > 0] * g                      (g the cotangent of y_{l+1})
//     dK_l = patches(y_l)^T @ g_z                     (9C x C)
//     db_l = sum over pixels of g_z
//     g   <- g + conv3x3_same(g_z, K_l^T)             (K_l^T: rot180, c_in <-> c_out)
//
// walking l = L-1 .. 0; gx is the final g.  dK and db are written as
// per-image partials (B, L, 9, C, C) and (B, L, C) that the wrapper sums over
// images: no float atomics, so the sums are deterministic.  K^T is arranged
// by the wrapper, as the Pallas wrapper does (:302-306).
//
// Numerics: the forward recompute, the z recompute and the g_z * K^T product
// take bf16 operands (fp32 sums) in bf16 mode, as B1 and the Pallas kernel
// do; dK and db are fp32 in both modes (the Pallas `dot_general` at :266-270
// never casts).  The fp32 mode is true fp32: FFMA on the CUDA cores, no TF32.
//
// What bounds it on an H100: operations.  The least work from x is three
// 2*L*B*H*W*9*C^2 products (forward recompute, dK, the state cotangent):
// 28.99 GFLOP at B=32, L=64, 32x32, C=16, against fp32 CUDA cores.  This
// kernel also recomputes z in the reverse sweep, so it does four.
//
// What the design does about that bound: one thread block per image, as B1.
//   1. Forward recompute: B1's step in a loop, each pre-step state y_l
//      written to a global trajectory scratch (L, B, H, W, C) that the wrapper
//      allocates: one SM cannot hold 64 states, as the Pallas kernel holds
//      them in VMEM.
//   2. Reverse sweep, per layer: y_l back into a zero-padded shared buffer;
//      z_l recomputed per pixel; g_z formed into a second zero-padded shared
//      buffer; dK_l and db_l by a register-tiled pass (below); then g_z * K^T
//      added into g.  The register-resident variant keeps g in registers for
//      each thread's pixels; the staged variant keeps it in the image's slice
//      of gx.
//   dK pass: a work item is (c_in, a group of G outputs, a chunk of rows); it
//   slides a 3x3 window of y along each of its rows, so each new pixel costs
//   three loads of y and one of g_z for 9*G FMAs, and the R row chunks of an
//   item group sit in adjacent lanes and are summed with warp shuffles.
//
// Known weaknesses: one block per image fills only B of the 132 SMs (32 at
// batch 32), as B1; z is recomputed rather than kept as a mask; y_l's load
// into shared memory is not overlapped with the previous layer's work.

#include "euler_common.cuh"

using namespace deqres;

namespace {

// dK_l and db_l of one image from the padded y_l and g_z in shared memory.
// R (a power of two <= 32) row chunks per item; every thread of the block
// calls this the same number of times (the shuffles need full warps).
template <int G>
__device__ void weight_grads(const float* ypad, const float* gpad, int H, int W, int C,
                             int S, int R, float* __restrict__ gk,
                             float* __restrict__ gb) {
  const int Wp = W + 2;
  const int groups = C / G;
  const int items = C * groups * R;
  for (int base = 0; base < items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool active = item < items;
    const int grp = item / R, chunk = item - grp * R;
    const int ci = grp / groups, co = (grp - ci * groups) * G;
    float acc[9][G];
    float dsum[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dsum[j] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[t][j] = 0.f;
    }
    if (active) {
#pragma unroll 1
      for (int r = chunk; r < H; r += R) {
        const float* yr = ypad + r * Wp * S + ci;                // padded rows r .. r+2
        const float* gr = gpad + ((r + 1) * Wp + 1) * S + co;    // interior row r
        float w[3][3];                                           // [row][column] window
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          w[dr][0] = yr[(dr * Wp) * S];
          w[dr][1] = yr[(dr * Wp + 1) * S];
        }
#pragma unroll 1
        for (int q = 0; q < W; ++q) {
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) w[dr][2] = yr[(dr * Wp + q + 2) * S];
          float gz[G];
          if constexpr (G == 4) {
            const float4 v = *reinterpret_cast<const float4*>(gr + q * S);
            gz[0] = v.x;
            gz[1] = v.y;
            gz[2] = v.z;
            gz[3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < G; ++j) gz[j] = gr[q * S + j];
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
            dsum[j] += gz[j];
#pragma unroll
            for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
              for (int dq = 0; dq < 3; ++dq) {
                acc[dr * 3 + dq][j] = fmaf(w[dr][dq], gz[j], acc[dr * 3 + dq][j]);
              }
            }
          }
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
            w[dr][0] = w[dr][1];
            w[dr][1] = w[dr][2];
          }
        }
      }
    }
    for (int m = R >> 1; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        dsum[j] += __shfl_xor_sync(0xffffffffu, dsum[j], m);
#pragma unroll
        for (int t = 0; t < 9; ++t) acc[t][j] += __shfl_xor_sync(0xffffffffu, acc[t][j], m);
      }
    }
    if (active && chunk == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int j = 0; j < G; ++j) gk[(t * C + ci) * C + co + j] = acc[t][j];
      }
      if (ci == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) gb[co + j] = dsum[j];
      }
    }
  }
}

// C floats of each owned pixel between the padded state and a dense
// (H, W, C) image.
template <int C, int P>
__device__ __forceinline__ void store_own(const float* pad, const int (&corner)[P],
                                          const bool (&own)[P], int Wp, int S,
                                          float* __restrict__ dst) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!own[k]) continue;
    const int p = threadIdx.x + k * blockDim.x;
    const float* src = pad + corner[k] + (Wp + 1) * S;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      *reinterpret_cast<float4*>(dst + p * C + c) = *reinterpret_cast<const float4*>(src + c);
    }
  }
}

template <int C, int P>
__device__ __forceinline__ void load_own(const float* __restrict__ src, const int (&corner)[P],
                                         const bool (&own)[P], int Wp, int S, float* pad) {
  float4 v[P][C / 4];  // all loads in flight before the first store
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      v[k][c / 4] = own[k] ? *reinterpret_cast<const float4*>(src + p * C + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!own[k]) continue;
    float* dst = pad + corner[k] + (Wp + 1) * S;
#pragma unroll
    for (int c = 0; c < C; c += 4) *reinterpret_cast<float4*>(dst + c) = v[k][c / 4];
  }
}

__device__ inline void zero_fill(float* buf, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = 0.f;
}

// Register-resident variant: thread t owns pixels t, t + T, ... and keeps
// their z (or the g_z * K^T sum) and g, P pixels x C channels each, in
// registers.
template <int C, int P, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    euler_bwd_resident(const float* __restrict__ x, const float* __restrict__ K,
                       const float* __restrict__ KT, const float* __restrict__ bias,
                       const float* __restrict__ g_in, float* __restrict__ gx,
                       float* __restrict__ gk, float* __restrict__ gb,
                       float* __restrict__ traj, int B, int H, int W, int L, int S,
                       int R, float h) {
  extern __shared__ float4 smem4[];
  const int Wp = W + 2, HW = H * W;
  const int padded = (H + 2) * Wp * S;
  float* ypad = reinterpret_cast<float*>(smem4);
  float* gpad = ypad + padded;
  float* Ks = gpad + padded;
  float* KTs = Ks + 9 * C * C;
  float* bs = KTs + 9 * C * C;
  const size_t img = static_cast<size_t>(blockIdx.x) * HW * C;
  const size_t layer_stride = static_cast<size_t>(B) * HW * C;
  float* my_traj = traj + img;

  fill_state(x + img, ypad, H, W, C, S);
  zero_fill(gpad, padded);
  load_layer<BF16>(K, bias, 0, C, Ks, bs);
  int corner[P];
  bool own[P];
  own_pixels<P>(HW, W, Wp, S, corner, own);
  __syncthreads();

  // Forward recompute, stashing y_0 .. y_{L-1}.
  for (int l = 0; l < L; ++l) {
    store_own<C, P>(ypad, corner, own, Wp, S, my_traj + l * layer_stride);
    if (l + 1 == L) break;
    float acc[P][C];
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int co = 0; co < C; ++co) acc[k][co] = bs[co];
    }
    conv_accumulate<C, P, BF16>(ypad, corner, Wp, S, Ks, acc);
    __syncthreads();  // every thread has read layer l's state and kernel
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!own[k]) continue;
      float* yp = ypad + corner[k] + (Wp + 1) * S;
#pragma unroll
      for (int co = 0; co < C; ++co) yp[co] += h * relu(acc[k][co]);
    }
    load_layer<BF16>(K, bias, l + 1, C, Ks, bs);
    __syncthreads();
  }

  float g[P][C];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = own[k] ? threadIdx.x + k * blockDim.x : 0;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(g_in + img + p * C + c);
      g[k][c] = v.x;
      g[k][c + 1] = v.y;
      g[k][c + 2] = v.z;
      g[k][c + 3] = v.w;
    }
  }
  __syncthreads();

  // Reverse sweep.
  for (int l = L - 1; l >= 0; --l) {
    load_own<C, P>(my_traj + l * layer_stride, corner, own, Wp, S, ypad);
    load_layer<BF16>(K, bias, l, C, Ks, bs);
    load_kernel<BF16>(KT, l, C, KTs);
    __syncthreads();
    {
      float acc[P][C];
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int co = 0; co < C; ++co) acc[k][co] = bs[co];
      }
      conv_accumulate<C, P, BF16>(ypad, corner, Wp, S, Ks, acc);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (!own[k]) continue;
        float* gp = gpad + corner[k] + (Wp + 1) * S;
#pragma unroll
        for (int co = 0; co < C; ++co) gp[co] = acc[k][co] > 0.f ? h * g[k][co] : 0.f;
      }
    }
    __syncthreads();  // g_z of every pixel is in gpad
    const size_t il = static_cast<size_t>(blockIdx.x) * L + l;
    weight_grads<4>(ypad, gpad, H, W, C, S, R, gk + il * 9 * C * C, gb + il * C);
    {
      float acc[P][C];
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
      }
      conv_accumulate<C, P, BF16>(gpad, corner, Wp, S, KTs, acc);
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) g[k][c] += acc[k][c];
      }
    }
    __syncthreads();  // every thread is done with y_l, g_z and the kernels
  }

#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!own[k]) continue;
    const int p = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      *reinterpret_cast<float4*>(gx + img + p * C + c) =
          make_float4(g[k][c], g[k][c + 1], g[k][c + 2], g[k][c + 3]);
    }
  }
}

// Staged variant, for any C: one (pixel, channel) per work item, scalar
// reads.  The forward recompute writes y_{l+1} straight into the trajectory
// and reads it back into shared memory after a barrier; g lives in the
// image's slice of gx.
template <bool BF16, int G>
__global__ void __launch_bounds__(kMaxThreads)
    euler_bwd_staged(const float* __restrict__ x, const float* __restrict__ K,
                     const float* __restrict__ KT, const float* __restrict__ bias,
                     const float* __restrict__ g_in, float* __restrict__ gx,
                     float* __restrict__ gk, float* __restrict__ gb,
                     float* __restrict__ traj, int B, int H, int W, int C, int L,
                     int R, float h) {
  extern __shared__ float4 smem4[];
  const int Wp = W + 2, HW = H * W, n = HW * C;
  const int padded = (H + 2) * Wp * C;
  float* ypad = reinterpret_cast<float*>(smem4);
  float* gpad = ypad + padded;
  float* Ks = gpad + padded;
  float* KTs = Ks + 9 * C * C;
  float* bs = KTs + 9 * C * C;
  const size_t img = static_cast<size_t>(blockIdx.x) * n;
  const size_t layer_stride = static_cast<size_t>(B) * n;
  float* my_traj = traj + img;
  float* gxi = gx + img;

  fill_state(x + img, ypad, H, W, C, C);
  zero_fill(gpad, padded);
  load_layer<BF16>(K, bias, 0, C, Ks, bs);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    my_traj[i] = x[img + i];
    gxi[i] = g_in[img + i];
  }
  __syncthreads();

  // Forward recompute: y_{l+1} into the trajectory, then into shared memory.
  for (int l = 0; l + 1 < L; ++l) {
    float* next = my_traj + (l + 1) * layer_stride;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C, co = i - p * C;
      const float* win = ypad + ((p / W) * Wp + p % W) * C;
      float acc = bs[co];
      for (int tap = 0; tap < 9; ++tap) {
        const float* yv = win + ((tap / 3) * Wp + tap % 3) * C;
        const float* kc = Ks + tap * C * C + co;
        for (int ci = 0; ci < C; ++ci) acc = fmaf(operand<BF16>(yv[ci]), kc[ci * C], acc);
      }
      next[i] = win[(Wp + 1) * C + co] + h * relu(acc);
    }
    __syncthreads();  // every thread has read layer l's state and kernel
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C, c = i - p * C;
      ypad[((p / W + 1) * Wp + p % W + 1) * C + c] = next[i];
    }
    load_layer<BF16>(K, bias, l + 1, C, Ks, bs);
    __syncthreads();
  }

  // Reverse sweep.
  for (int l = L - 1; l >= 0; --l) {
    const float* yl = my_traj + l * layer_stride;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C, c = i - p * C;
      ypad[((p / W + 1) * Wp + p % W + 1) * C + c] = yl[i];
    }
    load_layer<BF16>(K, bias, l, C, Ks, bs);
    load_kernel<BF16>(KT, l, C, KTs);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C, co = i - p * C;
      const float* win = ypad + ((p / W) * Wp + p % W) * C;
      float acc = bs[co];
      for (int tap = 0; tap < 9; ++tap) {
        const float* yv = win + ((tap / 3) * Wp + tap % 3) * C;
        const float* kc = Ks + tap * C * C + co;
        for (int ci = 0; ci < C; ++ci) acc = fmaf(operand<BF16>(yv[ci]), kc[ci * C], acc);
      }
      gpad[((p / W + 1) * Wp + p % W + 1) * C + co] = acc > 0.f ? h * gxi[i] : 0.f;
    }
    __syncthreads();  // g_z of every pixel is in gpad
    const size_t il = static_cast<size_t>(blockIdx.x) * L + l;
    weight_grads<G>(ypad, gpad, H, W, C, C, R, gk + il * 9 * C * C, gb + il * C);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C, c = i - p * C;
      const float* win = gpad + ((p / W) * Wp + p % W) * C;
      float acc = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const float* gv = win + ((tap / 3) * Wp + tap % 3) * C;
        const float* kc = KTs + tap * C * C + c;
        for (int co = 0; co < C; ++co) acc = fmaf(operand<BF16>(gv[co]), kc[co * C], acc);
      }
      gxi[i] += acc;
    }
    __syncthreads();  // every thread is done with y_l, g_z and the kernels
  }
}

struct Launch {
  const float *x, *K, *KT, *bias, *g;
  float *gx, *gk, *gb, *traj;
  int B, H, W, C, L, S, R, threads, smem;
  float h;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C, int P, bool BF16>
cudaError_t launch_resident(const Launch& a) {
  auto kernel = euler_bwd_resident<C, P, BF16>;
  cudaError_t err = prepare(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.threads, a.smem, a.stream>>>(a.x, a.K, a.KT, a.bias, a.g, a.gx, a.gk,
                                                a.gb, a.traj, a.B, a.H, a.W, a.L, a.S,
                                                a.R, a.h);
  return cudaGetLastError();
}

template <bool BF16, int G>
cudaError_t launch_staged(const Launch& a) {
  auto kernel = euler_bwd_staged<BF16, G>;
  cudaError_t err = prepare(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.threads, a.smem, a.stream>>>(a.x, a.K, a.KT, a.bias, a.g, a.gx, a.gk,
                                                a.gb, a.traj, a.B, a.H, a.W, a.C, a.L,
                                                a.R, a.h);
  return cudaGetLastError();
}

// P * C <= 32, so that z and g of a thread's pixels fit its registers.
template <bool BF16>
cudaError_t dispatch_resident(const Launch& a, int P) {
  switch (a.C) {
    case 4:
      return P == 1 ? launch_resident<4, 1, BF16>(a)
             : P == 2 ? launch_resident<4, 2, BF16>(a)
                      : launch_resident<4, 4, BF16>(a);
    case 8:
      return P == 1 ? launch_resident<8, 1, BF16>(a)
             : P == 2 ? launch_resident<8, 2, BF16>(a)
                      : launch_resident<8, 4, BF16>(a);
    case 16:
      return P == 1 ? launch_resident<16, 1, BF16>(a) : launch_resident<16, 2, BF16>(a);
    default:
      return launch_resident<32, 1, BF16>(a);
  }
}

long long smem_bytes(int H, int W, int C, int S) {
  return 4LL * (2LL * (H + 2LL) * (W + 2LL) * S + 18LL * C * C + C);
}

// Pixels per thread of the register-resident variant, or 0 where the staged
// variant runs instead.
int resident_pixels(int H, int W, int C) {
  if (C != 4 && C != 8 && C != 16 && C != 32) return 0;
  const int max_p = C >= 16 ? 32 / C : 4;
  for (int p = 1; p <= max_p; p *= 2) {
    if ((H * W + p - 1) / p <= kMaxThreads) return p;
  }
  return 0;
}

// Row chunks of a dK work item: a power of two <= 32 (one warp) and <= H,
// with no more items than threads.
int row_chunks(int H, int groups, int threads) {
  int r = 1;
  while (r < 32 && 2 * r <= H && groups * 2 * r <= threads) r *= 2;
  return r;
}

}  // namespace

extern "C" {

// 1 where the register-resident variant runs, 0 for the staged one, -1 for a
// shape the kernel cannot hold in one block's shared memory.
int deqres_euler_bwd_variant(int H, int W, int C) {
  if (H < 1 || W < 1 || C < 1 || smem_bytes(H, W, C, C) > kMaxSmemBytes) return -1;
  return resident_pixels(H, W, C) > 0 ? 1 : 0;
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous fp32 tensors: x, g and gx (B, H,
// W, C); K and KT (L, 3, 3, C, C); bias (L, C); gk (B, L, 9, C, C) and gb
// (B, L, C), per-image partials; traj (L, B, H, W, C), scratch.
int deqres_euler_bwd(const float* x, const float* K, const float* KT, const float* bias,
                     const float* g, float* gx, float* gk, float* gb, float* traj, int B,
                     int H, int W, int C, int L, float h, int bf16, void* stream) {
  const int variant = deqres_euler_bwd_variant(H, W, C);
  if (variant < 0 || B < 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Launch a{x, K, KT, bias, g, gx, gk, gb, traj, B, H, W, C, L, C, 1, kMaxThreads, 0, h,
           static_cast<cudaStream_t>(stream)};
  if (variant == 0) {
    const int G = C % 4 == 0 ? 4 : 1;
    a.R = row_chunks(H, C * (C / G), a.threads);
    a.smem = static_cast<int>(smem_bytes(H, W, C, C));
    if (G == 4) {
      return static_cast<int>(bf16 ? launch_staged<true, 4>(a) : launch_staged<false, 4>(a));
    }
    return static_cast<int>(bf16 ? launch_staged<true, 1>(a) : launch_staged<false, 1>(a));
  }
  const int P = resident_pixels(H, W, C);
  // The per-pixel channel stride is padded to C + 4 where that still fits,
  // as in B1, so that float4 reads of neighbouring pixels spread over banks.
  a.S = smem_bytes(H, W, C, C + 4) <= kMaxSmemBytes ? C + 4 : C;
  a.smem = static_cast<int>(smem_bytes(H, W, C, a.S));
  a.threads = ((H * W + P - 1) / P + 31) / 32 * 32;
  a.R = row_chunks(H, C * (C / 4), a.threads);
  return static_cast<int>(bf16 ? dispatch_resident<true>(a, P) : dispatch_resident<false>(a, P));
}

}  // extern "C"
