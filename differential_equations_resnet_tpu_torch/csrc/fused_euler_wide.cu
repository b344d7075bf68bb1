// The wide variants of the fused L-layer forward-Euler integrator (B1) and of
// its backward (B2), written by hand for Hopper (sm_90a): the shapes of the
// JAX kernel gate's reach (C <= 128, H*W <= 4096, any batch) whose band of
// rows does not fit one block's shared memory in the banded kernels
// (fused_euler_fwd.cu, fused_euler_bwd.cu).
//
// Replaces, for those shapes, the TPU kernels `_euler_fwd_kernel`
// (differential_equations_resnet_tpu/ops/pallas/fused_integrator.py:146,
// launched by `_fused_euler_dense_fwd_impl` at :168) and `_euler_bwd_kernel`
// (:216, launched by `_fused_euler_dense_bwd_impl` at :290).  They compute
// what the banded kernels compute:
//
//     y_0 = x,   y_{l+1} = y_l + h * relu(z_l),   z_l = conv3x3_same(y_l, K_l) + b_l
//
// and, from x and a cotangent g of y_L, walking l = L-1 .. 0,
//
//     g_z  = h * 1[z_l > 0] * g,  dK_l = patches(y_l)^T g_z,  db_l = sum g_z,
//     g   <- g + conv3x3_same(g_z, K_l^T).
//
// Numerics are the banded kernels': fp32 FFMA (no TF32); in bf16 mode the
// conv operands (state or g_z, and the kernel, which the wrapper rounds) are
// rounded to bf16 and the sums stay fp32; dK and db are fp32 in both modes.
//
// Why the banded design stops: one fp32 layer kernel is 9*C^2*4 bytes,
// 589,824 B at C = 128, over one block's 232,448 B however few rows a band
// holds, and the padded 64x64x128 state (2.2 MB) is more than a 16-block
// cluster can double buffer.  So here the state lives in device memory
// between layers, and every layer is a tiled implicit GEMM:
//
//   - the forward step (wide_conv, kStep): rows are the B*H*W pixels,
//     columns the Cp output channels, the reduction the 9*Cp (tap, input
//     channel) pairs, read straight from the (B, H, W, Cp) state with the
//     zero "SAME" padding done by the loads.  A block computes 128 pixels x
//     64 channels (128 where Cp > 64, so the patch tile is read once); each
//     thread 8 pixels x 4 channels a group of 64 from two shared-memory
//     stages of 16 reduction steps (the next stage's loads are in flight
//     while this one computes).  The epilogue adds the bias, applies
//     y + h * relu(z), and in B2's recompute ORs the relu mask bits
//     1[z > 0] into a (L, B, H, W, ceil(Cp/32)) word mask;
//   - B2's state cotangent (wide_conv, kAccumulate): the same GEMM of
//     g_z with K^T, added into g in place;
//   - B2's weight gradient (wide_dk): rows the 9*Cp (tap, input) pairs,
//     columns the Cp outputs, the reduction over pixels split into S fixed
//     chunks, each written as a partial and summed in a fixed order
//     (wide_reduce): no float atomics, so two calls are bit-identical; db
//     the same way.
//
// What bounds it on an H100: operations.  B1 is 2*L*B*H*W*9C^2 FLOP (618.5
// GFLOP at B=32, L=64, 32x32x128, 9.23 ms at 67 TFLOP/s); B2 three times
// that.  Each layer reads its state and writes the next one (or g) through
// L2 and HBM, B2 its trajectory (L, B, H, W, Cp) too: at 32x32x128, B = 32,
// about 34 MB a layer, under a millisecond of HBM traffic against 0.14 ms of
// FFMA a layer.  A layer is one or four launches on the caller's stream
// (L launches for B1, 5L for B2), so the call is graph-capturable.

#include "euler_common.cuh"

using namespace deqres;

namespace {

constexpr int kBM = 128;        // pixels of a forward tile, reduction rows of a dK tile
constexpr int kBK = 16;         // reduction steps a stage
constexpr int kThreads = 256;   // 16 x 16 threads, each 8 rows x 4 columns
constexpr int kPad = 4;         // floats after each shared row of 128
constexpr int kStep = 0;        // y + h * relu(conv(y, K) + b), relu mask optional
constexpr int kAccumulate = 1;  // g += conv(g_z, K^T)

struct Wide {
  int B, H, W, C, Cp, L;
  int K;        // 9 * Cp: the reduction of a conv
  int nw;       // relu-mask words a pixel
  long long M;  // B * H * W pixels
};

Wide make_wide(int B, int H, int W, int C, int L) {
  Wide g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Cp = (C + 3) / 4 * 4;
  g.L = L;
  g.K = 9 * g.Cp;
  g.nw = (g.Cp + 31) / 32;
  g.M = static_cast<long long>(B) * H * W;
  return g;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A pixel's (image, row, column), or image -1 past the last pixel.
struct Pixel {
  int b, y, x;
};

__device__ __forceinline__ Pixel pixel_of(const Wide& g, long long m) {
  Pixel p{-1, 0, 0};
  if (m < g.M) {
    const int hw = g.H * g.W;
    p.b = static_cast<int>(m / hw);
    const int r = static_cast<int>(m - static_cast<long long>(p.b) * hw);
    p.y = r / g.W;
    p.x = r - p.y * g.W;
  }
  return p;
}

// The next pixel, 16 on: (b, y, x) advanced without a division.
__device__ __forceinline__ void advance16(const Wide& g, Pixel& p) {
  p.x += 16;
  while (p.x >= g.W) {
    p.x -= g.W;
    ++p.y;
  }
  while (p.y >= g.H) {
    p.y -= g.H;
    ++p.b;
  }
}

// A reduction index k = t * Cp + ci of the 9*Cp (tap, input channel) pairs,
// kept as (t, ci) and advanced 16 at a time without a division.
struct Tap {
  int t, ci;
};

__device__ __forceinline__ Tap tap_of(const Wide& g, int k) {
  const int t = k / g.Cp;
  return Tap{t, k - t * g.Cp};
}

__device__ __forceinline__ void advance16(const Wide& g, Tap& k) {
  k.ci += 16;
  while (k.ci >= g.Cp) {
    k.ci -= g.Cp;
    ++k.t;
  }
}

// Four consecutive reduction entries (tap t, input channels ci .. ci+3) of
// a pixel's 3x3 patch of the (B, H, W, Cp) state (Cp is a multiple of 4, so
// the four share a tap); zero outside the image ("SAME" padding), past the
// last pixel (b < 0 or b >= B) and past the reduction's end (t >= 9).
__device__ __forceinline__ float4 patch4(const float* __restrict__ src, const Wide& g,
                                         const Pixel& p, const Tap& k) {
  if (p.b < 0 || p.b >= g.B || k.t >= 9) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int dy = k.t / 3;
  const int yy = p.y + dy - 1, xx = p.x + k.t - 3 * dy - 1;
  if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W) return make_float4(0.f, 0.f, 0.f, 0.f);
  return ldg4(src + ((static_cast<size_t>(p.b) * g.H + yy) * g.W + xx) * g.Cp + k.ci);
}

// The columns of a tile: NG groups of 64 output channels (NG = 2 where Cp >
// 64, so that one tile holds every channel and the patch tile is read
// once); each thread holds 4 channels of each group.
template <int NG>
struct Cols {
  static constexpr int kN = 64 * NG;
};

// One layer as a tiled implicit GEMM over pixels x output channels (see the
// file's note).  MODE kStep: dst = src + h * relu(src (*) K + bias), with
// dst optional (null: the relu mask alone) and the mask optional (null: not
// recorded).  MODE kAccumulate: dst += src (*) K.  The sum over the 9*Cp
// reduction runs in one fixed order, one stage of 16 after another.
template <bool BF16, int MODE, int NG>
__global__ void __launch_bounds__(kThreads, 2)
    wide_conv(const float* __restrict__ src, const float* __restrict__ Kl,
              const float* __restrict__ bias, float* __restrict__ dst,
              unsigned* __restrict__ mask, Wide g, float h) {
  constexpr int kN = Cols<NG>::kN;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];  // [reduction][pixel]
  __shared__ __align__(16) float Bs[2][kBK][kN];          // [reduction][channel]
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kN;

  // Loads: each thread brings two float4s of the patch tile (pixels
  // tid/4 and tid/4 + 64, reduction quad tid % 4) and NG of the kernel
  // tile (reduction row tid / 16, channel quad tid % 16 of each group).
  const int a_kq = tid % 4;
  Pixel a_px[2];
  a_px[0] = pixel_of(g, m0 + tid / 4);
  a_px[1] = pixel_of(g, m0 + tid / 4 + 64);
  Tap a_k = tap_of(g, 4 * a_kq);  // the reduction index of the next load
  const int b_kr = tid / 16;
  float4 ra[2], rb[NG];
  // Called with k0 = 0, 16, 32, ... in turn.
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) ra[j] = operand4<BF16>(patch4(src, g, a_px[j], a_k));
    advance16(g, a_k);
    const int k = k0 + b_kr;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int col = n0 + 64 * q + 4 * tn;
      rb[q] = (col < g.Cp && k < g.K) ? ldg4(Kl + static_cast<size_t>(k) * g.Cp + col)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int mm = tid / 4 + 64 * j;
#pragma unroll
      for (int q = 0; q < 4; ++q) As[s][4 * a_kq + q][mm] = lane(ra[j], q);
    }
#pragma unroll
    for (int q = 0; q < NG; ++q) st4(&Bs[s][b_kr][64 * q + 4 * tn], rb[q]);
  };

  float acc[8][4 * NG];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }
  load(0);
  store(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    const bool more = k0 + kBK < g.K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(&As[s][kk][8 * tm]), a1 = ld4(&As[s][kk][8 * tm + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float4 b = ld4(&Bs[s][kk][64 * q + 4 * tn]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * q + 0] = fmaf(a[i], b.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(a[i], b.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(a[i], b.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(a[i], b.w, acc[i][4 * q + 3]);
        }
      }
    }
    // The other stage was last read before the previous barrier.
    if (more) store(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int co = n0 + 64 * q + 4 * tn;
    if (co >= g.Cp) break;
    float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (MODE == kStep) bb = ldg4(bias + co);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + 8 * tm + i;
      if (m >= g.M) break;
      const size_t o = static_cast<size_t>(m) * g.Cp + co;
      if constexpr (MODE == kStep) {
        const float z0 = acc[i][4 * q] + bb.x, z1 = acc[i][4 * q + 1] + bb.y;
        const float z2 = acc[i][4 * q + 2] + bb.z, z3 = acc[i][4 * q + 3] + bb.w;
        if (mask) {
          const unsigned bits = (z0 > 0.f ? 1u : 0u) | (z1 > 0.f ? 2u : 0u) |
                                (z2 > 0.f ? 4u : 0u) | (z3 > 0.f ? 8u : 0u);
          if (bits) atomicOr(mask + static_cast<size_t>(m) * g.nw + co / 32, bits << (co % 32));
        }
        if (dst) {
          float4 y = ldg4(src + o);
          y.x += h * relu(z0);
          y.y += h * relu(z1);
          y.z += h * relu(z2);
          y.w += h * relu(z3);
          st4(dst + o, y);
        }
      } else {
        float4 v = ld4(dst + o);
        v.x += acc[i][4 * q];
        v.y += acc[i][4 * q + 1];
        v.z += acc[i][4 * q + 2];
        v.w += acc[i][4 * q + 3];
        st4(dst + o, v);
      }
    }
  }
}

// g_z = h * mask * g over every (pixel, channel quad).
__global__ void __launch_bounds__(kThreads)
    wide_gz(const float* __restrict__ gin, const unsigned* __restrict__ mask,
            float* __restrict__ gz, Wide g, float h) {
  const int quads = g.Cp / 4;
  const long long n = g.M * quads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / quads;
    const int c = static_cast<int>(i - m * quads) * 4;
    const unsigned word = mask[m * g.nw + c / 32] >> (c % 32);
    const float4 v = ldg4(gin + m * g.Cp + c);
    st4(gz + m * g.Cp + c, make_float4(word & 1u ? h * v.x : 0.f, word & 2u ? h * v.y : 0.f,
                                       word & 4u ? h * v.z : 0.f, word & 8u ? h * v.w : 0.f));
  }
}

// Partial dK (rows: 9*Cp (tap, input) pairs; columns: Cp outputs) and db of
// the pixels [s * chunk, (s + 1) * chunk), s = blockIdx.z: fp32, y and g_z
// unrounded in both modes.  part is (S, 9*Cp, Cp), pdb (S, Cp); the blocks
// of row tile 0 also sum db.  Each thread sums its 8 x 4NG entries over the
// chunk's pixels in order, 16 a stage, two stages.
template <int NG>
__global__ void __launch_bounds__(kThreads, 2)
    wide_dk(const float* __restrict__ Y, const float* __restrict__ Gz, float* __restrict__ part,
            float* __restrict__ pdb, Wide g, int chunk) {
  constexpr int kN = Cols<NG>::kN;
  __shared__ __align__(16) float Ps[2][kBK][kBM + kPad];  // [pixel][reduction row]
  __shared__ __align__(16) float Gs[2][kBK][kN];          // [pixel][channel]
  const int tid = threadIdx.x;
  const int tk = tid / 16, tn = tid % 16;
  const int r0 = blockIdx.x * kBM, n0 = blockIdx.y * kN;
  const long long p_begin = static_cast<long long>(blockIdx.z) * chunk;
  const long long p_end = p_begin + chunk < g.M ? p_begin + chunk : g.M;

  // Loads: two float4s of the patch tile (pixel i / 32, rows quad i % 32,
  // i = tid and tid + 256: each thread's rows stay, its pixels move 16 a
  // stage) and NG of g_z (pixel tid / 16, quad tid % 16 of each group).
  Tap p_k[2];
  Pixel p_px[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + kThreads * j;
    p_k[j] = tap_of(g, r0 + 4 * (i % 32));
    p_px[j] = pixel_of(g, p_begin + i / 32);
  }
  float4 rp[2], rg[NG];
  // Called with p0 = p_begin, p_begin + 16, ... in turn.
  auto load = [&](long long p0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + kThreads * j;
      rp[j] = p0 + i / 32 < p_end ? patch4(Y, g, p_px[j], p_k[j])
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      advance16(g, p_px[j]);
    }
    const long long m = p0 + tid / 16;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int col = n0 + 64 * q + 4 * tn;
      rg[q] = (m < p_end && col < g.Cp) ? ldg4(Gz + static_cast<size_t>(m) * g.Cp + col)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + kThreads * j;
      st4(&Ps[s][i / 32][4 * (i % 32)], rp[j]);
    }
#pragma unroll
    for (int q = 0; q < NG; ++q) st4(&Gs[s][tid / 16][64 * q + 4 * tn], rg[q]);
  };

  float acc[8][4 * NG], ds[4 * NG];
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) {
    ds[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = 0.f;
  }
  const bool sums_db = blockIdx.x == 0 && tk == 0;
  load(p_begin);
  store(0);
  __syncthreads();
  int s = 0;
  for (long long p0 = p_begin; p0 < p_end; p0 += kBK) {
    const bool more = p0 + kBK < p_end;
    if (more) load(p0 + kBK);
#pragma unroll
    for (int mm = 0; mm < kBK; ++mm) {
      const float4 a0 = ld4(&Ps[s][mm][8 * tk]), a1 = ld4(&Ps[s][mm][8 * tk + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float4 b = ld4(&Gs[s][mm][64 * q + 4 * tn]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * q + 0] = fmaf(a[i], b.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(a[i], b.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(a[i], b.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(a[i], b.w, acc[i][4 * q + 3]);
        }
        if (sums_db) {
          ds[4 * q + 0] += b.x;
          ds[4 * q + 1] += b.y;
          ds[4 * q + 2] += b.z;
          ds[4 * q + 3] += b.w;
        }
      }
    }
    if (more) store(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  float* out = part + static_cast<size_t>(blockIdx.z) * g.K * g.Cp;
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int co = n0 + 64 * q + 4 * tn;
    if (co >= g.Cp) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + 8 * tk + i;
      if (r < g.K) {
        st4(out + static_cast<size_t>(r) * g.Cp + co,
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]));
      }
    }
    if (sums_db) {
      st4(pdb + static_cast<size_t>(blockIdx.z) * g.Cp + co,
          make_float4(ds[4 * q], ds[4 * q + 1], ds[4 * q + 2], ds[4 * q + 3]));
    }
  }
}

// dK_l (9, C, C) and db_l (C) of the S partials, summed over s in order.
__global__ void __launch_bounds__(kThreads)
    wide_reduce(const float* __restrict__ part, const float* __restrict__ pdb,
                float* __restrict__ gk, float* __restrict__ gb, Wide g, int S) {
  const int C = g.C, Cp = g.Cp;
  const int n = 9 * C * C + C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (i < 9 * C * C) {
      const int t = i / (C * C), r = i - t * C * C;
      const int ci = r / C, co = r - ci * C;
      const size_t o = static_cast<size_t>(t * Cp + ci) * Cp + co;
      for (int s = 0; s < S; ++s) sum += part[static_cast<size_t>(s) * g.K * Cp + o];
      gk[i] = sum;
    } else {
      const int co = i - 9 * C * C;
      for (int s = 0; s < S; ++s) sum += pdb[static_cast<size_t>(s) * Cp + co];
      gb[co] = sum;
    }
  }
}

// Channel groups of 64 a tile: 2 where Cp > 64 (one tile holds them all).
int groups(const Wide& g) { return g.Cp > 64 ? 2 : 1; }

dim3 conv_grid(const Wide& g) {
  const int n = 64 * groups(g);
  return dim3(static_cast<unsigned>((g.M + kBM - 1) / kBM), (g.Cp + n - 1) / n);
}

unsigned flat_grid(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

template <bool BF16, int MODE>
void conv(const float* src, const float* Kl, const float* bias, float* dst, unsigned* mask,
          const Wide& g, float h, cudaStream_t s) {
  if (groups(g) == 2) {
    wide_conv<BF16, MODE, 2><<<conv_grid(g), kThreads, 0, s>>>(src, Kl, bias, dst, mask, g, h);
  } else {
    wide_conv<BF16, MODE, 1><<<conv_grid(g), kThreads, 0, s>>>(src, Kl, bias, dst, mask, g, h);
  }
}

template <bool BF16>
cudaError_t forward(const float* x, const float* K, const float* bias, float* s0, float* s1,
                    float* out, const Wide& g, float h, cudaStream_t s) {
  const size_t layer = 9LL * g.Cp * g.Cp;
  for (int l = 0; l < g.L; ++l) {
    const float* src = l == 0 ? x : ((l - 1) % 2 ? s1 : s0);
    float* dst = l == g.L - 1 ? out : (l % 2 ? s1 : s0);
    conv<BF16, kStep>(src, K + l * layer, bias + static_cast<size_t>(l) * g.Cp, dst, nullptr, g,
                      h, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool BF16>
cudaError_t backward(const float* K, const float* bias, const float* KT, float* traj,
                     unsigned* mask, float* gstate, float* gz, float* part, float* pdb,
                     float* gk, float* gb, const Wide& g, int S, int chunk, float h,
                     cudaStream_t s) {
  const size_t layer = 9LL * g.Cp * g.Cp;
  const size_t state = static_cast<size_t>(g.M) * g.Cp, words = static_cast<size_t>(g.M) * g.nw;
  cudaError_t err;
  // 1. Forward recompute: y_l into the trajectory, the relu mask of z_l.
  for (int l = 0; l < g.L; ++l) {
    conv<BF16, kStep>(traj + l * state, K + l * layer, bias + static_cast<size_t>(l) * g.Cp,
                      l + 1 < g.L ? traj + (l + 1) * state : nullptr, mask + l * words, g, h, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 2. Reverse sweep.
  const int n = 64 * groups(g);
  const dim3 dk_grid((g.K + kBM - 1) / kBM, (g.Cp + n - 1) / n, S);
  const int n_reduce = 9 * g.C * g.C + g.C;
  for (int l = g.L - 1; l >= 0; --l) {
    wide_gz<<<flat_grid(g.M * (g.Cp / 4)), kThreads, 0, s>>>(gstate, mask + l * words, gz, g, h);
    if (groups(g) == 2) {
      wide_dk<2><<<dk_grid, kThreads, 0, s>>>(traj + l * state, gz, part, pdb, g, chunk);
    } else {
      wide_dk<1><<<dk_grid, kThreads, 0, s>>>(traj + l * state, gz, part, pdb, g, chunk);
    }
    wide_reduce<<<flat_grid(n_reduce), kThreads, 0, s>>>(
        part, pdb, gk + static_cast<size_t>(l) * 9 * g.C * g.C,
        gb + static_cast<size_t>(l) * g.C, g, S);
    conv<BF16, kAccumulate>(gz, KT + l * layer, nullptr, gstate, nullptr, g, h, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of static shared memory a block of the wide variants uses at C
// channels (the conv step and the dK pass use the same two stages of
// tiles: 16 x (128 + 4) and 16 x 64 or 16 x 128 floats).
long long deqres_euler_wide_smem(int C) {
  const Wide g = make_wide(1, 1, 1, C, 1);
  return 4LL * 2 * kBK * (kBM + kPad + 64 * groups(g));
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The wide B1 on `stream`; returns the first launch error (0 on success).
// Device pointers to contiguous fp32 tensors: x (B, H, W, Cp) and out (B, H,
// W, Cp), s0 and s1 (B, H, W, Cp) scratch (unused at L = 1), K (L, 3, 3, Cp,
// Cp) and bias (L, Cp), zero-padded from C to Cp (C rounded up to a multiple
// of 4), K rounded to bf16 values in bf16 mode; all 16-byte aligned.
int deqres_euler_wide_fwd(const float* x, const float* K, const float* bias, float* s0, float* s1,
                          float* out, int B, int H, int W, int C, int L, float h, int bf16,
                          void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Wide g = make_wide(B, H, W, C, L);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? forward<true>(x, K, bias, s0, s1, out, g, h, s)
                               : forward<false>(x, K, bias, s0, s1, out, g, h, s));
}

// The wide B2 on `stream`; returns the first launch error (0 on success).
// Device pointers to contiguous tensors: K and KT (L, 3, 3, Cp, Cp) and bias
// (L, Cp) as for B1 (KT rot180 with c_in and c_out swapped); traj (L, B, H,
// W, Cp) with x, zero-padded, in its slice 0 (the recompute writes the
// others); mask (L, B, H, W, ceil(Cp/32)) 32-bit words, zeroed; g (B, H, W,
// Cp) the zero-padded cotangent of y_L in, gx out; gz (B, H, W, Cp),
// part (S, 9*Cp, Cp) and pdb (S, Cp) scratch; gk (L, 3, 3, C, C) and gb (L,
// C) out.  S chunks of `chunk` pixels (S * chunk >= B*H*W) split dK's sum.
int deqres_euler_wide_bwd(const float* K, const float* bias, const float* KT, float* traj,
                          void* mask, float* g, float* gz, float* part, float* pdb, float* gk,
                          float* gb, int B, int H, int W, int C, int L, int S, int chunk,
                          float h, int bf16, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || L < 1 || S < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Wide w = make_wide(B, H, W, C, L);
  if (static_cast<long long>(S) * chunk < w.M) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* bits = static_cast<unsigned*>(mask);
  return static_cast<int>(
      bf16 ? backward<true>(K, bias, KT, traj, bits, g, gz, part, pdb, gk, gb, w, S, chunk, h, s)
           : backward<false>(K, bias, KT, traj, bits, g, gz, part, pdb, gk, gb, w, S, chunk, h, s));
}

}  // extern "C"
