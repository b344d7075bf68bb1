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
// between layers, and every layer is a tiled implicit GEMM.
//
// What bounds it on an H100: operations.  B1 is 2*L*B*H*W*9C^2 FLOP (618.5
// GFLOP at B=32, L=64, 32x32x128, 9.23 ms at 67 TFLOP/s); B2 three times
// that.  A layer's state, its next state, and B2's trajectory and g move
// about 34 MB a layer at 32x32x128, B = 32: about 10 us of HBM traffic
// against 0.14 ms of FFMA.  Inside the block, the FFMAs are held back by
// the shared-memory loads that feed them (the more accumulators a thread
// holds, the fewer loads an FFMA) and by the work around them: the design
// before this one staged every operand through registers (spilling at 128
// registers), formed g_z in a pass of its own (written to device memory and
// read back), and summed dK's partials in a fifth launch a layer.  This
// design:
//
//   - Operands arrive by cp.async (16-byte copies; the zero-fill source
//     size does the "SAME" padding, the channels past Cp and the ragged last
//     tile), into a ring of stages of dynamic shared memory, one barrier a
//     stage, no staging registers: 4 stages of 16 reduction steps (three in
//     flight while one is computed) in the dK pass and in the conv, but for
//     2 stages of 64 steps (one in flight) in the conv where 48 < Cp <= 64.
//   - The conv's reduction runs tap by tap, each tap in chunks of 16 input
//     channels, or of 64 where 48 < Cp <= 64 (zero-filled past Cp; no waste
//     at Cp = 16, 32, 48, 64, 80, 96, 112, 128).  A tap's displacement in the
//     flattened (B, H, W) pixel index is the same for every pixel of a tile:
//     each copying thread computes the 9-bit "tap lands in the image" mask
//     of its pixels and its copies' offsets once a block, and a stage only
//     adds the tap's and the chunk's offset.
//   - wide_conv (B1's step, B2's recompute and its state cotangent): a block
//     computes 128 pixels x 64*NG output channels (NG = 2 where Cp > 64, so
//     one tile holds every channel).  Where Cp > 64 a block is 128 threads,
//     each 8 pixels (rows tm + 16i) x 16 channels (4tn + 32j .. +3): 128
//     accumulators, 24 float4 shared loads for 512 FFMAs; at Cp <= 64 256
//     threads of 4 pixels x 8 channels, over a whole tap a stage where 48 <
//     Cp: a thread does 2,048 FFMAs between two barriers at either width.  On an H100,
//     the whole-tap stages took the Cp <= 64 conv of B2's state cotangent
//     from 3.68 to 3.41 ms (128 x 32x32x64, L = 12), and its step from 3.25
//     to 3.13; threads of 8 pixels x 16 channels on 256-pixel tiles, with
//     the 16-step ring, took 3.55 and 4.45 (PERF.md §6).  The patch stage is
//     kept [pixel][16 or 64 channels + 4 floats of padding]: a thread reads
//     4 reduction steps of a pixel as one float4, and the 4 pixels a warp
//     reads at once (rows 20 or 68 floats apart) fall on distinct banks; the
//     kernel stage is [channel in][channel out], read as 8 consecutive
//     float4s a warp.  The epilogue adds the bias, applies y + h * relu(z),
//     and in B2's recompute writes the relu mask 1[z > 0] as whole 32-bit
//     words (OR-reduced across the 8 lanes that hold a word's channels), so
//     the mask needs no zeroing and no atomics.
//   - B2 forms g_z = h * 1[z > 0] * g from the mask bits as its operands
//     arrive: once a thread's own copies of a stage have landed (waited for
//     after it computed the stage before, off the barrier's path), it
//     rewrites its float4s in shared memory from the mask words, which the
//     state-cotangent conv loads once a block (the 3 x 130 pixels its taps
//     reach) and the dK pass a stage.  No g_z pass: g ping-pongs between two
//     buffers (the conv reads neighbours' g while other blocks write), and
//     the input g is only read.  The bf16 rounding of the conv's patch
//     operand is done in the same rewrite.
//   - B2's weight gradient (wide_dk): rows the 9*Cp (tap, input) pairs,
//     columns the Cp outputs, in tiles of 128 rows (64 at Cp <= 64, so that
//     9*Cp divides at Cp = 64 as at 128), a thread 4 rows x 8*NG channels
//     (512 or 1,024 FFMAs a stage: 8 rows a thread on 64-thread blocks, or
//     32-pixel stages, were 8-33% slower on an H100, PERF.md §6);
//     the reduction over pixels split into S fixed chunks, one block each
//     (row tile, chunk), so that the pass fills the card (S = 29 at
//     32x32x128, B = 32); its patch stage lands [pixel][row] (a thread reads
//     its 4 rows as one float4).  db rides on the rewrite of the g_z copies.
//     The chunk partials (S, 9*Cp, Cp) stay in device memory, where L2
//     holds them (17 MB at 32x32x128), and the next launch, the layer's
//     state-cotangent conv, sums them in a fixed order (s = 0 .. S-1) over
//     all its blocks while its first stages load: no float atomics, so two
//     calls are bit-identical.  Summed there, they cost that conv 3.6-4.1
//     us a layer (an H100 at 32x32x128 and 32x32x64, B = 32); a launch of
//     their own took 6.2-7.2 us and made B2 0.3-1.6% slower (PERF.md §6).
//
// Launches, all on the caller's stream (graph-capturable): B1 one a layer;
// B2 the recompute (one a layer) and two a layer in reverse (wide_dk, then
// wide_conv<kAccumulate>): 3L.  Each launch checks cudaGetLastError.

#include "euler_common.cuh"

using namespace deqres;

namespace {

constexpr int kBM = 128;             // pixels of a conv tile
constexpr int kBK = 16;              // pixels a dK stage
constexpr int kStages = 4;           // stages in the dK pass's ring
constexpr int kMinBlocks = 2;        // conv blocks an SM (255 registers at 128 threads)
constexpr int kStep = 0;             // y + h * relu(conv(y, K) + b), relu mask optional
constexpr int kAccumulate = 1;       // g_out = g + conv(g_z(g), K^T), after summing dK

// Threads a block.  The conv where Cp > 64 runs 128, each thread 8 pixels x
// 16 channels (128 accumulators: fewer shared loads an FFMA, 255 registers);
// at Cp <= 64, where 128 x 64 outputs would give 128 threads 64 each, 256
// threads of 4 pixels x 8 channels keep twice the warps an SM.  The dK pass
// gives each thread 4 rows x 8*NG channels: 128-row tiles of 256 threads,
// two blocks an SM, where Cp > 64 (9*Cp = 1152 rows at Cp = 128: 9 tiles);
// 64-row tiles of 128 threads, four blocks an SM, at Cp <= 64 (576 rows at
// Cp = 64: 9 tiles, where 128-row tiles would leave half of a fifth idle).
constexpr int kConvThreadsNarrow = 256;
constexpr int kConvThreadsWide = 128;

// The conv's stages of BK reduction steps: 16 in a ring of 4, or, where a
// tap's Cp channels fill four chunks of 16 at Cp <= 64 (48 < Cp <= 64), the
// whole tap (64) in a ring of 2, so that two blocks an SM still fit.
__host__ __device__ constexpr int conv_stages(int BK) { return BK == 64 ? 2 : 4; }

__host__ __device__ constexpr int dk_rows(int NG) { return NG == 2 ? 128 : 64; }
__host__ __device__ constexpr int dk_threads(int NG) { return NG == 2 ? 256 : 128; }
__host__ __device__ constexpr int dk_blocks(int NG) { return NG == 2 ? 2 : 4; }

// A conv block of T threads over stages of BK reduction steps: (T / 8) x 8
// threads, each kTM pixels x 8*NG channels; each copies kACopies float4s of
// a patch stage (quad tid % kAQuads of pixels tid / kAQuads + T / kAQuads j).
template <int T, int BK>
struct Threads {
  static constexpr int kTM = kBM * 8 / T;
  static constexpr int kRowThreads = T / 8;
  static constexpr int kAQuads = BK / 4;
  static constexpr int kACopies = kBM * kAQuads / T;
};

struct Wide {
  int B, H, W, C, Cp, L;
  int K;        // 9 * Cp: the reduction of a conv, the rows of dK
  int nc;       // chunks of 16 input channels a tap
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
  g.nc = (g.Cp + 15) / 16;
  g.nw = (g.Cp + 31) / 32;
  g.M = static_cast<long long>(B) * H * W;
  return g;
}

// Channel groups of 64 a tile: 2 where Cp > 64 (one tile holds them all).
int groups(const Wide& g) { return g.Cp > 64 ? 2 : 1; }

// Floats of one ring stage: the patch tile and the kernel (or g) tile; the
// dK pass's stage also holds the relu-mask words of its 16 pixels' 64*NG
// channels.  The state-cotangent conv keeps, beside its ring, the mask words
// of the pixels its taps reach: for each tap row dy, the tile's 128 pixels
// shifted by (dy - 1) rows and one more on each side, 4 words (128
// channels) each.
constexpr int kMaskPixels = kBM + 2;
constexpr int kConvMaskWords = 3 * kMaskPixels * 4;

template <int NG, int BK>
__host__ __device__ constexpr int conv_stage_floats() {
  return kBM * (BK + 4) + BK * 64 * NG;
}

template <int NG>
__host__ __device__ constexpr int dk_stage_floats() {
  return kBK * dk_rows(NG) + kBK * 64 * NG + kBK * 2 * NG;
}

template <int NG, int BK>
__host__ __device__ constexpr int conv_smem_bytes() {
  return 4 * (conv_stages(BK) * conv_stage_floats<NG, BK>() + kConvMaskWords);
}

template <int NG>
__host__ __device__ constexpr int dk_smem_bytes() {
  return 4 * kStages * dk_stage_floats<NG>();
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes of src into shared memory, or 16 zero bytes where !valid (src is
// then not read; callers pass a valid base pointer all the same).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// g_z of a float4 of g: h * g where the mask bit is set, else 0.
__device__ __forceinline__ float4 masked(float4 v, unsigned bits, float h) {
  return make_float4(bits & 1u ? h * v.x : 0.f, bits & 2u ? h * v.y : 0.f,
                     bits & 4u ? h * v.z : 0.f, bits & 8u ? h * v.w : 0.f);
}

struct ConvArgs {
  const float* src;   // (B, H, W, Cp): y_l (kStep) or g (kAccumulate)
  const float* K;     // (9, Cp, Cp): K_l (kStep) or K_l^T (kAccumulate)
  const float* bias;  // (Cp), kStep
  float* dst;         // kStep: y_{l+1}, or null; kAccumulate: g + conv(g_z, K^T)
  unsigned* mask;     // (B, H, W, nw): kStep's relu mask out (or null), kAccumulate's in
  const float* part;  // kAccumulate: the dK pass's (S, 9*Cp, Cp) partials
  const float* pdb;   //   and its (S, Cp) db partials, summed into
  float* gk;          //   dK_l (9, C, C)
  float* gb;          //   and db_l (C)
  int S;
  float h;
};

// The sum of n values at p[0], p[stride], ... in that order, their loads
// issued 16 at a time so that the L2 latency is paid n/16 times.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ p, size_t stride, int n) {
  float sum = 0.f;
  for (int s0 = 0; s0 < n; s0 += 16) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = s0 + q < n ? p[(s0 + q) * stride] : 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (s0 + q < n) sum += v[q];
    }
  }
  return sum;
}

// dK_l (9, C, C) and db_l (C): the S partials (S, 9*Cp, Cp) and (S, Cp)
// summed in order s = 0 .. S-1, spread over every block of the launch.  Not
// inlined, so that the conv's main loop keeps its own register allocation.
template <int kThreads>
__device__ __noinline__ void sum_partials(const float* __restrict__ part,
                                          const float* __restrict__ pdb, float* __restrict__ gk,
                                          float* __restrict__ gb, int S, int C, int Cp) {
  const int n = 9 * C * C + C;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    if (i < 9 * C * C) {
      const int t = i / (C * C), r = i - t * C * C;
      const int ci = r / C, co = r - ci * C;
      gk[i] = ordered_sum(part + static_cast<size_t>(t * Cp + ci) * Cp + co,
                          static_cast<size_t>(9) * Cp * Cp, S);
    } else {
      const int co = i - 9 * C * C;
      gb[co] = ordered_sum(pdb + co, Cp, S);
    }
  }
}

// One layer as a tiled implicit GEMM over pixels x output channels (see the
// file's note).  MODE kStep: dst = src + h * relu(src (*) K + bias), dst
// optional (null: the relu mask alone), the mask optional (null: not
// recorded).  MODE kAccumulate: first dK_l and db_l from the partials, then
// dst = src + g_z(src) (*) K^T.  Each output sums its 9*Cp products in one
// fixed order: tap, then input channel.
template <bool BF16, int MODE, int NG, int T, int BK>
__global__ void __launch_bounds__(T, kMinBlocks) wide_conv(const ConvArgs a, const Wide g) {
  // BK reduction steps a stage, kRing stages.
  constexpr int kRing = conv_stages(BK), kAStride = BK + 4;
  constexpr int kThreads = T, kTM = Threads<T, BK>::kTM;
  constexpr int kRowThreads = Threads<T, BK>::kRowThreads;
  constexpr int kAQuads = Threads<T, BK>::kAQuads, kACopies = Threads<T, BK>::kACopies;
  constexpr int kN = 64 * NG;             // output channels of the tile
  constexpr int kQuads = kN / 4;          // float4s a kernel-tile row
  constexpr int kBCopies = BK * kQuads / kThreads;
  constexpr int kStageFloats = conv_stage_floats<NG, BK>();
  constexpr bool kRewrite = BF16 || MODE == kAccumulate;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long hw = static_cast<long long>(g.H) * g.W;
  const int nc = BK == 64 ? 1 : g.nc;  // chunks of BK input channels a tap (Cp <= 64 at 64)

  // Copies: each thread brings kACopies float4s of the patch tile (pixels
  // tid / kAQuads + kThreads / kAQuads j of the tile, channel quad tid %
  // kAQuads of the stage's BK) and kBCopies of the kernel tile.  Which taps
  // of its pixels land inside the image, and the copies' offsets, computed
  // once; a stage adds the tap's and the chunk's offset, the same for every
  // copy.
  const int qa = tid % kAQuads;
  const float* tile = a.src + m0 * g.Cp;
  unsigned inside[kACopies];
#pragma unroll
  for (int j = 0; j < kACopies; ++j) {
    const long long m = m0 + tid / kAQuads + kThreads / kAQuads * j;
    inside[j] = 0u;
    if (m < g.M) {
      const int r = static_cast<int>(m % hw);
      const int y = r / g.W, x = r - (r / g.W) * g.W;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) inside[j] |= 1u << t;
      }
    }
  }
  // The stage to issue next, as (tap, channel chunk).
  int it_t = 0, it_c = 0;
  auto issue = [&](int slot) {
    float* As = smem + slot * kStageFloats;
    float* Bs = As + kBM * kAStride;
    const int ci0 = it_c * BK, ci = ci0 + 4 * qa;
    const int shift = (it_t / 3 - 1) * g.W + (it_t % 3 - 1);
    const bool quad_ok = ci < g.Cp;
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const int mm = tid / kAQuads + kThreads / kAQuads * j;
      const bool ok = quad_ok && ((inside[j] >> it_t) & 1u);
      copy16(As + mm * kAStride + 4 * qa, ok ? tile + (mm + shift) * g.Cp + ci : a.src, ok);
    }
    const float* k_rows = a.K + static_cast<size_t>(it_t * g.Cp + ci0) * g.Cp;
#pragma unroll
    for (int j = 0; j < kBCopies; ++j) {
      const int c = tid + kThreads * j;
      const int r = c / kQuads, col = 4 * (c % kQuads);
      const bool ok = ci0 + r < g.Cp && col < g.Cp;
      copy16(Bs + r * kN + col, ok ? k_rows + r * g.Cp + col : a.K, ok);
    }
    if (++it_c == nc) {
      it_c = 0;
      ++it_t;
    }
  };

  // kAccumulate: the mask words of every pixel a tap reaches, with the
  // first stage (zero outside the batch; a tap that leaves its image reads
  // zeros, so its bits do not matter).
  unsigned* Mt = reinterpret_cast<unsigned*>(smem + kRing * kStageFloats);
  if constexpr (MODE == kAccumulate) {
    const int words = 3 * kMaskPixels * g.nw;
    for (int i = tid; i < words; i += kThreads) {
      const int px = i / g.nw, w = i - px * g.nw;  // px: row r = px / kMaskPixels
      const int r = px / kMaskPixels;
      const long long q = m0 + static_cast<long long>(r - 1) * g.W + (px - r * kMaskPixels) - 1;
      const bool ok = q >= 0 && q < g.M;
      copy4(Mt + 4 * px + w, ok ? a.mask + q * g.nw + w : a.mask, ok);
    }
  }
  const int n = 9 * nc;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < n) issue(s);
    commit_copies();
  }
  if constexpr (MODE == kAccumulate) {
    sum_partials<kThreads>(a.part, a.pdb, a.gk, a.gb, a.S, g.C, g.Cp);
  }

  float acc[kTM][8 * NG];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < 8 * NG; ++j) acc[i][j] = 0.f;
  }
  const int tm = tid / 8, tn = tid % 8;
  // Stage `stage`'s own copies, landed: g_z from g (kAccumulate) and the
  // bf16 rounding, rewritten in place; the next barrier publishes them.
  // Stages come in order: (rw_t, rw_c) is the next one's (tap, chunk).
  int rw_t = 0, rw_c = 0;
  auto rewrite = [&](int stage) {
    if constexpr (kRewrite) {
      float* As = smem + stage % kRing * kStageFloats;
      const int ci = rw_c * BK + 4 * qa;
      // The tap's row of mask words, shifted by its column.
      const unsigned* row = Mt + 4 * (rw_t / 3 * kMaskPixels + rw_t % 3) + ci / 32;
#pragma unroll
      for (int j = 0; j < kACopies; ++j) {
        const int mm = tid / kAQuads + kThreads / kAQuads * j;
        float* v = As + mm * kAStride + 4 * qa;
        float4 x = ld4(v);
        if constexpr (MODE == kAccumulate) x = masked(x, row[4 * mm] >> (ci & 31), a.h);
        st4(v, operand4<BF16>(x));
      }
      if (++rw_c == nc) {
        rw_c = 0;
        ++rw_t;
      }
    }
  };
  wait_copies<kRing - 2>();
  if constexpr (MODE == kAccumulate) __syncthreads();  // every thread's mask words
  rewrite(0);
  for (int it = 0; it < n; ++it) {
    const float* As = smem + it % kRing * kStageFloats;
    const float* Bs = As + kBM * kAStride;
    __syncthreads();
    // The slot computed last iteration is free once every thread passed the barrier.
    if (it + kRing - 1 < n) issue((it + kRing - 1) % kRing);
    commit_copies();
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = ld4(As + (tm + kRowThreads * i) * kAStride + 4 * kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < 2 * NG; ++j) {
          const float4 b = ld4(Bs + (4 * kq + e) * kN + 4 * tn + 32 * j);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float ai = lane(av[i], e);
            acc[i][4 * j + 0] = fmaf(ai, b.x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(ai, b.y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(ai, b.z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(ai, b.w, acc[i][4 * j + 3]);
          }
        }
      }
    }
    // The next stage, issued kRing - 2 stages ago, has landed by now: its
    // rewrite runs while other warps still compute this one.
    if (it + 1 < n) {
      wait_copies<kRing - 2>();
      rewrite(it + 1);
    }
  }
  wait_copies<0>();

#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    const int co = 4 * tn + 32 * j;
    float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (MODE == kStep) {
      if (co < g.Cp) bb = ldg4(a.bias + co);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long m = m0 + tm + kRowThreads * i;
      const size_t o = static_cast<size_t>(m) * g.Cp + co;
      const bool mine = m < g.M && co < g.Cp;
      if constexpr (MODE == kStep) {
        const float z0 = acc[i][4 * j] + bb.x, z1 = acc[i][4 * j + 1] + bb.y;
        const float z2 = acc[i][4 * j + 2] + bb.z, z3 = acc[i][4 * j + 3] + bb.w;
        if (a.mask && j < g.nw) {
          // Word j of the pixel's mask holds channels 32j .. 32j+31: the 8
          // lanes tn = 0..7 of this tm, 4 bits each.
          unsigned bits = ((z0 > 0.f ? 1u : 0u) | (z1 > 0.f ? 2u : 0u) | (z2 > 0.f ? 4u : 0u) |
                           (z3 > 0.f ? 8u : 0u))
                          << (4 * tn);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
          if (tn == 0 && m < g.M) a.mask[static_cast<size_t>(m) * g.nw + j] = bits;
        }
        if (a.dst && mine) {
          float4 y = ldg4(a.src + o);
          y.x += a.h * relu(z0);
          y.y += a.h * relu(z1);
          y.z += a.h * relu(z2);
          y.w += a.h * relu(z3);
          st4(a.dst + o, y);
        }
      } else if (mine) {
        float4 v = ldg4(a.src + o);
        v.x += acc[i][4 * j];
        v.y += acc[i][4 * j + 1];
        v.z += acc[i][4 * j + 2];
        v.w += acc[i][4 * j + 3];
        st4(a.dst + o, v);
      }
    }
  }
}

struct DkArgs {
  const float* Y;         // (B, H, W, Cp): y_l
  const float* G;         // (B, H, W, Cp): g, the cotangent of y_{l+1}
  const unsigned* mask;   // (B, H, W, nw): the relu mask of z_l
  float* part;            // (S, 9*Cp, Cp) partial dK_l
  float* pdb;             // (S, Cp) partial db_l, from the blocks of row tile 0
  int chunk;
  float h;
};

// Partial dK (rows: 9*Cp (tap, input) pairs; columns: Cp outputs) and db of
// the pixels [s * chunk, (s + 1) * chunk), s = blockIdx.y: fp32, y and g_z
// unrounded in both modes.  Each thread sums its 4 x 8NG entries over the
// chunk's pixels in order, 16 a stage.
template <int NG>
__global__ void __launch_bounds__(dk_threads(NG), dk_blocks(NG))
    wide_dk(const DkArgs a, const Wide g) {
  constexpr int kThreads = dk_threads(NG), kRows = dk_rows(NG);
  constexpr int kRowQuads = kRows / 4;                    // float4s a patch-stage pixel
  constexpr int kACopies = kBK * kRowQuads / kThreads;    // patch float4s a thread copies
  constexpr int kPixelStep = kThreads / kRowQuads;        // between a thread's copied pixels
  constexpr int kN = 64 * NG;
  constexpr int kQuads = kN / 4;
  constexpr int kGCopies = kBK * kQuads / kThreads;
  constexpr int kStageFloats = dk_stage_floats<NG>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const long long p_begin = static_cast<long long>(blockIdx.y) * a.chunk;
  const long long p_end = p_begin + a.chunk < g.M ? p_begin + a.chunk : g.M;
  const int n = p_end > p_begin ? static_cast<int>((p_end - p_begin + kBK - 1) / kBK) : 0;
  const bool sums_db = blockIdx.x == 0;

  // Patch copies: rows r0 + 4 (tid % kRowQuads) .. +3 (one tap, four inputs:
  // Cp is a multiple of 4), pixels tid / kRowQuads + kPixelStep j of each
  // stage.  The rows' tap is fixed; each pixel's (y, x) advances 16 pixels a
  // stage.
  const int row = r0 + 4 * (tid % kRowQuads);
  const bool row_ok = row < g.K;
  const int t = row_ok ? row / g.Cp : 0;
  const int ci = row - t * g.Cp;
  const int dy = t / 3 - 1, dx = t % 3 - 1;
  const long long shift = static_cast<long long>(dy) * g.W + dx;
  const int hw = g.H * g.W;
  int py[kACopies], px[kACopies];
#pragma unroll
  for (int j = 0; j < kACopies; ++j) {
    const int r = static_cast<int>((p_begin + tid / kRowQuads + kPixelStep * j) % hw);
    py[j] = r / g.W;
    px[j] = r - py[j] * g.W;
  }
  long long p0 = p_begin;  // the first pixel of the stage to issue next
  auto issue = [&](int slot) {
    float* Ps = smem + slot * kStageFloats;
    float* Gs = Ps + kBK * kRows;
    unsigned* Ms = reinterpret_cast<unsigned*>(Gs + kBK * kN);
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const int pp = tid / kRowQuads + kPixelStep * j;
      const long long p = p0 + pp;
      const int yy = py[j] + dy, xx = px[j] + dx;
      const bool ok = row_ok && p < p_end && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
      copy16(Ps + pp * kRows + 4 * (tid % kRowQuads), ok ? a.Y + (p + shift) * g.Cp + ci : a.Y,
             ok);
      px[j] += kBK;
      while (px[j] >= g.W) {
        px[j] -= g.W;
        if (++py[j] == g.H) py[j] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kGCopies; ++j) {
      const int c = tid + kThreads * j;
      const int pp = c / kQuads, col = 4 * (c % kQuads);
      const long long p = p0 + pp;
      const bool ok = p < p_end && col < g.Cp;
      copy16(Gs + pp * kN + col, ok ? a.G + p * g.Cp + col : a.G, ok);
      // One copy of each mask word (32 channels), by the lane of its first quad.
      if (col % 32 == 0) {
        copy4(Ms + pp * 2 * NG + col / 32, ok ? a.mask + p * g.nw + col / 32 : a.mask, ok);
      }
    }
    p0 += kBK;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s);
    commit_copies();
  }

  // A thread's rows: r0 + 4 tr + i, i < 4.
  float acc[4][8 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8 * NG; ++j) acc[i][j] = 0.f;
  }
  // db: each thread sums the g_z float4s it copies (channel quad
  // 4 (tid % kQuads), pixels (tid + kThreads j) / kQuads of every stage).
  float4 ds = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tr = tid / 8, tn = tid % 8;
  // Stage `stage`'s own g copies, landed: g_z = h * mask * g in place (and
  // db's sums); the next barrier publishes them.
  auto rewrite = [&](int stage) {
    __syncwarp();  // the mask words came by other lanes of this warp
    float* Gs = smem + stage % kStages * kStageFloats + kBK * kRows;
    const unsigned* Ms = reinterpret_cast<const unsigned*>(Gs + kBK * kN);
#pragma unroll
    for (int j = 0; j < kGCopies; ++j) {
      const int c = tid + kThreads * j;
      const int col = 4 * (c % kQuads);
      float* v = Gs + (c / kQuads) * kN + col;
      const float4 gz = masked(ld4(v), Ms[c / kQuads * 2 * NG + col / 32] >> (col & 31), a.h);
      st4(v, gz);
      if (sums_db) {
        ds.x += gz.x;
        ds.y += gz.y;
        ds.z += gz.z;
        ds.w += gz.w;
      }
    }
  };
  if (n > 0) {
    wait_copies<kStages - 2>();
    rewrite(0);
  }
  for (int it = 0; it < n; ++it) {
    const float* Ps = smem + it % kStages * kStageFloats;
    const float* Gs = Ps + kBK * kRows;
    __syncthreads();
    if (it + kStages - 1 < n) issue((it + kStages - 1) % kStages);
    commit_copies();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = ld4(Ps + k * kRows + 4 * tr);
#pragma unroll
      for (int j = 0; j < 2 * NG; ++j) {
        const float4 b = ld4(Gs + k * kN + 4 * tn + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = lane(av, i);
          acc[i][4 * j + 0] = fmaf(ai, b.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(ai, b.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(ai, b.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(ai, b.w, acc[i][4 * j + 3]);
        }
      }
    }
    if (it + 1 < n) {
      wait_copies<kStages - 2>();
      rewrite(it + 1);
    }
  }
  wait_copies<0>();

  float* out = a.part + static_cast<size_t>(blockIdx.y) * g.K * g.Cp;
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    const int co = 4 * tn + 32 * j;
    if (co >= g.Cp) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * tr + i;
      if (r < g.K) {
        st4(out + static_cast<size_t>(r) * g.Cp + co,
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]));
      }
    }
  }
  if (sums_db) {
    // The threads' sums of each channel quad, in thread order.
    __syncthreads();
    st4(smem + 4 * tid, ds);
    __syncthreads();
    if (tid < kQuads && 4 * tid < g.Cp) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = tid; k < kThreads; k += kQuads) {
        const float4 v = ld4(smem + 4 * k);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      st4(a.pdb + static_cast<size_t>(blockIdx.y) * g.Cp + 4 * tid, sum);
    }
  }
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                   const Args& args, const Wide& g) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(args, g);
  return cudaGetLastError();
}

dim3 conv_grid(const Wide& g) { return dim3(static_cast<unsigned>((g.M + kBM - 1) / kBM)); }

template <bool BF16, int MODE>
cudaError_t conv(const ConvArgs& args, const Wide& g, cudaStream_t s) {
  constexpr int t1 = kConvThreadsNarrow, t2 = kConvThreadsWide;
  if (groups(g) == 2) {
    return launch(wide_conv<BF16, MODE, 2, t2, 16>, conv_grid(g), t2, conv_smem_bytes<2, 16>(), s,
                  args, g);
  }
  if (g.Cp > 48) {
    return launch(wide_conv<BF16, MODE, 1, t1, 64>, conv_grid(g), t1, conv_smem_bytes<1, 64>(), s,
                  args, g);
  }
  return launch(wide_conv<BF16, MODE, 1, t1, 16>, conv_grid(g), t1, conv_smem_bytes<1, 16>(), s,
                args, g);
}

cudaError_t dk(const DkArgs& args, const Wide& g, int S, cudaStream_t s) {
  if (groups(g) == 2) {
    const dim3 grid((g.K + dk_rows(2) - 1) / dk_rows(2), S);
    return launch(wide_dk<2>, grid, dk_threads(2), dk_smem_bytes<2>(), s, args, g);
  }
  const dim3 grid((g.K + dk_rows(1) - 1) / dk_rows(1), S);
  return launch(wide_dk<1>, grid, dk_threads(1), dk_smem_bytes<1>(), s, args, g);
}

template <bool BF16>
cudaError_t forward(const float* x, const float* K, const float* bias, float* scratch, float* out,
                    const Wide& g, float h, cudaStream_t s) {
  const size_t layer = 9LL * g.Cp * g.Cp;
  const float* src = x;
  for (int l = 0; l < g.L; ++l) {
    // The last layer writes `out`; the ones before it alternate.
    float* dst = (g.L - 1 - l) % 2 == 0 ? out : scratch;
    ConvArgs args{};
    args.src = src;
    args.K = K + l * layer;
    args.bias = bias + static_cast<size_t>(l) * g.Cp;
    args.dst = dst;
    args.h = h;
    const cudaError_t err = conv<BF16, kStep>(args, g, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

template <bool BF16>
cudaError_t backward(const float* K, const float* bias, const float* KT, float* traj,
                     unsigned* mask, const float* gin, float* gx, float* scratch, float* part,
                     float* pdb, float* gk, float* gb, const Wide& g, int S, int chunk, float h,
                     cudaStream_t s) {
  const size_t layer = 9LL * g.Cp * g.Cp;
  const size_t state = static_cast<size_t>(g.M) * g.Cp, words = static_cast<size_t>(g.M) * g.nw;
  cudaError_t err;
  // 1. Forward recompute: y_l into the trajectory, the relu mask of z_l.
  for (int l = 0; l < g.L; ++l) {
    ConvArgs args{};
    args.src = traj + l * state;
    args.K = K + l * layer;
    args.bias = bias + static_cast<size_t>(l) * g.Cp;
    args.dst = l + 1 < g.L ? traj + (l + 1) * state : nullptr;
    args.mask = mask + l * words;
    args.h = h;
    err = conv<BF16, kStep>(args, g, s);
    if (err != cudaSuccess) return err;
  }
  // 2. Reverse sweep: layer l reads g from the buffer layer l+1 wrote (the
  // input g at l = L-1) and writes gx at even l, `scratch` at odd l.
  const float* g_in = gin;
  for (int l = g.L - 1; l >= 0; --l) {
    float* g_out = l % 2 == 0 ? gx : scratch;
    DkArgs d{};
    d.Y = traj + l * state;
    d.G = g_in;
    d.mask = mask + l * words;
    d.part = part;
    d.pdb = pdb;
    d.chunk = chunk;
    d.h = h;
    err = dk(d, g, S, s);
    if (err != cudaSuccess) return err;
    ConvArgs args{};
    args.src = g_in;
    args.K = KT + l * layer;
    args.dst = g_out;
    args.mask = mask + l * words;
    args.part = part;
    args.pdb = pdb;
    args.gk = gk + static_cast<size_t>(l) * 9 * g.C * g.C;
    args.gb = gb + static_cast<size_t>(l) * g.C;
    args.S = S;
    args.h = h;
    err = conv<BF16, kAccumulate>(args, g, s);
    if (err != cudaSuccess) return err;
    g_in = g_out;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the largest block of the wide variants
// asks for at C channels: the conv's (its ring stages and its mask rows) or
// the dK pass's (kStages ring stages), whichever is larger.
long long deqres_euler_wide_smem(int C) {
  const Wide g = make_wide(1, 1, 1, C, 1);
  const int conv = groups(g) == 2 ? conv_smem_bytes<2, 16>()
                   : g.Cp > 48    ? conv_smem_bytes<1, 64>()
                                  : conv_smem_bytes<1, 16>();
  const int dk = groups(g) == 2 ? dk_smem_bytes<2>() : dk_smem_bytes<1>();
  return conv > dk ? conv : dk;
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The wide B1 on `stream`; returns the first launch error (0 on success).
// Device pointers to contiguous fp32 tensors: x (B, H, W, Cp) (only read),
// out (B, H, W, Cp), scratch (B, H, W, Cp) (unused at L = 1), K (L, 3, 3,
// Cp, Cp) and bias (L, Cp), zero-padded from C to Cp (C rounded up to a
// multiple of 4), K rounded to bf16 values in bf16 mode; all 16-byte
// aligned.
int deqres_euler_wide_fwd(const float* x, const float* K, const float* bias, float* scratch,
                          float* out, int B, int H, int W, int C, int L, float h, int bf16,
                          void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Wide g = make_wide(B, H, W, C, L);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? forward<true>(x, K, bias, scratch, out, g, h, s)
                               : forward<false>(x, K, bias, scratch, out, g, h, s));
}

// The wide B2 on `stream`; returns the first launch error (0 on success).
// Device pointers to contiguous tensors: K and KT (L, 3, 3, Cp, Cp) and bias
// (L, Cp) as for B1 (KT rot180 with c_in and c_out swapped); traj (L, B, H,
// W, Cp) with x, zero-padded, in its slice 0 (the recompute writes the
// others); mask (L, B, H, W, ceil(Cp/32)) 32-bit words (written whole, no
// zeroing needed); g (B, H, W, Cp) the zero-padded cotangent of y_L (only
// read); gx (B, H, W, Cp) out; scratch (B, H, W, Cp) (unused at L = 1),
// part (S, 9*Cp, Cp) and pdb (S, Cp) scratch; gk (L, 3, 3, C, C) and gb
// (L, C) out.  S chunks of `chunk` pixels (S * chunk >= B*H*W) split dK's
// sum.
int deqres_euler_wide_bwd(const float* K, const float* bias, const float* KT, float* traj,
                          void* mask, const float* g, float* gx, float* scratch, float* part,
                          float* pdb, float* gk, float* gb, int B, int H, int W, int C, int L,
                          int S, int chunk, float h, int bf16, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || L < 1 || S < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Wide w = make_wide(B, H, W, C, L);
  if (static_cast<long long>(S) * chunk < w.M) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* bits = static_cast<unsigned*>(mask);
  return static_cast<int>(
      bf16 ? backward<true>(K, bias, KT, traj, bits, g, gx, scratch, part, pdb, gk, gb, w, S,
                            chunk, h, s)
           : backward<false>(K, bias, KT, traj, bits, g, gx, scratch, part, pdb, gk, gb, w, S,
                             chunk, h, s));
}

}  // extern "C"
