// Device and launch code shared by the band variants of the fused Euler
// kernels (fused_euler_fwd.cu and fused_euler_bwd.cu): operand rounding, the
// banded zero-padded shared-memory state and its halo exchange between the
// blocks of an image, bulk copies (TMA) with their mbarriers, and the layer
// step, whose 3x3 convolution each 4-pixel x 4-output tile splits over two
// threads.
//
// Bands.  One image is n blocks; block (band) r owns image rows
// [r*H/n, (r+1)*H/n) (integer division, so band heights differ by at most
// one; n <= H).  A band's state sits in shared memory with one halo row above
// and one below: padded row i holds image row start - 1 + i, zero outside the
// image.  The blocks of an image trade their edge rows through device
// memory: after a step a block writes its first and last own rows to an
// edge buffer (two, by step parity), then publishes the step in its counter
// (a release store after a fence); a neighbour that needs those rows waits
// for the counter (an acquire load), then copies them into its halo rows.
// Only neighbours wait for each other.  A waiting block spins until its
// neighbour has run, so every block of an image must be resident at once:
// a launch holds no more images than the card holds, and it is cooperative,
// so CUDA starts it only with all its blocks resident, whatever else
// the card runs, or refuses it (`launch_images`).  (A thread-block
// cluster with one barrier a step would tie an image's blocks to one GPC:
// at batch 32 in 8 bands the H100's GPCs hold 30 such clusters at two
// blocks an SM, and 45 at three, which left some SMs three blocks and
// others one.)
//
// Padded row layout: padded column c (image column c - 1, zero at c = 0 and
// from c = W + 1 on) starts at col_off(c) = c*Cp + (c/4)*4 floats, so every
// group of four columns is followed by four floats of padding.  Cp is C
// rounded up to a multiple of 4; the extra channels are 0.  The row stride RS
// is padded to 8 (mod 32) floats.  Kernels are laid out (9, Cp, Cp),
// tap-major (row-major over the 3x3 window), then c_in, then c_out,
// zero-padded; a layer's bias follows its kernel.
//
// The layer step (layer_items).  A work item is a 4 x 4 tile, or half of
// one: the 4 pixels (4g .. 4g+3) of band row r, 4 outputs co .. co+3, and
// with S = 2 one half s of the input channels, the groups of four inputs s,
// s+2, s+4, ...  (S, the threads a tile, is the wrapper's `kernel_split`:
// 2 where one thread a tile would leave a block under 4 warps.)  The two
// halves of a tile sit in adjacent lanes; each sums its 9 taps x Cp/2
// inputs alone, then one shuffle exchange adds the two halves for 2 pixels
// each (the lane of half s keeps pixels 2s and 2s+1), so the serial chain
// of a thread is half a tile's and a block has twice the warps.  Within a
// row, lane bits are (s, co group, column group): with S = 2 the column
// groups of one warp are every other one (0, 2, 4, 6, then 1, 3, 5, 7 in
// the next warp), so that with the halves' one-group offset the eight state
// addresses of a float4 read fall on distinct banks at C = 16.  At
// compile-time channel counts (CP = 8 or 16) the whole reduction is
// unrolled, so the compiler issues each step's shared-memory reads while
// the previous step's FFMAs run.
//
// Kernels and trajectories move by bulk copy (cp.async.bulk, the Tensor
// Memory Accelerator's one-dimensional form): one thread issues a layer's
// kernel and bias, and an mbarrier counts its bytes in, so no other thread
// spends an instruction on the copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deqres {

constexpr int kMaxSmemBytes = 232448;  // per block, sm_90
constexpr int kMaxThreads = 512;
constexpr int kMaxBands = 32;          // bands an image

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

template <bool BF16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand<BF16>(v.x), operand<BF16>(v.y), operand<BF16>(v.z),
                     operand<BF16>(v.w));
}

// relu that keeps a NaN, as jnp.maximum(z, 0) and torch.relu do.
__device__ __forceinline__ float relu(float z) { return z <= 0.f ? 0.f : z; }

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__host__ __device__ __forceinline__ int col_off(int c, int Cp) { return c * Cp + (c >> 2) * 4; }

// Geometry of one launch: the image, its padding and its bands.
struct Band {
  int H, W, C, L, n;  // image, depth, bands (= blocks) an image
  int Cp;             // channels rounded up to a multiple of 4
  int ncg;            // 4-pixel column groups a row
  int RS;             // floats a padded row
  int Rmax;           // rows of the tallest band
  int S;              // input-channel parts of a tile (one thread each): 1 or 2
};

inline Band make_band(int H, int W, int C, int L, int n, int S = 2) {
  Band b{};
  b.S = S;
  b.H = H;
  b.W = W;
  b.C = C;
  b.L = L;
  b.n = n;
  b.Cp = (C + 3) / 4 * 4;
  b.ncg = (W + 3) / 4;
  const int base = col_off(4 * b.ncg + 2, b.Cp);
  b.RS = base + (8 - base % 32 + 32) % 32;
  b.Rmax = (H + n - 1) / n;
  return b;
}

inline bool valid_band(int H, int W, int C, int n) {
  return H >= 1 && W >= 1 && C >= 1 && n >= 1 && n <= kMaxBands && n <= H;
}

// Floats of one padded band buffer, halo rows included.
__host__ __device__ inline long long band_floats(const Band& b) { return (b.Rmax + 2LL) * b.RS; }

// Floats of one layer's kernel and bias in shared memory.
__host__ __device__ inline long long layer_floats(const Band& b) {
  return 9LL * b.Cp * b.Cp + b.Cp;
}

// Work items a band row: column groups x output groups x input parts.
__host__ __device__ inline int row_items(const Band& b) { return b.ncg * (b.Cp / 4) * b.S; }

// Threads a block: one per work item of the tallest band, a whole number of
// warps, at most kMaxThreads (more items loop).
inline int band_threads(const Band& b) {
  const int items = b.Rmax * row_items(b);
  const int warps = (items + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

__device__ __forceinline__ int band_start(const Band& b, int rank) { return rank * b.H / b.n; }

__device__ __forceinline__ int band_rows(const Band& b, int rank) {
  return band_start(b, rank + 1) - band_start(b, rank);
}

__device__ __forceinline__ void zero_fill(float* buf, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) buf[i] = 0.f;
}

// Image rows start - 1 .. start + rows of a dense (H, W, C) image into the
// padded band buffer (rows outside the image stay as they are: zero).
__device__ __forceinline__ void load_band(const float* __restrict__ img, const Band& b,
                                          int start, int rows, float* buf) {
  const int n = (rows + 2) * b.W * b.C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % b.C, p = i / b.C;
    const int q = p % b.W, lr = p / b.W;
    const int gr = start - 1 + lr;
    if (gr < 0 || gr >= b.H) continue;
    buf[lr * b.RS + col_off(q + 1, b.Cp) + c] = img[(gr * b.W + q) * b.C + c];
  }
}

// The band's own rows of the padded buffer into a dense (H, W, C) image.
__device__ __forceinline__ void store_band(const float* buf, const Band& b, int start,
                                           int rows, float* __restrict__ img) {
  const int n = rows * b.W * b.C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % b.C, p = i / b.C;
    const int q = p % b.W, r = p / b.W;
    img[((start + r) * b.W + q) * b.C + c] = buf[(r + 1) * b.RS + col_off(q + 1, b.Cp) + c];
  }
}

// Every helper that takes a pointer into shared memory is inlined, and the
// kernels pick buffers by arithmetic on the shared base, not from an indexed
// array: either way the compiler would lose the address space and issue
// generic loads (LD) instead of shared ones (LDS).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers (64-bit words in shared memory, 8-byte aligned), initialised by
// one thread for one arrival: the issuing thread's arrive.expect_tx, after
// which the barrier's phase completes once the copies' bytes are in.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the next phase of `bar`; `phases` holds one parity bit a
// barrier (bit `which`), flipped here.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned& phases, int which) {
  const unsigned parity = (phases >> which) & 1u;
  while (!mbar_try_wait(bar, parity)) {
  }
  phases ^= 1u << which;
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` of shared memory into device memory, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The issuing thread's bulk stores are complete in device memory.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory accesses before later bulk
// copies (the async proxy) of the same bytes.
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Layer l's kernel and bias into shared memory by one thread: K is (L, 9, Cp,
// Cp) and the bias (L, Cp), zero-padded from C to Cp and K's operands
// rounded as the mode says by the wrapper; the bias follows the kernel's
// 9*Cp*Cp floats.
__device__ __forceinline__ void issue_layer(const float* __restrict__ K,
                                            const float* __restrict__ bias, const Band& b,
                                            int l, float* Ks, unsigned long long* bar) {
  const unsigned kbytes = 36u * b.Cp * b.Cp, bbytes = 4u * b.Cp;
  mbar_expect(bar, kbytes + bbytes);
  bulk_load(Ks, K + static_cast<size_t>(l) * 9 * b.Cp * b.Cp, kbytes, bar);
  bulk_load(Ks + 9 * b.Cp * b.Cp, bias + static_cast<size_t>(l) * b.Cp, bbytes, bar);
}

// The edge exchange.  edges: (2 parities, B*n bands, 2 rows, RS) floats,
// each band's first own row (slot 0) and last (slot 1) after a step;
// counters: one a band, the steps it has published.
struct Edges {
  float* rows;        // the edge buffer, this launch's images
  unsigned* steps;    // the counters, this launch's images
  long long parity;   // floats of one parity's rows
};

__device__ __forceinline__ float* edge_row(const Edges& e, int step, int band, int slot, int RS) {
  return e.rows + (step & 1) * e.parity + (2LL * band + slot) * RS;
}

// This band's edge row `slot` of step `step`, or null where the image is one
// band (nothing to trade).
__device__ __forceinline__ float* own_edge(const Edges& e, const Band& b, int step, int slot) {
  return b.n > 1 ? edge_row(e, step, blockIdx.x, slot, b.RS) : nullptr;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Step `step` of this band is out: its edge rows, written by every thread of
// the block before the barrier here, are ordered before the counter by the
// release (the pattern of a split-K semaphore).
__device__ __forceinline__ void publish_step(const Edges& e, int band, int step) {
  __syncthreads();
  if (threadIdx.x == 0) store_release(e.steps + band, static_cast<unsigned>(step) + 1u);
}

// Thread 0 waits until both neighbours of band `rank` (of `n`) have
// published step `step`; its acquire orders its later reads (and, through
// a barrier, its block's) after their edge rows.
__device__ __forceinline__ void wait_neighbours(const Edges& e, int band, int rank, int n,
                                                int step) {
  if (threadIdx.x == 0) {
    const unsigned done = static_cast<unsigned>(step) + 1u;
    while ((rank > 0 && load_acquire(e.steps + band - 1) < done) ||
           (rank + 1 < n && load_acquire(e.steps + band + 1) < done)) {
    }
  }
}

// The neighbours' edge rows of step `step` into the halo rows of `buf` (a
// band buffer of `rows` own rows), once they are published; warp 0 waits and
// copies the image columns (the zero columns at either end stay zero, so
// the edge buffer needs no zeroing), the block's barrier ends it.  Image top
// and bottom have no neighbour: their halo rows stay zero.
__device__ __forceinline__ void take_halos(const Edges& e, const Band& b, int image, int rank,
                                           int rows, int step, float* buf) {
  if (threadIdx.x < 32) {
    const int band = image * b.n + rank;
    wait_neighbours(e, band, rank, b.n, step);
    __syncwarp();
    const float* above = edge_row(e, step, band - 1, 1, b.RS);
    const float* below = edge_row(e, step, band + 1, 0, b.RS);
    float* bottom = buf + (rows + 1) * b.RS;
    const int end = col_off(b.W + 1, b.Cp);
    for (int i = b.Cp + 4 * threadIdx.x; i < end; i += 128) {
      if (rank > 0) st4(buf + i, __ldcg(reinterpret_cast<const float4*>(above + i)));
      if (rank + 1 < b.n) st4(bottom + i, __ldcg(reinterpret_cast<const float4*>(below + i)));
    }
  }
  __syncthreads();
}

// Where work item `it` of a band lies: band row r, column group g, first
// output co, input half s (0 where S = 1).  Within a row the half s is the
// lowest index, then the output group, then the column group (with S = 2
// every other one first; see the header).
struct HalfTile {
  int r, g, co, s;
};

template <int S>
__device__ __forceinline__ HalfTile half_tile(const Band& b, int it) {
  const int ncog = b.Cp / 4, per_row = row_items(b);
  HalfTile t;
  t.r = it / per_row;
  int rest = it - t.r * per_row;
  t.s = rest % S;
  rest /= S;
  t.co = (rest % ncog) * 4;
  const int gi = rest / ncog;
  const int half = b.ncg / 2;
  t.g = (S == 2 && b.ncg % 2 == 0) ? (gi % half) * 2 + gi / half : gi;
  return t;
}

template <bool BF16, int CP>
__device__ __forceinline__ void conv_step(const float* s0, const float* kr, int Cp,
                                          float (&acc)[4][4]) {
  // s0: the window's first column at this step's inputs; kr: the kernel rows
  // of this tap row's first input at this tile's outputs.
  const int cp = CP ? CP : Cp;
  float4 v[6], kv[3][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = ld4(s0 + j * cp + (j >= 4 ? 4 : 0));
#pragma unroll
  for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
    for (int q = 0; q < 4; ++q) kv[dq][q] = ld4(kr + (dq * cp + q) * cp);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = operand4<BF16>(v[j]);
#pragma unroll
  for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = lane(v[k + dq], q);
        acc[k][0] = fmaf(a, kv[dq][q].x, acc[k][0]);
        acc[k][1] = fmaf(a, kv[dq][q].y, acc[k][1]);
        acc[k][2] = fmaf(a, kv[dq][q].z, acc[k][2]);
        acc[k][3] = fmaf(a, kv[dq][q].w, acc[k][3]);
      }
    }
  }
}

// acc[k][j] += the 3x3 "SAME" convolution of the padded source at pixel
// (band row r, image column 4g + k), output channel co + j, with Ks, over
// the input groups s, s + S, s + 2S, ... (S = 1: every input).
// The window slides along the row, so the 4 pixels share their source loads
// (6 float4 reads for 3 taps x 4 inputs; a window's columns sit at fixed
// offsets from its first, whatever g), and every float4 read of a kernel
// row feeds 16 FFMAs.  The sum over taps and inputs runs in one fixed order:
// tap row, then the thread's input groups, then tap column, then the input
// within its four.  CP > 0 is the channel count at compile time (the loops
// unroll); CP = 0 reads it from b.
template <bool BF16, int CP, int S>
__device__ __forceinline__ void conv_half(const float* src, const Band& b, const HalfTile& t,
                                          const float* Ks, float (&acc)[4][4]) {
  const int Cp = CP ? CP : b.Cp;
  const float* s0 = src + t.r * b.RS + col_off(4 * t.g, Cp);
  const float* k0 = Ks + t.co;
  if constexpr (CP > 0) {
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
      for (int ci = 0; ci < CP; ci += 4 * S) {
        const int c = ci + 4 * t.s;
        conv_step<BF16, CP>(s0 + dr * b.RS + c, k0 + (dr * 3 * CP + c) * CP, CP, acc);
      }
    }
  } else {
#pragma unroll 1
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 1
      for (int ci = 4 * t.s; ci < Cp; ci += 4 * S) {
        conv_step<BF16, 0>(s0 + dr * b.RS + ci, k0 + (dr * 3 * Cp + ci) * Cp, Cp, acc);
      }
    }
  }
}

// A tile's sums for this thread's 4 / S pixels (pixels s*4/S ..): with S =
// 2 the two halves added for 2 pixels each (the lane of half s keeps pixels
// 2s and 2s + 1), out = acc_{s=0} + acc_{s=1}, the same bits in either lane;
// every lane of the warp takes part.  With S = 1, acc itself.
template <int S>
__device__ __forceinline__ void combine_halves(const float (&acc)[4][4], int s,
                                               float (&out)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4 / S; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (S == 2) {
        const float send = s ? acc[kk][j] : acc[2 + kk][j];
        const float keep = s ? acc[2 + kk][j] : acc[kk][j];
        out[kk][j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      } else {
        out[kk][j] = acc[kk][j];
      }
    }
  }
}

// One Euler step of the band: nxt = cur + h * relu(conv(cur, K) + bias) on
// the band's own rows, read from `cur` (halo rows included), written to
// `nxt`'s interior; the first and last own rows also go to this band's edge
// rows `first` and `last` (device memory; null where the image is one
// band).  With RECORD, the relu mask 1[z > 0] of each item's 4 / S pixels x
// 4 outputs goes to mask[it] (bit 4*kk + j).  Every thread of
// the block runs the same iterations (the halves' shuffle needs whole
// warps).
template <bool BF16, int CP, int S, bool RECORD>
__device__ __forceinline__ void layer_items(const Band& b, int rows, const float* cur, float* nxt,
                                            float* first, float* last, const float* Ks, float h,
                                            unsigned short* __restrict__ mask) {
  const int Cp = CP ? CP : b.Cp;
  const float* bs = Ks + 9 * Cp * Cp;
  const int items = rows * row_items(b);
  for (int base = 0; base < items; base += blockDim.x) {
    const int it = base + threadIdx.x;
    const bool active = it < items;  // both halves of a tile, or neither
    const HalfTile t = half_tile<S>(b, active ? it : 0);
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = t.s == 0 ? bs[t.co + j] : 0.f;
    }
    if (active) conv_half<BF16, CP, S>(cur, b, t, Ks, acc);
    float z[4][4];
    combine_halves<S>(acc, t.s, z);
    if (!active) continue;
    unsigned bits = 0;
#pragma unroll
    for (int kk = 0; kk < 4 / S; ++kk) {
      const int q = 4 * t.g + (4 / S) * t.s + kk;
      if (q >= b.W) break;
      const int c = col_off(q + 1, Cp) + t.co;
      const int o = (t.r + 1) * b.RS + c;
      float4 y = ld4(cur + o);
      if constexpr (RECORD) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bits |= (z[kk][j] > 0.f ? 1u : 0u) << (4 * kk + j);
      }
      y.x += h * relu(z[kk][0]);
      y.y += h * relu(z[kk][1]);
      y.z += h * relu(z[kk][2]);
      y.w += h * relu(z[kk][3]);
      st4(nxt + o, y);
      if (t.r == 0 && first) st4(first + c, y);
      if (t.r == rows - 1 && last) st4(last + c, y);
    }
    if constexpr (RECORD) mask[it] = static_cast<unsigned short>(bits);
  }
}

// Images a launch may hold at once: every band of an image must be resident
// together (they wait for each other), so no more than the card holds,
// which is also the most blocks a cooperative launch may have.
template <typename Kernel>
int resident_images(Kernel kernel, int n, int threads, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms / n;
}

// `kernel` over B images of n bands, as many images a launch as the card
// holds at once (`resident_images`).  Where the bands of an image trade
// edge rows (n > 1), each launch is cooperative: CUDA starts it only
// when every one of its blocks can be resident together, so other work on
// the card (a kernel on another stream) cannot leave a band
// unscheduled while its neighbours wait for it; a launch it cannot place so
// fails.  launch(config, first image, images) enqueues one launch with
// cudaLaunchKernelEx.  The shared-memory attribute and the occupancy are
// asked once a (device, kernel, threads, shared memory, bands) on each host
// thread, not at every launch.  Returns the launches made, or minus the
// CUDA error.
template <typename Kernel, typename Launch>
int launch_images(Kernel kernel, int B, int n, int threads, int smem, cudaStream_t stream,
                  Launch launch) {
  struct Query {
    int device;
    const void* kernel;
    int threads, smem, n, at_once;
  };
  thread_local Query last = {-1, nullptr, 0, 0, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const void* key = reinterpret_cast<const void*>(kernel);
  if (last.device != device || last.kernel != key || last.threads != threads ||
      last.smem != smem || last.n != n) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int at_once = n == 1 ? 1 << 30 : resident_images(kernel, n, threads, smem);
    if (at_once < 0) return at_once;
    last = {device, key, threads, smem, n, at_once};
  }
  if (last.at_once == 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute cooperative[1];
  cooperative[0].id = cudaLaunchAttributeCooperative;
  cooperative[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = cooperative;
  config.numAttrs = n > 1 ? 1 : 0;
  int launches = 0;
  for (int first = 0; first < B; first += last.at_once, ++launches) {
    const int count = B - first < last.at_once ? B - first : last.at_once;
    config.gridDim = dim3(count * n);
    err = launch(config, first, count);
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return launches;
}

}  // namespace deqres
