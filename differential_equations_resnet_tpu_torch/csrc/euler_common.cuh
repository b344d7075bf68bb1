// Device and launch code shared by the fused Euler kernels (fused_euler_fwd.cu
// and fused_euler_bwd.cu): operand rounding, the banded zero-padded
// shared-memory state, its halo exchange across a thread-block cluster,
// asynchronous copies into shared memory, and the register-tiled 3x3
// convolution.
//
// Bands.  One image is one cluster of n blocks; block (rank) r owns image rows
// [r*H/n, (r+1)*H/n) (integer division, so band heights differ by at most
// one; n <= H).  A band's state sits in shared memory with one halo row above
// and one below: padded row i holds image row start - 1 + i, zero outside the
// image.  A block writes its first and last own rows into its neighbours'
// halo rows through distributed shared memory as it computes them; the
// cluster barrier that ends the step makes them visible.
//
// Padded row layout: padded column c (image column c - 1, zero at c = 0 and
// from c = W + 1 on) starts at col_off(c) = c*Cp + (c/4)*4 floats, so every
// group of four columns is followed by four floats of padding.  The float4
// reads of the same column of eight neighbouring 4-pixel groups then fall on
// distinct banks.  Cp is C rounded up to a multiple of 4; the extra channels
// are 0.  The row stride RS is padded to 8 (mod 32) floats, so rows handled by
// adjacent lanes fall on different banks.  Kernels are laid out (9, Cp, Cp),
// tap-major (row-major over the 3x3 window), then c_in, then c_out, zero-padded.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deqres {

namespace cg = cooperative_groups;

constexpr int kMaxSmemBytes = 232448;  // per block, sm_90
constexpr int kMaxThreads = 512;
constexpr int kMaxBands = 16;          // non-portable cluster size of sm_90

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

__host__ __device__ __forceinline__ int col_off(int c, int Cp) { return c * Cp + (c >> 2) * 4; }

// Geometry of one launch: the image, its padding and its bands.
struct Band {
  int H, W, C, L, n;  // image, depth, bands (= cluster blocks) an image
  int Cp;             // channels rounded up to a multiple of 4
  int ncg;            // 4-pixel column groups a row
  int RS;             // floats a padded row
  int Rmax;           // rows of the tallest band
  int nw;             // 32-bit relu-mask words a pixel
};

inline Band make_band(int H, int W, int C, int L, int n) {
  Band b{};
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
  b.nw = (b.Cp + 31) / 32;
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

// Threads a block: one per (band row, column group, 4 outputs) work item of
// the tallest band, a whole number of warps, at most kMaxThreads.
inline int band_threads(const Band& b) {
  const int items = b.Rmax * b.ncg * (b.Cp / 4);
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

// Asynchronous copies from device memory into shared memory (cp.async): the
// issuing thread does not wait for them, so their latency overlaps other
// work until cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats (a multiple of 4, both ends 16-byte aligned) into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
}

// Layer l's kernel and bias into shared memory: K is (L, 9, Cp, Cp) and the
// bias (L, Cp), zero-padded from C to Cp and K's operands rounded as the mode
// says by the wrapper; the bias follows the kernel's 9*Cp*Cp floats.
__device__ __forceinline__ void load_layer_async(const float* __restrict__ K,
                                                 const float* __restrict__ bias, const Band& b,
                                                 int l, float* Ks) {
  const int n = 9 * b.Cp * b.Cp;
  copy_async(Ks, K + static_cast<size_t>(l) * n, n);
  copy_async(Ks + n, bias + static_cast<size_t>(l) * b.Cp, b.Cp);
}

// The rows of the cluster neighbours' copy of `buf` that mirror this band's
// edge rows: the band above's bottom halo row (up) and the band below's top
// halo row (down), through distributed shared memory; null at the image's
// top and bottom.
__device__ __forceinline__ void neighbour_halos(cg::cluster_group& cluster, const Band& b,
                                                int rank, float* buf, float*& up,
                                                float*& down) {
  up = rank > 0 ? cluster.map_shared_rank(buf, rank - 1) + (band_rows(b, rank - 1) + 1) * b.RS
                : nullptr;
  down = rank + 1 < b.n ? cluster.map_shared_rank(buf, rank + 1) : nullptr;
}

// acc[k][j] += the 3x3 "SAME" convolution of the padded source at pixel
// (band row r, image column 4g + k), output channel co + j, with Ks: an
// outer product of 4 pixels x 4 outputs a thread.  The window slides along
// the row, so the 4 pixels share their source loads (6 float4 reads for 3
// taps x 4 inputs), and every float4 read of a kernel row feeds 16 FFMAs.
// A step's 18 reads come before its 192 FFMAs in the source, so that the
// compiler may issue them early.
// The sum over the 9 taps and Cp inputs runs in one fixed order: tap row,
// then inputs in fours, then tap column, then the input within its four.
template <bool BF16>
__device__ __forceinline__ void conv_tile(const float* src, const Band& b, int r, int g, int co,
                                          const float* Ks, float (&acc)[4][4]) {
  const int Cp = b.Cp;
  int off[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) off[j] = col_off(4 * g + j, Cp);
#pragma unroll 1
  for (int dr = 0; dr < 3; ++dr) {
    const float* srow = src + (r + dr) * b.RS;
    const float* kr = Ks + dr * 3 * Cp * Cp + co;
#pragma unroll 1
    for (int ci = 0; ci < Cp; ci += 4) {
      // Every load of the step first, so that one wait covers them all.
      float4 v[6], kv[3][4];
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = ld4(srow + off[j] + ci);
#pragma unroll
      for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
        for (int q = 0; q < 4; ++q) kv[dq][q] = ld4(kr + (dq * Cp + ci + q) * Cp);
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
  }
}

// One Euler step of the band: nxt = cur + h * relu(conv(cur, K) + bias) on
// the band's own rows, read from `cur` (halo rows included), written to
// `nxt`'s interior; the first and last own rows are also written into the
// neighbours' halo rows `up` and `down` of their `nxt` (neighbour_halos),
// where they are read after the next cluster barrier.  With RECORD, the
// pre-step state y_l of the band's rows also goes to `traj` (dense (rows, W,
// Cp)) and the relu mask 1[z > 0] is OR-ed into `mask` (rows x W pixels of
// nw words).
template <bool BF16, bool RECORD>
__device__ __forceinline__ void euler_layer(const Band& b, int rows, const float* cur, float* nxt,
                                            float* up, float* down, const float* Ks, float h,
                                            float* __restrict__ traj, unsigned* mask) {
  const int Cp = b.Cp, ncog = Cp / 4;
  const float* bs = Ks + 9 * Cp * Cp;
  const int items = rows * b.ncg * ncog;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int co = (it % ncog) * 4, rest = it / ncog;
    const int g = rest % b.ncg, r = rest / b.ncg;
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = bs[co + j];
    }
    conv_tile<BF16>(cur, b, r, g, co, Ks, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * g + k;
      if (q >= b.W) break;
      const int c = col_off(q + 1, Cp) + co;
      const int o = (r + 1) * b.RS + c;
      float4 y = ld4(cur + o);
      if constexpr (RECORD) {
        const int p = r * b.W + q;
        st4(traj + p * Cp + co, y);
        const unsigned bits = (acc[k][0] > 0.f ? 1u : 0u) | (acc[k][1] > 0.f ? 2u : 0u) |
                              (acc[k][2] > 0.f ? 4u : 0u) | (acc[k][3] > 0.f ? 8u : 0u);
        if (bits) atomicOr(mask + p * b.nw + co / 32, bits << (co % 32));
      }
      y.x += h * relu(acc[k][0]);
      y.y += h * relu(acc[k][1]);
      y.z += h * relu(acc[k][2]);
      y.w += h * relu(acc[k][3]);
      st4(nxt + o, y);
      if (r == 0 && up) st4(up + c, y);
      if (r == rows - 1 && down) st4(down + c, y);
    }
  }
}

// Launch of `kernel` as clusters of n blocks, B images (B * n blocks).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int B, int n, int threads, int smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * n);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for clusters of n blocks of `kernel`, or
// minus the CUDA error.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int n, int threads, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.attrs = attr;
  config.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

}  // namespace deqres
