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
// output channel, a sum over the 9 taps and the input channels in fp32, in
// one fixed order (conv_half and combine_halves in euler_common.cuh).  In
// bf16 mode every patch element and every kernel element is rounded to bf16
// (round to nearest even) before the multiply and the sum stays fp32, which
// is `patches.astype(bf16) @ K.astype(bf16)` with `preferred_element_type=f32`.
// The fp32 mode is true fp32: FFMA on the CUDA cores, no TF32.
//
// What bounds it on an H100: operations.  The work is 2*L*B*H*W*9*C^2 FLOP
// (9.66 GFLOP at B=32, L=64, 32x32, C=16) on the fp32 CUDA cores, while the
// bytes it must move are y in, y out and the kernels: about 4.8 MB at the same
// shape.
//
// What the design does about that bound:
//   - SM fill, one block an SM: one image is n blocks (n from the wrapper's
//     band plan: the most bands with batch * n <= 132 SMs, 4 at batch 32, 32
//     at batch 1), each block a band of about H/n rows.  The blocks of an
//     image trade their edge rows through device memory (euler_common.cuh),
//     not inside a thread-block cluster: clusters of 8 had to sit in one GPC,
//     which at batch 32 left 16 SMs three blocks and 8 SMs one (clock64()
//     phase counters and %smid readings, PERF.md section 7), and a cluster
//     barrier a layer.
//   - All L layers stay on chip: the band's zero-padded state, double
//     buffered, and layer l's kernel and bias live in shared memory; y is read
//     from device memory once and written once.  Layer l reads buffer l % 2,
//     once the neighbours' edge rows of step l - 1 are in its halo rows, and
//     writes y_{l+1} into the other, its edge rows also to device memory.
//   - Issue rate: each thread computes 4 adjacent pixels x 4 outputs,
//     sliding the 3x3 window along the row, so each float4 read of a kernel
//     row feeds 16 FFMAs; at C = 8 and 16 the reduction is unrolled at
//     compile time so loads issue under the FFMAs.  Where one thread a tile
//     would leave a block under 4 warps (batch 1 in 32 one-row bands), a
//     tile's inputs split over two lanes: half the serial chain, twice the
//     warps, a shuffle to add the halves (the wrapper's `kernel_split`).
//   - The next layer's kernel and bias arrive by one bulk copy (TMA) that one
//     thread issues while the layer computes, where two kernel buffers fit;
//     else it is issued at the layer's start and waited for at once (the
//     previous design's 128 threads spent 18% of a layer issuing cp.async).
//   - Latency: a block waits only for its two neighbours' counters (a
//     release store and an acquire load in device memory).
// With n = 1 the band is the whole image: the same kernel, no exchange.

#include "euler_common.cuh"

using namespace deqres;

namespace {

// Bytes ahead of the buffers in shared memory: the kernel buffers' two
// mbarriers.
constexpr int kHeaderFloats = 4;

// nkb: kernel buffers (2: the next layer's kernel loads during this layer).
// Block b of the grid is band b % n of image b / n of this launch.
template <bool BF16, int CP, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    euler_fwd(const float* __restrict__ x, const float* __restrict__ K,
              const float* __restrict__ bias, float* __restrict__ out, Edges e, Band b, int nkb,
              float h) {
  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;
  const int start = band_start(b, rank), rows = band_rows(b, rank);
  const size_t img = static_cast<size_t>(image) * b.H * b.W * b.C;
  extern __shared__ float4 smem4[];
  auto* bars = reinterpret_cast<unsigned long long*>(smem4);  // one a kernel buffer
  float* state = reinterpret_cast<float*>(smem4) + kHeaderFloats;  // two band buffers
  const int band = static_cast<int>(band_floats(b));
  float* kbuf = state + 2 * band;
  const int layer = static_cast<int>(layer_floats(b));
  const bool issuer = threadIdx.x == 0;
  unsigned phases = 0;

  if (issuer) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_fence_init();
  }
  zero_fill(state, 2 * band);
  __syncthreads();
  load_band(x + img, b, start, rows, state);
  if (issuer && b.L > 0) issue_layer(K, bias, b, 0, kbuf, bars);
  __syncthreads();

  for (int l = 0; l < b.L; ++l) {
    const int slot = nkb == 2 ? (l & 1) : 0;
    if (issuer) {
      // Two buffers: layer l + 1's kernel into the one layer l - 1 read (done
      // before the last barrier).  One: layer l's, now.
      if (nkb == 2 && l + 1 < b.L) {
        issue_layer(K, bias, b, l + 1, kbuf + ((l + 1) & 1) * layer, bars + ((l + 1) & 1));
      }
      if (nkb == 1 && l > 0) issue_layer(K, bias, b, l, kbuf, bars);
    }
    mbar_wait(bars + slot, phases, slot);
    const float* Ks = kbuf + slot * layer;
    float* cur = state + (l & 1) * band;
    float* nxt = state + ((l + 1) & 1) * band;
    float* first = own_edge(e, b, l, 0);
    float* last = own_edge(e, b, l, 1);
    // y_0's halo rows came with x; y_l's come from the neighbours' step l - 1.
    if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);
    layer_items<BF16, CP, S, false>(b, rows, cur, nxt, first, last, Ks, h, nullptr);
    // Every own row of y_{l+1} is written; the edge rows are out.
    if (b.n > 1) {
      publish_step(e, blockIdx.x, l);
    } else {
      __syncthreads();
    }
  }
  store_band(state + (b.L & 1) * band, b, start, rows, out + img);
}

long long smem_floats(const Band& b, int nkb) {
  return kHeaderFloats + 2 * band_floats(b) + nkb * layer_floats(b);
}

// Kernel buffers: 2 where they fit, else 1; 0 where not even one does.
int kernel_buffers(const Band& b) {
  for (int nkb = 2; nkb >= 1; --nkb) {
    if (4 * smem_floats(b, nkb) <= kMaxSmemBytes) return nkb;
  }
  return 0;
}

// The instantiation for this channel count, split and mode: unrolled at C =
// 8 and 16 (Cp = 8, 16), else the general loop.
template <bool BF16, int S>
auto* fwd_kernel_split(int Cp) {
  return Cp == 16 ? &euler_fwd<BF16, 16, S> : Cp == 8 ? &euler_fwd<BF16, 8, S>
                                                      : &euler_fwd<BF16, 0, S>;
}

auto* fwd_kernel(const Band& b, bool bf16) {
  if (b.S == 1) return bf16 ? fwd_kernel_split<true, 1>(b.Cp) : fwd_kernel_split<false, 1>(b.Cp);
  return bf16 ? fwd_kernel_split<true, 2>(b.Cp) : fwd_kernel_split<false, 2>(b.Cp);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of an H x W x C image in n bands
// asks for, or -1 where it does not fit (or n is not a valid band count).
long long deqres_euler_fwd_smem(int H, int W, int C, int n) {
  if (!valid_band(H, W, C, n)) return -1;
  const Band b = make_band(H, W, C, 0, n);
  const int nkb = kernel_buffers(b);
  return nkb ? 4 * smem_floats(b, nkb) : -1;
}

// Images of this shape in n bands, each tile's inputs split in `split`
// parts, that run at once (every band of an image resident together), or a
// negative number on error.
int deqres_euler_fwd_resident_images(int H, int W, int C, int n, int split, int bf16) {
  const long long smem = deqres_euler_fwd_smem(H, W, C, n);
  if (smem < 0 || split < 1 || split > 2) return -1;
  const Band b = make_band(H, W, C, 0, n, split);
  return resident_images(fwd_kernel(b, bf16), n, band_threads(b), static_cast<int>(smem));
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns the launches made (0 where B = 0), or
// minus the CUDA error.  All pointers are device pointers to contiguous
// tensors: x and out (B, H, W, C) fp32; K (L, 3, 3, Cp, Cp) and bias (L, Cp) fp32, zero-padded from C to Cp
// (C rounded up to a multiple of 4), K rounded to bf16 values in bf16 mode,
// both 16-byte aligned; edges (2, B*n, 2, RS) fp32 (RS: floats of a padded
// row, `make_band`) and steps (B*n) 32-bit counters (zeroed here), scratch
// for the bands' edge exchange (unused at n = 1).  n: bands an image; split:
// threads a 4 x 4 tile (its input channels in that many parts), 1 or 2.
// Where the card cannot hold every band of B images at once, the images go
// in several launches.
int deqres_euler_fwd(const float* x, const float* K, const float* bias, float* out, float* edges,
                     void* steps, int B, int H, int W, int C, int L, int n, int split, float h,
                     int bf16, void* stream) {
  const long long smem = deqres_euler_fwd_smem(H, W, C, n);
  if (smem < 0 || B < 0 || L < 0 || split < 1 || split > 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const Band b = make_band(H, W, C, L, n, split);
  const int nkb = kernel_buffers(b), threads = band_threads(b);
  const auto s = static_cast<cudaStream_t>(stream);
  auto kernel = fwd_kernel(b, bf16);
  if (n > 1) {
    const cudaError_t zeroed = cudaMemsetAsync(steps, 0, sizeof(unsigned) * B * n, s);
    if (zeroed != cudaSuccess) return -static_cast<int>(zeroed);
  }
  const size_t image = static_cast<size_t>(H) * W * C;
  return launch_images(kernel, B, n, threads, static_cast<int>(smem), s,
                       [&](const cudaLaunchConfig_t& config, int first, int count) {
    const Edges e{edges + 2LL * first * n * b.RS, static_cast<unsigned*>(steps) + first * n,
                  2LL * B * n * b.RS};
    return cudaLaunchKernelEx(&config, kernel, x + first * image, K, bias, out + first * image,
                              e, b, nkb, h);
  });
}

}  // extern "C"
