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
// one fixed order (conv_tile in euler_common.cuh).  In bf16 mode every patch
// element and every kernel element is rounded to bf16 (round to nearest even)
// before the multiply and the sum stays fp32, which is
// `patches.astype(bf16) @ K.astype(bf16)` with `preferred_element_type=f32`.
// The fp32 mode is true fp32: FFMA on the CUDA cores, no TF32.
//
// What bounds it on an H100: operations.  The work is 2*L*B*H*W*9*C^2 FLOP
// (9.66 GFLOP at B=32, L=64, 32x32, C=16) on the fp32 CUDA cores, while the
// bytes it must move are y in, y out and the kernels: about 4.8 MB at the same
// shape.
//
// What the design does about that bound:
//   - SM fill: one image is one thread-block cluster of n blocks (n from the
//     wrapper's band plan: 8 at batch 1-33 on 132 SMs), each block a band of
//     about H/n rows, so batch 32 runs 256 blocks on all 132 SMs and batch 1
//     runs on 8 SMs instead of one.
//   - All L layers stay on chip: the band's zero-padded state, double
//     buffered, and layer l's kernel and bias live in shared memory; y is read
//     from device memory once and written once.  Layer l reads buffer l % 2 and
//     writes y_{l+1} into the other, its first and last rows also into the
//     neighbours' other buffer; then one cluster barrier.  Nobody reads that
//     buffer during layer l, and its next write comes a barrier later, so no
//     row is overwritten while it is read.
//   - Per-SM efficiency: each thread computes 4 adjacent pixels x 4 outputs,
//     sliding the 3x3 window along the row (conv_tile), so each float4 read of
//     a kernel row feeds 16 FFMAs and the 4 pixels share their state reads.
//     In an experiment on an H100, halving those reads left the time as it
//     was: what is left is the FFMA issue itself, at one or two warps a
//     scheduler.
//   - Latency: a block writes its edge rows straight into its neighbours'
//     halo rows (distributed shared memory) as it computes them, so a layer
//     ends in one cluster barrier and nothing waits on a remote read; the
//     next layer's kernel arrives by cp.async while this layer computes,
//     where two kernel buffers fit, else after the barrier.
// With n = 1 the band is the whole image: the same kernel.

#include "euler_common.cuh"

using namespace deqres;

namespace {

// nkb: kernel buffers (2: the next layer's kernel loads during this layer).
template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    euler_fwd(const float* __restrict__ x, const float* __restrict__ K,
              const float* __restrict__ bias, float* __restrict__ out, Band b, int nkb,
              float h) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int start = band_start(b, rank), rows = band_rows(b, rank);
  const size_t img = static_cast<size_t>(blockIdx.x / b.n) * b.H * b.W * b.C;
  extern __shared__ float4 smem4[];
  float* state = reinterpret_cast<float*>(smem4);  // two band buffers
  const int band = static_cast<int>(band_floats(b));
  float* kbuf = state + 2 * band;
  const int layer = static_cast<int>(layer_floats(b));

  zero_fill(state, 2 * band);
  __syncthreads();
  load_band(x + img, b, start, rows, state);
  if (b.L > 0) load_layer_async(K, bias, b, 0, kbuf);
  cp_async_wait_all();
  // Every block of the cluster runs and has zeroed its buffers before any
  // neighbour writes into them.
  cluster.sync();

  for (int l = 0; l < b.L; ++l) {
    const float* Ks = kbuf + (l % nkb) * layer;
    if (nkb == 2 && l + 1 < b.L) {
      load_layer_async(K, bias, b, l + 1, kbuf + ((l + 1) % 2) * layer);
    }
    float* cur = state + (l & 1) * band;
    float* nxt = state + ((l + 1) & 1) * band;
    float *up, *down;
    neighbour_halos(cluster, b, rank, nxt, up, down);
    euler_layer<BF16, false>(b, rows, cur, nxt, up, down, Ks, h, nullptr, nullptr);
    cp_async_wait_all();
    // Every band's y_{l+1}, halo rows included, is written; layer l's reads
    // of its state and kernel are done.
    cluster.sync();
    if (nkb == 1 && l + 1 < b.L) {
      load_layer_async(K, bias, b, l + 1, kbuf);
      cp_async_wait_all();
      __syncthreads();
    }
  }
  // No block touches another's shared memory after the last cluster barrier,
  // so each may finish on its own.
  store_band(state + (b.L & 1) * band, b, start, rows, out + img);
}

long long smem_floats(const Band& b, int nkb) { return 2 * band_floats(b) + nkb * layer_floats(b); }

// Kernel buffers: 2 where they fit, else 1; 0 where not even one does.
int kernel_buffers(const Band& b) {
  for (int nkb = 2; nkb >= 1; --nkb) {
    if (4 * smem_floats(b, nkb) <= kMaxSmemBytes) return nkb;
  }
  return 0;
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

// cudaOccupancyMaxActiveClusters of the kernel at this shape in n bands, or
// a negative number on error.
int deqres_euler_fwd_max_clusters(int H, int W, int C, int n, int bf16) {
  const long long smem = deqres_euler_fwd_smem(H, W, C, n);
  if (smem < 0) return -1;
  const Band b = make_band(H, W, C, 0, n);
  return bf16 ? max_active_clusters(euler_fwd<true>, n, band_threads(b), static_cast<int>(smem))
              : max_active_clusters(euler_fwd<false>, n, band_threads(b), static_cast<int>(smem));
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous fp32 tensors: x and out (B, H, W,
// C); K (L, 3, 3, Cp, Cp) and bias (L, Cp), zero-padded from C to Cp (C rounded
// up to a multiple of 4), K rounded to bf16 values in bf16 mode, both 16-byte
// aligned.  n: bands (cluster blocks) an image.
int deqres_euler_fwd(const float* x, const float* K, const float* bias, float* out, int B,
                     int H, int W, int C, int L, int n, float h, int bf16, void* stream) {
  const long long smem = deqres_euler_fwd_smem(H, W, C, n);
  if (smem < 0 || B < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Band b = make_band(H, W, C, L, n);
  const int nkb = kernel_buffers(b), threads = band_threads(b);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_clusters(euler_fwd<true>, B, n, threads, static_cast<int>(smem), s, x, K,
                             bias, out, b, nkb, h)
           : launch_clusters(euler_fwd<false>, B, n, threads, static_cast<int>(smem), s, x, K,
                             bias, out, b, nkb, h);
  return static_cast<int>(err);
}

}  // extern "C"
