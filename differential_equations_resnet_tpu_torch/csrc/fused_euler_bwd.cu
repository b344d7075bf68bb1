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
// partials, one per (image, band): (B*n, L, 9, C, C) and (B*n, L, C), which
// the wrapper sums in a fixed order: no float atomics, so the sums are
// deterministic.  K^T is arranged by the wrapper, as the Pallas wrapper does
// (:302-306).
//
// Numerics: the forward recompute and the g_z * K^T product take bf16
// operands (fp32 sums) in bf16 mode, as B1 and the Pallas kernel do; dK and
// db are fp32 in both modes (the Pallas `dot_general` at :266-270 never
// casts).  The fp32 mode is true fp32: FFMA on the CUDA cores, no TF32.
//
// What bounds it on an H100: operations.  The least work from x is three
// 2*L*B*H*W*9*C^2 products (forward recompute, dK, the state cotangent):
// 28.99 GFLOP at B=32, L=64, 32x32, C=16, against fp32 CUDA cores.
//
// What the design does about that bound: B1's banded design (one image is a
// cluster of n blocks, each a band of rows; see fused_euler_fwd.cu and
// euler_common.cuh), in two phases.
//   1. Forward recompute: B1's banded step.  Each pre-step band y_l goes to a
//      global trajectory scratch (L, B, H, W, Cp) that the wrapper allocates
//      (one SM cannot hold 64 states, as the Pallas kernel holds them in
//      VMEM), and the relu mask 1[z_l > 0] to a global bit mask (L, B, H, W,
//      ceil(C/32)) of 32-bit words, gathered per layer in shared memory by
//      integer OR.  The reverse sweep reads the mask instead of recomputing
//      z_l: three products, not four.  The bits are those of the recomputed
//      step: the same operands through the same arithmetic in the same order.
//   2. Reverse sweep, per layer: the band of y_l with its halo rows straight
//      from the trajectory (every row is there: no exchange), the layer's mask
//      words and K_l^T, all by cp.async one layer ahead; g_z = h * mask * g
//      formed into a padded buffer (two, by layer parity), its first and last
//      rows also written into the neighbours' halo rows through distributed
//      shared memory; dK_l and db_l over the band's own pixels, before the
//      layer's one cluster barrier so that they hide it; then g += g_z * K^T.
//      g stays in shared memory for the band's pixels.
//   dK pass: a work item is (tap row, 4 inputs, 4 outputs, a chunk of rows);
//   it slides a 3-column window of y along each of its rows, so each pixel
//   costs one float4 read of y and one of g_z for 48 FMAs, and the row
//   chunks of an item sit in adjacent lanes and are summed with warp
//   shuffles.

#include "euler_common.cuh"

using namespace deqres;

namespace {

// dK_l and db_l of the band from the padded y_l (halo rows included) and g_z
// (own rows) in shared memory.  R (a power of two <= 32) row chunks an item;
// every thread of the block calls this the same number of times (the
// shuffles need full warps).
__device__ __forceinline__ void weight_grads(const Band& b, int rows, int R, const float* Y,
                                             const float* Gz, float* __restrict__ gk,
                                             float* __restrict__ gb) {
  const int Cp = b.Cp, C = b.C, ncog = Cp / 4, per_dr = ncog * ncog;
  const int items = 3 * per_dr * R;
  for (int base = 0; base < items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool active = item < items;
    const int grp = item / R, chunk = item % R;
    const int dr = grp / per_dr, rem = grp % per_dr;
    const int ci = (rem / ncog) * 4, co = (rem % ncog) * 4;
    float acc[3][4][4];
    float ds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ds[j] = 0.f;
#pragma unroll
      for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dq][i][j] = 0.f;
      }
    }
    if (active) {
#pragma unroll 1
      for (int r = chunk; r < rows; r += R) {
        const float* yr = Y + (r + dr) * b.RS + ci;       // padded rows r .. r+2
        const float* gr = Gz + (r + 1) * b.RS + co;       // own row r
        float4 w0 = ld4(yr + col_off(0, Cp)), w1 = ld4(yr + col_off(1, Cp));
        // The next pixel's two reads are in flight while this one's FMAs run.
        float4 w2 = ld4(yr + col_off(2, Cp)), gz = ld4(gr + col_off(1, Cp));
#pragma unroll 1
        for (int q = 0; q < b.W; ++q) {
          float4 w2_next = w2, gz_next = gz;
          if (q + 1 < b.W) {
            w2_next = ld4(yr + col_off(q + 3, Cp));
            gz_next = ld4(gr + col_off(q + 2, Cp));
          }
          ds[0] += gz.x;
          ds[1] += gz.y;
          ds[2] += gz.z;
          ds[3] += gz.w;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a[3] = {lane(w0, i), lane(w1, i), lane(w2, i)};
#pragma unroll
            for (int dq = 0; dq < 3; ++dq) {
              acc[dq][i][0] = fmaf(a[dq], gz.x, acc[dq][i][0]);
              acc[dq][i][1] = fmaf(a[dq], gz.y, acc[dq][i][1]);
              acc[dq][i][2] = fmaf(a[dq], gz.z, acc[dq][i][2]);
              acc[dq][i][3] = fmaf(a[dq], gz.w, acc[dq][i][3]);
            }
          }
          w0 = w1;
          w1 = w2;
          w2 = w2_next;
          gz = gz_next;
        }
      }
    }
    for (int m = R >> 1; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[j] += __shfl_xor_sync(0xffffffffu, ds[j], m);
#pragma unroll
        for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[dq][i][j] += __shfl_xor_sync(0xffffffffu, acc[dq][i][j], m);
          }
        }
      }
    }
    if (active && chunk == 0) {
#pragma unroll
      for (int dq = 0; dq < 3; ++dq) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ci + i < C && co + j < C) {
              gk[((dr * 3 + dq) * C + ci + i) * C + co + j] = acc[dq][i][j];
            }
          }
        }
      }
      if (dr == 0 && ci == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (co + j < C) gb[co + j] = ds[j];
        }
      }
    }
  }
}

// Shared memory, forward phase: two band buffers, nkb layer buffers, the
// relu-mask words of two layers (by parity).  Reverse phase, over the same
// bytes: y_l, g_z by layer parity (two band buffers), g of the band's pixels
// (rows x W x Cp), nkb K^T buffers and one layer's relu-mask words.
__host__ __device__ long long mask_floats(const Band& b) {
  return static_cast<long long>(b.Rmax) * b.W * b.nw;
}

long long forward_floats(const Band& b, int nkb) {
  return 2 * band_floats(b) + nkb * layer_floats(b) + 2 * mask_floats(b);
}

long long reverse_floats(const Band& b, int nkb) {
  return 3 * band_floats(b) + static_cast<long long>(b.Rmax) * b.W * b.Cp +
         nkb * 9LL * b.Cp * b.Cp + mask_floats(b);
}

long long smem_floats(const Band& b, int nkb) {
  const long long f = forward_floats(b, nkb), r = reverse_floats(b, nkb);
  return f > r ? f : r;
}

template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    euler_bwd(const float* __restrict__ x, const float* __restrict__ K,
              const float* __restrict__ bias, const float* __restrict__ KT,
              const float* __restrict__ g_in,
              float* __restrict__ gx, float* __restrict__ gk, float* __restrict__ gb,
              float* __restrict__ traj, unsigned* __restrict__ mask, Band b, int B, int nkb,
              int R, float h) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int start = band_start(b, rank), rows = band_rows(b, rank);
  const int image = blockIdx.x / b.n, Cp = b.Cp, W = b.W, nw = b.nw;
  const size_t img = static_cast<size_t>(image) * b.H * W * b.C;
  // Layer l's slices of the trajectory (this image) and of the mask (this band).
  const size_t traj_image = static_cast<size_t>(image) * b.H * W * Cp;
  const size_t traj_layer = static_cast<size_t>(B) * b.H * W * Cp;
  const size_t mask_band = (static_cast<size_t>(image) * b.H + start) * W * nw;
  const size_t mask_layer = static_cast<size_t>(B) * b.H * W * nw;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int band = static_cast<int>(band_floats(b));
  const int layer = static_cast<int>(layer_floats(b)), kt_floats = 9 * Cp * Cp;
  const int nbits = rows * W * nw;

  // 1. Forward recompute, recording y_l and the relu mask of z_l.
  {
    float* state = smem;  // two band buffers
    float* kbuf = smem + 2 * band;
    unsigned* bits = reinterpret_cast<unsigned*>(kbuf + nkb * layer);  // two layers' words
    const int words = static_cast<int>(mask_floats(b));
    zero_fill(smem, 2 * band);
    for (int i = threadIdx.x; i < 2 * words; i += blockDim.x) bits[i] = 0u;
    __syncthreads();
    load_band(x + img, b, start, rows, state);
    load_layer_async(K, bias, b, 0, kbuf);
    cp_async_wait_all();
    cluster.sync();  // every block runs and has zeroed its buffers
    for (int l = 0; l < b.L; ++l) {
      const float* Ks = kbuf + (l % nkb) * layer;
      if (nkb == 2 && l + 1 < b.L) {
        load_layer_async(K, bias, b, l + 1, kbuf + ((l + 1) % 2) * layer);
      }
      float* cur = state + (l & 1) * band;
      float* nxt = state + ((l + 1) & 1) * band;
      unsigned* layer_bits = bits + (l & 1) * words;
      float *up, *down;
      neighbour_halos(cluster, b, rank, nxt, up, down);
      euler_layer<BF16, true>(b, rows, cur, nxt, up, down, Ks, h,
                              traj + l * traj_layer + traj_image +
                                  static_cast<size_t>(start) * W * Cp,
                              layer_bits);
      cp_async_wait_all();
      cluster.sync();  // every band's y_{l+1} and layer l's mask are written
      // Layer l's mask out, its words zeroed for layer l + 2.
      unsigned* dst = mask + l * mask_layer + mask_band;
      for (int i = threadIdx.x; i < nbits; i += blockDim.x) {
        dst[i] = layer_bits[i];
        layer_bits[i] = 0u;
      }
      if (nkb == 1 && l + 1 < b.L) {
        load_layer_async(K, bias, b, l + 1, kbuf);
        cp_async_wait_all();
        __syncthreads();
      }
    }
    __syncthreads();  // the last mask words are out before the bytes are reused
  }

  // 2. Reverse sweep.  y_l (band and halo rows), layer l's mask and K_l^T
  // arrive by cp.async one step ahead.
  float* Y = smem;
  float* G = smem + band;  // g_z, two band buffers by layer parity
  float* gs = smem + 3 * band;
  float* KTs = gs + static_cast<long long>(b.Rmax) * W * Cp;
  unsigned* bits = reinterpret_cast<unsigned*>(KTs + nkb * kt_floats);
  const int ncog = Cp / 4;
  auto fetch_y = [&](int l) {
    const float* src = traj + l * traj_layer + traj_image;
    const int n = (rows + 2) * W * ncog;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = (i % ncog) * 4, p = i / ncog;
      const int q = p % W, lr = p / W, gr = start - 1 + lr;
      if (gr < 0 || gr >= b.H) continue;
      cp_async16(Y + lr * b.RS + col_off(q + 1, Cp) + c, src + (gr * W + q) * Cp + c);
    }
  };
  auto fetch_mask = [&](int l) {
    const unsigned* src = mask + l * mask_layer + mask_band;
    for (int i = threadIdx.x; i < nbits; i += blockDim.x) cp_async4(bits + i, src + i);
  };
  auto fetch_kt = [&](int l) {
    copy_async(KTs + (l % nkb) * kt_floats, KT + static_cast<size_t>(l) * kt_floats, kt_floats);
  };
  zero_fill(smem, 3 * band);
  for (int i = threadIdx.x; i < rows * W * Cp; i += blockDim.x) {
    const int c = i % Cp, p = i / Cp;
    gs[i] = c < b.C ? g_in[img + (static_cast<size_t>(start) * W + p) * b.C + c] : 0.f;
  }
  __syncthreads();
  fetch_y(b.L - 1);
  fetch_mask(b.L - 1);
  fetch_kt(b.L - 1);
  // Every block has zeroed its buffers before any neighbour writes g_z rows
  // into them.
  cluster.sync();

  for (int l = b.L - 1; l >= 0; --l) {
    float* Gz = G + (l & 1) * band;
    cp_async_wait_all();
    __syncthreads();  // y_l, the mask and K_l^T are in; the last layer's g is written
    // g_z = h * mask * g over the band's pixels, the edge rows also into the
    // neighbours' halo rows.
    {
      float *up, *down;
      neighbour_halos(cluster, b, rank, Gz, up, down);
      const int quads = rows * W * ncog;
      for (int i = threadIdx.x; i < quads; i += blockDim.x) {
        const int c = (i % ncog) * 4, p = i / ncog;
        const int q = p % W, r = p / W;
        const unsigned word = bits[p * nw + c / 32] >> (c % 32);
        const float4 g = ld4(gs + p * Cp + c);
        const float4 v = make_float4(word & 1u ? h * g.x : 0.f, word & 2u ? h * g.y : 0.f,
                                     word & 4u ? h * g.z : 0.f, word & 8u ? h * g.w : 0.f);
        const int o = col_off(q + 1, Cp) + c;
        st4(Gz + (r + 1) * b.RS + o, v);
        if (r == 0 && up) st4(up + o, v);
        if (r == rows - 1 && down) st4(down + o, v);
      }
    }
    __syncthreads();  // g_z of the band is in; the mask words are free
    if (l > 0) fetch_mask(l - 1);
    const size_t il = static_cast<size_t>(blockIdx.x) * b.L + l;
    weight_grads(b, rows, R, Y, Gz, gk + il * 9 * b.C * b.C, gb + il * b.C);
    // Every band's g_z, halo rows included, is written; y_l is free.
    cluster.sync();
    if (l > 0) {
      fetch_y(l - 1);
      if (nkb == 2) fetch_kt(l - 1);
    }
    // g += g_z * K^T over the band's pixels.
    const float* Kt = KTs + (l % nkb) * kt_floats;
    const int items = rows * b.ncg * ncog;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int co = (it % ncog) * 4, rest = it / ncog;
      const int g = rest % b.ncg, r = rest / b.ncg;
      float acc[4][4] = {};
      conv_tile<BF16>(Gz, b, r, g, co, Kt, acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = 4 * g + k;
        if (q >= W) break;
        float* dst = gs + (r * W + q) * Cp + co;
        float4 v = ld4(dst);
        v.x += acc[k][0];
        v.y += acc[k][1];
        v.z += acc[k][2];
        v.w += acc[k][3];
        st4(dst, v);
      }
    }
    if (l > 0 && nkb == 1) {
      __syncthreads();  // every thread is done with K_l^T
      fetch_kt(l - 1);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < rows * W * b.C; i += blockDim.x) {
    const int c = i % b.C, p = i / b.C;
    gx[img + (static_cast<size_t>(start) * W + p) * b.C + c] = gs[p * Cp + c];
  }
  // No block touches another's shared memory after the last cluster barrier.
}

// Kernel buffers of the forward phase: 2 where they fit, else 1; 0 where not
// even one does.
int kernel_buffers(const Band& b) {
  for (int nkb = 2; nkb >= 1; --nkb) {
    if (4 * smem_floats(b, nkb) <= kMaxSmemBytes) return nkb;
  }
  return 0;
}

// Row chunks of a dK work item: a power of two <= 32 (one warp) and <= the
// tallest band, with no more items than threads.
int row_chunks(const Band& b, int threads) {
  const int per_r = 3 * (b.Cp / 4) * (b.Cp / 4);
  int r = 1;
  while (r < 32 && 2 * r <= b.Rmax && per_r * 2 * r <= threads) r *= 2;
  return r;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of an H x W x C image in n bands
// asks for, or -1 where it does not fit (or n is not a valid band count).
long long deqres_euler_bwd_smem(int H, int W, int C, int n) {
  if (!valid_band(H, W, C, n)) return -1;
  const Band b = make_band(H, W, C, 1, n);
  const int nkb = kernel_buffers(b);
  return nkb ? 4 * smem_floats(b, nkb) : -1;
}

// cudaOccupancyMaxActiveClusters of the kernel at this shape in n bands, or
// a negative number on error.
int deqres_euler_bwd_max_clusters(int H, int W, int C, int n, int bf16) {
  const long long smem = deqres_euler_bwd_smem(H, W, C, n);
  if (smem < 0) return -1;
  const Band b = make_band(H, W, C, 1, n);
  return bf16 ? max_active_clusters(euler_bwd<true>, n, band_threads(b), static_cast<int>(smem))
              : max_active_clusters(euler_bwd<false>, n, band_threads(b), static_cast<int>(smem));
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous tensors: x, g and gx (B, H, W,
// C); K and KT (L, 3, 3, Cp, Cp) and bias (L, Cp), zero-padded from C to Cp (C
// rounded up to a multiple of 4), K and KT rounded to bf16 values in bf16
// mode, all three 16-byte aligned; gk (B*n, L, 9, C, C) and gb (B*n, L, C),
// per-band partials; traj (L, B, H, W, Cp) and mask (L, B, H, W, ceil(Cp/32))
// 32-bit words, scratch.
int deqres_euler_bwd(const float* x, const float* K, const float* bias, const float* KT,
                     const float* g, float* gx, float* gk, float* gb, float* traj, void* mask,
                     int B, int H, int W, int C, int L, int n, float h, int bf16, void* stream) {
  const long long smem = deqres_euler_bwd_smem(H, W, C, n);
  if (smem < 0 || B < 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Band b = make_band(H, W, C, L, n);
  const int nkb = kernel_buffers(b), threads = band_threads(b);
  const int R = row_chunks(b, threads);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* bits = static_cast<unsigned*>(mask);
  const cudaError_t err =
      bf16 ? launch_clusters(euler_bwd<true>, B, n, threads, static_cast<int>(smem), s, x, K,
                             bias, KT, g, gx, gk, gb, traj, bits, b, B, nkb, R, h)
           : launch_clusters(euler_bwd<false>, B, n, threads, static_cast<int>(smem), s, x, K,
                             bias, KT, g, gx, gk, gb, traj, bits, b, B, nkb, R, h);
  return static_cast<int>(err);
}

}  // extern "C"
