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
// walking l = L-1 .. 0; gx is the final g.  dK and db leave as partials, one
// row a band: (B*n, L, 9*Cp*Cp + Cp), which the wrapper sums in a fixed
// order.  No float atomics: the sums are deterministic.  K^T is arranged by the wrapper, as the Pallas
// wrapper does (:302-306).
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
// What the design does about that bound: B1's banded design (one image is n
// blocks, each a band of rows, trading edge rows through device memory; see
// fused_euler_fwd.cu and euler_common.cuh) and B1's layer step, in two
// phases.  clock64() phase timings of the previous design at 32x32x16, batch
// 32, found the reverse sweep's layer spending 38% of its cycles in dK (a
// quarter of the threads idle), 20% at the cluster barrier waiting for it,
// 19% in the K^T conv, 11% in 128 threads issuing cp.async copies and 10%
// forming g_z.
//   1. Forward recompute: B1's layer step (layer_items, the same arithmetic,
//      so the relu mask bits are those of the forward that B1 serves).  Each
//      pre-step band y_l goes to a global trajectory scratch (L, B, H, RS),
//      the padded rows as shared memory holds them, by one bulk store a layer
//      (one SM cannot hold 64 states, as the Pallas kernel holds them in
//      VMEM); each work item's relu mask 1[z_l > 0] (4 / split pixels x 4
//      outputs) goes to a 16-bit word of a global scratch (L, B*n, items a
//      band), which the same thread reads back in reverse.
//   2. Reverse sweep, in two roles of warps that meet at no block barrier
//      inside a layer.  The conv warps (B1's tile mapping; `choose_roles`)
//      take K_l^T by bulk copy a layer ahead where two buffers fit; warp 0
//      copies the neighbours' g_z edge rows into the halo rows, a barrier of
//      the conv warps ends the copy, then each conv thread runs its work
//      items of the K^T conv, whose epilogue adds into g (the band's pixels,
//      in shared memory) and at once forms the next layer's g_z = h * mask
//      * g, its edge rows also to the edge buffer.  The dK warps take y_l
//      (band and halo rows, from the trajectory) by bulk copy a layer ahead
//      where two buffers fit and run the dK work items on g_z's own rows.
//      g_z sits in two buffers by layer parity.  The roles hand the buffers
//      over on named barriers, one a buffer each way: "g_z of layer l is
//      written" (conv to dK) and "dK of layer l is done" (dK to conv, which
//      then overwrites that buffer with g_z of layer l - 2).  So dK of layer
//      l runs beside the conv of layer l and may lag it by one layer: the
//      conv chain, layer to layer, no longer waits for dK.
//      clock64() counters at 32x32x16, batch 32 (PERF.md): the previous
//      sweep (dK, then a block barrier, then the conv) took 25564 cycles a
//      reverse layer, 12611 of them dK; this one about 21200, the dK warps
//      busy nearly all of it.
//   dK pass: a work item is (tap row, 4 inputs, 4 outputs, a chunk of rows);
//   it walks each of its rows 4 pixels at a time, reading their 6 window
//   columns of y and 4 of g_z (10 float4 reads for 192 FMAs); the row chunks
//   of an item sit in adjacent lanes and are summed with warp shuffles, and
//   the items spread evenly over the dK warps (so over the schedulers).

#include "euler_common.cuh"

using namespace deqres;

namespace {

// mbarriers ahead of the buffers: the forward's two kernel buffers, the
// reverse sweep's two y_l buffers and two K^T buffers.
constexpr int kHeaderFloats = 12;
constexpr int kKBar = 0, kYBar = 2, kTBar = 4;

// The reverse sweep's named barriers (0 is the block's): the conv warps',
// the dK warps', then "g_z of layer l is written" and "dK of layer l is
// done", one of each a g_z buffer (layer l's is l & 1).
constexpr int kConvBar = 1, kDkBar = 2, kReadyBar = 3, kFreeBar = 5;

// Named barrier `id` over `threads` threads (whole warps, warp-uniform
// calls): bar_sync waits for all of them, bar_arrive counts the calling
// warp in without waiting.  The shared-memory writes before either are
// visible to the threads past the bar_sync.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// How the shared memory is shared out: forward kernel buffers (nkb), and in
// the reverse sweep y_l buffers (ny) and K^T buffers (nk).
struct Layout {
  int nkb, ny, nk;
};

long long forward_floats(const Band& b, const Layout& s) {
  return kHeaderFloats + 2 * band_floats(b) + s.nkb * layer_floats(b);
}

// y_l, g_z twice, g of the band's pixels, K^T.
long long reverse_floats(const Band& b, const Layout& s) {
  return kHeaderFloats + (s.ny + 2) * band_floats(b) +
         static_cast<long long>(b.Rmax) * b.W * b.Cp + s.nk * 9LL * b.Cp * b.Cp;
}

long long smem_floats(const Band& b, const Layout& s) {
  const long long f = forward_floats(b, s), r = reverse_floats(b, s);
  return f > r ? f : r;
}

// The first layout that fits, in order of preference; nkb = 0 where none
// does.
Layout choose_layout(const Band& b) {
  const int options[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};
  for (const auto& o : options) {
    for (int nkb = 2; nkb >= 1; --nkb) {
      const Layout s{nkb, o[0], o[1]};
      if (4 * smem_floats(b, s) <= kMaxSmemBytes) return s;
    }
  }
  return Layout{0, 0, 0};
}

// The reverse sweep's roles: conv threads (the first of the block), dK
// threads (the rest) and the row chunks R of a dK work item.
struct Roles {
  int conv, dk, R;
};

// dK threads that the row chunks fill at most: one warp a scheduler.
constexpr int kDkThreads = 128;

// The conv warps are a block of B1's (`band_threads`: one thread a work
// item) where that leaves room for one dK item of each (tap row, input
// group, output group), or up to 256 threads; else at most 256 threads
// (half of kMaxThreads, as the two roles do the same FMAs), the work items
// in even rounds.  R is a power of two <= 32 (one warp) and <= the tallest
// band whose items fill at most one warp a scheduler (kDkThreads) and the
// room beside the conv warps, and the dK warps as many as those items fill,
// at most the room.  At 32x32x16 in 4 bands two dK warps on one scheduler
// beside its two conv warps held the layer back: B2 took 1.156 ms with six
// dK warps (R = 4) and 1.117-1.121 ms with three (R = 2; PERF.md).
Roles choose_roles(const Band& b) {
  const auto whole_warps = [](int n) { return (n + 31) / 32 * 32; };
  const int half = kMaxThreads / 2;
  const int items = b.Rmax * row_items(b), groups = 3 * (b.Cp / 4) * (b.Cp / 4);
  Roles r{band_threads(b), 0, 1};
  const int reserve = whole_warps(groups) < half ? whole_warps(groups) : half;
  if (r.conv + reserve > kMaxThreads) {
    const int rounds = (items + half - 1) / half;
    r.conv = whole_warps((items + rounds - 1) / rounds);
  }
  const int room = kMaxThreads - r.conv, fill = room < kDkThreads ? room : kDkThreads;
  while (r.R < 32 && 2 * r.R <= b.Rmax && whole_warps(groups * 2 * r.R) <= fill) r.R *= 2;
  r.dk = whole_warps(groups * r.R) < room ? whole_warps(groups * r.R) : room;
  return r;
}

// The dK sums of one work item over its chunk of rows (r = chunk, chunk +
// R, ...): acc[dq][i][j] += y[row r+dr, col q+dq, input ci+i] * g_z[row r,
// col q, output co+j] over the row's pixels q, and ds[j] += g_z (db, which
// only the items of tap row 0 and inputs 0-3 keep: summed by every item,
// since a branch would split the warp that holds both kinds).
template <int CP>
__device__ __forceinline__ void dk_rows(const Band& b, int rows, int R, int chunk, int dr, int ci,
                                        int co, const float* Y, const float* Gz,
                                        float (&acc)[3][4][4], float (&ds)[4]) {
  const int Cp = CP ? CP : b.Cp;
#pragma unroll 1
  for (int r = chunk; r < rows; r += R) {
    const float* yr = Y + (r + dr) * b.RS + ci;       // padded rows r .. r+2
    const float* gr = Gz + (r + 1) * b.RS + co;       // own row r
    // Whole groups of 4 pixels: their 6 window columns and 4 g_z reads
    // sit at fixed offsets from the group's first column, and the
    // window needs no register moves.
#pragma unroll 1
    for (int q0 = 0; q0 + 4 <= b.W; q0 += 4) {
      const int c0 = col_off(q0, Cp);
      float4 w[6], gz[4];
#pragma unroll
      for (int j = 0; j < 6; ++j) w[j] = ld4(yr + c0 + j * Cp + (j >= 4 ? 4 : 0));
#pragma unroll
      for (int k = 0; k < 4; ++k) gz[k] = ld4(gr + c0 + (k + 1) * Cp + (k == 3 ? 4 : 0));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ds[0] += gz[k].x;
        ds[1] += gz[k].y;
        ds[2] += gz[k].z;
        ds[3] += gz[k].w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int dq = 0; dq < 3; ++dq) {
            const float a = lane(w[k + dq], i);
            acc[dq][i][0] = fmaf(a, gz[k].x, acc[dq][i][0]);
            acc[dq][i][1] = fmaf(a, gz[k].y, acc[dq][i][1]);
            acc[dq][i][2] = fmaf(a, gz[k].z, acc[dq][i][2]);
            acc[dq][i][3] = fmaf(a, gz[k].w, acc[dq][i][3]);
          }
        }
      }
    }
    // The last W % 4 pixels one at a time.
#pragma unroll 1
    for (int q = b.W / 4 * 4; q < b.W; ++q) {
      const float4 gz = ld4(gr + col_off(q + 1, Cp));
      const float4 w[3] = {ld4(yr + col_off(q, Cp)), ld4(yr + col_off(q + 1, Cp)),
                           ld4(yr + col_off(q + 2, Cp))};
      ds[0] += gz.x;
      ds[1] += gz.y;
      ds[2] += gz.z;
      ds[3] += gz.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int dq = 0; dq < 3; ++dq) {
          const float a = lane(w[dq], i);
          acc[dq][i][0] = fmaf(a, gz.x, acc[dq][i][0]);
          acc[dq][i][1] = fmaf(a, gz.y, acc[dq][i][1]);
          acc[dq][i][2] = fmaf(a, gz.z, acc[dq][i][2]);
          acc[dq][i][3] = fmaf(a, gz.w, acc[dq][i][3]);
        }
      }
    }
  }
}

// dK_l and db_l of the band from the padded y_l (halo rows included) and g_z
// (own rows) in shared memory, into out: (9, Cp, Cp) then (Cp), in shared
// memory or device memory.  Items are (tap row, input group, output group,
// row chunk), R (a power of two <= 32) chunks an item in adjacent lanes; the
// items spread evenly over the warps of `threads` threads (whole warps), of
// which the caller is thread `tid`.  Every one of them calls this (the
// shuffles need full warps).
template <int CP>
__device__ __forceinline__ void weight_grads(const Band& b, int rows, int R, const float* Y,
                                             const float* Gz, float* out, int tid, int threads) {
  const int Cp = CP ? CP : b.Cp, ncog = Cp / 4, per_dr = ncog * ncog;
  const int items = 3 * per_dr * R;
  const int nwarps = threads / 32, warp = tid / 32, ln = tid % 32;
  int per_warp = ((items + nwarps - 1) / nwarps + R - 1) / R * R;
  if (per_warp > 32) per_warp = 32;
  for (int round = 0; round < items; round += nwarps * per_warp) {
    const int item = round + warp * per_warp + ln;
    const bool active = ln < per_warp && item < items;
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
    if (active) dk_rows<CP>(b, rows, R, chunk, dr, ci, co, Y, Gz, acc, ds);
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
          st4(out + ((dr * 3 + dq) * Cp + ci + i) * Cp + co,
              make_float4(acc[dq][i][0], acc[dq][i][1], acc[dq][i][2], acc[dq][i][3]));
        }
      }
      if (dr == 0 && ci == 0) st4(out + 9 * Cp * Cp + co, make_float4(ds[0], ds[1], ds[2], ds[3]));
    }
  }
}

// g_z = h * mask * g for one half-tile's pixel q (band row r) and outputs
// co .. co+3 into the padded buffer Gz, the band's edge rows also into its
// edge rows `first` and `last`.
__device__ __forceinline__ void store_gz(const Band& b, int rows, const HalfTile& t, int q,
                                         int kk, float4 g, unsigned bits, float h, float* Gz,
                                         float* first, float* last) {
  const unsigned w = bits >> (4 * kk);
  const float4 v = make_float4(w & 1u ? h * g.x : 0.f, w & 2u ? h * g.y : 0.f,
                               w & 4u ? h * g.z : 0.f, w & 8u ? h * g.w : 0.f);
  const int o = col_off(q + 1, b.Cp) + t.co;
  st4(Gz + (t.r + 1) * b.RS + o, v);
  if (t.r == 0 && first) st4(first + o, v);
  if (t.r == rows - 1 && last) st4(last + o, v);
}

// Block b of the grid is band b % n of image b / n of this launch; x, g_in,
// gx, gk and mask start at this launch's first image, traj at its first
// image of layer 0 (layer stride B*H*RS, B the whole batch's), mask at its
// first band of layer 0 (layer stride Bn bands).
template <bool BF16, int CP, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    euler_bwd(const float* __restrict__ x, const float* __restrict__ K,
              const float* __restrict__ bias, const float* __restrict__ KT,
              const float* __restrict__ g_in, float* __restrict__ gx, float* __restrict__ gk,
              float* __restrict__ traj, unsigned short* __restrict__ mask, Edges e, Band b,
              int B, int Bn, Layout lay, Roles roles, float h) {
  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;
  const int start = band_start(b, rank), rows = band_rows(b, rank);
  const int Cp = CP ? CP : b.Cp, W = b.W, L = b.L;
  const size_t img = static_cast<size_t>(image) * b.H * W * b.C;
  // Layer l's trajectory rows and this block's mask bytes.
  auto traj_rows = [&](int l, int row) {
    return traj + ((static_cast<size_t>(l) * B + image) * b.H + row) * b.RS;
  };
  const int mstride = b.Rmax * row_items(b);
  auto mask_words = [&](int l) {
    return mask + (static_cast<size_t>(l) * Bn + blockIdx.x) * mstride;
  };
  extern __shared__ float4 smem4[];
  auto* bars = reinterpret_cast<unsigned long long*>(smem4);
  float* smem = reinterpret_cast<float*>(smem4) + kHeaderFloats;
  const int band = static_cast<int>(band_floats(b));
  const int layer = static_cast<int>(layer_floats(b)), kt_floats = 9 * Cp * Cp;
  const bool issuer = threadIdx.x == 0;
  const int items = rows * row_items(b);
  unsigned phases = 0;

  // 1. Forward recompute (steps 0 .. L-1), recording y_l and the relu mask
  // of z_l.
  {
    float* state = smem;  // two band buffers
    float* kbuf = smem + 2 * band;
    if (issuer) {
      for (int i = 0; i < 6; ++i) mbar_init(bars + i);
      mbar_fence_init();
    }
    zero_fill(state, 2 * band);
    __syncthreads();
    load_band(x + img, b, start, rows, state);
    fence_proxy_shared();  // y_0 is read by the first bulk store
    if (issuer) issue_layer(K, bias, b, 0, kbuf, bars + kKBar);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int slot = lay.nkb == 2 ? (l & 1) : 0;
      float* cur = state + (l & 1) * band;
      float* nxt = state + ((l + 1) & 1) * band;
      if (issuer) {
        if (lay.nkb == 2 && l + 1 < L) {
          issue_layer(K, bias, b, l + 1, kbuf + ((l + 1) & 1) * layer,
                      bars + kKBar + ((l + 1) & 1));
        }
        if (lay.nkb == 1 && l > 0) issue_layer(K, bias, b, l, kbuf, bars + kKBar);
      }
      mbar_wait(bars + kKBar + slot, phases, kKBar + slot);
      const float* Ks = kbuf + slot * layer;
      float* first = own_edge(e, b, l, 0);
      float* last = own_edge(e, b, l, 1);
      // y_l's own rows out to the trajectory (its halo rows are not needed).
      if (issuer) bulk_store(traj_rows(l, start), cur + b.RS, static_cast<unsigned>(rows) * b.RS * 4);
      if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);
      layer_items<BF16, CP, S, true>(b, rows, cur, nxt, first, last, Ks, h, mask_words(l));
      fence_proxy_shared();  // y_{l+1} is read by the next bulk store
      if (issuer) bulk_wait_read();  // y_l is read out before it is overwritten
      if (b.n > 1) {
        publish_step(e, blockIdx.x, l);
      } else {
        __syncthreads();
      }
    }
    if (issuer) {
      bulk_wait_all();
      fence_proxy_global();
    }
  }

  // 2. Reverse sweep.  The buffers reuse the forward's bytes.
  float* Y = smem;                  // y_l, ny buffers
  float* G = Y + lay.ny * band;     // g_z, two buffers by layer parity
  float* gs = G + 2 * band;         // g of the band's pixels, (rows, W, Cp)
  float* KTs = gs + static_cast<long long>(b.Rmax) * W * Cp;
  const int top = start > 0 ? start - 1 : 0;
  const int end = start + rows + 1 < b.H ? start + rows + 1 : b.H;  // rows top .. end-1
  auto issue_y = [&](int l) {
    const int s = lay.ny == 2 ? (l & 1) : 0;
    const unsigned bytes = static_cast<unsigned>(end - top) * b.RS * 4;
    mbar_expect(bars + kYBar + s, bytes);
    bulk_load(Y + s * band + (top - (start - 1)) * b.RS, traj_rows(l, top), bytes,
              bars + kYBar + s);
  };
  auto issue_kt = [&](int l) {
    const int s = lay.nk == 2 ? (l & 1) : 0;
    mbar_expect(bars + kTBar + s, 4u * kt_floats);
    bulk_load(KTs + s * kt_floats, KT + static_cast<size_t>(l) * kt_floats, 4u * kt_floats,
              bars + kTBar + s);
  };
  zero_fill(smem, (lay.ny + 2) * band);
  for (int i = threadIdx.x; i < rows * W * Cp; i += blockDim.x) {
    const int c = i % Cp, p = i / Cp;
    gs[i] = c < b.C ? g_in[img + (static_cast<size_t>(start) * W + p) * b.C + c] : 0.f;
  }
  fence_proxy_shared();  // the zeros are written before bulk copies land beside them
  // Step L's edge rows go where step L - 2's were: the neighbours have read
  // those once they publish step L - 1.
  if (b.n > 1) wait_neighbours(e, blockIdx.x, rank, b.n, L - 1);
  __syncthreads();
  // g_z of the last layer from the incoming cotangent (step L).
  {
    float* Gz = G + ((L - 1) & 1) * band;
    float* first = own_edge(e, b, L, 0);
    float* last = own_edge(e, b, L, 1);
    const unsigned short* mb = mask_words(L - 1);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const HalfTile t = half_tile<S>(b, it);
      const unsigned bits = mb[it];
#pragma unroll
      for (int kk = 0; kk < 4 / S; ++kk) {
        const int q = 4 * t.g + (4 / S) * t.s + kk;
        if (q >= W) break;
        store_gz(b, rows, t, q, kk, ld4(gs + (t.r * W + q) * Cp + t.co), bits, h, Gz, first,
                 last);
      }
    }
  }
  if (b.n > 1) {
    publish_step(e, blockIdx.x, L);
  } else {
    __syncthreads();
  }

  // Both roles, on the hand-off barriers: the conv of layer l arrives at
  // kReadyBar of g_z of layer l - 1 (l >= 1), which the dK warps wait for
  // before dK of layer l - 1 (g_z of layer L - 1 is the block's, above); dK
  // of layer m arrives at kFreeBar of its buffer where the conv of layer m
  // - 1 writes g_z of layer m - 2 there (m >= 2), and that conv waits for
  // it before its first store.  Each barrier is ahead of its waiters by
  // one arrival at most.
  const int both = roles.conv + roles.dk;
  if (static_cast<int>(threadIdx.x) < roles.conv) {
    // Conv warps: g += g_z * K^T over the band's pixels, and g_z of layer l
    // - 1 from it, once the neighbours' g_z edge rows are in the halo rows.
    if (issuer) issue_kt(L - 1);  // K^T is the wrapper's: nothing to wait for
    for (int l = L - 1; l >= 0; --l) {
      const int step = 2 * L - l;  // publishes g_z of layer l - 1
      const int ks = lay.nk == 2 ? (l & 1) : 0;
      float* Gz = G + (l & 1) * band;
      float* Gn = G + ((l + 1) & 1) * band;  // g_z of layer l - 1, held g_z of l + 1
      if (issuer) {
        if (lay.nk == 2 && l > 0) issue_kt(l - 1);
        if (lay.nk == 1 && l < L - 1) issue_kt(l);
      }
      // This thread's first mask byte of layer l - 1, read early.
      const unsigned short first_bits =
          l > 0 && static_cast<int>(threadIdx.x) < items ? mask_words(l - 1)[threadIdx.x] : 0;
      mbar_wait(bars + kTBar + ks, phases, kTBar + ks);
      const float* Kt = KTs + ks * kt_floats;
      float* first = own_edge(e, b, step, 0);
      float* last = own_edge(e, b, step, 1);
      if (b.n > 1) {
        copy_halos(e, b, image, rank, rows, step - 1, Gz);
        bar_sync(kConvBar, roles.conv);
      }
      for (int base = 0; base < items; base += roles.conv) {
        const int it = base + threadIdx.x;
        const bool active = it < items;
        const HalfTile t = half_tile<S>(b, active ? it : 0);
        float acc[4][4] = {};
        if (active) conv_half<BF16, CP, S>(Gz, b, t, Kt, acc);
        float d[4][4];
        combine_halves<S>(acc, t.s, d);
        if (base == 0 && l > 0 && l + 1 < L) bar_sync(kFreeBar + ((l + 1) & 1), both);
        if (!active) continue;
        const unsigned bits = l == 0 ? 0u : base == 0 ? first_bits : mask_words(l - 1)[it];
#pragma unroll
        for (int kk = 0; kk < 4 / S; ++kk) {
          const int q = 4 * t.g + (4 / S) * t.s + kk;
          if (q >= W) break;
          float* gp = gs + (t.r * W + q) * Cp + t.co;
          const float4 g = add4(ld4(gp), make_float4(d[kk][0], d[kk][1], d[kk][2], d[kk][3]));
          st4(gp, g);
          if (l > 0) store_gz(b, rows, t, q, kk, g, bits, h, Gn, first, last);
        }
      }
      if (l > 0) bar_arrive(kReadyBar + ((l - 1) & 1), both);
      // g_z of layer l - 1 is written and its edge rows are out; the reads
      // of g_z of layer l and K_l^T are done.
      bar_sync(kConvBar, roles.conv);
      if (issuer && l > 0 && b.n > 1) store_release(e.steps + blockIdx.x, step + 1u);
    }
  } else {
    // dK warps: dK_l and db_l from y_l and g_z of layer l.
    const int tid = threadIdx.x - roles.conv;
    const bool loader = tid == 0;
    if (loader) {
      // The neighbours' trajectories are complete once they publish step L.
      if (b.n > 1) neighbours_published(e, blockIdx.x, rank, b.n, L);
      fence_proxy_global();
      issue_y(L - 1);
    }
    for (int l = L - 1; l >= 0; --l) {
      const int ys = lay.ny == 2 ? (l & 1) : 0;
      if (loader && lay.ny == 2 && l > 0) issue_y(l - 1);
      if (l < L - 1) bar_sync(kReadyBar + (l & 1), both);
      mbar_wait(bars + kYBar + ys, phases, kYBar + ys);
      weight_grads<CP>(b, rows, roles.R, Y + ys * band, G + (l & 1) * band,
                       gk + (static_cast<size_t>(blockIdx.x) * L + l) * layer, tid, roles.dk);
      if (l >= 2) bar_arrive(kFreeBar + (l & 1), both);
      bar_sync(kDkBar, roles.dk);  // every read of y_l is done
      if (loader && lay.ny == 1 && l > 0) issue_y(l - 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * W * b.C; i += blockDim.x) {
    const int c = i % b.C, p = i / b.C;
    gx[img + (static_cast<size_t>(start) * W + p) * b.C + c] = gs[p * Cp + c];
  }
}

template <bool BF16, int S>
auto* bwd_kernel_split(int Cp) {
  return Cp == 16 ? &euler_bwd<BF16, 16, S> : Cp == 8 ? &euler_bwd<BF16, 8, S>
                                                      : &euler_bwd<BF16, 0, S>;
}

auto* bwd_kernel(const Band& b, bool bf16) {
  if (b.S == 1) return bf16 ? bwd_kernel_split<true, 1>(b.Cp) : bwd_kernel_split<false, 1>(b.Cp);
  return bf16 ? bwd_kernel_split<true, 2>(b.Cp) : bwd_kernel_split<false, 2>(b.Cp);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of an H x W x C image in n bands
// asks for, or -1 where it does not fit (or n is not a valid band count).
long long deqres_euler_bwd_smem(int H, int W, int C, int n) {
  if (!valid_band(H, W, C, n)) return -1;
  const Band b = make_band(H, W, C, 1, n);
  const Layout lay = choose_layout(b);
  return lay.nkb ? 4 * smem_floats(b, lay) : -1;
}

// The layout a block of this shape takes, as nkb + 4*ny + 16*nk, or -1
// where none fits.
int deqres_euler_bwd_layout(int H, int W, int C, int n) {
  if (!valid_band(H, W, C, n)) return -1;
  const Layout lay = choose_layout(make_band(H, W, C, 1, n));
  return lay.nkb ? lay.nkb + 4 * lay.ny + 16 * lay.nk : -1;
}

// The reverse sweep's roles in a block of this shape in n bands, each
// tile's inputs split in `split` parts: out[0] conv threads, out[1] dK
// threads, out[2] the dK items' row chunks.  0, or -1 on a bad shape.
int deqres_euler_bwd_roles(int H, int W, int C, int n, int split, int* out) {
  if (!valid_band(H, W, C, n) || split < 1 || split > 2) return -1;
  const Roles r = choose_roles(make_band(H, W, C, 1, n, split));
  out[0] = r.conv;
  out[1] = r.dk;
  out[2] = r.R;
  return 0;
}

// Images of this shape in n bands, each tile's inputs split in `split`
// parts, that run at once (every band of an image resident together), or a
// negative number on error.
int deqres_euler_bwd_resident_images(int H, int W, int C, int n, int split, int bf16) {
  const long long smem = deqres_euler_bwd_smem(H, W, C, n);
  if (smem < 0 || split < 1 || split > 2) return -1;
  const Band b = make_band(H, W, C, 1, n, split);
  const Roles r = choose_roles(b);
  return resident_images(bwd_kernel(b, bf16), n, r.conv + r.dk, static_cast<int>(smem));
}

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns the launches made (0 where B = 0), or
// minus the CUDA error.  All pointers are device pointers to contiguous
// tensors: x, g and gx (B, H, W, C); K and KT (L, 3, 3, Cp, Cp) and bias (L, Cp), zero-padded from C to Cp (C
// rounded up to a multiple of 4), K and KT rounded to bf16 values in bf16
// mode, all three 16-byte aligned; gk (B*n, L, 9*Cp*Cp + Cp), the bands' dK
// and db partials; scratch: traj (L, B, H, RS) floats and mask (L, B*n, Rmax
// * ceil(W/4) * Cp/4 * split) 16-bit words (RS: floats of a padded row, Rmax:
// rows of the tallest band, `make_band`), edges (2, B*n, 2, RS) floats and
// steps (B*n) 32-bit counters (zeroed here) for the bands' edge exchange.  split:
// threads a 4 x 4 tile, 1 or 2.  Where the card cannot hold every band of B
// images at once, the images go in several launches.
int deqres_euler_bwd(const float* x, const float* K, const float* bias, const float* KT,
                     const float* g, float* gx, float* gk, float* traj, void* mask, float* edges,
                     void* steps, int B, int H, int W, int C, int L, int n, int split, float h,
                     int bf16, void* stream) {
  const long long smem = deqres_euler_bwd_smem(H, W, C, n);
  if (smem < 0 || B < 0 || L < 1 || split < 1 || split > 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const Band b = make_band(H, W, C, L, n, split);
  const Layout lay = choose_layout(b);
  const Roles roles = choose_roles(b);
  const auto s = static_cast<cudaStream_t>(stream);
  auto kernel = bwd_kernel(b, bf16);
  if (n > 1) {
    const cudaError_t zeroed = cudaMemsetAsync(steps, 0, sizeof(unsigned) * B * n, s);
    if (zeroed != cudaSuccess) return -static_cast<int>(zeroed);
  }
  const size_t image = static_cast<size_t>(H) * W * C;
  const size_t partials = static_cast<size_t>(n) * L * layer_floats(b);
  const int mstride = b.Rmax * row_items(b);
  return launch_images(kernel, B, n, roles.conv + roles.dk, static_cast<int>(smem), s,
                       [&](const cudaLaunchConfig_t& config, int first, int count) {
    const Edges e{edges + 2LL * first * n * b.RS, static_cast<unsigned*>(steps) + first * n,
                  2LL * B * n * b.RS};
    return cudaLaunchKernelEx(
        &config, kernel, x + first * image, K, bias, KT, g + first * image, gx + first * image,
        gk + first * partials, traj + static_cast<size_t>(first) * H * b.RS,
        static_cast<unsigned short*>(mask) + static_cast<size_t>(first) * n * mstride, e, b, B,
        B * n, lay, roles, h);
  });
}

}  // extern "C"
