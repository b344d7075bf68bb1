// Train-mode batch norm over the channel (last) axis of a contiguous NHWC fp32
// tensor, forward and backward, written by hand for Hopper (sm_90a), with the
// op that follows it in the model (relu, or a residual add and relu) taken
// into its passes.
//
// Replaces no TPU kernel: the JAX package leaves batch norm to XLA.  It was
// added because the composite of torch ops it replaces (torch.var_mean,
// rsqrt, four broadcast passes, six small ops for the running statistics,
// and autograd's backward through all of them, about 25 device operations a
// layer) took about 40% of ResNet-50's train step at 224x224 on an H100.
//
// For x of M rows and C channels, scale and offset (C):
//
//   forward   mean, var: each channel's mean and biased variance over the rows
//             y = ((x - mean) * inv) * scale + offset,  inv = rsqrt(var + eps)
//             out = y, relu(y) or relu(y + residual): the epilogue
//             running statistics: keep * old + take * batch (keep = 0.99)
//   backward  g = dout, masked to 0 where the recomputed y <= 0 for relu
//             doffset = sum g,  dscale = sum g * xhat,  xhat = (x - mean) * inv
//             dx = scale * inv * (g - doffset / M - xhat * dscale / M)
//
// The forward is the composite's bit for bit.  Its mean and var are
// torch.var_mean's, taken by the wrapper (one reduction launch); this file's
// apply computes inv, y and the running statistics in the composite's order,
// each step rounded in fp32 as torch's ops round it.  A first design summed
// the statistics here in fp64: on ResNet-50 the last-bit differences from
// torch's fp32 Welford sums flip relu and max-pool masks, and the flips
// moved the first step's gradients 4e-3 to 7e-3 from the composite's (PERF.md,
// PR 22).  The backward is this file's: its sums change no mask.
//
// The epilogue, chosen by the caller for the op that follows the batch norm
// (the wrapper's "none", "relu", "add_relu"), gives the bits of the torch ops
// it replaces: the add is __fadd_rn(y, residual), the relu is torch.relu's
// (at::clamp_min's CUDA kernel: a NaN as it came, else fmaxf(v, 0), which
// fixes the sign of a zero as torch's does).  For relu the backward's two
// passes recompute y from the x they already read, with the forward's own
// device function, and zero g where y <= 0: threshold_backward's rule on
// relu's output (relu(y) <= 0 exactly where y <= 0; a NaN passes g).  So
// both backward passes see the gradient torch's threshold_backward would
// have given them, and dx, dscale and doffset are bit for bit what these
// kernels give on that gradient.  For add_relu the wrapper masks g once
// with threshold_backward (that mask is the residual's gradient too) and
// runs the plain backward on it.
//
// What bounds it on an H100: bytes.  It does about one FLOP a byte.  The
// least traffic of these kernels is seven passes over x's size: the apply
// reads x and writes out; the backward's sums read dout and x, its apply
// reads dout and x and writes dx; an add_relu layer's apply reads its
// residual too.  torch.var_mean reads x once more.  Over ResNet-50's 53
// batch norms at batch 32 (1.355 GB a pass; the 16 add_relu layers hold
// 0.706 GB) that is 10.19 GB, 3.04 ms a step at 3.35 TB/s, and 0.40 ms
// more for the statistics.  The epilogues take the passes of the torch ops
// they replace: a relu's read and write, an add's two reads and write, and
// threshold_backward's two reads and write for each relu layer.
//
// What the design does about that bound:
//   - One apply launch forward (after torch's reduction) and three backward:
//     the sums, a finalize of C threads, the apply.  Each pass reads and
//     writes each element once.  The epilogue is a template argument, so a
//     layer without one runs the code it ran before.
//   - 16-byte loads along C, which is innermost: four channels a thread where
//     C % 4 == 0 and the tensors are 16-byte aligned (the wrapper's
//     `bn_plan`), else one.
//   - A grid of row chunks x channel groups, about four blocks of 256 threads
//     an SM at every ResNet-50 shape: a thread holds fixed channels, so the
//     apply passes load their per-channel factors once, and strides over its
//     chunk's rows with four rows' loads in flight (two in relu's sums, which
//     hold the forward's factors too: no kernel spills a register).
//   - The backward's two sums (g, and g times x - mean) in fp64, so dscale
//     and doffset are within a rounding of exact; fp64 adds cost nothing
//     here: an SM needs about 4 floats a cycle to keep up with HBM, far under
//     its fp64 rate.
//   - Deterministic: each block adds its row lanes' partials in a fixed order
//     and writes one partial a channel; the finalize adds the chunks' partials
//     in a fixed order.  No atomics, so two replays give the same bits.
//   - Left out: one persistent cooperative launch with a grid-wide barrier,
//     which would keep dout and x in L2 between the sums and the apply.  Where
//     they fit the 50 MB L2 the apply's reads find them there without one,
//     and where they do not fit a barrier would not keep them.  It would save
//     one launch for a second plan that holds every block resident.  Also
//     left out: add_relu's mask inside these kernels, which would need the
//     forward's output as one more input of both passes and would save at
//     most one pass of the threshold_backward left in the wrapper.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows' loads in flight a thread

// What the apply writes (the wrapper's "none", "relu", "add_relu"): y,
// relu(y) or relu(y + residual).  The backward takes kNone or kRelu.
enum Epilogue : int { kNone = 0, kRelu = 1, kAddRelu = 2 };

// How a launch covers an (M, C) tensor: blockIdx.y picks a group of lanes * V
// channels, blockIdx.x a chunk of `chunk` rows.  Thread t takes the V channels
// of lane t % lanes in the rows first + t / lanes, stepping by kThreads / lanes.
struct Grid {
  int M, C, lanes, chunk;
};

template <int V>
struct Slot {  // a thread's channels c0 .. c0 + V - 1, rows first, first + step, .. < end
  int c0, first, end, step;

  __device__ explicit Slot(const Grid& g) {
    const int lane = threadIdx.x % g.lanes;
    step = kThreads / g.lanes;
    c0 = (blockIdx.y * g.lanes + lane) * V;
    const int begin = blockIdx.x * g.chunk;
    first = begin + static_cast<int>(threadIdx.x) / g.lanes;
    end = min(g.M, begin + g.chunk);
  }
};

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

__device__ __forceinline__ const float* at(const float* base, const Grid& g, int row, int c0) {
  return base + static_cast<size_t>(row) * g.C + c0;
}

__device__ __forceinline__ float* at(float* base, const Grid& g, int row, int c0) {
  return base + static_cast<size_t>(row) * g.C + c0;
}

// Each channel's (a, b) summed over the block's row lanes in a fixed order,
// written to out[c] (out: this chunk's C partials).
template <int V>
__device__ void block_sums(const double (&a)[V], const double (&b)[V], double2* __restrict__ out,
                           const Grid& g) {
  __shared__ double2 sums[kThreads * V];  // [row lane][lane * V + i]
#pragma unroll
  for (int i = 0; i < V; ++i) sums[threadIdx.x * V + i] = make_double2(a[i], b[i]);
  __syncthreads();
  const int width = g.lanes * V, rows = kThreads / g.lanes;
  const int j = threadIdx.x, c = blockIdx.y * width + j;
  if (j >= width || c >= g.C) return;
  double2 s = make_double2(0.0, 0.0);
  for (int r = 0; r < rows; ++r) {
    const double2 p = sums[r * width + j];
    s.x += p.x;
    s.y += p.y;
  }
  out[c] = s;
}

// y = ((x - mean) * inv) * scale + offset, each step rounded in fp32 as the
// composite's torch ops round it: the forward's value, and the backward's
// recomputation of it for relu's mask.
__device__ __forceinline__ float bn_value(float x, float mean, float inv, float scale,
                                          float offset) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), scale), offset);
}

// torch.relu's bits: at::clamp_min's CUDA kernel, a NaN as it came, else
// fmaxf(v, 0) (::max of two floats).
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// The gradient that reaches y: dout, or for kRelu 0 where y <= 0 (relu(y) <= 0
// there and only there: threshold_backward's rule on relu's output).
template <int E>
__device__ __forceinline__ float masked(float dout, float y) {
  if constexpr (E == kRelu) return y <= 0.0f ? 0.0f : dout;
  return dout;
}

// out = the epilogue of y = ((x - mean) * inv) * scale + offset, inv =
// rsqrt(var + eps), each step rounded in fp32 as the composite's torch ops
// round it (rsqrtf is what torch's rsqrt runs); residual is read for kAddRelu
// only.  The first row chunk's row lane 0 also writes stats (4, C): mean,
// inv, and the new running mean and variance, keep * old + take * batch.
template <int V, int E>
__global__ void __launch_bounds__(kThreads)
    fused_bn_apply(const float* __restrict__ x, const float* __restrict__ residual,
                   const float* __restrict__ mean, const float* __restrict__ var,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   const float* __restrict__ run_mean, const float* __restrict__ run_var,
                   float eps, float keep, float take, float* __restrict__ y,
                   float* __restrict__ stats, Grid g) {
  const Slot<V> t(g);
  if (t.c0 >= g.C) return;
  float m[V], inv[V], sc[V], of[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t.c0 + i;
    m[i] = mean[c];
    inv[i] = rsqrtf(__fadd_rn(var[c], eps));
    sc[i] = scale[c];
    of[i] = offset[c];
    if (blockIdx.x == 0 && threadIdx.x < g.lanes) {
      stats[c] = m[i];
      stats[g.C + c] = inv[i];
      stats[2 * g.C + c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(take, m[i]));
      stats[3 * g.C + c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(take, var[c]));
    }
  }
  auto apply = [&](float (&v)[V], const float (&res)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float o = bn_value(v[i], m[i], inv[i], sc[i], of[i]);
      if constexpr (E == kAddRelu) o = __fadd_rn(o, res[i]);
      if constexpr (E != kNone) o = relu(o);
      v[i] = o;
    }
  };
  int r = t.first;
  for (; r + (kUnroll - 1) * t.step < t.end; r += kUnroll * t.step) {
    float v[kUnroll][V], res[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<V>(at(x, g, r + u * t.step, t.c0), v[u]);
      if constexpr (E == kAddRelu) load<V>(at(residual, g, r + u * t.step, t.c0), res[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply(v[u], res[u]);
      store<V>(at(y, g, r + u * t.step, t.c0), v[u]);
    }
  }
  for (; r < t.end; r += t.step) {
    float v[V], res[V];
    load<V>(at(x, g, r, t.c0), v);
    if constexpr (E == kAddRelu) load<V>(at(residual, g, r, t.c0), res);
    apply(v, res);
    store<V>(at(y, g, r, t.c0), v);
  }
}

// The per-channel factors that recompute y for relu's mask: a thread's mean,
// inv, scale and offset (loaded for kRelu only).
template <int V, int E>
struct Refold {
  float m[V], inv[V], sc[V], of[V];

  __device__ Refold(const float* __restrict__ stats, const float* __restrict__ scale,
                    const float* __restrict__ offset, int C, int c0) {
    if constexpr (E == kRelu) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        m[i] = stats[c0 + i];
        inv[i] = stats[C + c0 + i];
        sc[i] = scale[c0 + i];
        of[i] = offset[c0 + i];
      }
    }
  }

  // dout's values as the gradient that reaches y, from x's.
  __device__ __forceinline__ void mask(float (&dv)[V], const float (&xv)[V]) const {
    if constexpr (E == kRelu) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dv[i] = masked<E>(dv[i], bn_value(xv[i], m[i], inv[i], sc[i], of[i]));
      }
    }
  }
};

// partial[chunk][c] = (sum g, sum g * (x - mean)) over the chunk's rows, g the
// gradient that reaches y (`masked`).
template <int V, int E>
__global__ void __launch_bounds__(kThreads)
    fused_bn_grad_stats(const float* __restrict__ dy, const float* __restrict__ x,
                        const float* __restrict__ stats, const float* __restrict__ scale,
                        const float* __restrict__ offset, double2* __restrict__ partial, Grid g) {
  // Rows' loads in flight: relu's mask holds four more registers a channel, and
  // at four rows the sums took 70 registers (three blocks an SM, a tail wave)
  // or, held to 64, spilled; at two they run as fast as the plain sums.
  constexpr int kRows = E == kRelu ? 2 : kUnroll;
  const Slot<V> t(g);
  double s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.0;
  if (t.c0 < g.C) {
    double m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = stats[t.c0 + i];
    const Refold<V, E> fold(stats, scale, offset, g.C, t.c0);
    int r = t.first;
    for (; r + (kRows - 1) * t.step < t.end; r += kRows * t.step) {
      float gv[kRows][V], xv[kRows][V];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        load<V>(at(dy, g, r + u * t.step, t.c0), gv[u]);
        load<V>(at(x, g, r + u * t.step, t.c0), xv[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        fold.mask(gv[u], xv[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += gv[u][i];
          s2[i] = fma(static_cast<double>(gv[u][i]), xv[u][i] - m[i], s2[i]);
        }
      }
    }
    for (; r < t.end; r += t.step) {
      float gv[V], xv[V];
      load<V>(at(dy, g, r, t.c0), gv);
      load<V>(at(x, g, r, t.c0), xv);
      fold.mask(gv, xv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += gv[i];
        s2[i] = fma(static_cast<double>(gv[i]), xv[i] - m[i], s2[i]);
      }
    }
  }
  block_sums<V>(s1, s2, partial + static_cast<size_t>(blockIdx.x) * g.C, g);
}

// Each of the block's 32 channels (lane) summed over the chunks' partials: warp
// w takes chunks w, w + 8, ..., then warp 0 adds the warps' sums in order.
// Returns false on the threads that hold no total.
__device__ bool total(const double2* __restrict__ partial, int chunks, int C, double2& s) {
  __shared__ double2 warps[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  s = make_double2(0.0, 0.0);
  if (c < C) {
    for (int i = warp; i < chunks; i += kWarps) {
      const double2 p = partial[static_cast<size_t>(i) * C + c];
      s.x += p.x;
      s.y += p.y;
    }
  }
  warps[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= C) return false;
  for (int w = 1; w < kWarps; ++w) {
    s.x += warps[w][lane].x;
    s.y += warps[w][lane].y;
  }
  return true;
}

// dscale, doffset (C) and factors (3, C): dx's a, b, d (dx = a dy + b (x - mean) + d).
__global__ void __launch_bounds__(kThreads)
    fused_bn_grad_finalize(const double2* __restrict__ partial, int chunks, int M, int C,
                           const float* __restrict__ stats, const float* __restrict__ scale,
                           float* __restrict__ dscale, float* __restrict__ doffset,
                           float* __restrict__ factors) {
  double2 s;
  if (!total(partial, chunks, C, s)) return;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const double inv = stats[C + c];
  const double dxhat = inv * s.y;  // sum dy * xhat
  const double a = static_cast<double>(scale[c]) * inv;
  dscale[c] = static_cast<float>(dxhat);
  doffset[c] = static_cast<float>(s.x);
  factors[c] = static_cast<float>(a);
  factors[C + c] = static_cast<float>(-a * inv * dxhat / M);
  factors[2 * C + c] = static_cast<float>(-a * s.x / M);
}

// dx = a g + (b (x - mean) + d), g the gradient that reaches y (`masked`).
template <int V, int E>
__global__ void __launch_bounds__(kThreads)
    fused_bn_grad_apply(const float* __restrict__ dy, const float* __restrict__ x,
                        const float* __restrict__ stats, const float* __restrict__ scale,
                        const float* __restrict__ offset, const float* __restrict__ factors,
                        float* __restrict__ dx, Grid g) {
  const Slot<V> t(g);
  if (t.c0 >= g.C) return;
  float m[V], a[V], b[V], d[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = stats[t.c0 + i];
    a[i] = factors[t.c0 + i];
    b[i] = factors[g.C + t.c0 + i];
    d[i] = factors[2 * g.C + t.c0 + i];
  }
  const Refold<V, E> fold(stats, scale, offset, g.C, t.c0);
  auto apply = [&](float (&gv)[V], float (&xv)[V]) {
    fold.mask(gv, xv);
#pragma unroll
    for (int i = 0; i < V; ++i)
      xv[i] = __fmaf_rn(a[i], gv[i], __fmaf_rn(b[i], __fsub_rn(xv[i], m[i]), d[i]));
  };
  int r = t.first;
  for (; r + (kUnroll - 1) * t.step < t.end; r += kUnroll * t.step) {
    float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<V>(at(dy, g, r + u * t.step, t.c0), gv[u]);
      load<V>(at(x, g, r + u * t.step, t.c0), xv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply(gv[u], xv[u]);
      store<V>(at(dx, g, r + u * t.step, t.c0), xv[u]);
    }
  }
  for (; r < t.end; r += t.step) {
    float gv[V], xv[V];
    load<V>(at(dy, g, r, t.c0), gv);
    load<V>(at(x, g, r, t.c0), xv);
    apply(gv, xv);
    store<V>(at(dx, g, r, t.c0), xv);
  }
}

// The launch's shape, or false where the plan is not one these kernels take:
// vec 1 or 4 dividing C, lanes a power of two up to 32, chunks of `chunk` rows
// covering M.
bool plan(int M, int C, int vec, int lanes, int chunks, int chunk, Grid& g, dim3& grid) {
  if (M < 1 || C < 1 || (vec != 1 && vec != 4) || C % vec != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || chunks < 1 || chunk < 1 ||
      static_cast<long long>(chunks) * chunk < M) {
    return false;
  }
  g = Grid{M, C, lanes, chunk};
  grid = dim3(chunks, (C + lanes * vec - 1) / (lanes * vec));
  return true;
}

int launched(int launches) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launches : -static_cast<int>(err);
}

// The forward's apply with epilogue E, at the plan's vector width.
template <int E>
int apply_fwd(int vec, dim3 grid, cudaStream_t s, const float* x, const float* residual,
              const float* mean, const float* var, const float* scale, const float* offset,
              const float* run_mean, const float* run_var, float eps, float keep, float take,
              float* y, float* stats, const Grid& g) {
  if (vec == 4) {
    fused_bn_apply<4, E><<<grid, kThreads, 0, s>>>(x, residual, mean, var, scale, offset,
                                                   run_mean, run_var, eps, keep, take, y, stats, g);
  } else {
    fused_bn_apply<1, E><<<grid, kThreads, 0, s>>>(x, residual, mean, var, scale, offset,
                                                   run_mean, run_var, eps, keep, take, y, stats, g);
  }
  return launched(1);
}

// The backward's three launches with epilogue E (kNone or kRelu).
template <int E>
int apply_bwd(int vec, dim3 grid, cudaStream_t s, const float* dy, const float* x,
              const float* stats, const float* scale, const float* offset, float* dx,
              float* dscale, float* doffset, float* factors, double2* sums, int M, int C,
              int chunks, const Grid& g) {
  if (vec == 4) {
    fused_bn_grad_stats<4, E><<<grid, kThreads, 0, s>>>(dy, x, stats, scale, offset, sums, g);
  } else {
    fused_bn_grad_stats<1, E><<<grid, kThreads, 0, s>>>(dy, x, stats, scale, offset, sums, g);
  }
  int err = launched(1);
  if (err < 0) return err;
  fused_bn_grad_finalize<<<(C + 31) / 32, kThreads, 0, s>>>(sums, chunks, M, C, stats, scale,
                                                            dscale, doffset, factors);
  if ((err = launched(2)) < 0) return err;
  if (vec == 4) {
    fused_bn_grad_apply<4, E><<<grid, kThreads, 0, s>>>(dy, x, stats, scale, offset, factors, dx,
                                                        g);
  } else {
    fused_bn_grad_apply<1, E><<<grid, kThreads, 0, s>>>(dy, x, stats, scale, offset, factors, dx,
                                                        g);
  }
  return launched(3);
}

}  // namespace

extern "C" {

const char* deqres_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward's apply on `stream`: returns the launches made (1), or minus the
// CUDA error.  Device pointers to contiguous fp32 tensors: x and y (M, C);
// residual (M, C), read for epilogue 2 only (may be null otherwise); mean and
// var (C), the batch's (torch.var_mean's); scale, offset, run_mean, run_var
// (C); stats (4, C) out: mean, inv, the new running mean and variance.  vec,
// lanes, chunks, chunk: the wrapper's `bn_plan` (x, residual and y 16-byte
// aligned at vec 4).  epilogue: 0 none, 1 relu, 2 add_relu (`Epilogue`).
int deqres_bn_fwd(const float* x, const float* residual, const float* mean, const float* var,
                  const float* scale, const float* offset, const float* run_mean,
                  const float* run_var, float* y, float* stats, int M, int C, int vec, int lanes,
                  int chunks, int chunk, int epilogue, float eps, float keep, float take,
                  void* stream) {
  Grid g;
  dim3 grid;
  if (!plan(M, C, vec, lanes, chunks, chunk, g, grid) ||
      (epilogue == kAddRelu && residual == nullptr)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kNone:
      return apply_fwd<kNone>(vec, grid, s, x, residual, mean, var, scale, offset, run_mean,
                              run_var, eps, keep, take, y, stats, g);
    case kRelu:
      return apply_fwd<kRelu>(vec, grid, s, x, residual, mean, var, scale, offset, run_mean,
                              run_var, eps, keep, take, y, stats, g);
    case kAddRelu:
      return apply_fwd<kAddRelu>(vec, grid, s, x, residual, mean, var, scale, offset, run_mean,
                                 run_var, eps, keep, take, y, stats, g);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward on `stream`: returns the launches made (3), or minus the CUDA
// error.  dy, x and dx (M, C); stats (4, C) the forward's; scale and offset
// (C), offset read for epilogue 1 only; dscale and doffset (C) out; factors
// (3, C) scratch: dx's per-channel factors; partial (chunks, C) double2
// scratch.  The plan as for the forward (dy, x, dx 16-byte aligned at vec
// 4).  epilogue: 0 none, 1 relu (dy masked where the recomputed y <= 0).
int deqres_bn_bwd(const float* dy, const float* x, const float* stats, const float* scale,
                  const float* offset, float* dx, float* dscale, float* doffset, float* factors,
                  void* partial, int M, int C, int vec, int lanes, int chunks, int chunk,
                  int epilogue, void* stream) {
  Grid g;
  dim3 grid;
  if (!plan(M, C, vec, lanes, chunks, chunk, g, grid) ||
      (epilogue == kRelu && offset == nullptr)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sums = static_cast<double2*>(partial);
  switch (epilogue) {
    case kNone:
      return apply_bwd<kNone>(vec, grid, s, dy, x, stats, scale, offset, dx, dscale, doffset,
                              factors, sums, M, C, chunks, g);
    case kRelu:
      return apply_bwd<kRelu>(vec, grid, s, dy, x, stats, scale, offset, dx, dscale, doffset,
                              factors, sums, M, C, chunks, g);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
