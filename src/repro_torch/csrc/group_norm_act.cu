// group_norm_act: the ReLU and residual add after a GroupNorm, and the
// backward of all three in one pass, for NCHW f32 activations:
//   y = GN(x) * s + b                 (a projection's norm)
//   y = relu(GN(x) * s + b)           (the stem, g1, g2)
//   y = relu(GN(x) * s + b + r)       (g3 with the block's shortcut)
// GN is F.group_norm's function (groups of C/G contiguous channels, the
// biased variance, eps 1e-5).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA
// (src/repro/models/resnet.py `_gn`).  It exists because ResNet-50's
// worker step ran the norm, the add, the ReLU and their backward as five
// to seven separate passes over ~1.4 GB of activations a 32-image step.
//
// The forward keeps the bits of F.group_norm + add + relu: the norm itself
// is PyTorch's (its statistics decide every later ReLU and max-pool, so a
// rounding elsewhere would flip some of them and move the gradient by far
// more than its own size); this file's forward kernel only folds the add
// and the ReLU into one pass, in place over the norm's output, with
// PyTorch's arithmetic (an f32 add, then a max with 0 that keeps NaN).
// The backward owes no bits to anyone and is this file's own:
//   dz = dy where y > 0 (0 elsewhere), or dy without the ReLU;
//   dr = dz; db[c] = sum dz; ds[c] = sum dz xhat, xhat = (x - mean) rstd;
//   dx = rstd (s dz - A - xhat B), A = sum_g s dz / M, B = sum_g s dz xhat
//   / M over the sample's group of M = H W C/G elements.
//
// Bound: device-memory bandwidth (a handful of flops per element).  The
// least bytes, each input read once and each output written once:
//   forward epilogue  4 B x (y, [r], y) = 8 or 12 B an element;
//   backward          4 B x (dy, [y], x, dx, [dr]) = 12, 16 or 20 B.
// The backward reads dy, y and x twice (once for the per-channel sums,
// once to apply them).  The apply kernel walks the samples from the last
// to the first, the reverse of the sums kernel, so it starts on the rows
// that kernel read last, which L2 (50 MB) still holds.  Loads are 16
// bytes where a channel's H W is a multiple of 4.
//
// Kernels:
//   gn_act_epilogue_kernel  y = relu(y [+ r]) (or y + r) in place;
//   gn_bwd_rows_kernel      a warp per (n, c) row of H W elements: the
//                           row's sum(dz) and sum(dz xhat);
//   gn_bwd_coef_kernel      per (n, g) A and B; per c, ds and db over n;
//   gn_bwd_apply_kernel     dx (and dr).
// No float atomics: every sum runs in an order fixed by the shapes alone,
// so a recomputed gradient repeats bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // vectors a thread in an elementwise block

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

// PyTorch's relu on CUDA (clamp_min): NaN stays, else max(v, 0).
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gn_act_epilogue_kernel(float* __restrict__ y, const float* __restrict__ r,
                       int64_t n, int do_relu) {
  const int64_t steps = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < steps; j += stride) {
    float v[VEC], w[VEC];
    Vec<VEC>::load(y + j * VEC, v);
    if (r) {
      Vec<VEC>::load(r + j * VEC, w);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = __fadd_rn(v[e], w[e]);
    }
    if (do_relu) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = relu(v[e]);
    }
    Vec<VEC>::store(y + j * VEC, v);
  }
}

// A warp per row (n, c) of hw elements: lane l sums its elements l, l +
// 32, ... (in VEC-wide steps) in order, then the lanes combine in a fixed
// butterfly; lane 0 writes u[row] = sum(dz), v[row] = sum(dz xhat).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_rows_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                   const float* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ rstd, float* __restrict__ u,
                   float* __restrict__ v, int64_t rows, int hw, int cn,
                   int cg) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const int64_t stat = (row / cn) * (cn / cg) + (row % cn) / cg;
  const float m = mean[stat], rs = rstd[stat];
  const int64_t base = row * hw;
  float su = 0.0f, sv = 0.0f;
#pragma unroll 4
  for (int i = lane * VEC; i < hw; i += 32 * VEC) {
    float d[VEC], yy[VEC], xx[VEC];
    Vec<VEC>::load(dy + base + i, d);
    Vec<VEC>::load(x + base + i, xx);
    if (y) Vec<VEC>::load(y + base + i, yy);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float dz = (!y || yy[e] > 0.0f) ? d[e] : 0.0f;
      const float xh = __fmul_rn(__fsub_rn(xx[e], m), rs);
      su = __fadd_rn(su, dz);
      sv = __fadd_rn(sv, __fmul_rn(dz, xh));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    su = __fadd_rn(su, __shfl_xor_sync(0xffffffffu, su, off));
    sv = __fadd_rn(sv, __shfl_xor_sync(0xffffffffu, sv, off));
  }
  if (lane == 0) {
    u[row] = su;
    v[row] = sv;
  }
}

// Threads [0, N G): ab[n G + g] = (sum_c s u / M, sum_c s v / M) over the
// group's channels in order; threads [N G, N G + C): db[c] = sum_n u,
// ds[c] = sum_n v in sample order.
__global__ void __launch_bounds__(kThreads)
gn_bwd_coef_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ s, float2* __restrict__ ab,
                   float* __restrict__ ds, float* __restrict__ db, int batch,
                   int cn, int groups, float m) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int pairs = batch * groups;
  const int cg = cn / groups;
  if (t < pairs) {
    const int n = t / groups, g = t % groups;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < cg; ++j) {
      const int c = g * cg + j;
      const int64_t at = static_cast<int64_t>(n) * cn + c;
      a = __fadd_rn(a, __fmul_rn(s[c], u[at]));
      b = __fadd_rn(b, __fmul_rn(s[c], v[at]));
    }
    ab[t] = make_float2(__fdiv_rn(a, m), __fdiv_rn(b, m));
  } else if (t < pairs + cn) {
    const int c = t - pairs;
    float su = 0.0f, sv = 0.0f;
    for (int n = 0; n < batch; ++n) {
      su = __fadd_rn(su, u[static_cast<int64_t>(n) * cn + c]);
      sv = __fadd_rn(sv, v[static_cast<int64_t>(n) * cn + c]);
    }
    db[c] = su;
    ds[c] = sv;
  }
}

// Blocks of kThreads * kVecs vectors within one sample; row y of the grid
// is sample N - 1 - y.  A vector lies inside one channel (VEC divides hw).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                    const float* __restrict__ x, const float* __restrict__ s,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float2* __restrict__ ab, float* __restrict__ dx,
                    float* __restrict__ dr, int hw, int cn, int cg) {
  const int64_t n = gridDim.y - 1 - blockIdx.y;
  const int64_t per = static_cast<int64_t>(hw) * cn / VEC;
  const int groups = cn / cg;
  const int64_t base = n * per * VEC;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs +
                      k * kThreads + threadIdx.x;
    if (i >= per) break;
    const int64_t at = base + i * VEC;
    const int c = static_cast<int>(i * VEC / hw);
    const int64_t stat = n * groups + c / cg;
    const float m = __ldg(mean + stat), rs = __ldg(rstd + stat);
    const float2 co = __ldg(ab + stat);
    const float sc = __ldg(s + c);
    float d[VEC], yy[VEC], xx[VEC], gx[VEC];
    Vec<VEC>::load(dy + at, d);
    Vec<VEC>::load(x + at, xx);
    if (y) Vec<VEC>::load(y + at, yy);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      d[e] = (!y || yy[e] > 0.0f) ? d[e] : 0.0f;
      const float xh = __fmul_rn(__fsub_rn(xx[e], m), rs);
      gx[e] = __fmul_rn(rs, __fsub_rn(__fsub_rn(__fmul_rn(d[e], sc), co.x),
                                      __fmul_rn(xh, co.y)));
    }
    Vec<VEC>::store(dx + at, gx);
    if (dr) Vec<VEC>::store(dr + at, d);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned stride_grid(int64_t steps) {
  const int64_t blocks = (steps + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1)
                                                 : 132 * 16);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every tensor is contiguous
// f32; (N, C, H, W) activations, hw = H W; mean and rstd (N, G) as
// torch.native_group_norm returns them.  Each launches on `stream` and
// returns cudaGetLastError() (0 on success).
//
// forward epilogue: y (n elements) = relu(y + r) in place; r null for no
// add, relu 0 for no ReLU.
extern "C" int group_norm_act_fwd_launch(void* y, const void* r, int64_t n,
                                         int relu, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error so the return is this launch's
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  const float* rf = static_cast<const float*>(r);
  if (n % 4 == 0 && aligned16(y) && aligned16(r)) {
    gn_act_epilogue_kernel<4><<<stride_grid(n / 4), kThreads, 0, st>>>(yf, rf, n,
                                                                     relu);
  } else {
    gn_act_epilogue_kernel<1><<<stride_grid(n), kThreads, 0, st>>>(yf, rf, n, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// backward: dy, y (null without the ReLU), x, s, mean, rstd -> dx, dr
// (null without a residual), and in `work`, in this order: ds, db (C
// each), then the kernels' scratch u, v (N C each) and ab (N G float2).
extern "C" int group_norm_act_bwd_launch(
    const void* dy, const void* y, const void* x, const void* s,
    const void* mean, const void* rstd, void* dx, void* dr, void* work,
    int64_t batch, int64_t cn, int64_t hw, int64_t groups, void* stream) {
  if (batch <= 0 || batch >= 65535 || cn <= 0 || hw <= 0 || groups <= 0 ||
      cn % groups || hw > 0x7fffffff || batch * cn > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(cn), h = static_cast<int>(hw);
  const int cg = static_cast<int>(cn / groups);
  const float* dyf = static_cast<const float*>(dy);
  const float* yf = static_cast<const float*>(y);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* ds = static_cast<float*>(work);
  float* db = ds + cn;
  float* uf = db + cn;
  float* vf = uf + batch * cn;
  // 2 (C + N C) floats in: 8-byte aligned for float2
  float2* ab = reinterpret_cast<float2*>(vf + batch * cn);
  const bool vec = hw % 4 == 0 && aligned16(dy) && aligned16(y) &&
                   aligned16(x) && aligned16(dx) && aligned16(dr);
  const int64_t rows = batch * cn;
  const unsigned row_blocks =
      static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  if (vec) {
    gn_bwd_rows_kernel<4><<<row_blocks, kThreads, 0, st>>>(
        dyf, yf, xf, mf, rf, uf, vf, rows, h, c, cg);
  } else {
    gn_bwd_rows_kernel<1><<<row_blocks, kThreads, 0, st>>>(
        dyf, yf, xf, mf, rf, uf, vf, rows, h, c, cg);
  }
  const int64_t coef = batch * groups + cn;
  gn_bwd_coef_kernel<<<static_cast<unsigned>((coef + kThreads - 1) / kThreads),
                       kThreads, 0, st>>>(
      uf, vf, static_cast<const float*>(s), ab, ds, db, static_cast<int>(batch),
      c, static_cast<int>(groups),
      static_cast<float>(hw) * static_cast<float>(cg));
  const int vw = vec ? 4 : 1;
  const int64_t per = hw * cn / vw;
  const dim3 grid(static_cast<unsigned>((per + kThreads * kVecs - 1) /
                                        (kThreads * kVecs)),
                  static_cast<unsigned>(batch));
  if (vec) {
    gn_bwd_apply_kernel<4><<<grid, kThreads, 0, st>>>(
        dyf, yf, xf, static_cast<const float*>(s), mf, rf,
        ab, static_cast<float*>(dx),
        static_cast<float*>(dr), h, c, cg);
  } else {
    gn_bwd_apply_kernel<1><<<grid, kThreads, 0, st>>>(
        dyf, yf, xf, static_cast<const float*>(s), mf, rf,
        ab, static_cast<float*>(dx),
        static_cast<float*>(dr), h, c, cg);
  }
  return static_cast<int>(cudaGetLastError());
}
