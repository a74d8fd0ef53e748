// embedding_bag: weighted bags of table rows, folded in slot order.
//
// Replaces the Pallas TPU kernel `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py) on NVIDIA Hopper:
//   out[b, :] = fold over l of  acc = fma(w[b, l], table[idx[b, l], :], acc)
// from acc = 0, in f32 and in slot order; "mean" then divides by
// max(sum_l w[b, l], 1e-9).  The same source also folds the sparse push's
// duplicate ids (`segment_sum`, the counterpart of `jax.ops.segment_sum`
// in src/repro/runtime/sparse_push.py): out[u, :] = the rows order[j] for
// j in [seg[u], seg[u+1]), added in that order from 0.
//
// Bound: device-memory bandwidth.  A bag reads L rows of D f32 and writes
// one; there are two flops an element a slot.  So the design only keeps
// the touched rows crossing memory once, with wide accesses:
//   * one warp a bag (8 bags a 256-thread block); the lanes split D, four
//     consecutive floats a lane (one 16-byte load) when D % 4 == 0 and the
//     rows are 16-byte aligned, else one float a lane, with the ragged tail
//     of D masked.  D wider than 32 x 4 loops over strips of the row;
//   * the slot loop loads up to four rows ahead before it folds them, so
//     each warp has several row loads in flight; the fold itself stays in
//     slot order;
//   * every lane reads the slot's index and weight itself (a broadcast
//     load through the read-only cache).  The TPU kernel's scalar prefetch
//     of the index matrix and its one-row grid steps have no counterpart.
//
// Bit contract with the JAX package (and the plain version,
// `embedding_bag_torch`): the TPU kernel's `o += w * row`, as XLA compiles
// it, is a fused multiply-add, so the fold is `__fmaf_rn` in slot order
// (the build's -fmad=false keeps every other product separately rounded,
// so the FMA is written out).  A single one-slot bag (B = L = 1, a TPU
// grid of one step) is the plain product `__fmul_rn(w, row)`: XLA drops
// the add of the zero accumulator there, which differs from the FMA only
// in the sign of a zero.  Zero-weight padding slots still multiply
// their row, as the TPU kernel does: an inf or NaN there gives NaN.  The
// mean's weight sum is a sequential `__fadd_rn` fold from 0, its max with
// f32(1e-9) propagates NaN (jnp.maximum), and the division is `__fdiv_rn`.
// The segment fold is `__fadd_rn` from 0 (so -0 rows sum to +0, as the
// JAX scatter-add into zeros does).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pbox_opt.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kAhead = 4;  // rows in flight a warp

template <int VEC>
struct Row {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Row<VEC> load_row(const float* p, int64_t d,
                                             int64_t dim) {
  Row<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + d));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.v[e] = d + e < dim ? __ldg(p + d + e) : 0.0f;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, int64_t d, int64_t dim,
                                          const float* acc) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p + d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (d + e < dim) p[d + e] = acc[e];
  }
}

// Slots [begin, end) of one bag, folded into `out` row `bag`.  WEIGHTED:
// slot s carries weight w[s] and the fold is an FMA; otherwise every slot
// has weight one and the fold is an add (fma(1, x, acc) is the same bits).
template <typename Idx, int VEC, bool WEIGHTED>
__device__ __forceinline__ void fold_bag(const float* __restrict__ table,
                                         int64_t row_stride,
                                         const Idx* __restrict__ idx,
                                         const float* __restrict__ w,
                                         int64_t begin, int64_t end,
                                         float* __restrict__ out_row,
                                         int64_t dim, bool single,
                                         bool mean, float denom) {
  const int lane = threadIdx.x & 31;
  for (int64_t d = static_cast<int64_t>(lane) * VEC; d < dim; d += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int64_t s = begin; s < end; s += kAhead) {
      Row<VEC> rows[kAhead];
      float ws[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (s + a < end) {
          const int64_t r = static_cast<int64_t>(__ldg(idx + s + a));
          rows[a] = load_row<VEC>(table + r * row_stride, d, dim);
          ws[a] = WEIGHTED ? __ldg(w + s + a) : 1.0f;
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (s + a < end) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = !WEIGHTED ? __fadd_rn(acc[e], rows[a].v[e])
                     : single  ? __fmul_rn(ws[a], rows[a].v[e])
                               : __fmaf_rn(ws[a], rows[a].v[e], acc[e]);
        }
      }
    }
    if (mean) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], denom);
    }
    store_row<VEC>(out_row, d, dim, acc);
  }
}

// Padded bags: bag b's slots are b * len .. b * len + len - 1.
template <typename Idx, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_kernel(const float* __restrict__ table, int64_t row_stride,
           const Idx* __restrict__ idx, const float* __restrict__ w,
           float* __restrict__ out, int64_t bags, int64_t len, int64_t dim,
           int mean) {
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (bag >= bags) return;
  const int64_t begin = bag * len, end = begin + len;
  float denom = 1.0f;
  if (mean) {
    float wsum = 0.0f;
    for (int64_t s = begin; s < end; ++s) wsum = __fadd_rn(wsum, __ldg(w + s));
    const float lo = static_cast<float>(1e-9);  // f32(1e-9), as JAX rounds it
    denom = (wsum > lo || wsum != wsum) ? wsum : lo;
  }
  fold_bag<Idx, VEC, true>(table, row_stride, idx, w, begin, end,
                           out + bag * dim, dim, bags == 1 && len == 1,
                           mean != 0, denom);
}

// Segments: segment u's slots are seg[u] .. seg[u+1] - 1, all weight one.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_kernel(const float* __restrict__ rows, int64_t row_stride,
               const int64_t* __restrict__ order,
               const int64_t* __restrict__ seg, float* __restrict__ out,
               int64_t segments, int64_t dim) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (u >= segments) return;
  fold_bag<int64_t, VEC, false>(rows, row_stride, order, nullptr,
                                __ldg(seg + u), __ldg(seg + u + 1),
                                out + u * dim, dim, false, false, 1.0f);
}

inline bool wide(const void* rows, int64_t row_stride, const void* out,
                 int64_t dim) {
  return dim % 4 == 0 && row_stride % 4 == 0 && pbox::aligned(rows, 16) &&
         pbox::aligned(out, 16);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename Idx>
void launch_bags(const float* table, int64_t row_stride, const Idx* idx,
                 const float* w, float* out, int64_t bags, int64_t len,
                 int64_t dim, int mean, cudaStream_t s) {
  const dim3 grid(blocks_for(bags)), block(kWarpsPerBlock * 32);
  if (wide(table, row_stride, out, dim)) {
    bag_kernel<Idx, 4><<<grid, block, 0, s>>>(table, row_stride, idx, w, out,
                                              bags, len, dim, mean);
  } else {
    bag_kernel<Idx, 1><<<grid, block, 0, s>>>(table, row_stride, idx, w, out,
                                              bags, len, dim, mean);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each runs on `stream` and
// returns cudaGetLastError() of its launch (0 on success); the wrapper
// validates shapes, dtypes and index ranges first.
//
// table: rows of `dim` f32, `row_stride` floats apart; idx: (bags, len)
// int32 (idx64 == 0) or int64; w: (bags, len) f32; out: (bags, dim) f32.
extern "C" int embedding_bag_launch(const void* table, int64_t row_stride,
                                    const void* idx, int idx64, const void* w,
                                    void* out, int64_t bags, int64_t len,
                                    int64_t dim, int mean, void* stream) {
  if (bags < 0 || len < 1 || dim < 1 || row_stride < dim ||
      bags > 0x7fffffffLL * kWarpsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (bags == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (idx64) {
    launch_bags(t, row_stride, static_cast<const int64_t*>(idx), wf, o, bags,
                len, dim, mean, s);
  } else {
    launch_bags(t, row_stride, static_cast<const int32_t*>(idx), wf, o, bags,
                len, dim, mean, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows: rows of `dim` f32, `row_stride` floats apart; order: (n,) int64 row
// numbers grouped by segment, in batch order within each; seg: (segments +
// 1,) int64 offsets into `order`; out: (segments, dim) f32.
extern "C" int segment_sum_launch(const void* rows, int64_t row_stride,
                                  const void* order, const void* seg,
                                  void* out, int64_t segments, int64_t dim,
                                  void* stream) {
  if (segments < 0 || dim < 1 || row_stride < dim ||
      segments > 0x7fffffffLL * kWarpsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  if (segments == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  const int64_t* ord = static_cast<const int64_t*>(order);
  const int64_t* sg = static_cast<const int64_t*>(seg);
  float* o = static_cast<float*>(out);
  const dim3 grid(blocks_for(segments)), block(kWarpsPerBlock * 32);
  if (wide(rows, row_stride, out, dim)) {
    segment_kernel<4><<<grid, block, 0, s>>>(r, row_stride, ord, sg, o,
                                             segments, dim);
  } else {
    segment_kernel<1><<<grid, block, 0, s>>>(r, row_stride, ord, sg, o,
                                             segments, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
