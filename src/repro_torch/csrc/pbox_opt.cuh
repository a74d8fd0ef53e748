// pbox_opt.cuh: what the PS kernels share, so the optimizer math and the
// element loads exist once.
//
// fused_agg_opt.cu (the raw f32/bf16 wire) and wire_path.cu (the codec'd
// wire) both end in the same server optimizer step, and their results must
// be bit-identical to each other and to the JAX package: the TPU wire
// kernel imports `sgd_body`, `momentum_body`, `adam_body` and `fence` from
// the fused_agg_opt kernel for the same reason.  quant.cu shares the
// int8 load and the grid sizing.
//
// Every product that feeds a sum is rounded on its own (`__fmul_rn` then
// `__fadd_rn`), division and square root are IEEE-rounded, and bf16 stores
// round to nearest even; the build passes -fmad=false as well.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace pbox {

enum Opt { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Hyper {
  float wd, mu, b1, b2, eps, omb1, omb2, inv_k;
  int has_wd, nesterov;
};

// ---- loads and stores of VEC consecutive elements, widened to f32 --------
// (int8 loads widen q exactly; they have no store: nothing writes int8
// through them)
template <typename T, int VEC>
struct Access;

template <>
struct Access<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = p[0];
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    p[0] = in[0];
  }
};

template <>
struct Access<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Access<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    p[0] = __float2bfloat16_rn(in[0]);
  }
};

template <>
struct Access<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// 8 elements: two 16-byte accesses of f32, one of bf16 (fused_agg_opt's
// vector wherever an operand is bf16)
template <>
struct Access<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    Access<float, 4>::load(p, out);
    Access<float, 4>::load(p + 4, out + 4);
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    Access<float, 4>::store(p, in);
    Access<float, 4>::store(p + 4, in + 4);
  }
};

template <>
struct Access<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair;
      memcpy(&pair, &w[i], sizeof(pair));
      const float2 f = __bfloat1622float2(pair);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      memcpy(&w[i], &pair, sizeof(pair));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Access<int8_t, 1> {
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    out[0] = static_cast<float>(p[0]);
  }
};

template <>
struct Access<int8_t, 4> {
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    out[0] = static_cast<float>(v.x); out[1] = static_cast<float>(v.y);
    out[2] = static_cast<float>(v.z); out[3] = static_cast<float>(v.w);
  }
};

// ---- the optimizer bodies: the TPU kernel's op order, strictly rounded ----
template <int OPT>
__device__ __forceinline__ float update(const Hyper& h, float lr, float bc1,
                                        float bc2, float g, float p, float& m,
                                        float& v) {
  if (OPT == kSgd) {
    if (h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    return __fsub_rn(p, __fmul_rn(lr, g));
  }
  if (OPT == kMomentum) {
    if (h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    m = __fadd_rn(__fmul_rn(h.mu, m), g);
    const float upd = h.nesterov ? __fadd_rn(g, __fmul_rn(h.mu, m)) : m;
    return __fsub_rn(p, __fmul_rn(lr, upd));
  }
  // Adam / AdamW
  if (OPT == kAdam && h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fmul_rn(m, bc1);
  const float vhat = __fmul_rn(v, bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (OPT == kAdamW && h.has_wd) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(lr, upd));
}

// ---- launch geometry -------------------------------------------------------
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// Blocks for a grid-stride loop of `steps` iterations at `threads` a block:
// enough resident blocks to fill every SM (8 x 256 threads = 2048, the SM's
// limit), never more than the work needs, at least one.
inline int stride_grid(int64_t steps, int threads) {
  const int64_t want = (steps + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / threads);
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

inline bool aligned(const void* ptr, size_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace pbox
