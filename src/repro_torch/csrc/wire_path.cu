// wire_fused: codec decode + K-way aggregate + server optimizer, one pass.
//
// Replaces the Pallas TPU kernel `wire_fused_pallas`
// (src/repro/kernels/wire_path/kernel.py) on NVIDIA Hopper.  A PS shard
// receives K worker streams still in wire form (int8 payload with one f32
// scale per chunk, bf16, or raw f32) and must apply their average to its
// parameters.  The unfused path decodes each stream into an f32 slab in
// device memory (the dequantize kernel) and reads those slabs back in
// fused_agg_opt; this kernel decodes in registers, so the decoded f32
// gradients never reach device memory.
//
// Bound: device-memory bandwidth.  With AdamW, K=2 and int8 streams it
// moves 26 bytes per element (2 payload bytes, param and both Adam slots
// read and written) plus 8 bytes per chunk of scales, for ~30 operations.
// The design keeps each byte crossing memory once, as fused_agg_opt does:
//   * a grid-stride loop, one thread per VEC = 4 consecutive elements when
//     every pointer allows 4-wide accesses (else VEC = 1).  A group of 4
//     never straddles a chunk (chunk_elems is a multiple of 128), so it
//     needs one scale per stream;
//   * per element: for i = 0..K-1, decode stream i (bf16 widening, or
//     `__fmul_rn(f32(q), scale[i][chunk])`) and fold it into the sum with
//     `__fadd_rn` in ascending stream order; then `acc * 1/K` and the
//     optimizer body of pbox_opt.cuh, which fused_agg_opt runs too;
//   * param, m and v are updated IN PLACE (the shard owns private copies).
//   The TPU kernel's chunk blocking and two-slot VMEM staging buffer exist
//   to overlap its DMA with compute on one core; here the warps in flight
//   on 132 SMs hide the load latency, so the kernel needs neither.
//
// Bit contract: equal to the unfused kernel pipeline (dequantize, then
// fused_agg_opt) and to the plain version `wire_fused_torch`.  The decoded
// value is the dequantize kernel's exact expression, the fold and the
// optimizer are fused_agg_opt's, and the build passes -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbox_opt.cuh"

namespace {

using pbox::Access;
using pbox::Hyper;
using pbox::kAdam;
using pbox::kAdamW;
using pbox::kMomentum;
using pbox::kSgd;

enum Codec { kNone = 0, kBf16 = 1, kInt8 = 2 };

template <int OPT, typename W, int VEC>
__global__ void __launch_bounds__(256)
wire_fused_kernel(const W* __restrict__ payload,
                  const float* __restrict__ scales, float* __restrict__ param,
                  float* __restrict__ m_ptr, float* __restrict__ v_ptr,
                  const float* __restrict__ scalars, int64_t k, int64_t n,
                  int64_t chunk_elems, Hyper h) {
  constexpr int kSlots = OPT == kSgd ? 0 : (OPT == kMomentum ? 1 : 2);
  constexpr bool kScaled = sizeof(W) == 1;  // int8 streams carry scales
  const float lr = __ldg(scalars + 0);
  const float bc1 = __ldg(scalars + 1);
  const float bc2 = __ldg(scalars + 2);
  const int64_t chunks = kScaled ? n / chunk_elems : 0;
  const int64_t steps = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < steps; j += stride) {
    const int64_t i = j * VEC;
    const int64_t chunk = kScaled ? i / chunk_elems : 0;
    float acc[VEC], row[VEC], p[VEC];
    float m[VEC] = {}, v[VEC] = {};  // unused slots stay zero
    // decode stream r of this thread's VEC elements to rounded f32: the
    // dequantize kernel's exact expression
    const auto decode = [&](int64_t r, float* out) {
      Access<W, VEC>::load(payload + r * n + i, out);
      if constexpr (kScaled) {
        const float s = __ldg(scales + r * chunks + chunk);
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = __fmul_rn(out[e], s);
      }
    };
    decode(0, acc);
    for (int64_t r = 1; r < k; ++r) {  // left fold, ascending stream order
      decode(r, row);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], row[e]);
    }
    Access<float, VEC>::load(param + i, p);
    if (kSlots >= 1) Access<float, VEC>::load(m_ptr + i, m);
    if (kSlots >= 2) Access<float, VEC>::load(v_ptr + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = __fmul_rn(acc[e], h.inv_k);
      p[e] = pbox::update<OPT>(h, lr, bc1, bc2, g, p[e], m[e], v[e]);
    }
    Access<float, VEC>::store(param + i, p);
    if (kSlots >= 1) Access<float, VEC>::store(m_ptr + i, m);
    if (kSlots >= 2) Access<float, VEC>::store(v_ptr + i, v);
  }
}

template <int OPT, typename W>
void launch_vec(const void* payload, const float* scales, float* param,
                float* m, float* v, const float* scalars, int64_t k, int64_t n,
                int64_t chunk_elems, const Hyper& h, cudaStream_t stream) {
  constexpr int kThreads = 256;
  using pbox::aligned;
  // 4-wide accesses need every row start aligned to 4 elements' bytes
  const bool vec = n % 4 == 0 && chunk_elems % 4 == 0 &&
                   aligned(payload, 4 * sizeof(W)) && aligned(param, 16) &&
                   aligned(m, 16) && aligned(v, 16);
  const W* pay = static_cast<const W*>(payload);
  if (vec) {
    wire_fused_kernel<OPT, W, 4><<<pbox::stride_grid(n / 4, kThreads),
                                   kThreads, 0, stream>>>(
        pay, scales, param, m, v, scalars, k, n, chunk_elems, h);
  } else {
    wire_fused_kernel<OPT, W, 1><<<pbox::stride_grid(n, kThreads), kThreads,
                                   0, stream>>>(
        pay, scales, param, m, v, scalars, k, n, chunk_elems, h);
  }
}

template <int OPT>
void launch_codec(int codec, const void* payload, const float* scales,
                  float* param, float* m, float* v, const float* scalars,
                  int64_t k, int64_t n, int64_t chunk_elems, const Hyper& h,
                  cudaStream_t stream) {
  switch (codec) {
    case kNone:
      launch_vec<OPT, float>(payload, scales, param, m, v, scalars, k, n,
                             chunk_elems, h, stream);
      break;
    case kBf16:
      launch_vec<OPT, __nv_bfloat16>(payload, scales, param, m, v, scalars, k,
                                     n, chunk_elems, h, stream);
      break;
    default:
      launch_vec<OPT, int8_t>(payload, scales, param, m, v, scalars, k, n,
                              chunk_elems, h, stream);
      break;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  payload: (k, n) contiguous in
// the codec's wire type (0: f32, 1: bf16, 2: int8); scales: (k,
// n/chunk_elems) f32 for int8, else null; param, m, v: (n,) f32 (m and v
// null as the optimizer needs); scalars: 4 f32 on the device.  n is a
// positive whole number of chunks.  Updates param, m and v in place on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int wire_fused_launch(
    const void* payload, const void* scales, void* param, void* m, void* v,
    const void* scalars, int64_t k, int64_t n, int64_t chunk_elems, int codec,
    int opt, int has_wd, float wd, float mu, int nesterov, float b1, float b2,
    float eps, float omb1, float omb2, float inv_k, void* stream) {
  if (k <= 0 || n <= 0 || chunk_elems <= 0 || n % chunk_elems ||
      codec < kNone || codec > kInt8 || (codec == kInt8 && scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{wd, mu, b1, b2, eps, omb1, omb2, inv_k, has_wd, nesterov};
  const float* sc = static_cast<const float*>(scales);
  float* pf = static_cast<float*>(param);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* pk = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear any stale error so the return is this launch's
  switch (opt) {
    case kSgd:
      launch_codec<kSgd>(codec, payload, sc, pf, mf, vf, pk, k, n, chunk_elems, h, s);
      break;
    case kMomentum:
      launch_codec<kMomentum>(codec, payload, sc, pf, mf, vf, pk, k, n, chunk_elems, h, s);
      break;
    case kAdam:
      launch_codec<kAdam>(codec, payload, sc, pf, mf, vf, pk, k, n, chunk_elems, h, s);
      break;
    case kAdamW:
      launch_codec<kAdamW>(codec, payload, sc, pf, mf, vf, pk, k, n, chunk_elems, h, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
