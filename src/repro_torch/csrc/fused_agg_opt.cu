// fused_agg_opt: K-way gradient aggregation fused with the server optimizer.
//
// Replaces the Pallas TPU kernel `fused_agg_opt_pallas`
// (src/repro/kernels/fused_agg_opt/kernel.py) on NVIDIA Hopper.  It is the
// PHub hot loop: each PS shard sums the K worker gradient rows of the chunks
// it owns in f32, in ascending worker order, scales by 1/K, and applies one
// SGD, momentum (Nesterov optional), Adam or AdamW step, all in one pass.
//
// Bound: device-memory bandwidth.  Per element it reads K gradients, the
// param and 0-2 f32 state slots and writes the param and the state back,
// and does a few dozen flops.  AdamW with K=2 f32 gradients and f32 params
// moves 32 bytes per element (8 gradient + 8 param + 16 state) for ~20
// flops, far below the card's flop-per-byte balance.  The design therefore
// only keeps every byte crossing memory once:
//   * one thread owns VEC consecutive elements per grid-stride step and
//     loads them with one 16-byte (f32) or 8-byte (bf16) access when every
//     pointer is aligned and N is a multiple of VEC; otherwise VEC = 1 and
//     the loop bound masks the ragged tail (N need not be a multiple of
//     anything);
//   * the K-row fold stays in registers, the optimizer runs on the sum at
//     once, and param and state are updated IN PLACE: the shard replaces
//     them anyway, and at full width this saves an output copy of the
//     param and both Adam slots (about 4 GB for a 325M-element shard).
//
// Bit contract: the result equals the TPU kernel's op sequence exactly (its
// plain PyTorch version is `fused_agg_opt_torch`).  Every product that
// feeds a sum is rounded on its own (`__fmul_rn` then `__fadd_rn`, never a
// fused multiply-add), division and square root are IEEE-rounded
// (`__fdiv_rn`, `__fsqrt_rn`), and bf16 outputs round to nearest even.  The
// build also passes -fmad=false so no stray expression can contract.
//
// Hyperparameters arrive as f32 arguments rounded on the host from double,
// as JAX's weak-typed constants are; the step's scalars [lr_t, bc1, bc2,
// tok] are read from a device pointer, so a round needs no host sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

enum Opt { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Hyper {
  float wd, mu, b1, b2, eps, omb1, omb2, inv_k;
  int has_wd, nesterov;
};

// ---- loads and stores of VEC consecutive elements, widened to f32 --------
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

template <int OPT, typename G, typename P, int VEC>
__global__ void __launch_bounds__(256)
fused_agg_opt_kernel(const G* __restrict__ grads, P* __restrict__ param,
                     float* __restrict__ m_ptr, float* __restrict__ v_ptr,
                     const float* __restrict__ scalars, int64_t k, int64_t n,
                     Hyper h) {
  constexpr int kSlots = OPT == kSgd ? 0 : (OPT == kMomentum ? 1 : 2);
  const float lr = __ldg(scalars + 0);
  const float bc1 = __ldg(scalars + 1);
  const float bc2 = __ldg(scalars + 2);
  const int64_t steps = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < steps; j += stride) {
    const int64_t i = j * VEC;
    float acc[VEC], row[VEC], p[VEC];
    float m[VEC] = {}, v[VEC] = {};  // unused slots stay zero
    Access<G, VEC>::load(grads + i, acc);
    for (int64_t r = 1; r < k; ++r) {  // left fold, ascending worker order
      Access<G, VEC>::load(grads + r * n + i, row);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], row[e]);
    }
    Access<P, VEC>::load(param + i, p);
    if (kSlots >= 1) Access<float, VEC>::load(m_ptr + i, m);
    if (kSlots >= 2) Access<float, VEC>::load(v_ptr + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = __fmul_rn(acc[e], h.inv_k);
      p[e] = update<OPT>(h, lr, bc1, bc2, g, p[e], m[e], v[e]);
    }
    Access<P, VEC>::store(param + i, p);
    if (kSlots >= 1) Access<float, VEC>::store(m_ptr + i, m);
    if (kSlots >= 2) Access<float, VEC>::store(v_ptr + i, v);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <int OPT, typename G, typename P, int VEC>
void launch(const void* grads, void* param, float* m, float* v,
            const float* scalars, int64_t k, int64_t n, const Hyper& h,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t steps = n / VEC;
  // enough resident blocks to fill every SM (8 x 256 threads = 2048, the
  // SM's limit); the grid-stride loop covers the rest
  const int64_t want = (steps + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  fused_agg_opt_kernel<OPT, G, P, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const G*>(grads), static_cast<P*>(param), m, v, scalars, k,
      n, h);
}

template <int OPT, typename G, typename P>
void launch_vec(const void* grads, void* param, float* m, float* v,
                const float* scalars, int64_t k, int64_t n, const Hyper& h,
                cudaStream_t stream) {
  // 4-wide accesses need every row start aligned to 4 elements' bytes
  const auto aligned = [](const void* ptr, size_t bytes) {
    return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  const bool vec = n % 4 == 0 && aligned(grads, 4 * sizeof(G)) &&
                   aligned(param, 4 * sizeof(P)) && aligned(m, 16) &&
                   aligned(v, 16);
  if (vec) {
    launch<OPT, G, P, 4>(grads, param, m, v, scalars, k, n, h, stream);
  } else {
    launch<OPT, G, P, 1>(grads, param, m, v, scalars, k, n, h, stream);
  }
}

template <int OPT>
void launch_types(const void* grads, void* param, float* m, float* v,
                  const float* scalars, int64_t k, int64_t n, int grad_bf16,
                  int param_bf16, const Hyper& h, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (grad_bf16 && param_bf16) {
    launch_vec<OPT, bf16, bf16>(grads, param, m, v, scalars, k, n, h, stream);
  } else if (grad_bf16) {
    launch_vec<OPT, bf16, float>(grads, param, m, v, scalars, k, n, h, stream);
  } else if (param_bf16) {
    launch_vec<OPT, float, bf16>(grads, param, m, v, scalars, k, n, h, stream);
  } else {
    launch_vec<OPT, float, float>(grads, param, m, v, scalars, k, n, h, stream);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  grads: (k, n) contiguous, f32 or
// bf16; param: (n,) f32 or bf16; m, v: (n,) f32 or null per the optimizer;
// scalars: 4 f32 on the device.  Updates param, m and v in place on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int fused_agg_opt_launch(
    const void* grads, void* param, void* m, void* v, const void* scalars,
    int64_t k, int64_t n, int grad_bf16, int param_bf16, int opt, int has_wd,
    float wd, float mu, int nesterov, float b1, float b2, float eps,
    float omb1, float omb2, float inv_k, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const Hyper h{wd, mu, b1, b2, eps, omb1, omb2, inv_k, has_wd, nesterov};
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear any stale error so the return is this launch's
  switch (opt) {
    case kSgd:
      launch_types<kSgd>(grads, param, mf, vf, sc, k, n, grad_bf16, param_bf16, h, s);
      break;
    case kMomentum:
      launch_types<kMomentum>(grads, param, mf, vf, sc, k, n, grad_bf16, param_bf16, h, s);
      break;
    case kAdam:
      launch_types<kAdam>(grads, param, mf, vf, sc, k, n, grad_bf16, param_bf16, h, s);
      break;
    case kAdamW:
      launch_types<kAdamW>(grads, param, mf, vf, sc, k, n, grad_bf16, param_bf16, h, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
