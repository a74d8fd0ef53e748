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
      p[e] = pbox::update<OPT>(h, lr, bc1, bc2, g, p[e], m[e], v[e]);
    }
    Access<P, VEC>::store(param + i, p);
    if (kSlots >= 1) Access<float, VEC>::store(m_ptr + i, m);
    if (kSlots >= 2) Access<float, VEC>::store(v_ptr + i, v);
  }
}

template <int OPT, typename G, typename P, int VEC>
void launch(const void* grads, void* param, float* m, float* v,
            const float* scalars, int64_t k, int64_t n, const Hyper& h,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = pbox::stride_grid(n / VEC, kThreads);
  fused_agg_opt_kernel<OPT, G, P, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const G*>(grads), static_cast<P*>(param), m, v, scalars, k,
      n, h);
}

template <int OPT, typename G, typename P>
void launch_vec(const void* grads, void* param, float* m, float* v,
                const float* scalars, int64_t k, int64_t n, const Hyper& h,
                cudaStream_t stream) {
  // 4-wide accesses need every row start aligned to 4 elements' bytes
  using pbox::aligned;
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
