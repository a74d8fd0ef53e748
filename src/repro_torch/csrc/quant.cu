// quant: per-chunk symmetric int8 quantize and dequantize, the wire codec.
//
// Replaces the Pallas TPU kernels `quantize_chunks_pallas` and
// `dequantize_chunks_pallas` (src/repro/kernels/quant/kernel.py) on NVIDIA
// Hopper.  A flat f32 slab of C chunks becomes an int8 payload plus one f32
// scale per chunk:
//   scale = amax / 127 (1.0 when not amax > 0; see the bit contract),
//   q     = clip(round_half_even(x / scale), -127, 127),
// and decodes as f32(q) * scale[chunk].
//
// Bound: device-memory bandwidth.  Quantize reads 4 bytes and writes 1 per
// element (plus 4 per chunk) for a handful of operations; dequantize the
// reverse.  So the design only keeps each byte crossing memory once:
//   * quantize runs one block per chunk, and the block holds its chunk in
//     registers: ITEMS elements a thread (256 threads x 32 at the default
//     8192), loaded with 16-byte accesses, all issued before the block
//     reduces.  The abs-max is a warp-shuffle then shared-memory
//     reduction, and the encode reads the registers, so device memory
//     sees each element once.  A chunk that does not split into at most
//     1024 threads of 4 to 32 elements in whole warps (one over 32768
//     elements, or an odd multiple of 128 above 4096) streams through
//     twice instead, the second pass mostly from L2;
//   * dequantize is a grid-stride loop, one thread per 4 int8 (one 4-byte
//     load, one 16-byte store).  A group of 4 never straddles a chunk,
//     because chunk_elems is a multiple of 128.
//
// Bit contract with the JAX package (and the plain version,
// `quantize_chunks_torch` / `dequantize_chunks_torch`):
//   * the max propagates NaN, as jnp.max does: a chunk holding a NaN has
//     amax = NaN, so `amax > 0` is false and its scale is 1.0.  fmaxf would
//     drop the NaN and change the scale of the whole chunk;
//   * a NaN quotient encodes as 0 (XLA's float-to-int conversion), before
//     the clamp: fmaxf/fminf would turn it into -127.  An inf chunk thus
//     has scale inf and encodes as all zeros (x/inf = 0, inf/inf = NaN);
//   * the scale is `amax * f32(1/127)`, not the quotient: XLA compiles the
//     TPU kernel's `amax / 127.0`, a division by a constant, into a product
//     with the constant's reciprocal (one ulp off the quotient for about
//     one chunk in twenty-five).  `x / scale` divides by a value, which
//     XLA leaves a true division: `__fdiv_rn` here;
//   * rounding is `rintf` (half to even, as jnp.round), the decode
//     multiply is `__fmul_rn`.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "pbox_opt.cuh"

namespace {

constexpr int kMaxQuantThreads = 1024;  // a staged chunk's block
constexpr int kStreamThreads = 256;     // a streamed chunk's block

// max that propagates NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int8_t encode(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// The chunk's scale from its abs-max, reduced over the block: warp
// shuffles, then one value per warp in shared memory.  Every thread returns
// the scale; thread 0 also writes it out.
__device__ __forceinline__ float chunk_scale(float amax, float* scale_out) {
  __shared__ float warp_max[32];
  __shared__ float block_scale;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      m = nan_max(m, warp_max[w]);
    const float s = m > 0.0f ? __fmul_rn(m, 1.0f / 127.0f) : 1.0f;
    block_scale = s;
    *scale_out = s;
  }
  __syncthreads();
  return block_scale;
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* q, const float* v, float s) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(q) = make_char4(
        encode(v[0], s), encode(v[1], s), encode(v[2], s), encode(v[3], s));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] = encode(v[e], s);
  }
}

// One block per chunk of blockDim.x * ITEMS elements, held in registers:
// thread t holds the VEC-element groups t, t + blockDim.x, ... (coalesced).
template <int VEC, int ITEMS>
__global__ void __launch_bounds__(kMaxQuantThreads)
quantize_staged_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scale, int64_t chunk_elems) {
  constexpr int kGroups = ITEMS / VEC;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float* xc = x + base;
  float v[ITEMS];
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
    pbox::Access<float, VEC>::load(
        xc + (static_cast<int64_t>(j) * blockDim.x + threadIdx.x) * VEC,
        v + j * VEC);
  float amax = 0.0f;
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) amax = nan_max(amax, fabsf(v[e]));
  const float s = chunk_scale(amax, scale + blockIdx.x);
  int8_t* qc = q + base;
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
    store_q<VEC>(
        qc + (static_cast<int64_t>(j) * blockDim.x + threadIdx.x) * VEC,
        v + j * VEC, s);
}

// One block per chunk of any size: one pass for the abs-max, one to encode.
template <int VEC>
__global__ void __launch_bounds__(kStreamThreads)
quantize_streamed_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int64_t chunk_elems) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float* xc = x + base;
  const int64_t groups = chunk_elems / VEC;
  float amax = 0.0f;
  for (int64_t j = threadIdx.x; j < groups; j += blockDim.x) {
    float v[VEC];
    pbox::Access<float, VEC>::load(xc + j * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = nan_max(amax, fabsf(v[e]));
  }
  const float s = chunk_scale(amax, scale + blockIdx.x);
  int8_t* qc = q + base;
  for (int64_t j = threadIdx.x; j < groups; j += blockDim.x) {
    float v[VEC];
    pbox::Access<float, VEC>::load(xc + j * VEC, v);
    store_q<VEC>(qc + j * VEC, v, s);
  }
}

template <int VEC>
void launch_quantize(const float* x, int8_t* q, float* scale, int64_t chunks,
                    int64_t chunk_elems, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(chunks);
  // the most elements a thread holds such that the chunk is whole warps
  // of threads and a block holds at most kMaxQuantThreads of them
  for (int items : {32, 16, 8, 4}) {
    if (chunk_elems % (32 * items) || chunk_elems / items > kMaxQuantThreads)
      continue;
    const unsigned threads = static_cast<unsigned>(chunk_elems / items);
    switch (items) {
      case 32:
        quantize_staged_kernel<VEC, 32><<<grid, threads, 0, s>>>(
            x, q, scale, chunk_elems);
        break;
      case 16:
        quantize_staged_kernel<VEC, 16><<<grid, threads, 0, s>>>(
            x, q, scale, chunk_elems);
        break;
      case 8:
        quantize_staged_kernel<VEC, 8><<<grid, threads, 0, s>>>(
            x, q, scale, chunk_elems);
        break;
      default:
        quantize_staged_kernel<VEC, 4><<<grid, threads, 0, s>>>(
            x, q, scale, chunk_elems);
    }
    return;
  }
  quantize_streamed_kernel<VEC><<<grid, kStreamThreads, 0, s>>>(
      x, q, scale, chunk_elems);
}

template <int VEC>
__global__ void __launch_bounds__(256)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ out, int64_t n, int64_t chunk_elems) {
  const int64_t steps = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < steps; j += stride) {
    const int64_t i = j * VEC;
    const float s = __ldg(scale + i / chunk_elems);
    float v[VEC];
    pbox::Access<int8_t, VEC>::load(q + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __fmul_rn(v[e], s);
    pbox::Access<float, VEC>::store(out + i, v);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  x / out: (n,) f32; q: (n,)
// int8; scale: (n / chunk_elems,) f32; n a positive whole number of chunks
// and chunk_elems a multiple of 128 (the wrapper checks both).  Each runs
// on `stream` and returns cudaGetLastError() of its launch (0 on success).
extern "C" int quantize_chunks_launch(const void* x, void* q, void* scale,
                                      int64_t n, int64_t chunk_elems,
                                      void* stream) {
  if (n <= 0 || chunk_elems <= 0 || n % chunk_elems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int64_t chunks = n / chunk_elems;
  if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int8_t* qi = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(scale);
  if (pbox::aligned(x, 16) && pbox::aligned(q, 4) && chunk_elems % 4 == 0) {
    launch_quantize<4>(xf, qi, sf, chunks, chunk_elems, s);
  } else {
    launch_quantize<1>(xf, qi, sf, chunks, chunk_elems, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_chunks_launch(const void* q, const void* scale,
                                        void* out, int64_t n,
                                        int64_t chunk_elems, void* stream) {
  if (n <= 0 || chunk_elems <= 0 || n % chunk_elems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  constexpr int kThreads = 256;
  if (pbox::aligned(q, 4) && pbox::aligned(out, 16) && chunk_elems % 4 == 0) {
    dequantize_kernel<4><<<pbox::stride_grid(n / 4, kThreads), kThreads, 0, s>>>(
        qi, sf, of, n, chunk_elems);
  } else {
    dequantize_kernel<1><<<pbox::stride_grid(n, kThreads), kThreads, 0, s>>>(
        qi, sf, of, n, chunk_elems);
  }
  return static_cast<int>(cudaGetLastError());
}
