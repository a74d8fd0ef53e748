// channels_last: a copy of an f32 tensor into channels-last memory, as a
// batch of 2-D transposes (N, C, P) -> (N, P, C).
//
// Replaces no TPU kernel: XLA picks layouts itself.  It exists for
// ResNet-50's weight gradients, which cuDNN computes far faster on
// channels-last operands at some shapes (models/resnet.py `_weight_grad`)
// while the forward stays NCHW: each such call lays out the convolution's
// NCHW input and incoming gradient (P = H W).  PyTorch's own copy runs
// these permutes as a strided elementwise kernel at a fraction of the
// card's bandwidth.
//
// Bound: device-memory bandwidth, 8 bytes an element (read once, written
// once).  The design: 32 x 32 tiles staged in shared memory (one pad
// column against bank conflicts), read along P and written along C, so
// both sides are whole 128-byte lines of a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileDim = 32;
constexpr int kRows = 8;  // a block is kTileDim x kRows threads

__global__ void __launch_bounds__(kTileDim * kRows)
channels_last_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int c, int p) {
  __shared__ float tile[kTileDim][kTileDim + 1];
  const int64_t off = static_cast<int64_t>(blockIdx.z) * c * p;
  const int p0 = blockIdx.x * kTileDim, c0 = blockIdx.y * kTileDim;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < kTileDim; k += kRows) {
    const int cc = c0 + k, pp = p0 + tx;
    if (cc < c && pp < p) tile[k][tx] = in[off + static_cast<int64_t>(cc) * p + pp];
  }
  __syncthreads();
  for (int k = ty; k < kTileDim; k += kRows) {
    const int pp = p0 + k, cc = c0 + tx;
    if (cc < c && pp < p) out[off + static_cast<int64_t>(pp) * c + cc] = tile[tx][k];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): out[n][q][j] = in[n][j][q] for
// n < batch, j < c, q < p; both contiguous f32.  Runs on `stream` and
// returns cudaGetLastError() of its launch (0 on success).
extern "C" int channels_last_launch(const void* in, void* out, int64_t batch,
                                    int64_t c, int64_t p, void* stream) {
  if (batch <= 0 || c <= 0 || p <= 0 || batch > 65535 ||
      c > 0x7fffffff - kTileDim || p > 0x7fffffff - kTileDim ||
      (c + kTileDim - 1) / kTileDim > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const dim3 grid(static_cast<unsigned>((p + kTileDim - 1) / kTileDim),
                  static_cast<unsigned>((c + kTileDim - 1) / kTileDim),
                  static_cast<unsigned>(batch));
  channels_last_kernel<<<grid, dim3(kTileDim, kRows), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<int>(c), static_cast<int>(p));
  return static_cast<int>(cudaGetLastError());
}
