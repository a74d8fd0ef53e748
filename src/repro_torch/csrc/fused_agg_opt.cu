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
// for a few dozen flops.  AdamW with K=2 f32 gradients and f32 params moves
// 32 bytes per element (8 gradient + 8 param + 16 state) for ~20 flops, far
// below the card's flop-per-byte balance.  So the design keeps bytes in
// flight on every SM, balances the work across SMs, and every byte crosses
// memory once:
//   * a persistent grid of one block an SM.  A block has three roles: one
//     thread of the producer warp fills a ring of shared-memory stages with
//     1D TMA bulk copies (`cp.async.bulk`) that complete on each stage's
//     `mbarrier`; eight consumer warps read a stage with 16-byte
//     shared-memory accesses (4 f32 or 8 bf16 values a thread; 8 wherever
//     an operand is bf16), fold the K rows in registers, run the update and
//     write param and state back into the stage; one thread of the storer
//     warp writes them to device memory with bulk stores and frees the
//     stage.  Param and state are updated IN PLACE;
//   * a stage holds one tile of every stream (the K gradient rows, the
//     param, 0-2 state slots).  The host picks the tile (2048-4096
//     elements: each copy moves at least 8 KB) and the number of stages
//     (4-16) to fill ~200 KB of shared memory, halving the tile while the
//     slab has fewer than two rings' worth of tiles per SM;
//   * tiles are shared out in two parts: block b owns tiles b, b + nb, ...
//     (as many as it has stages, issued at once), and the rest are claimed
//     in runs from a device counter, so an SM that memory serves faster
//     takes more (with a fixed share per block, the blocks that memory
//     served slower finished long after the rest, and the card idled
//     behind them).  The counter is the caller's device word, one for each
//     stream (launches on one stream never overlap, so none shares it with
//     a launch on another), and it resets itself: the block that makes a
//     launch's last claim zeroes it for the stream's next launch;
//   * the gradient rows arrive as K pointers in the launch's parameters,
//     not as a stacked (K, N) copy, so a caller never stacks its inbox.  A
//     shard whose chunks are not one run of the flat space passes its
//     chunk-id table, and the copies read each worker's whole push in
//     place, one bulk copy per chunk piece of a tile;
//   * the ragged edge (the head before the first element where every
//     pointer is 16-byte aligned, the tail after the last whole tile) takes
//     plain element loads in the same kernel.  Where the pointers share no
//     16-byte alignment, or a chunk table's pieces would not be aligned,
//     every element is edge.
//
// Bit contract: the result equals the TPU kernel's op sequence exactly (its
// plain PyTorch version is `fused_agg_opt_torch`).  Every product that
// feeds a sum is rounded on its own (`__fmul_rn` then `__fadd_rn`, never a
// fused multiply-add), division and square root are IEEE-rounded
// (`__fdiv_rn`, `__fsqrt_rn`), and bf16 outputs round to nearest even.  The
// build also passes -fmad=false so no stray expression can contract.
// Null rows (zero rows the caller did not materialise) are folded as one
// `+ 0.0f` after the present rows: x + 0 only turns -0 into +0, so where
// the zeros sit in a left fold does not change its bits.  An optional
// gradient scale multiplies the folded sum and rounds it to the gradient's
// dtype, as an eager `slab * scale` would, before `x 1/K`.  The order in
// which tiles are processed does not touch the arithmetic.
//
// Hyperparameters arrive as f32 arguments rounded on the host from double,
// as JAX's weak-typed constants are; the step's scalars [lr_t, bc1, bc2,
// tok] are read from a device pointer once a block, so a round needs no
// host sync.

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

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 64;  // + the producer and storer warps
constexpr int kMaxStages = 16;
constexpr int kMinStages = 4;
// dynamic shared memory of the one block an SM (of the SM's 228 KB)
constexpr int kSmemBudget = 200 * 1024;
constexpr int kMaxTile = 4096;
constexpr int kMinTile = 2048;  // below ~8 KB a copy, TMA's per-copy cost shows
constexpr int kRunBytes = 32 * 1024;  // a claim takes at least this much work
// row-pointer capacities, the smaller that holds the launch's rows is used
// (a launch of up to 8 rows carries 64 bytes of pointers)
constexpr int kCaps[] = {8, 256};

template <int CAP>
struct Rows {
  const void* p[CAP];
};

// What a launch walks: `head` edge elements, then `tiles` tiles of `tile`
// elements through the ring, then the edge tail up to `n`.
struct Plan {
  const int64_t* chunk_ids;  // device table, or null: rows are contiguous
  int64_t chunk_elems, n, head, tiles;
  int k;         // present (non-null) rows
  int tile;      // elements a tile
  int stages;    // ring stages
  int run;       // tiles a claim takes
  int has_zero;  // a null row was folded: + 0.0f after the present rows
  int has_scale;
  float grad_scale;
  // the claim counter: claims made so far in this launch (zero between
  // the launches of its stream)
  unsigned long long* claims;
};

// ---- mbarrier and bulk-copy helpers (PTX) ----------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// ---- the arithmetic, shared by the ring and the edge -----------------------
template <typename G>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// `acc` holds the left fold of the present rows; finish the fold, scale,
// and run the optimizer on W elements.
template <int OPT, typename G, int W>
__device__ __forceinline__ void update_elems(const Hyper& h, const Plan& pl,
                                             float lr, float bc1, float bc2,
                                             float (&acc)[W], float (&p)[W],
                                             float (&m)[W], float (&v)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    float a = acc[e];
    if (pl.has_zero) a = __fadd_rn(a, 0.0f);
    if (pl.has_scale) a = round_to<G>(__fmul_rn(a, pl.grad_scale));
    const float g = __fmul_rn(a, h.inv_k);
    p[e] = pbox::update<OPT>(h, lr, bc1, bc2, g, p[e], m[e], v[e]);
  }
}

// Element `i` of the shard in a row: through the chunk table if there is one.
__device__ __forceinline__ int64_t src_index(const Plan& pl, int64_t i) {
  if (pl.chunk_ids == nullptr) return i;
  const int64_t c = i / pl.chunk_elems;
  return pl.chunk_ids[c] * pl.chunk_elems + (i - c * pl.chunk_elems);
}

template <int OPT, typename G, typename P, int CAP>
__global__ void __launch_bounds__(kThreads)
fused_agg_opt_kernel(const Rows<CAP> rows, P* __restrict__ param,
                     float* __restrict__ m_ptr, float* __restrict__ v_ptr,
                     const float* __restrict__ scalars, const Plan pl,
                     const Hyper h) {
  constexpr int kSlots = OPT == kSgd ? 0 : (OPT == kMomentum ? 1 : 2);
  constexpr int E = (sizeof(G) == 2 || sizeof(P) == 2) ? 8 : 4;
  extern __shared__ __align__(128) unsigned char ring[];
  // per stage: loaded (full), computed, written back (empty); its tile
  __shared__ uint64_t full[kMaxStages], computed[kMaxStages], empty[kMaxStages];
  __shared__ int64_t stage_tile[kMaxStages];
  __shared__ float packet[3];

  const int tile = pl.tile, k = pl.k, S = pl.stages;
  const uint32_t row_bytes = static_cast<uint32_t>(tile) * sizeof(G);
  const uint32_t p_bytes = static_cast<uint32_t>(tile) * sizeof(P);
  const uint32_t s_bytes = static_cast<uint32_t>(tile) * sizeof(float);
  const uint32_t stage_bytes = k * row_bytes + p_bytes + kSlots * s_bytes;
  const int64_t nb = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool producer = warp == kConsumerWarps && lane == 0;

  // Stage use j gets tile t, or the end mark (t < 0).
  auto produce = [&](int64_t j, int64_t t) {
    const int s = static_cast<int>(j % S);
    if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
    stage_tile[s] = t;
    if (t < 0) {
      mbar_arrive(&full[s]);
      return;
    }
    mbar_arrive_expect_tx(&full[s], stage_bytes);
    unsigned char* st = ring + static_cast<size_t>(s) * stage_bytes;
    const int64_t i0 = pl.head + t * tile;
    for (int r = 0; r < k; ++r) {
      const G* row = static_cast<const G*>(rows.p[r]);
      unsigned char* dst = st + r * row_bytes;
      if (pl.chunk_ids == nullptr) {
        bulk_load(dst, row + i0, row_bytes, &full[s]);
        continue;
      }
      // one copy per chunk piece of the tile, each read in place
      for (int64_t i = i0; i < i0 + tile;) {
        const int64_t c = i / pl.chunk_elems;
        const int64_t chunk_end = (c + 1) * pl.chunk_elems;
        const int64_t end = chunk_end < i0 + tile ? chunk_end : i0 + tile;
        bulk_load(dst + (i - i0) * sizeof(G),
                  row + pl.chunk_ids[c] * pl.chunk_elems +
                      (i - c * pl.chunk_elems),
                  static_cast<uint32_t>((end - i) * sizeof(G)), &full[s]);
        i = end;
      }
    }
    unsigned char* dst = st + k * row_bytes;
    bulk_load(dst, param + i0, p_bytes, &full[s]);
    if (kSlots >= 1) bulk_load(dst + p_bytes, m_ptr + i0, s_bytes, &full[s]);
    if (kSlots >= 2)
      bulk_load(dst + p_bytes + s_bytes, v_ptr + i0, s_bytes, &full[s]);
  };

  // the block's own tiles: b, b + nb, ..., S of them
  int64_t j = 0, own = 0;
  if (warp == kConsumerWarps) {
    for (int s = lane; s < S; s += 32) {
      mbar_init(&full[s], 1);
      mbar_init(&computed[s], kConsumerWarps);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
  }
  if (producer) {
    // the first tile before the block meets, the rest after, so the
    // consumers are not held at the barrier while the copies queue
    if (b < pl.tiles) {
      produce(j++, b);
      ++own;
    }
  }
  if (threadIdx.x == 0) {
    packet[0] = scalars[0];
    packet[1] = scalars[1];
    packet[2] = scalars[2];
  }
  __syncthreads();
  const float lr = packet[0], bc1 = packet[1], bc2 = packet[2];

  if (warp == kConsumerWarps) {
    if (producer) {
      for (; own < S && b + own * nb < pl.tiles; ++own)
        produce(j++, b + own * nb);
      // the rest in claimed runs; the next claim is in flight while the
      // current run is issued.  Every block stops at its first claim past
      // the end, so a launch makes runs + nb claims, and the block that
      // makes the last one resets the counter for the next launch
      const int64_t shared0 = nb * S;
      if (shared0 < pl.tiles) {
        const int64_t runs = (pl.tiles - shared0 + pl.run - 1) / pl.run;
        int64_t r = static_cast<int64_t>(atomicAdd(pl.claims, 1ULL));
        while (r < runs) {
          const int64_t next = static_cast<int64_t>(atomicAdd(pl.claims, 1ULL));
          const int64_t t0 = shared0 + r * pl.run;
          const int64_t t1 = t0 + pl.run < pl.tiles ? t0 + pl.run : pl.tiles;
          for (int64_t t = t0; t < t1; ++t) produce(j++, t);
          r = next;
        }
        if (r == runs + nb - 1) *pl.claims = 0;
      }
      produce(j, -1);
    }
    return;
  }

  if (warp == kConsumerWarps + 1) {  // the storer warp: one thread writes
    if (lane == 0) {
      for (int64_t q = 0;; ++q) {
        const int s = static_cast<int>(q % S);
        mbar_wait(&computed[s], (q / S) & 1);
        const int64_t t = stage_tile[s];
        if (t < 0) break;
        unsigned char* st =
            ring + static_cast<size_t>(s) * stage_bytes + k * row_bytes;
        const int64_t i0 = pl.head + t * tile;
        bulk_store(param + i0, st, p_bytes);
        if (kSlots >= 1) bulk_store(m_ptr + i0, st + p_bytes, s_bytes);
        if (kSlots >= 2)
          bulk_store(v_ptr + i0, st + p_bytes + s_bytes, s_bytes);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the stage is free once the copies have read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&empty[s]);
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    return;
  }

  // the consumer warps: the ring's tiles, until the end mark
  for (int64_t q = 0;; ++q) {
    const int s = static_cast<int>(q % S);
    mbar_wait(&full[s], (q / S) & 1);
    if (stage_tile[s] < 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&computed[s]);
      break;
    }
    unsigned char* st = ring + static_cast<size_t>(s) * stage_bytes;
    const G* g_s = reinterpret_cast<const G*>(st);
    P* p_s = reinterpret_cast<P*>(st + k * row_bytes);
    float* m_s = reinterpret_cast<float*>(st + k * row_bytes + p_bytes);
    float* v_s = m_s + tile;
    for (int off = threadIdx.x * E; off < tile; off += kConsumers * E) {
      float acc[E], row[E], p[E];
      float m[E] = {}, v[E] = {};  // unused slots stay zero
      Access<G, E>::load(g_s + off, acc);
      for (int r = 1; r < k; ++r) {  // left fold, ascending worker order
        Access<G, E>::load(g_s + r * tile + off, row);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], row[e]);
      }
      Access<P, E>::load(p_s + off, p);
      if (kSlots >= 1) Access<float, E>::load(m_s + off, m);
      if (kSlots >= 2) Access<float, E>::load(v_s + off, v);
      update_elems<OPT, G, E>(h, pl, lr, bc1, bc2, acc, p, m, v);
      Access<P, E>::store(p_s + off, p);
      if (kSlots >= 1) Access<float, E>::store(m_s + off, m);
      if (kSlots >= 2) Access<float, E>::store(v_s + off, v);
    }
    // the results, written through the generic proxy, are read by the
    // storer's bulk copies (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&computed[s]);
  }

  // the edge: [0, head) and [head + tiles * tile, n), element by element
  const int64_t body_end = pl.head + pl.tiles * tile;
  const int64_t edge = pl.head + (pl.n - body_end);
  for (int64_t x = b * kConsumers + threadIdx.x; x < edge;
       x += nb * kConsumers) {
    const int64_t i = x < pl.head ? x : body_end + (x - pl.head);
    const int64_t src = src_index(pl, i);
    float acc[1], row[1], p[1];
    float m[1] = {}, v[1] = {};
    Access<G, 1>::load(static_cast<const G*>(rows.p[0]) + src, acc);
    for (int r = 1; r < k; ++r) {
      Access<G, 1>::load(static_cast<const G*>(rows.p[r]) + src, row);
      acc[0] = __fadd_rn(acc[0], row[0]);
    }
    Access<P, 1>::load(param + i, p);
    if (kSlots >= 1) m[0] = m_ptr[i];
    if (kSlots >= 2) v[0] = v_ptr[i];
    update_elems<OPT, G, 1>(h, pl, lr, bc1, bc2, acc, p, m, v);
    Access<P, 1>::store(param + i, p);
    if (kSlots >= 1) m_ptr[i] = m[0];
    if (kSlots >= 2) v_ptr[i] = v[0];
  }
}

// The element offset (0-15) at which every pointer is 16-byte aligned, or
// -1 if there is none.
int common_head(const void* const* rows, int k, size_t g_size,
                const void* param, size_t p_size, const void* m,
                const void* v) {
  for (int h = 0; h < 16; ++h) {
    auto at = [h](const void* ptr, size_t size) {
      return ptr == nullptr ||
             (reinterpret_cast<uintptr_t>(ptr) + h * size) % 16 == 0;
    };
    bool ok = at(param, p_size) && at(m, 4) && at(v, 4);
    for (int r = 0; ok && r < k; ++r) ok = at(rows[r], g_size);
    if (ok) return h;
  }
  return -1;
}

template <int OPT, typename G, typename P, int CAP>
int launch(const void* const* row_ptrs, const Plan& pl, void* param, float* m,
           float* v, const float* scalars, const Hyper& h,
           cudaStream_t stream) {
  constexpr int kSlots = OPT == kSgd ? 0 : (OPT == kMomentum ? 1 : 2);
  auto kernel = fused_agg_opt_kernel<OPT, G, P, CAP>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int smem = pl.stages * pl.tile *
                   static_cast<int>(pl.k * sizeof(G) + sizeof(P) +
                                    kSlots * sizeof(float));
  // one block an SM, never more blocks than tiles (or edge work)
  const int64_t edge = pl.n - pl.tiles * pl.tile;
  const int64_t want =
      pl.tiles > 0 ? pl.tiles : (edge + kConsumers - 1) / kConsumers;
  const int64_t sms = pbox::sm_count();
  const int blocks =
      static_cast<int>(want < sms ? (want > 0 ? want : 1) : sms);
  Rows<CAP> rows{};
  for (int r = 0; r < pl.k; ++r) rows.p[r] = row_ptrs[r];
  kernel<<<blocks, kThreads, smem, stream>>>(rows, static_cast<P*>(param), m,
                                             v, scalars, pl, h);
  return 0;
}

template <int OPT, typename G, typename P>
int launch_cap(const void* const* rows, Plan pl, void* param, float* m,
               float* v, const float* scalars, const Hyper& h,
               cudaStream_t stream) {
  constexpr int kSlots = OPT == kSgd ? 0 : (OPT == kMomentum ? 1 : 2);
  constexpr int64_t E = (sizeof(G) == 2 || sizeof(P) == 2) ? 8 : 4;
  const int64_t elem_bytes = pl.k * sizeof(G) + sizeof(P) + kSlots * 4;
  // the head where every pointer is 16-byte aligned; a chunk table's
  // pieces start at chunk starts, which are aligned only at head 0
  const int head = common_head(rows, pl.k, sizeof(G), param, sizeof(P), m, v);
  const bool aligned =
      head >= 0 && (pl.chunk_ids == nullptr ||
                    (head == 0 && pl.chunk_elems * sizeof(G) % 16 == 0));
  pl.head = aligned ? (head < pl.n ? head : pl.n) : pl.n;
  // the tile: halved from kMaxTile while the ring is shallower than
  // kMinStages, or (down to kMinTile) while the slab has fewer than two
  // rings' worth of tiles an SM
  const int64_t sms = pbox::sm_count();
  int64_t tile = kMaxTile, stages = 0;
  for (;; tile /= 2) {
    stages = kSmemBudget / (tile * elem_bytes);
    if (stages > kMaxStages) stages = kMaxStages;
    const int64_t tiles = (pl.n - pl.head) / tile;
    const bool shallow = stages < kMinStages;
    const bool few = tile > kMinTile && tiles < 2 * sms * stages;
    if (tile <= E || !(shallow || few)) break;
  }
  if (stages < 2) {  // no ring fits (thousands of rows): every element is edge
    pl.head = pl.n;
    tile = E;
    stages = 1;
  }
  pl.tile = static_cast<int>(tile);
  pl.stages = static_cast<int>(stages);
  pl.tiles = (pl.n - pl.head) / tile;
  const int64_t run = kRunBytes / (tile * elem_bytes);
  pl.run = static_cast<int>(run > 1 ? run : 1);
  if (pl.k <= kCaps[0])
    return launch<OPT, G, P, kCaps[0]>(rows, pl, param, m, v, scalars, h, stream);
  return launch<OPT, G, P, kCaps[1]>(rows, pl, param, m, v, scalars, h, stream);
}

template <int OPT>
int launch_types(const void* const* rows, const Plan& pl, void* param,
                 float* m, float* v, const float* scalars, int grad_bf16,
                 int param_bf16, const Hyper& h, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (grad_bf16 && param_bf16)
    return launch_cap<OPT, bf16, bf16>(rows, pl, param, m, v, scalars, h, stream);
  if (grad_bf16)
    return launch_cap<OPT, bf16, float>(rows, pl, param, m, v, scalars, h, stream);
  if (param_bf16)
    return launch_cap<OPT, float, bf16>(rows, pl, param, m, v, scalars, h, stream);
  return launch_cap<OPT, float, float>(rows, pl, param, m, v, scalars, h, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  rows: a host array of k device
// pointers, the present gradient rows in ascending worker order (f32 or
// bf16, one dtype); has_zero: the caller's rows included null (zero) rows;
// chunk_ids: null, or a device int64 table of the shard's chunk ids, each
// row then being a worker's whole (num_chunks, chunk_elems) push; param:
// (n,) f32 or bf16; m, v: (n,) f32 or null per the optimizer; scalars: 4
// f32 on the device; grad_scale multiplies the folded sum when has_scale;
// claims: a device word that is zero and that no launch on another stream
// uses (the launch leaves it zero).  Updates param, m and v in place on
// `stream` and returns the launch's CUDA error (0 on success).
extern "C" int fused_agg_opt_launch(
    const void* const* rows, int k, int has_zero, const int64_t* chunk_ids,
    int64_t chunk_elems, void* param, void* m, void* v, const void* scalars,
    int64_t n, int grad_bf16, int param_bf16, int opt, int has_wd, float wd,
    float mu, int nesterov, float b1, float b2, float eps, float omb1,
    float omb2, float inv_k, int has_scale, float grad_scale,
    unsigned long long* claims, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || k > kCaps[1] || claims == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{wd, mu, b1, b2, eps, omb1, omb2, inv_k, has_wd, nesterov};
  const Plan pl{chunk_ids, chunk_elems, n, 0, 0, k, 0, 0, 0,
                has_zero, has_scale, grad_scale, claims};
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear any stale error so the return is this launch's
  int rc;
  switch (opt) {
    case kSgd:
      rc = launch_types<kSgd>(rows, pl, param, mf, vf, sc, grad_bf16, param_bf16, h, s);
      break;
    case kMomentum:
      rc = launch_types<kMomentum>(rows, pl, param, mf, vf, sc, grad_bf16, param_bf16, h, s);
      break;
    case kAdam:
      rc = launch_types<kAdam>(rows, pl, param, mf, vf, sc, grad_bf16, param_bf16, h, s);
      break;
    case kAdamW:
      rc = launch_types<kAdamW>(rows, pl, param, mf, vf, sc, grad_bf16, param_bf16, h, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
