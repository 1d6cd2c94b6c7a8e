// K2: brute-force 5-NN of queries against a masked target cloud.
//
// Replaces the Pallas TPU kernel lego_loam_tpu/ops/pallas_knn.py
// (pallas_topk_l2 / _knn_kernel / _insert_sorted), which streams target
// tiles through the MXU and merges a running sorted top-k per query.
//
// Computes, per query q: the 5 targets t with the smallest
// d2 = max(|q|^2 + |t|^2 - 2 q.t, 0) among unmasked targets, sorted by d2;
// equal distances keep the earlier index. Missing neighbours are index -1
// with d2 = 1e30. groups > 1 follows the TPU kernel's approximation: within
// each tile of `tile` targets, lane l only offers the nearest of targets
// l, l+L, ..., l+(groups-1)L (L = tile / groups, the first wins ties).
//
// Bound on this card: ~8 fp32 operations per (query, target) pair against
// 67 TFLOP/s; the bytes (12 per point) are negligible, so it is operation
// bound. The first design (one thread per query walking 1,024-4,096 targets)
// was bound instead by the latency of one thread's dependent chain, with a
// few warps per SM to hide it. Giving each thread its own short list does
// not cure that: every list starts empty, so in its first few hundred
// targets almost every step inserts into some lane's list, and the warp
// runs each divergent insert for all 32 lanes.
//
// Design of the exact path (groups == 1):
//  - A warp holds 4 queries (R = 4 independent FMA chains); its 32 lanes
//    walk 32 targets a step, lane l its own chunk of the split, so that a
//    step samples 32 parts of the cloud (map and feature clouds are ordered
//    along the scan, and walked in order a list would keep improving, each
//    time with an insert). A block holds 8 warps (32 queries) that share
//    each 256-target tile. The target range is also split over gridDim.y (a
//    few hundred targets per lane), so the path's shapes put 256-2,048
//    warps on the card.
//  - The tiles go through a ring of 8 slots in shared memory with a full
//    and an empty mbarrier per slot: every thread copies its share of tile
//    k+7 by cp.async (which arrives on the slot's full barrier when it
//    lands) while tile k is scanned, and each warp arrives on the empty
//    barrier when it is done with a slot. So a warp busy with candidates
//    holds up the others only when it falls 7 tiles behind, and a tile is
//    read from L2 once per block, not once per warp. A lane turns its
//    target into |t|^2 (+inf where masked) and each pair costs 3 FMAs,
//    e = |t|^2 - 2 q.t, and one compare.
//  - The 5-best list of each query is the warp's, kept alike in all 32
//    lanes, so its threshold falls as the whole warp's targets stream by.
//    The compare is against thr = (next float after the 5th best d2) -
//    |q|^2 rounded up: since fl(|q|^2 + e) is monotone in e, d2 <= 5th best
//    implies e < thr, so the filter never drops a candidate. A step with a
//    candidate (a warp vote) takes them lane by lane: the warp broadcasts
//    each e and index, every lane computes the exact d2 = max(|q|^2 + e, 0)
//    and inserts it by its (d2, index) key, uniformly. So the list is the
//    top 5 by (d2, index) in whatever order the targets came, and a
//    duplicate target never displaces the earlier copy. The first step,
//    where every lane has a candidate, fills the lists by five warp-wide
//    (d2, index) minima instead.
//  - Where the targets were split over blocks, each block writes its lists
//    to scratch, and the last block of a query block to finish (a ticket
//    from an atomic counter, which it resets) merges the splits in split
//    order with a strict `<`: one launch, no merge kernel.
// The grouped path (groups > 1, off the main path) keeps the first, simpler
// design, one thread per query, and shares the ticket merge.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kK = 5;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
// exact path
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 4;             // queries per warp
constexpr int kQB = kWarps * kR;  // queries per block
constexpr int kBT = 256;          // targets per tile
constexpr int kBSteps = kBT / 32;  // warp steps per tile
constexpr int kStages = 8;        // tiles in the ring
// grouped path
constexpr int kGQ = 128;  // queries (threads) per block

// Insert (d, i) into the sorted list: it goes after the entries it does
// not beat (ties keep the earlier arrival first) and shifts the rest down.
__device__ __forceinline__ void insert5(float d, int i, float (&bd)[kK],
                                        int (&bi)[kK]) {
  bool shift = false;
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    shift = shift || d < bd[s];
    if (shift) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

// (d, i) before (bd, bi)? Empty slots (index -1) sort after real ones.
__device__ __forceinline__ bool key_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && static_cast<unsigned>(i) < static_cast<unsigned>(bi));
}

// insert5 by (d2, index) keys, for candidates that arrive in any order.
__device__ __forceinline__ void insert5_key(float d, int i, float (&bd)[kK],
                                            int (&bi)[kK]) {
  bool shift = false;
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    shift = shift || key_less(d, i, bd[s], bi[s]);
    if (shift) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

// The filter on e = |t|^2 - 2 q.t that passes every pair whose d2 can
// still enter a list whose 5th entry is bd4: fl(qq + e) is monotone in e,
// so fl(qq + e) <= bd4 implies qq + e < the next float, i.e. e < thr.
__device__ __forceinline__ float filter(float bd4, float qq) {
  return __fsub_ru(__int_as_float(__float_as_int(bd4) + 1), qq);
}

__device__ __forceinline__ void clear5(float (&bd)[kK], int (&bi)[kK]) {
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    bd[s] = kBig;
    bi[s] = -1;
  }
}

// For each of the kR queries, the 5 smallest of the lanes' (d, idx) keys
// (d = +inf where a lane has none): five warp-wide minima, the queries'
// shuffle chains side by side. Every lane ends with the same lists.
__device__ __forceinline__ void warp_top5(float (&d)[kR], int idx,
                                          float (&bd)[kR][kK], int (&bi)[kR][kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float m[kR];
    int w[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[r] = d[r];
      w[r] = idx;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float m2 = __shfl_xor_sync(kFull, m[r], o);
        const int w2 = __shfl_xor_sync(kFull, w[r], o);
        if (key_less(m2, w2, m[r], w[r])) {
          m[r] = m2;
          w[r] = w2;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (m[r] < kBig) {  // the same in every lane
        bd[r][k] = m[r];
        bi[r][k] = w[r];
        if (idx == w[r]) d[r] = CUDART_INF_F;
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_u32(b)), "r"(parity) : "memory");
}

// Copies 4 bytes, of which the first n (0-4) come from src, the rest are 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}

// The calling thread holds its block's sorted list of query qi (own = it
// holds one). With S == 1 it is the answer. Otherwise each block writes it
// to part (S, Q, 5), and the last block of this query block to arrive merges
// the S lists in split order (split s holds smaller indices than split s+1,
// so a strict `<` keeps the earlier index on ties) and resets the counter.
__device__ void finish(float (&bd)[kK], int (&bi)[kK], bool own, int qi, int Q,
                       int S, float* __restrict__ part_d,
                       int* __restrict__ part_i, float* __restrict__ out_d,
                       int* __restrict__ out_i, int* __restrict__ counters) {
  __shared__ int s_last;
  own = own && qi < Q;
  if (S == 1) {
    if (own) {
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        out_d[static_cast<size_t>(qi) * kK + s] = bd[s];
        out_i[static_cast<size_t>(qi) * kK + s] = bi[s];
      }
    }
    return;
  }
  if (own) {
    const size_t o = (static_cast<size_t>(blockIdx.y) * Q + qi) * kK;
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      part_d[o + s] = bd[s];
      part_i[o + s] = bi[s];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (own) {
    clear5(bd, bi);
    for (int sp = 0; sp < S; ++sp) {
      const size_t o = (static_cast<size_t>(sp) * Q + qi) * kK;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float d = __ldcg(part_d + o + k);
        if (!(d < bd[kK - 1])) break;  // each list is sorted
        insert5(d, __ldcg(part_i + o + k), bd, bi);
      }
    }
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      out_d[static_cast<size_t>(qi) * kK + s] = bd[s];
      out_i[static_cast<size_t>(qi) * kK + s] = bi[s];
    }
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

__global__ void __launch_bounds__(kThreads) knn_top5_kernel(
    const float* __restrict__ q, const float* __restrict__ t,
    const uint8_t* __restrict__ mask, int Q, int T, int split_len, int S,
    float* __restrict__ part_d, int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i,
    int* __restrict__ counters) {
  // The ring of target tiles: lane l's 8 targets as 24 floats at l * kLane
  // (one spare word, so the lanes' reads fall in 32 different banks).
  constexpr int kLane = 3 * kBSteps + 1;
  __shared__ float raw[kStages][32 * kLane];
  __shared__ uint8_t live[kStages][kBT];   // and their mask bytes, 8 a lane
  __shared__ uint64_t full[kStages], empty[kStages];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQB + warp * kR;  // this warp's first query
  const int begin = blockIdx.y * split_len;
  const int end = min(T, begin + split_len);
  // Lane l walks its own chunk of `chunk` targets from begin + l * chunk,
  // 8 a tile: a step's 32 targets come from 32 parts of the cloud, so a
  // list sees the whole cloud early even when the targets are ordered
  // along the scan, and its threshold falls fast.
  const int chunk = (end - begin + kBT - 1) / kBT * kBSteps;
  const int ntiles = chunk / kBSteps;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kThreads);  // every thread's copies of the tile
      mbar_init(&empty[s], kWarps);   // every warp done with the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Queries as -2q: x * (-2 qx) is exactly (-2 x) * qx.
  float mx[kR], my[kR], mz[kR], qq[kR], thr[kR], bd[kR][kK];
  int bi[kR][kK];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + r;
    const float x = qi < Q ? q[3 * qi] : 0.f;
    const float y = qi < Q ? q[3 * qi + 1] : 0.f;
    const float z = qi < Q ? q[3 * qi + 2] : 0.f;
    mx[r] = -2.f * x;
    my[r] = -2.f * y;
    mz[r] = -2.f * z;
    qq[r] = x * x + y * y + z * z;
    clear5(bd[r], bi[r]);
    thr[r] = filter(kBig, qq[r]);
  }

  // Tile j into slot j % kStages, once every warp is done with the tile
  // before it there: the block copies each lane's 8 targets (24 contiguous
  // floats) and 64 threads the lanes' mask bytes, by cp.async, which arrives
  // on full[slot] when they land. Bytes past the end arrive as zeros:
  // masked.
  static_assert(3 * kBT % kThreads == 0, "whole words a thread");
  auto produce = [&](int j) {
    if (j >= ntiles) return;
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
#pragma unroll
    for (int i = 0; i < 3 * kBT / kThreads; ++i) {
      const int w = tid + kThreads * i, l = w / (3 * kBSteps), c = w - l * (3 * kBSteps);
      const int g = begin + l * chunk + j * kBSteps;  // the lane's first target
      const bool in = 3 * (g - begin) + c < 3 * (end - begin);
      cp_async4(&raw[s][l * kLane + c], t + 3 * static_cast<size_t>(in ? g : begin) + (in ? c : 0), in ? 4 : 0);
    }
    if (tid < 2 * 32) {
      const int g4 = begin + (tid >> 1) * chunk + j * kBSteps + 4 * (tid & 1);
      cp_async4(&live[s][4 * tid], mask + (g4 < end ? g4 : begin), max(0, min(4, end - g4)));
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(&full[s])) : "memory");
  };

  for (int j = 0; j < kStages - 1; ++j) produce(j);
  bool seeded = false;
  for (int k = 0; k < ntiles; ++k) {
    produce(k + kStages - 1);
    const int slot = k % kStages;
    mbar_wait(&full[slot], (k / kStages) & 1);  // tile k has landed
    const float* rw = raw[slot];
    const uint8_t* lv = live[slot];
    // Not unrolled: the kernel's code must stay small enough for the
    // instruction cache, with the rare paths below inlined once.
#pragma unroll 1
    for (int s = 0; s < kBSteps; ++s) {
      const float* v = rw + lane * kLane + 3 * s;
      const float x = v[0], y = v[1], z = v[2];
      const float tt = lv[8 * lane + s] ? fmaf(x, x, fmaf(y, y, z * z)) : CUDART_INF_F;
      const int idx = begin + lane * chunk + k * kBSteps + s;
      float e[kR];
      bool cand = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        e[r] = fmaf(x, mx[r], fmaf(y, my[r], fmaf(z, mz[r], tt)));
        cand = cand || e[r] < thr[r];
      }
      if (!__any_sync(kFull, cand)) continue;
      if (!seeded) {  // empty lists: the first step's 5 best by (d2, index)
        seeded = true;
        float d[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) d[r] = e[r] < CUDART_INF_F ? fmaxf(qq[r] + e[r], 0.f) : CUDART_INF_F;
        warp_top5(d, idx, bd, bi);
#pragma unroll
        for (int r = 0; r < kR; ++r) thr[r] = filter(bd[r][kK - 1], qq[r]);
        continue;
      }
      unsigned m[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) m[r] = __ballot_sync(kFull, e[r] < thr[r]);
      // The same in every lane: each query's candidates, the four queries'
      // chains side by side.
      while (m[0] | m[1] | m[2] | m[3]) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (!m[r]) continue;
          const int l = __ffs(m[r]) - 1;
          m[r] &= m[r] - 1;
          const float d = fmaxf(qq[r] + __shfl_sync(kFull, e[r], l), 0.f);
          const int i = __shfl_sync(kFull, idx, l);
          if (key_less(d, i, bd[r][kK - 1], bi[r][kK - 1])) {
            insert5_key(d, i, bd[r], bi[r]);
            thr[r] = filter(bd[r][kK - 1], qq[r]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the slot: it may refill
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // Lane r answers for query q0 + r.
  float fd[kK];
  int fi[kK];
  clear5(fd, fi);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (lane == r) {
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        fd[s] = bd[r][s];
        fi[s] = bi[r][s];
      }
    }
  }
  finish(fd, fi, lane < kR, q0 + lane, Q, S, part_d, part_i, out_d, out_i, counters);
}

__global__ void __launch_bounds__(kGQ) knn_top5_grouped_kernel(
    const float* __restrict__ q, const float* __restrict__ t,
    const uint8_t* __restrict__ mask, int Q, int T, int tile, int groups,
    int split_len, int S, float* __restrict__ part_d,
    int* __restrict__ part_i, float* __restrict__ out_d,
    int* __restrict__ out_i, int* __restrict__ counters) {
  extern __shared__ float4 st[];
  const int qi = blockIdx.x * kGQ + threadIdx.x;
  const int begin = blockIdx.y * split_len;
  const int end = min(T, begin + split_len);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  const float qq = qx * qx + qy * qy + qz * qz;
  float bd[kK];
  int bi[kK];
  clear5(bd, bi);
  const int lanes = tile / groups;

  for (int t0 = begin; t0 < end; t0 += tile) {
    for (int j = threadIdx.x; j < tile; j += kGQ) {
      const int g = t0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (g < end) {
        v.x = t[3 * g];
        v.y = t[3 * g + 1];
        v.z = t[3 * g + 2];
        v.w = mask[g] ? v.x * v.x + v.y * v.y + v.z * v.z : CUDART_INF_F;
      }
      st[j] = v;
    }
    __syncthreads();
    for (int l = 0; l < lanes; ++l) {
      float gm = CUDART_INF_F;
      int gi = -1;
      for (int g = 0; g < groups; ++g) {
        const float4 v = st[g * lanes + l];
        const float d = fmaxf(qq + v.w - 2.f * (qx * v.x + qy * v.y + qz * v.z), 0.f);
        if (d < gm) {
          gm = d;
          gi = t0 + g * lanes + l;
        }
      }
      if (gm < bd[kK - 1]) insert5(gm, gi, bd, bi);
    }
    __syncthreads();
  }
  finish(bd, bi, true, qi, Q, S, part_d, part_i, out_d, out_i, counters);
}

}  // namespace

// q: (Q, 3) f32, t: (T, 3) f32, mask: (T,) bool -> out_d (Q, 5) f32,
// out_i (Q, 5) int32; mask 4-byte aligned. The target range is cut into S splits of split_len
// targets (a multiple of the tile: 256 for groups == 1, `tile` otherwise);
// with S > 1 the per-split lists go to part_d/part_i (S, Q, 5) and the last
// block of each query block merges them. counters: one zeroed int per query
// block (32 queries for groups == 1, 128 otherwise), left zeroed. Returns
// the launch's cudaError_t.
extern "C" int knn_top5_launch(const void* q, const void* t, const void* mask,
                               int Q, int T, int tile, int groups,
                               int split_len, int S, void* part_d,
                               void* part_i, void* out_d, void* out_i,
                               void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* tp = static_cast<const float*>(t);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  int* cnt = static_cast<int*>(counters);
  if (groups > 1) {
    const dim3 grid((Q + kGQ - 1) / kGQ, S);
    const size_t smem = static_cast<size_t>(tile) * sizeof(float4);
    knn_top5_grouped_kernel<<<grid, kGQ, smem, st>>>(qp, tp, mp, Q, T, tile, groups,
                                                     split_len, S, pd, pi, od, oi, cnt);
  } else {
    const dim3 grid((Q + kQB - 1) / kQB, S);
    knn_top5_kernel<<<grid, kThreads, 0, st>>>(qp, tp, mp, Q, T, split_len, S, pd, pi,
                                               od, oi, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
