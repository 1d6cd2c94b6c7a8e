// K1: connected components of the range image, one thread-block cluster
// per scan.
//
// Replaces the Pallas TPU kernel lego_loam_tpu/ops/pallas_cc.py
// (pallas_label_prop / _cc_kernel), which runs segmented run-min sweeps by
// doubling rolls in VMEM and stops after max_iters=64 sweeps.
//
// Computes: for 4-neighbour connectivity masks left/right/up/down (columns
// wrap: column 0's left edge and column W-1's right edge join the two ends)
// and a candidate mask, the label of every candidate pixel is the row-major
// index of the smallest pixel of its component; non-candidates get H*W.
// This is exactly the fixpoint of lego_loam_tpu's converged_labels. The
// masks are symmetric, as the range image's angle test makes them
// (left = right rolled by one column, up = down shifted by one row), so the
// kernel reads each link once: `right` for the horizontal links and `down`
// for the vertical ones. A link counts only between two candidates.
//
// Design: the scan's rows are split over the CTAs of one cluster (up to 8;
// at 16/32/64 rows, 2/4/8 rows a CTA). Each CTA keeps its rows' labels
// (int32, global row-major pixel indices) and packed link flags in its own
// shared memory: 72 KB at 8 x 1800. A label points at a smaller pixel of
// the same component; a root points at itself.
//  1. Row runs first: a warp ballots the "no link from the left" bits of 32
//     columns into a word, one warp scans each row's words for the last
//     break at or before every column, and every pixel takes the first
//     column of its run of right-links as its label (the run that wraps
//     through column W-1 to column 0 takes column 0). Each run is then one
//     tree whose root is its minimum pixel.
//  2. The runs are joined through the vertical links, each contact between
//     two runs once (from its first column), by a lock-free union-find:
//     the larger of two roots is hooked under the smaller by a CAS that
//     only succeeds while it is still a root (else the chase resumes from
//     where it now points), and chases halve their paths. A hook is never
//     undone and labels only move to smaller pixels of the same component,
//     so when every union has returned, each component is one tree whose
//     root is its minimum, whatever the order of the CASes. No rounds, no
//     iteration cap, no convergence test.
//     a. First the links inside each CTA's rows, in its own shared memory;
//        then every pixel points at its local root.
//     b. Then, after a cluster barrier, the links from each CTA's last row
//        to the next CTA's first row, from local root to local root,
//        through distributed shared memory (mapa and relaxed cluster-scope
//        loads, stores and CAS). Only local roots change; other pixels
//        keep pointing at their local root.
//  3. After a second cluster barrier, each local root takes its final
//     root, and every pixel its local root's.
//
// Bound on this card: a scan moves 5 x H*W mask bytes in and 4 x H*W label
// bytes out (0.08 us at 16 x 1800 and 3.35 TB/s). The kernel is latency
// bound on its chains of dependent shared-memory accesses and its three
// cluster barriers: the row-run pass takes the long (1800-column) dimension
// out of the chains, the local pass keeps most of them in the CTA's own
// shared memory, and a chunk's scans go in one launch, one cluster each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;
// kLink: joined to column c+1 (wrapping). kHook: a down-link that is not
// a copy of the one to its left (the pixel to the left and the one below it
// are joined to this pixel and to the one below it), so each contact
// between two runs is hooked once, from its first column.
// kRoot: the root of this pixel's piece within the CTA's rows.
constexpr uint8_t kCand = 1, kLink = 2, kHook = 4, kRoot = 8;

// Distributed shared memory through 32-bit shared::cluster addresses and
// relaxed cluster-scope accesses; cluster.sync() orders them between passes.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return r;
}
__device__ __forceinline__ int ld_cluster(uint32_t a) {
  int v;
  asm volatile("ld.relaxed.cluster.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ int cas_cluster(uint32_t a, int cmp, int v) {
  int old;
  asm volatile("atom.relaxed.cluster.shared::cluster.cas.b32 %0, [%1], %2, %3;"
               : "=r"(old) : "r"(a), "r"(cmp), "r"(v) : "memory");
  return old;
}

// Union-find over the labels of the whole scan: this CTA's rows in its own
// shared memory (lab), the others' through the cluster window (base[r]:
// rank r's lab). A label points at a smaller pixel of the same component;
// a root points at itself.
struct Labels {
  volatile int32_t* lab;
  uint32_t base[kMaxCluster];
  int rank, cw;  // own rank; pixels per CTA

  __device__ int load(int x) const {
    const int r = x / cw, o = x - r * cw;
    return r == rank ? lab[o] : ld_cluster(base[r] + 4u * o);
  }
  __device__ void store(int x, int v) const {
    const int r = x / cw, o = x - r * cw;
    if (r == rank) lab[o] = v;
    else st_cluster(base[r] + 4u * o, v);
  }
  __device__ int cas(int x, int cmp, int v) const {
    const int r = x / cw, o = x - r * cw;
    return r == rank ? atomicCAS(const_cast<int32_t*>(lab) + o, cmp, v)
                     : cas_cluster(base[r] + 4u * o, cmp, v);
  }
  __device__ int root(int x) const {  // read-only chase
    int y = load(x);
    while (y != x) {
      x = y;
      y = load(x);
    }
    return x;
  }
  // Chase with path halving: a non-root is pointed at its grandparent, an
  // ancestor on the same path, so a store never touches a root.
  __device__ int find(int x) const {
    while (true) {
      const int y = load(x);
      if (y == x) return x;
      const int z = load(y);
      if (z == y) return y;
      store(x, z);
      x = z;
    }
  }
  // Join the trees of a and b: the larger root is hooked under the smaller
  // one by a CAS that only succeeds while it is still a root, so no hook is
  // ever undone; on failure the chase starts again from where it now points.
  __device__ void unite(int a, int b) const {
    a = find(a);
    b = find(b);
    while (a != b) {
      const int hi = max(a, b), lo = min(a, b);
      const int old = cas(hi, hi, lo);
      if (old == hi) return;
      a = find(old);
      b = find(lo);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) cc_label_prop_kernel(
    const uint8_t* __restrict__ right, const uint8_t* __restrict__ down,
    const uint8_t* __restrict__ cand, int32_t* __restrict__ out, int H, int W,
    int rows, int csize) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int scan = blockIdx.x / csize;
  const int HW = H * W;
  const int cw = rows * W;  // pixels of this CTA
  const int nw = (W + 31) / 32;  // ballot words per row
  const int row0 = rank * rows;
  const int pix0 = row0 * W;  // global index of this CTA's first pixel
  const size_t base = static_cast<size_t>(scan) * HW;

  // Dynamic shared memory, as k1_layout sizes it.
  extern __shared__ int32_t smem[];
  int32_t* lab = smem;                                        // cw
  uint32_t* brk = reinterpret_cast<uint32_t*>(lab + cw);       // rows * nw
  int32_t* last = reinterpret_cast<int32_t*>(brk + rows * nw);  // rows * nw
  uint8_t* flags = reinterpret_cast<uint8_t*>(last + rows * nw);  // cw
  __shared__ Labels L;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  // Flags of this CTA's pixels: candidate, effective right link (wrapping),
  // effective down link (the pixel below may lie in the next CTA's rows).
  const uint8_t* R = right + base;
  const uint8_t* D = down + base;
  const uint8_t* C = cand + base;
#pragma unroll 4
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    const int p = pix0 + o;
    const int r = p / W, c = p - r * W;
    // Every byte is loaded unconditionally (clamped in range), so the loads
    // of a pixel are in flight together.
    const int pr = r * W + (c == W - 1 ? 0 : c + 1);
    const int pl = c > 0 ? p - 1 : p;
    const int dw = r < H - 1 ? W : 0;
    const bool cd = C[p], rp = R[p], cr = C[pr], dp = D[p], cb = C[p + dw];
    const bool rl = R[pl], cl = C[pl], dl = D[pl], rlb = R[pl + dw], clb = C[pl + dw];
    const bool lk = cd && rp && cr;
    const bool dn = cd && dw && dp && cb;
    // Column 0 always hooks, so a row joined all round keeps one hook.
    const bool dup = c > 0 && rl && cl && dl && rlb && clb;
    flags[o] = (cd ? kCand : 0) | (lk ? kLink : 0) | (dn && !dup ? kHook : 0);
  }
  if (threadIdx.x == 0) {
    L.lab = lab;
    L.rank = rank;
    L.cw = cw;
  }
  if (threadIdx.x < csize) L.base[threadIdx.x] = map_rank(lab, threadIdx.x);
  __syncthreads();

  // 1. Row runs. Break bit of column c: c == 0, or no link from c-1 to c.
  for (int w = warp; w < rows * nw; w += nwarps) {
    const int lr = w / nw, c = (w - lr * nw) * 32 + lane;
    bool b = false;
    if (c < W) b = c == 0 || !(flags[lr * W + c - 1] & kLink);
    const uint32_t word = __ballot_sync(0xffffffffu, b);
    if (lane == 0) brk[w] = word;
  }
  __syncthreads();
  // last[lr * nw + i]: the last break column in words 0..i of row lr.
  for (int lr = warp; lr < rows; lr += nwarps) {
    int carry = -1;
    for (int i0 = 0; i0 < nw; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t word = i < nw ? brk[lr * nw + i] : 0u;
      int v = word ? i * 32 + 31 - __clz(word) : -1;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = max(v, u);
      }
      v = max(v, carry);
      if (i < nw) last[lr * nw + i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    const int lr = o / W, c = o - lr * W;
    int start = HW;
    if (flags[o] & kCand) {
      const int w = c >> 5, l = c & 31;
      const uint32_t m = brk[lr * nw + w] & (l == 31 ? 0xffffffffu : ((2u << l) - 1u));
      start = m ? w * 32 + 31 - __clz(m) : last[lr * nw + w - 1];
      // The run through column W-1 continues at column 0 when they link.
      if ((flags[lr * W + W - 1] & kLink) && start == last[lr * nw + nw - 1]) start = 0;
      start += (row0 + lr) * W;
    }
    lab[o] = start;
  }
  __syncthreads();

  // 2a. Join the runs through the vertical links inside this CTA's rows, in
  // its own shared memory; then every pixel points at its local root, the
  // smallest pixel of its piece.
  for (int o = threadIdx.x; o + W < cw; o += blockDim.x) {
    if (flags[o] & kHook) L.unite(pix0 + o, pix0 + o + W);
  }
  __syncthreads();
  volatile int32_t* vlab = lab;
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    if (flags[o] & kCand) vlab[o] = L.root(pix0 + o);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    if ((flags[o] & kCand) && vlab[o] == pix0 + o) flags[o] |= kRoot;
  }
  cluster.sync();  // every CTA's pieces are labelled before anyone reads them

  // 2b. Join the pieces through the links from each CTA's last row to the
  // next CTA's first row, through distributed shared memory. The chases
  // start at local roots, so only roots' labels change; a pixel that is no
  // local root keeps pointing at its local root.
  for (int o = cw - W + threadIdx.x; rank < csize - 1 && o < cw; o += blockDim.x) {
    if (flags[o] & kHook) L.unite(vlab[o], L.load(pix0 + o + W));
  }
  cluster.sync();  // every link joins one tree: no union is under way

  // 3. Each local root takes its root, then every pixel its local root's.
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    if (flags[o] & kRoot) vlab[o] = L.root(pix0 + o);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < cw; o += blockDim.x) {
    const uint8_t f = flags[o];
    out[base + pix0 + o] = !(f & kCand) ? HW : (f & kRoot) ? vlab[o] : vlab[vlab[o] - pix0];
  }
  cluster.sync();  // no CTA leaves while another may still read its labels
}

}  // namespace

namespace {

cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int B, int cs,
                                 int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Once per layout, before its first launch (not a stream operation, so
// never inside a captured CUDA graph): allows at least `smem` bytes of
// dynamic shared memory a CTA (the largest layout set up so far) and checks
// that the card holds one cluster of `cs` CTAs of `smem` bytes. Returns a
// cudaError_t, cudaErrorInvalidConfiguration where it does not.
extern "C" int cc_label_prop_setup(int cs, int smem) {
  static int allowed = 0;
  if (cs < 1 || cs > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        cc_label_prop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(attr, 1, cs, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cc_label_prop_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// right/down/cand: (B, H, W) bool; out: (B, H, W) int32. One cluster of
// H / rows CTAs (at most 8) per scan on `stream`, `rows` rows and `smem`
// bytes of dynamic shared memory a CTA: the layout is
// lego_loam_torch/ops/segmentation.py::k1_layout's, carved as at the top of
// the kernel, set up once by cc_label_prop_setup. Only the launch and its
// error check, so it may be captured into a CUDA graph. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int cc_label_prop_launch(const void* right, const void* down,
                                    const void* cand, void* out, int B, int H,
                                    int W, int rows, int smem, void* stream) {
  const int cs = H / rows;
  if (cs < 1 || cs > kMaxCluster || cs * rows != H) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(attr, B, cs, smem, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaLaunchKernelEx(&cfg, cc_label_prop_kernel,
                           static_cast<const uint8_t*>(right),
                           static_cast<const uint8_t*>(down),
                           static_cast<const uint8_t*>(cand),
                           static_cast<int32_t*>(out), H, W, rows, cs);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
