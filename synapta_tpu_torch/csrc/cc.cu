// Connected-component labels of (B, H, W) {0,1} float masks -> int32 labels.
//
// Replaces synapta_tpu/ops/pallas_cc.py::connected_components_pallas
// (kernel body _cc_kernel, _seg_scan, _shift). Same semantics: every ink
// pixel starts as y*W + x + 1, then rounds of
//   - 8-conn only: the in-bounds 3x3 neighbour max, times the mask;
//   - a segmented running max along each row, forward then backward;
//   - a segmented running max along each column, forward then backward.
// A segment is a maximal run of ink; the max resets at background. The
// result is each component's max id once converged; background is 0. The
// labels equal the plain twin (synapta_tpu_torch/ops/cc.py) bit for bit.
//
// Rounds: at most `rounds` (max_iters + 1). Labels only grow, so a round
// changed nothing exactly when the sum of the map's labels did not grow;
// the kernel stops after the first such round (never after round 1, as the
// twin always runs a second round). A fixed point stays fixed, so the labels
// equal the Pallas kernel's fixed-round result and the twin's early stop
// alike. The rounds each map took go to `rounds_out`.
//
// What bounds it on the card: one read of the mask and one write of the
// labels, 8.39 MB per (16, 256, 256) call, 2.5 us at 3.35 TB/s. Everything
// between stays on chip: one thread-block cluster holds one map, each CTA a
// band of rows (labels as int32, the mask as bytes) in shared memory for
// every round. The time then goes to the dependent steps of the scans and
// to the cluster barriers (three per round at 8-conn, two at 4-conn), which
// the design keeps few:
//   - 3x3 max as a horizontal 3-max (one warp per row, neighbours by
//     shuffle) then a vertical 3-max (one thread per column, in place with
//     the old row in registers); the halo rows come from the neighbouring
//     CTAs' shared memory (DSMEM) after a cluster barrier;
//   - row scans: one warp per row, 8 elements per lane scanned in order,
//     then a warp-level segmented max scan of the lane carries with
//     shuffles; (value, gate) combine as in pallas_cc.py's pointer doubling;
//   - column scans: two-level. Forward then backward is the same as giving
//     every vertical run its max, so each CTA does that within its band, one
//     thread per column, publishes per column the top run's max, the bottom
//     run's max and whether the band's column is all ink, and after a cluster
//     barrier folds the bands above and below from DSMEM into its edge runs;
//   - the round's "changed" flag is ORed across the cluster with one more
//     barrier; nothing goes back to the host.
// The cluster size is chosen from H*W (at most 8 CTAs, the portable limit);
// a map whose band does not fit 227 KB of shared memory is refused.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kPixelsPerCta = 8192;  // cluster size target: 32 KB of labels
constexpr int kMaxSmem = 232448;     // 227 KB, the opt-in limit of a block

struct Plan {
  int cluster, band, wp;  // CTAs per map, rows per CTA, padded row length
  size_t off_mask, off_exp, off_sum, off_full, off_flag, smem;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

Plan make_plan(int H, int W) {
  Plan p;
  int c = 1;
  while (c < kMaxCluster && (long long)c * kPixelsPerCta < (long long)H * W) c *= 2;
  while (c > 1 && c > H) c /= 2;
  p.cluster = c;
  p.band = (H + c - 1) / c;
  p.wp = (W + 7) & ~7;
  size_t lbl = (size_t)p.band * p.wp * 4;
  p.off_mask = align16(lbl);
  p.off_exp = align16(p.off_mask + (size_t)p.band * p.wp);
  p.off_sum = align16(p.off_exp + 2 * (size_t)p.wp * 4);   // exports: top, bottom
  p.off_full = align16(p.off_sum + 2 * (size_t)p.wp * 4);  // summaries: top, bottom
  p.off_flag = align16(p.off_full + (size_t)p.wp);
  p.smem = p.off_flag + 16;
  return p;
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// (value, gate) of the segmented max: `a` then `b` (b to the right).
__device__ __forceinline__ void seg_combine(int av, bool ag, int& bv, bool& bg) {
  bv = bg ? imax(av, bv) : bv;
  bg = ag && bg;
}

// Segmented running max of one row of `wp` labels, forward then backward,
// by one warp. Lanes own 8 consecutive elements of a 256-element chunk.
__device__ void row_scan(int* lbl, const unsigned char* m, int wp, int lane) {
  const int chunks = (wp + 255) / 256;
  int carry = 0;
  for (int c = 0; c < chunks; ++c) {  // forward
    int x0 = c * 256 + lane * 8;
    bool live = x0 < wp;
    int v[8];
    unsigned char g[8];
    if (live) {
      int4 a = *reinterpret_cast<const int4*>(lbl + x0);
      int4 b = *reinterpret_cast<const int4*>(lbl + x0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      uint2 mm = *reinterpret_cast<const uint2*>(m + x0);
      for (int j = 0; j < 4; ++j) g[j] = (mm.x >> (8 * j)) & 0xff;
      for (int j = 0; j < 4; ++j) g[4 + j] = (mm.y >> (8 * j)) & 0xff;
    } else {
      for (int j = 0; j < 8; ++j) { v[j] = 0; g[j] = 0; }
    }
    int sv = 0;
    bool sg = true;
    for (int j = 0; j < 8; ++j) {
      sv = g[j] ? imax(sv, v[j]) : 0;
      sg = sg && g[j];
    }
    if (lane == 0) seg_combine(carry, true, sv, sg);
    for (int d = 1; d < 32; d *= 2) {
      int pv = __shfl_up_sync(0xffffffffu, sv, d);
      bool pg = __shfl_up_sync(0xffffffffu, (int)sg, d);
      if (lane >= d) seg_combine(pv, pg, sv, sg);
    }
    int run = __shfl_up_sync(0xffffffffu, sv, 1);
    if (lane == 0) run = carry;
    carry = __shfl_sync(0xffffffffu, sv, 31);
    if (live) {
      for (int j = 0; j < 8; ++j) { run = g[j] ? imax(run, v[j]) : 0; v[j] = run; }
      *reinterpret_cast<int4*>(lbl + x0) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(lbl + x0 + 4) = make_int4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncwarp();
  carry = 0;
  for (int c = chunks - 1; c >= 0; --c) {  // backward: lanes mirrored
    int x0 = c * 256 + lane * 8;
    bool live = x0 < wp;
    int v[8];
    unsigned char g[8];
    if (live) {
      int4 a = *reinterpret_cast<const int4*>(lbl + x0);
      int4 b = *reinterpret_cast<const int4*>(lbl + x0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      uint2 mm = *reinterpret_cast<const uint2*>(m + x0);
      for (int j = 0; j < 4; ++j) g[j] = (mm.x >> (8 * j)) & 0xff;
      for (int j = 0; j < 4; ++j) g[4 + j] = (mm.y >> (8 * j)) & 0xff;
    } else {
      for (int j = 0; j < 8; ++j) { v[j] = 0; g[j] = 0; }
    }
    int sv = 0;
    bool sg = true;
    for (int j = 7; j >= 0; --j) {
      sv = g[j] ? imax(sv, v[j]) : 0;
      sg = sg && g[j];
    }
    if (lane == 31) seg_combine(carry, true, sv, sg);
    for (int d = 1; d < 32; d *= 2) {
      int pv = __shfl_down_sync(0xffffffffu, sv, d);
      bool pg = __shfl_down_sync(0xffffffffu, (int)sg, d);
      if (lane + d < 32) seg_combine(pv, pg, sv, sg);
    }
    int run = __shfl_down_sync(0xffffffffu, sv, 1);
    if (lane == 31) run = carry;
    carry = __shfl_sync(0xffffffffu, sv, 0);
    if (live) {
      for (int j = 7; j >= 0; --j) { run = g[j] ? imax(run, v[j]) : 0; v[j] = run; }
      *reinterpret_cast<int4*>(lbl + x0) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(lbl + x0 + 4) = make_int4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Horizontal 3-max of one row in place (the first half of the 3x3 max).
__device__ void row_max3(int* lbl, int wp, int lane) {
  int prev_last = 0;  // old value left of this chunk (0 is neutral: labels >= 0)
  for (int c = 0; c * 256 < wp; ++c) {
    int x0 = c * 256 + lane * 8;
    bool live = x0 < wp;
    int v[8];
    if (live) {
      int4 a = *reinterpret_cast<const int4*>(lbl + x0);
      int4 b = *reinterpret_cast<const int4*>(lbl + x0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      for (int j = 0; j < 8; ++j) v[j] = 0;
    }
    int left = __shfl_up_sync(0xffffffffu, v[7], 1);
    int right = __shfl_down_sync(0xffffffffu, v[0], 1);
    if (lane == 0) left = prev_last;
    // lane 31's right neighbour is the next chunk's first element, not yet
    // written by this warp
    if (lane == 31) right = (x0 + 8 < wp) ? lbl[x0 + 8] : 0;
    prev_last = __shfl_sync(0xffffffffu, v[7], 31);
    if (live) {
      int o[8];
      for (int j = 0; j < 8; ++j) {
        int l = j ? v[j - 1] : left, r = j < 7 ? v[j + 1] : right;
        o[j] = imax(imax(l, v[j]), r);
      }
      *reinterpret_cast<int4*>(lbl + x0) = make_int4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<int4*>(lbl + x0 + 4) = make_int4(o[4], o[5], o[6], o[7]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cc_cluster_kernel(const float* __restrict__ mask, int* __restrict__ labels,
                  int* __restrict__ rounds_out, int H, int W, int max_rounds,
                  int conn8, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, wp = p.wp;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int y0 = rank * p.band;
  const int rows = max(0, min(p.band, H - y0));
  const int nbands = (H + p.band - 1) / p.band;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int* lbl = reinterpret_cast<int*>(smem);
  unsigned char* m = smem + p.off_mask;
  int* exp_top = reinterpret_cast<int*>(smem + p.off_exp);
  int* exp_bot = exp_top + wp;
  int* sum_top = reinterpret_cast<int*>(smem + p.off_sum);
  int* sum_bot = sum_top + wp;
  unsigned char* full = smem + p.off_full;
  int* flag = reinterpret_cast<int*>(smem + p.off_flag);

  // load the band: one read of the mask, labels = id * mask
  const float* mk = mask + (size_t)b * H * W;
  for (int i = tid; i < rows * wp; i += kThreads) {
    int y = i / wp, x = i - y * wp;
    bool ink = x < W && mk[(size_t)(y0 + y) * W + x] != 0.f;
    m[i] = ink;
    lbl[i] = ink ? (y0 + y) * W + x + 1 : 0;
  }
  const int* up_exp = rank > 0 ? cluster.map_shared_rank(exp_bot, rank - 1) : nullptr;
  const int* dn_exp = (rank + 1 < nbands && rows > 0)
                          ? cluster.map_shared_rank(exp_top, rank + 1) : nullptr;
  unsigned long long prev_sum = 0;
  int r = 0;
  cluster.sync();
  while (true) {
    ++r;
    if (conn8) {
      // 3x3 max = vertical 3-max of the horizontal 3-max, times the mask
      for (int y = warp; y < rows; y += kWarps) row_max3(lbl + y * wp, wp, lane);
      __syncthreads();
      if (rows > 0) {
        for (int x = tid; x < wp; x += kThreads) {
          exp_top[x] = lbl[x];
          exp_bot[x] = lbl[(rows - 1) * wp + x];
        }
      }
      cluster.sync();  // exports of every band are ready
      for (int x = tid; x < wp; x += kThreads) {
        int above = up_exp ? up_exp[x] : 0;
        for (int y = 0; y < rows; ++y) {
          int cur = lbl[y * wp + x];
          int below = y + 1 < rows ? lbl[(y + 1) * wp + x] : (dn_exp ? dn_exp[x] : 0);
          lbl[y * wp + x] = m[y * wp + x] ? imax(imax(above, cur), below) : 0;
          above = cur;
        }
      }
      __syncthreads();
    }
    for (int y = warp; y < rows; y += kWarps) row_scan(lbl + y * wp, m + y * wp, wp, lane);
    __syncthreads();
    // columns, level 1: every vertical run of the band gets its max
    unsigned long long sum = 0;
    for (int x = tid; x < wp; x += kThreads) {
      int run = 0;
      bool all = true;
      for (int y = 0; y < rows; ++y) {
        int i = y * wp + x;
        run = m[i] ? imax(run, lbl[i]) : 0;
        all = all && m[i];
        lbl[i] = run;
      }
      run = 0;
      for (int y = rows - 1; y >= 0; --y) {
        int i = y * wp + x;
        run = m[i] ? imax(run, lbl[i]) : 0;
        lbl[i] = run;
        sum += (unsigned)run;
      }
      sum_top[x] = rows ? lbl[x] : 0;
      sum_bot[x] = rows ? lbl[(rows - 1) * wp + x] : 0;
      full[x] = rows > 0 && all;
    }
    cluster.sync();  // band summaries are ready
    // level 2: fold the runs that continue from the bands above and below
    for (int x = tid; x < wp && rows > 0; x += kThreads) {
      int up = 0, dn = 0;
      for (int j = rank - 1; j >= 0; --j) {
        int v = cluster.map_shared_rank(sum_bot, j)[x];
        if (v == 0) break;
        up = imax(up, v);
        if (!cluster.map_shared_rank(full, j)[x]) break;
      }
      for (int j = rank + 1; j < nbands; ++j) {
        int v = cluster.map_shared_rank(sum_top, j)[x];
        if (v == 0) break;
        dn = imax(dn, v);
        if (!cluster.map_shared_rank(full, j)[x]) break;
      }
      if (full[x]) up = dn = imax(up, dn);
      for (int y = 0; y < rows && up > 0; ++y) {  // the top run
        int i = y * wp + x;
        if (!m[i] || lbl[i] >= up) break;
        sum += (unsigned)(up - lbl[i]);
        lbl[i] = up;
      }
      for (int y = rows - 1; y >= 0 && dn > 0; --y) {  // the bottom run
        int i = y * wp + x;
        if (!m[i] || lbl[i] >= dn) break;
        sum += (unsigned)(dn - lbl[i]);
        lbl[i] = dn;
      }
    }
    // labels only grow: the round changed something iff a sum grew
    int changed = __syncthreads_or(sum != prev_sum);
    prev_sum = sum;
    if (tid == 0) flag[r & 1] = changed;
    cluster.sync();  // flags are ready
    int any = 0;
    for (int j = 0; j < C; ++j) any |= cluster.map_shared_rank(flag, j)[r & 1];
    if (r >= max_rounds || (r >= 2 && !any)) break;
  }
  int* out = labels + (size_t)b * H * W + (size_t)y0 * W;
  for (int i = tid; i < rows * W; i += kThreads) {
    int y = i / W, x = i - y * W;
    out[i] = lbl[y * wp + x];
  }
  if (rank == 0 && tid == 0) rounds_out[b] = r;
  cluster.sync();  // no CTA leaves while a peer may still read its memory
}

}  // namespace

// Cluster size and dynamic shared memory of one map; an error when the band
// does not fit a block's shared memory.
extern "C" int synapta_cc_plan(int H, int W, int* cluster, int* smem_bytes) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Plan p = make_plan(H, W);
  *cluster = p.cluster;
  *smem_bytes = (int)p.smem;
  return p.smem <= (size_t)kMaxSmem ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

extern "C" int synapta_cc(const float* mask, int* labels, int* rounds_out, int B,
                          int H, int W, int max_rounds, int connectivity,
                          cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || max_rounds < 1 ||
      (connectivity != 4 && connectivity != 8))
    return (int)cudaErrorInvalidValue;
  Plan p = make_plan(H, W);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cc_cluster_kernel, mask, labels, rounds_out, H,
                           W, max_rounds, connectivity == 8 ? 1 : 0, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
