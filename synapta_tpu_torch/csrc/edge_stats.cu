// Fused edge statistics of (B, H, W) float32 gray crops -> (B, 6) float32
// counts [edges, v_open, h_open, grid_h, grid_v, |v_open U h_open|].
//
// Replaces synapta_tpu/ops/pallas_kernels.py::fused_edge_stats (kernel body
// _edge_stats_kernel, _erode1d, _dilate1d, _shift2, _shift_axis) and, with
// `centred` set, computes what the JAX package's default route computes
// with XLA ops (ops/features.py::_core_features(use_pallas=False):
// sobel_edges, _open_iter2, box_count). The plain twins in
// synapta_tpu_torch/ops/cuda_kernels.py spell both out in PyTorch. Common:
//   - Sobel taps replicate the border: shift2(a, dy, dx)[y, x] =
//     a[clamp(y - dy), clamp(x - dx)] (the Pallas "tl" is a[y+1, x+1]);
//   - 4-sector NMS without atan2: is_h = |gy| < 0.41421356|gx|,
//     is_v = |gy| > 2.41421356|gx|, is_d1 = !is_h & !is_v & gx*gy >= 0;
//     local max = mag >= both neighbours; strong >= high, weak >= low;
//     edges = strong | (weak & in-bounds 3x3 dilation of strong);
//   - 1-D opens along an axis of length N with an odd window k, h = k/2,
//     counted where > 0.
// The two routes differ in the NMS neighbours and in the opens' borders:
//   - centred == 0 (the Pallas kernel): NMS neighbours clamp like the taps;
//     E[i] = AND e[i-h .. i+h] within [0, N) for i >= h, else 0, then the same
//     OR-window on E (the first h lanes of the axis are lost twice);
//   - centred == 1 (the XLA route): NMS neighbours wrap around,
//     ((y +- 1) mod H, (x +- 1) mod W), as jnp.roll does; lanes outside the
//     image are ignored: E[i] = AND e[max(0, i-h) .. min(N-1, i+h)],
//     D[i] = OR E[same], reduce_window with SAME padding. The sectors of this
//     route come from atan2 in degrees in the twin; the ratio tests give the
//     same four sectors for every integer gradient in [-1020, 1020]^2 but
//     (0, 0), whose magnitude is 0 (tests/test_torch_edge_stats.py), so the
//     route is exact for integer-valued gray (uint8 luma).
// All float arithmetic uses the _rn intrinsics (no multiply-add is
// contracted) and sqrt is __fsqrt_rn, so every value equals the twin's.
// Counts are exact integers, converted to float at the end.
//
// What bounds it on the card: one read of the gray batch, 16.78 MB at
// (16, 512, 512), 5.0 us at 3.35 TB/s; the arithmetic (about 60 operations
// a pixel, 252 MFLOP, 3.8 us at 67 TFLOP/s in float32) bounds it less.
// Design, two launches:
//   1. es_stencil: one CTA per band of kBand rows of one crop. The band and
//      a 3-row halo of gray come into shared memory with cp.async; magnitude
//      and sector, then the NMS code, then the grow are computed there. The
//      wrapped route needs the magnitude of row H-1 beside row 0 and of row 0
//      beside row H-1, which no halo holds: the bands that own those rows
//      compute them from nine global taps (2 x W pixels a crop). Only the
//      edges leave, bit-packed by warp ballot (one uint32 per 32 pixels:
//      32 KB a crop, 512 KB for 16 crops, which stay in L2).
//   2. es_opens: one CTA per (open, crop) holds the crop's edge bitmap in
//      shared memory and opens it on whole words: a window of k rows or bits
//      is built by doubling (log2 k AND/OR steps, the horizontal ones with
//      funnel shifts across neighbouring words), then shifted by k/2. The
//      centred route runs the same steps on the bitmap with h neutral lanes
//      laid in front of the axis (ones for the AND; the shift puts zeros
//      there for the OR), so no lane is lost; the open of lane i is then
//      lane i of the second window, unshifted. The counts are __popc sums,
//      reduced in the CTA and written once; the first open's CTA also counts
//      the edges. The v_open and h_open CTAs of a crop form a thread-block
//      cluster of 2: each leaves its open in shared memory and the second
//      reads the first's through distributed shared memory to count the
//      union, so the sixth count costs no third launch and no trip through
//      global memory. No memset, no global atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBand = 16;            // rows of output per stencil CTA
constexpr int kStencilThreads = 512;
constexpr int kOpenThreads = 512;
constexpr int kMaxSmem = 232448;     // 227 KB, the opt-in limit of a block

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

size_t stencil_smem(int W) {
  // gray (kBand + 6 rows), magnitude (kBand + 4) and the two wrapped
  // magnitude rows as float, sector (kBand + 4) and code (kBand + 2) as bytes
  size_t w = (size_t)((W + 3) & ~3);
  return (kBand + 6) * w * 4 + (kBand + 4 + 2) * w * 4 + (kBand + 4) * w +
         (kBand + 2) * w;
}

// Words of one of es_opens' three buffers: the largest of the four opens'
// bitmaps, each with its k/2 neutral lanes in front on the centred route.
int opens_stride(int H, int W, int line_k, int grid_k, int centred) {
  int k = 2 * (line_k > grid_k ? line_k : grid_k) - 1;
  int pad = centred ? k / 2 : 0;
  int vert = (H + pad) * ((W + 31) / 32), horiz = H * ((W + pad + 31) / 32);
  return vert > horiz ? vert : horiz;
}

// Sobel of the pixel at column x of row `mid` (taps replicate the border:
// the callers pass clamped rows and columns). Pallas names: tl = g[y+1, x+1],
// t = g[y+1, x], tr = g[y+1, x-1], l = g[y, x+1], r = g[y, x-1],
// bl = g[y-1, x+1], b = g[y-1, x], br = g[y-1, x-1].
__device__ __forceinline__ float sobel(const float* up, const float* mid,
                                       const float* dn, int xm, int x, int xp,
                                       float* gx_out, float* gy_out) {
  float tl = dn[xp], t = dn[x], tr = dn[xm];
  float l = mid[xp], r = mid[xm];
  float bl = up[xp], bo = up[x], br = up[xm];
  float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.f, r)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, l)), bl));
  float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.f, bo)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, t)), tr));
  *gx_out = gx;
  *gy_out = gy;
  return __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
}

// Magnitude of pixel (y, x) from nine taps in global memory.
__device__ float magnitude_at(const float* src, int y, int x, int H, int W) {
  float gx, gy;
  return sobel(src + (size_t)clampi(y - 1, H - 1) * W, src + (size_t)y * W,
               src + (size_t)clampi(y + 1, H - 1) * W, clampi(x - 1, W - 1), x,
               clampi(x + 1, W - 1), &gx, &gy);
}

// wrap = 0: the NMS neighbours clamp; 1: they wrap around the image.
__global__ void __launch_bounds__(kStencilThreads)
es_stencil(const float* __restrict__ gray, uint32_t* __restrict__ bits, int H,
           int W, float high, float low, int wrap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = (W + 3) & ~3;  // row stride in shared memory
  float* g = reinterpret_cast<float*>(smem);               // rows y0-3 ..
  float* mag = g + (kBand + 6) * ws;                       // rows y0-2 ..
  float* wrap_up = mag + (kBand + 4) * ws;  // magnitude of row H-1, above row 0
  float* wrap_dn = wrap_up + ws;            // magnitude of row 0, below row H-1
  unsigned char* sec = reinterpret_cast<unsigned char*>(wrap_dn + ws);
  unsigned char* code = sec + (kBand + 4) * ws;            // rows y0-1 ..
  const int b = blockIdx.y, y0 = blockIdx.x * kBand;
  const int rows = min(kBand, H - y0);
  const int tid = threadIdx.x;
  const float* src = gray + (size_t)b * H * W;

  // gray rows y0-3 .. y0+kBand+2, clamped (the taps of shift2 clamp too)
  if ((W & 3) == 0) {
    const int vec = W / 4;
    for (int i = tid; i < (kBand + 6) * vec; i += kStencilThreads) {
      int e = i / vec, c = i - e * vec;
      const float* from = src + (size_t)clampi(y0 - 3 + e, H - 1) * W + 4 * c;
      unsigned to = (unsigned)__cvta_generic_to_shared(g + e * ws + 4 * c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(from));
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = tid; i < (kBand + 6) * W; i += kStencilThreads) {
      int e = i / W, x = i - e * W;
      g[e * ws + x] = src[(size_t)clampi(y0 - 3 + e, H - 1) * W + x];
    }
  }
  // the wrapped neighbours' rows, for the bands that hold the code of row 0
  // (the first) and of row H-1 (the last, and the one before it when row H-1
  // is its lower halo)
  if (wrap && y0 == 0)
    for (int x = tid; x < W; x += kStencilThreads)
      wrap_up[x] = magnitude_at(src, H - 1, x, H, W);
  if (wrap && y0 + kBand >= H - 1)
    for (int x = tid; x < W; x += kStencilThreads)
      wrap_dn[x] = magnitude_at(src, 0, x, H, W);
  __syncthreads();

  // Sobel -> magnitude and NMS sector (0 = h, 1 = d1, 2 = v, 3 = d2) for the
  // real rows among y0-2 .. y0+kBand+1; other rows are read through clamp
  for (int i = tid; i < (kBand + 4) * W; i += kStencilThreads) {
    int e = i / W, x = i - e * W;
    int y = y0 - 2 + e;
    if (y < 0 || y >= H) continue;
    float gx, gy;
    mag[e * ws + x] = sobel(g + (clampi(y - 1, H - 1) - (y0 - 3)) * ws,
                            g + (y - (y0 - 3)) * ws,
                            g + (clampi(y + 1, H - 1) - (y0 - 3)) * ws,
                            clampi(x - 1, W - 1), x, clampi(x + 1, W - 1),
                            &gx, &gy);
    float ax = fabsf(gx), ay = fabsf(gy);
    bool is_h = ay < __fmul_rn(0.41421356f, ax);
    bool is_v = ay > __fmul_rn(2.41421356f, ax);
    bool is_d1 = !is_h && !is_v && __fmul_rn(gx, gy) >= 0.f;
    sec[e * ws + x] = is_h ? 0 : (is_d1 ? 1 : (is_v ? 2 : 3));
  }
  __syncthreads();

  // NMS + double threshold -> code (2 = strong, 1 = weak only, 0 = none)
  // for the real rows among y0-1 .. y0+kBand
  for (int i = tid; i < (kBand + 2) * W; i += kStencilThreads) {
    int e = i / W, x = i - e * W;
    int y = y0 - 1 + e;
    if (y < 0 || y >= H) continue;
    const float* mid = mag + (y - (y0 - 2)) * ws;
    const float *up, *dn;
    int xm, xp;
    if (wrap) {
      up = y == 0 ? wrap_up : mid - ws;
      dn = y == H - 1 ? wrap_dn : mid + ws;
      xm = x == 0 ? W - 1 : x - 1;
      xp = x == W - 1 ? 0 : x + 1;
    } else {
      up = mag + (clampi(y - 1, H - 1) - (y0 - 2)) * ws;
      dn = mag + (clampi(y + 1, H - 1) - (y0 - 2)) * ws;
      xm = clampi(x - 1, W - 1);
      xp = clampi(x + 1, W - 1);
    }
    float n1, n2;
    switch (sec[(y - (y0 - 2)) * ws + x]) {
      case 0:  // n1 = shift2(mag,0,1), n2 = shift2(mag,0,-1)
        n1 = mid[xm]; n2 = mid[xp]; break;
      case 1:  // shift2(mag,1,1), shift2(mag,-1,-1)
        n1 = up[xm]; n2 = dn[xp]; break;
      case 2:  // shift2(mag,1,0), shift2(mag,-1,0)
        n1 = up[x]; n2 = dn[x]; break;
      default:  // shift2(mag,1,-1), shift2(mag,-1,1)
        n1 = up[xp]; n2 = dn[xm]; break;
    }
    float v = mid[x];
    bool local_max = v >= n1 && v >= n2;
    code[e * ws + x] = local_max ? (v >= high ? 2 : (v >= low ? 1 : 0)) : 0;
  }
  __syncthreads();

  // grow: edges = strong | (weak & any strong in the in-bounds 3x3, on both
  // routes), one bit a pixel; a warp's 32 lanes are 32 consecutive pixels, so
  // its ballot is one word of the row
  const int nw = (W + 31) / 32;
  const int span = nw * 32;
  for (int i = tid; i < rows * span; i += kStencilThreads) {
    int yy = i / span, x = i - yy * span;
    int y = y0 + yy;
    bool edge = false;
    if (x < W) {
      unsigned char own = code[(y - (y0 - 1)) * ws + x];
      bool grown = own == 2;
      for (int dy = -1; dy <= 1 && !grown; ++dy) {
        const unsigned char* c = code + (clampi(y + dy, H - 1) - (y0 - 1)) * ws;
        grown = c[clampi(x - 1, W - 1)] == 2 || c[x] == 2 ||
                c[clampi(x + 1, W - 1)] == 2;
      }
      edge = own == 2 || (own == 1 && grown);
    }
    uint32_t word = __ballot_sync(0xffffffffu, edge);
    if ((threadIdx.x & 31) == 0)
      bits[((size_t)b * H + y) * nw + x / 32] = word;
  }
}

// The bits of word w that lie inside a row of W bits.
__device__ __forceinline__ uint32_t lane_mask(int w, int W) {
  int valid = W - 32 * w;
  return valid >= 32 ? 0xffffffffu : (valid <= 0 ? 0u : (1u << valid) - 1u);
}

// Bits [32w + s, 32w + s + 32) of a row of nw words; bits past the row are
// `fill` (the window's neutral value).
__device__ __forceinline__ uint32_t row_bits(const uint32_t* row, int w, int s,
                                             int nw, uint32_t fill) {
  int q = w + (s >> 5), r = s & 31;
  uint32_t lo = q < nw ? row[q] : fill;
  if (r == 0) return lo;
  uint32_t hi = q + 1 < nw ? row[q + 1] : fill;
  return __funnelshift_r(lo, hi, r);
}

// Bits [32w - s, 32w - s + 32) of a row of nw words: the row moved up by s
// bits; bits before and past the row are `fill`.
__device__ __forceinline__ uint32_t row_bits_back(const uint32_t* row, int w,
                                                  int s, int nw, uint32_t fill) {
  int q = w - (s >> 5), r = s & 31;
  uint32_t hi = q >= 0 && q < nw ? row[q] : fill;
  if (r == 0) return hi;
  uint32_t lo = q - 1 >= 0 && q - 1 < nw ? row[q - 1] : fill;
  return __funnelshift_l(lo, hi, r);
}

// Element j + s of the window's axis at word i = (row, word) of an H x nw map.
__device__ __forceinline__ uint32_t ahead(const uint32_t* a, int row, int w,
                                          int s, int H, int nw, bool vert,
                                          uint32_t fill) {
  if (vert) return row + s < H ? a[(row + s) * nw + w] : fill;
  return row_bits(a + row * nw, w, s, nw, fill);
}

// Window of k along the axis, unshifted: out[j] = AND (OR) of a[j .. j+k)
// within the map, by doubling. Returns the buffer that holds it (src, t0
// or t1).
template <bool kAnd>
__device__ const uint32_t* window(const uint32_t* src, uint32_t* t0,
                                  uint32_t* t1, int k, int H, int nw,
                                  bool vert) {
  const uint32_t fill = kAnd ? 0xffffffffu : 0u;
  const int n = H * nw;
  const uint32_t* cur = src;
  uint32_t* nxt = t0;
  int p = 1;
  // A_{2p}[j] = A_p[j] op A_p[j + p]; the last step overlaps to reach k
  while (p < k) {
    int s = 2 * p <= k ? p : k - p;
    for (int i = threadIdx.x; i < n; i += kOpenThreads) {
      int row = i / nw, w = i - row * nw;
      uint32_t a = cur[i], c = ahead(cur, row, w, s, H, nw, vert, fill);
      nxt[i] = kAnd ? (a & c) : (a | c);
    }
    __syncthreads();
    p = 2 * p <= k ? 2 * p : k;
    cur = nxt;
    nxt = (nxt == t0) ? t1 : t0;
  }
  return cur;
}

// out[i] = win[i - h] for i >= h, else 0 (along the axis), masked to W bits.
__device__ __forceinline__ uint32_t shifted(const uint32_t* win, int row, int w,
                                            int h, int nw, int W, bool vert) {
  uint32_t v = vert ? (row >= h ? win[(row - h) * nw + w] : 0u)
                    : row_bits_back(win + row * nw, w, h, nw, 0u);
  return v & lane_mask(w, W);
}

__device__ unsigned block_sum(unsigned v, unsigned* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0;
  for (int i = 0; i < kOpenThreads / 32; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

// blockIdx.x = open (0 v_open, 1 h_open, 2 grid_h, 3 grid_v), blockIdx.y =
// crop; clusters of 2 along x, so v_open and h_open of a crop share one.
// `stride` = words of each of the three buffers (opens_stride), the same in
// every CTA, so a buffer sits at the same offset in both CTAs of a cluster.
__global__ void __launch_bounds__(kOpenThreads)
es_opens(const uint32_t* __restrict__ bits, float* __restrict__ out, int H,
         int W, int line_k, int grid_k, int centred, int stride) {
  extern __shared__ __align__(16) uint32_t words[];
  __shared__ unsigned scratch[kOpenThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int nw = (W + 31) / 32, n = H * nw;
  const int s = blockIdx.x, b = blockIdx.y;
  const bool vert = s == 0 || s == 3;
  const int k = s < 2 ? 2 * line_k - 1 : 2 * grid_k - 1;  // iterations=2
  const int h = k / 2;
  // the centred route works on the map with h neutral lanes in front of the
  // axis: Hp x Wp bits, nwp words a row
  const int pad = centred ? h : 0;
  const int Hp = vert ? H + pad : H, Wp = vert ? W : W + pad;
  const int nwp = (Wp + 31) / 32, np = Hp * nwp;
  uint32_t* e = words;
  uint32_t* t0 = words + stride;
  uint32_t* t1 = words + 2 * stride;
  const uint32_t* src = bits + (size_t)b * n;
  // the erode's input: ones in the pad and past W (neutral for the AND)
  unsigned edges = 0;
  if (vert || pad == 0) {  // rows keep their words (nwp == nw)
    const int first = Hp - H;
    for (int i = threadIdx.x; i < np; i += kOpenThreads) {
      int row = i / nw, w = i - row * nw;
      uint32_t v = 0xffffffffu;
      if (row >= first) {
        v = src[i - first * nw];
        edges += __popc(v);
        v |= ~lane_mask(w, W);
      }
      e[i] = v;
    }
  } else {  // every row moves up by pad bits: staged through t1
    for (int i = threadIdx.x; i < n; i += kOpenThreads)
      t1[i] = src[i] | ~lane_mask(i % nw, W);
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += kOpenThreads) {
      int row = i / nwp, w = i - row * nwp;
      e[i] = row_bits_back(t1 + row * nw, w, pad, nw, 0xffffffffu);
    }
  }
  __syncthreads();
  if (s == 0) {
    unsigned total = block_sum(edges, scratch);
    if (threadIdx.x == 0) out[b * 6] = (float)total;
  }
  // erode: the window into t0/t1 (or e itself when k == 1), shifted into a
  // free buffer
  const uint32_t* win = window<true>(e, t0, t1, k, Hp, nwp, vert);
  uint32_t* eroded = win == t0 ? t1 : t0;
  for (int i = threadIdx.x; i < np; i += kOpenThreads) {
    int row = i / nwp, w = i - row * nwp;
    eroded[i] = shifted(win, row, w, h, nwp, Wp, vert);
  }
  __syncthreads();
  uint32_t* spare = eroded == t0 ? t1 : t0;
  win = window<false>(eroded, e, spare, k, Hp, nwp, vert);
  // The open of the real map, word (row, w) of H x nw: the second window
  // shifted by h; on the centred route lane i of the padded window is the
  // open of lane i, the pad having taken the shift. It goes to a buffer the
  // window no longer needs (the same one in both CTAs of a cluster: the
  // choice follows from k alone).
  uint32_t* fin = win == e ? t0 : e;
  unsigned count = 0;
  for (int i = threadIdx.x; i < n; i += kOpenThreads) {
    int row = i / nw, w = i - row * nw;
    uint32_t v = pad ? (win[row * nwp + w] & lane_mask(w, W))
                     : shifted(win, row, w, h, nw, W, vert);
    count += __popc(v);
    fin[i] = v;
  }
  unsigned total = block_sum(count, scratch);
  if (threadIdx.x == 0) out[b * 6 + 1 + s] = (float)total;
  if (s < 2) {  // the cluster of v_open (rank 0) and h_open (rank 1)
    cluster.sync();  // both opens are in place
    if (s == 1) {
      const uint32_t* other = cluster.map_shared_rank(fin, 0);
      unsigned both = 0;
      for (int i = threadIdx.x; i < n; i += kOpenThreads)
        both += __popc(fin[i] | other[i]);
      total = block_sum(both, scratch);
      if (threadIdx.x == 0) out[b * 6 + 5] = (float)total;
    }
    cluster.sync();  // rank 0 stays while rank 1 reads its memory
  }
}

}  // namespace

// centred = 0: the Pallas kernel's semantics; 1: the XLA route's. out: (B, 6).
extern "C" int synapta_edge_stats(const float* gray, float* out,
                                  uint32_t* edge_bits, int B, int H, int W,
                                  int line_k, int grid_k, float high,
                                  float low, int centred, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || line_k < 1 || grid_k < 1 ||
      (centred != 0 && centred != 1))
    return (int)cudaErrorInvalidValue;
  const int stride = opens_stride(H, W, line_k, grid_k, centred);
  size_t s1 = stencil_smem(W), s2 = 3 * (size_t)stride * 4;
  if (s1 > (size_t)kMaxSmem || s2 + 64 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      es_stencil, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(es_opens, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  es_stencil<<<dim3((H + kBand - 1) / kBand, B), kStencilThreads, s1, stream>>>(
      gray, edge_bits, H, W, high, low, centred);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4, B, 1);
  cfg.blockDim = dim3(kOpenThreads, 1, 1);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, es_opens, (const uint32_t*)edge_bits, out, H,
                           W, line_k, grid_k, centred, stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
