// Fused edge statistics of (B, H, W) float32 gray crops -> (B, 5) float32
// counts [edges, v_open, h_open, grid_h, grid_v].
//
// Replaces synapta_tpu/ops/pallas_kernels.py::fused_edge_stats (kernel body
// _edge_stats_kernel, _erode1d, _dilate1d, _shift2, _shift_axis) with the
// Pallas kernel's semantics, which the plain twin
// synapta_tpu_torch/ops/cuda_kernels.py::fused_edge_stats_reference spells
// out in PyTorch:
//   - shift2(a, dy, dx)[y, x] = a[clamp(y - dy), clamp(x - dx)]; Sobel taps
//     and NMS neighbours follow from it (the Pallas "tl" is a[y+1, x+1]);
//   - 4-sector NMS without atan2: is_h = |gy| < 0.41421356|gx|,
//     is_v = |gy| > 2.41421356|gx|, is_d1 = !is_h & !is_v & gx*gy >= 0;
//     local max = mag >= both neighbours; strong >= high, weak >= high/3;
//     edges = strong | (weak & clamped 3x3 dilation of strong);
//   - one-sided 1-D opens along an axis of length N with window k:
//     E[i] = min(e[i-k/2 .. i-k/2+k-1] within [0, N)) for i >= k/2, else 0,
//     then the same max-window on E; counted where > 0.
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
//      and sector, then the NMS code, then the grow are computed there. Only
//      the edges leave, bit-packed by warp ballot (one uint32 per 32 pixels:
//      32 KB a crop, 512 KB for 16 crops, which stay in L2).
//   2. es_opens: one CTA per (open, crop) holds the crop's edge bitmap in
//      shared memory and opens it on whole words: a window of k rows or bits
//      is built by doubling (log2 k AND/OR steps, the horizontal ones with
//      funnel shifts across neighbouring words), then shifted by k/2. The
//      counts are __popc sums, reduced in the CTA and written once; the
//      first open's CTA also counts the edges. No memset, no global atomics.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBand = 16;            // rows of output per stencil CTA
constexpr int kStencilThreads = 512;
constexpr int kOpenThreads = 512;
constexpr int kMaxSmem = 232448;     // 227 KB, the opt-in limit of a block

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

size_t stencil_smem(int W) {
  // gray (kBand + 6 rows) and magnitude (kBand + 4) as float, sector
  // (kBand + 4) and code (kBand + 2) as bytes
  size_t w = (size_t)((W + 3) & ~3);
  return (kBand + 6) * w * 4 + (kBand + 4) * w * 4 + (kBand + 4) * w +
         (kBand + 2) * w;
}

size_t opens_smem(int H, int W) {
  return 3 * (size_t)H * ((W + 31) / 32) * 4;  // bitmap + two work buffers
}

__global__ void __launch_bounds__(kStencilThreads)
es_stencil(const float* __restrict__ gray, uint32_t* __restrict__ bits, int H,
           int W, float high, float low) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = (W + 3) & ~3;  // row stride in shared memory
  float* g = reinterpret_cast<float*>(smem);               // rows y0-3 ..
  float* mag = g + (kBand + 6) * ws;                       // rows y0-2 ..
  unsigned char* sec = reinterpret_cast<unsigned char*>(mag + (kBand + 4) * ws);
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
  __syncthreads();

  // Sobel -> magnitude and NMS sector (0 = h, 1 = d1, 2 = v, 3 = d2) for the
  // real rows among y0-2 .. y0+kBand+1; other rows are read through clamp
  for (int i = tid; i < (kBand + 4) * W; i += kStencilThreads) {
    int e = i / W, x = i - e * W;
    int y = y0 - 2 + e;
    if (y < 0 || y >= H) continue;
    const float* up = g + (clampi(y - 1, H - 1) - (y0 - 3)) * ws;
    const float* mid = g + (y - (y0 - 3)) * ws;
    const float* dn = g + (clampi(y + 1, H - 1) - (y0 - 3)) * ws;
    int xm = clampi(x - 1, W - 1), xp = clampi(x + 1, W - 1);
    // Pallas names: tl = g[y+1, x+1], t = g[y+1, x], tr = g[y+1, x-1],
    // l = g[y, x+1], r = g[y, x-1], bl = g[y-1, x+1], b = g[y-1, x],
    // br = g[y-1, x-1]
    float tl = dn[xp], t = dn[x], tr = dn[xm];
    float l = mid[xp], r = mid[xm];
    float bl = up[xp], bo = up[x], br = up[xm];
    float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.f, r)), br),
                         __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, l)), bl));
    float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.f, bo)), br),
                         __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, t)), tr));
    mag[e * ws + x] = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
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
    const float* up = mag + (clampi(y - 1, H - 1) - (y0 - 2)) * ws;
    const float* mid = mag + (y - (y0 - 2)) * ws;
    const float* dn = mag + (clampi(y + 1, H - 1) - (y0 - 2)) * ws;
    int xm = clampi(x - 1, W - 1), xp = clampi(x + 1, W - 1);
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

  // grow: edges = strong | (weak & any strong in the clamped 3x3), one bit
  // a pixel; a warp's 32 lanes are 32 consecutive pixels, so its ballot is
  // one word of the row
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
  uint32_t v;
  if (vert) {
    v = row >= h ? win[(row - h) * nw + w] : 0u;
  } else {
    const uint32_t* r = win + row * nw;
    int q = h >> 5, s = h & 31;
    uint32_t hi = w - q >= 0 ? r[w - q] : 0u;
    uint32_t lo = w - q - 1 >= 0 ? r[w - q - 1] : 0u;
    v = s ? __funnelshift_l(lo, hi, s) : hi;
  }
  int valid = W - 32 * w;
  return valid >= 32 ? v : (v & ((1u << valid) - 1u));
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

// blockIdx.x = open (0 v_open, 1 h_open, 2 grid_h, 3 grid_v), blockIdx.y = crop
__global__ void __launch_bounds__(kOpenThreads)
es_opens(const uint32_t* __restrict__ bits, float* __restrict__ out, int H,
         int W, int line_k, int grid_k) {
  extern __shared__ __align__(16) uint32_t words[];
  __shared__ unsigned scratch[kOpenThreads / 32];
  const int nw = (W + 31) / 32, n = H * nw;
  const int s = blockIdx.x, b = blockIdx.y;
  const bool vert = s == 0 || s == 3;
  const int k = s < 2 ? 2 * line_k - 1 : 2 * grid_k - 1;  // iterations=2
  const int h = k / 2;
  uint32_t* e = words;
  uint32_t* t0 = words + n;
  uint32_t* t1 = words + 2 * n;
  const uint32_t* src = bits + (size_t)b * n;
  unsigned edges = 0;
  for (int i = threadIdx.x; i < n; i += kOpenThreads) {
    uint32_t v = src[i];
    edges += __popc(v);
    int valid = W - 32 * (i % nw);
    // bits past W are neutral for the erode: ones
    e[i] = valid >= 32 ? v : (v | ~((1u << valid) - 1u));
  }
  __syncthreads();
  if (s == 0) {
    unsigned total = block_sum(edges, scratch);
    if (threadIdx.x == 0) out[b * 5] = (float)total;
  }
  // erode: the window into t0/t1 (or e itself when k == 1), shifted into a
  // free buffer
  const uint32_t* win = window<true>(e, t0, t1, k, H, nw, vert);
  uint32_t* eroded = win == t0 ? t1 : t0;
  for (int i = threadIdx.x; i < n; i += kOpenThreads) {
    int row = i / nw, w = i - row * nw;
    eroded[i] = shifted(win, row, w, h, nw, W, vert);
  }
  __syncthreads();
  uint32_t* spare = eroded == t0 ? t1 : t0;
  win = window<false>(eroded, e, spare, k, H, nw, vert);
  unsigned count = 0;
  for (int i = threadIdx.x; i < n; i += kOpenThreads) {
    int row = i / nw, w = i - row * nw;
    count += __popc(shifted(win, row, w, h, nw, W, vert));
  }
  unsigned total = block_sum(count, scratch);
  if (threadIdx.x == 0) out[b * 5 + 1 + s] = (float)total;
}

}  // namespace

extern "C" int synapta_edge_stats(const float* gray, float* out,
                                  uint32_t* edge_bits, int B, int H, int W,
                                  int line_k, int grid_k, float high,
                                  float low, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || line_k < 1 || grid_k < 1)
    return (int)cudaErrorInvalidValue;
  size_t s1 = stencil_smem(W), s2 = opens_smem(H, W);
  if (s1 > (size_t)kMaxSmem || s2 + 64 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      es_stencil, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(es_opens, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  es_stencil<<<dim3((H + kBand - 1) / kBand, B), kStencilThreads, s1, stream>>>(
      gray, edge_bits, H, W, high, low);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  es_opens<<<dim3(4, B), kOpenThreads, s2, stream>>>(edge_bits, out, H, W,
                                                     line_k, grid_k);
  return (int)cudaGetLastError();
}
