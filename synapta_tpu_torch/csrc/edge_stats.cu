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
// Counts are exact: unsigned atomics, converted to float at the end.
//
// What bounds it here: a 512x512 crop is 1 MB of float32, which does not fit
// the 227 KB of shared memory a block can use, so the intermediates go
// through device memory (B=16: 16 MB gray, 16 MB magnitude, four 4 MB byte
// maps; about the size of the 50 MB L2). The open passes read k = 39 or 49
// bytes per output pixel and are bound by L1/L2 load bandwidth.
//
// Design: a stencil pass for Sobel and the NMS sector, one for NMS and the
// thresholds, one for the grow (which also counts edges), then one thread per
// output pixel for each erode and dilate pass with a direct O(k) window. All
// float arithmetic uses the _rn intrinsics so no multiply-add is contracted
// and every value equals the twin's. Warp-wide ballots keep the atomics to
// one per warp. Keeping a crop's rows in shared memory is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Sobel gradients (edge-replicated) -> magnitude and NMS sector
// (0 = h, 1 = d1, 2 = v, 3 = d2).
__global__ void es_sobel(const float* __restrict__ gray, float* __restrict__ mag,
                         unsigned char* __restrict__ sector, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  if (x >= W) return;
  const float* g = gray + (long long)b * H * W;
  int ym = clampi(y - 1, H - 1), yp = clampi(y + 1, H - 1);
  int xm = clampi(x - 1, W - 1), xp = clampi(x + 1, W - 1);
  // Pallas names: tl = shift2(g,-1,-1) = g[y+1, x+1], t = g[y+1, x],
  // tr = g[y+1, x-1], l = g[y, x+1], r = g[y, x-1], bl = g[y-1, x+1],
  // b = g[y-1, x], br = g[y-1, x-1]
  float tl = g[yp * W + xp], t = g[yp * W + x], tr = g[yp * W + xm];
  float l = g[y * W + xp], r = g[y * W + xm];
  float bl = g[ym * W + xp], bo = g[ym * W + x], br = g[ym * W + xm];
  // gx = (tr + 2r + br) - (tl + 2l + bl); gy = (bl + 2b + br) - (tl + 2t + tr)
  float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.f, r)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, l)), bl));
  float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.f, bo)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, t)), tr));
  long long i = (long long)b * H * W + (long long)y * W + x;
  mag[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  float ax = fabsf(gx), ay = fabsf(gy);
  bool is_h = ay < __fmul_rn(0.41421356f, ax);
  bool is_v = ay > __fmul_rn(2.41421356f, ax);
  bool is_d1 = !is_h && !is_v && __fmul_rn(gx, gy) >= 0.f;
  sector[i] = is_h ? 0 : (is_d1 ? 1 : (is_v ? 2 : 3));
}

// NMS + double threshold -> code (2 = strong, 1 = weak only, 0 = none).
__global__ void es_nms(const float* __restrict__ mag,
                       const unsigned char* __restrict__ sector,
                       unsigned char* __restrict__ code, int H, int W,
                       float high, float low) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  if (x >= W) return;
  const float* m = mag + (long long)b * H * W;
  int ym = clampi(y - 1, H - 1), yp = clampi(y + 1, H - 1);
  int xm = clampi(x - 1, W - 1), xp = clampi(x + 1, W - 1);
  long long i = (long long)b * H * W + (long long)y * W + x;
  float n1, n2;
  switch (sector[i]) {
    case 0:  // n1 = shift2(mag,0,1), n2 = shift2(mag,0,-1)
      n1 = m[y * W + xm]; n2 = m[y * W + xp]; break;
    case 1:  // shift2(mag,1,1), shift2(mag,-1,-1)
      n1 = m[ym * W + xm]; n2 = m[yp * W + xp]; break;
    case 2:  // shift2(mag,1,0), shift2(mag,-1,0)
      n1 = m[ym * W + x]; n2 = m[yp * W + x]; break;
    default:  // shift2(mag,1,-1), shift2(mag,-1,1)
      n1 = m[ym * W + xp]; n2 = m[yp * W + xm]; break;
  }
  float v = m[y * W + x];
  bool local_max = v >= n1 && v >= n2;
  code[i] = local_max ? (v >= high ? 2 : (v >= low ? 1 : 0)) : 0;
}

// Count the set predicate over the warp; lane 0 adds it to *counter.
__device__ __forceinline__ void warp_count(bool pred, unsigned* counter) {
  unsigned bal = __ballot_sync(0xffffffffu, pred);
  if ((threadIdx.x & 31) == 0 && bal) atomicAdd(counter, (unsigned)__popc(bal));
}

// edges = strong | (weak & any strong in the clamped 3x3), counted into slot 0.
__global__ void es_grow(const unsigned char* __restrict__ code,
                        unsigned char* __restrict__ edges,
                        unsigned* __restrict__ counts, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  bool edge = false;
  if (x < W) {
    const unsigned char* c = code + (long long)b * H * W;
    unsigned char own = c[y * W + x];
    bool grown = own == 2;
    for (int dy = -1; dy <= 1 && !grown; ++dy) {
      int yy = clampi(y + dy, H - 1);
      for (int dx = -1; dx <= 1; ++dx) {
        if (c[yy * W + clampi(x + dx, W - 1)] == 2) {
          grown = true;
          break;
        }
      }
    }
    edge = own == 2 || (own == 1 && grown);
    edges[(long long)b * H * W + (long long)y * W + x] = edge ? 1 : 0;
  }
  warp_count(edge, counts + b * 5);
}

// One-sided window reduction along `axis` (0 = rows of a column, 1 = along
// a row): out[i] = AND (erode) / OR (dilate) of src over
// [i - k/2, i - k/2 + k) within [0, n) for i >= k/2, else 0. When `slot` is
// >= 0 the result is counted into counts[b*5 + slot] instead of stored.
template <bool kErode>
__global__ void es_window(const unsigned char* __restrict__ src,
                          unsigned char* __restrict__ dst,
                          unsigned* __restrict__ counts, int H, int W, int k,
                          int axis, int slot) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  bool out = false;
  if (x < W) {
    const unsigned char* s = src + (long long)b * H * W;
    int i = axis == 0 ? y : x;
    int n = axis == 0 ? H : W;
    int h = k / 2;
    if (i >= h) {
      int lo = i - h;
      int hi = lo + k < n ? lo + k : n;
      out = kErode;
      for (int j = lo; j < hi; ++j) {
        bool v = (axis == 0 ? s[j * W + x] : s[y * W + j]) != 0;
        if (v != kErode) {
          out = !kErode;
          break;
        }
      }
    }
    if (slot < 0) dst[(long long)b * H * W + (long long)y * W + x] = out;
  }
  if (slot >= 0) warp_count(out, counts + b * 5 + slot);
}

__global__ void es_finish(const unsigned* __restrict__ counts,
                          float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (float)counts[i];
}

}  // namespace

extern "C" int synapta_edge_stats(const float* gray, float* out, float* mag,
                                  unsigned char* sector, unsigned char* code,
                                  unsigned char* edges,
                                  unsigned char* eroded, unsigned* counts,
                                  int B, int H, int W, int line_k, int grid_k,
                                  float high, float low, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || line_k < 1 || grid_k < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(unsigned) * B * 5, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kThreads - 1) / kThreads, H, B);
  es_sobel<<<grid, kThreads, 0, stream>>>(gray, mag, sector, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  es_nms<<<grid, kThreads, 0, stream>>>(mag, sector, code, H, W, high, low);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  es_grow<<<grid, kThreads, 0, stream>>>(code, edges, counts, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // iterations=2 equivalence: an open with the (2k - 1) window
  const int ekl = 2 * line_k - 1, ekg = 2 * grid_k - 1;
  const int axis[4] = {0, 1, 1, 0};  // v_open, h_open, grid_h, grid_v
  const int win[4] = {ekl, ekl, ekg, ekg};
  for (int s = 0; s < 4; ++s) {
    es_window<true><<<grid, kThreads, 0, stream>>>(edges, eroded, counts, H, W,
                                                   win[s], axis[s], -1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    es_window<false><<<grid, kThreads, 0, stream>>>(eroded, nullptr, counts, H,
                                                    W, win[s], axis[s], s + 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  es_finish<<<(B * 5 + 127) / 128, 128, 0, stream>>>(counts, out, B * 5);
  return (int)cudaGetLastError();
}
