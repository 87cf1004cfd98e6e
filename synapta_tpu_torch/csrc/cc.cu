// Connected-component labels of (B, H, W) {0,1} float masks -> int32 labels.
//
// Replaces synapta_tpu/ops/pallas_cc.py::connected_components_pallas
// (kernel body _cc_kernel, _seg_scan, _shift). Same semantics: every ink
// pixel starts as y*W + x + 1, then exactly `rounds` rounds (max_iters + 1)
// of
//   - 8-conn only: the in-bounds 3x3 neighbour max, times the mask;
//   - a segmented running max along each row, forward then backward;
//   - a segmented running max along each column, forward then backward.
// A segment is a maximal run of ink; the max resets at background. The
// result is each component's max id once converged; background is 0. The
// labels equal the plain twin (synapta_tpu_torch/ops/cc.py) bit for bit.
//
// What bounds it here: a 256x256 int32 map is 256 KB, above the 227 KB of
// shared memory a block can hold, so the labels stay in device memory (4 MB
// at B=16, resident in the 50 MB L2). Each round is three launches and is
// bound by L2 traffic and the sequential scans' latency, not by arithmetic.
//
// Design: the row pass runs one thread per (b, y) and the column pass one
// thread per (b, x), so a warp's 32 threads in the column pass touch 32
// adjacent words per step (coalesced). The loop over rounds is on the host
// with no synchronisation; every launch is checked with cudaGetLastError.
// Tiling a map into shared memory with clusters is later work.
#include <cuda_runtime.h>

namespace {

__global__ void cc_init(const float* __restrict__ mask, int* __restrict__ lbl,
                        long long n, int hw) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lbl[i] = mask[i] != 0.f ? (int)(i % hw) + 1 : 0;
}

// dst = mask ? max(src over the in-bounds 3x3 window) : 0
__global__ void cc_neighbor_max(const float* __restrict__ mask,
                                const int* __restrict__ src,
                                int* __restrict__ dst, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  if (x >= W) return;
  long long base = (long long)b * H * W;
  long long i = base + (long long)y * W + x;
  if (mask[i] == 0.f) {
    dst[i] = 0;
    return;
  }
  int best = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      int v = src[base + (long long)yy * W + xx];
      best = v > best ? v : best;
    }
  }
  dst[i] = best;
}

// Segmented running max along `n` elements at stride `stride`, forward then
// backward; src may alias dst.
__device__ __forceinline__ void seg_scan(const float* __restrict__ m,
                                         const int* src, int* dst, int n,
                                         long long stride) {
  int run = 0;
  for (int j = 0; j < n; ++j) {
    long long o = j * stride;
    if (m[o] != 0.f) {
      int v = src[o];
      run = v > run ? v : run;
    } else {
      run = 0;
    }
    dst[o] = run;
  }
  run = 0;
  for (int j = n - 1; j >= 0; --j) {
    long long o = j * stride;
    if (m[o] != 0.f) {
      int v = dst[o];
      run = v > run ? v : run;
    } else {
      run = 0;
    }
    dst[o] = run;
  }
}

__global__ void cc_row_scan(const float* __restrict__ mask, const int* src,
                            int* dst, int rows, int W) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;  // r = b * H + y
  if (r >= rows) return;
  long long o = (long long)r * W;
  seg_scan(mask + o, src + o, dst + o, W, 1);
}

__global__ void cc_col_scan(const float* __restrict__ mask, int* lbl, int B,
                            int H, int W) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;  // c = b * W + x
  if (c >= B * W) return;
  int b = c / W;
  int x = c - b * W;
  long long o = (long long)b * H * W + x;
  seg_scan(mask + o, lbl + o, lbl + o, H, W);
}

}  // namespace

extern "C" int synapta_cc(const float* mask, int* labels, int* scratch, int B,
                          int H, int W, int rounds, int connectivity,
                          cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || rounds < 1 ||
      (connectivity != 4 && connectivity != 8))
    return (int)cudaErrorInvalidValue;
  long long n = (long long)B * H * W;
  cc_init<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(mask, labels, n,
                                                         H * W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 nb_grid((W + 127) / 128, H, B);
  for (int r = 0; r < rounds; ++r) {
    const int* src = labels;
    if (connectivity == 8) {
      cc_neighbor_max<<<nb_grid, 128, 0, stream>>>(mask, labels, scratch, H,
                                                    W);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      src = scratch;
    }
    cc_row_scan<<<(B * H + 127) / 128, 128, 0, stream>>>(mask, src, labels,
                                                         B * H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cc_col_scan<<<(B * W + 127) / 128, 128, 0, stream>>>(mask, labels, B, H,
                                                         W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
