// Max-plus matrix-vector product with argmax, for Hopper (sm_90a): the
// cross-word step of the uniform-row LV decoder.
//
// Replaces the TPU kernels htk_tpu/ops/maxplus_pallas.py : maxplus_matvec
// and htk_tpu/ops/tropical_pallas.py : _tropical_pallas_t (the same
// contract on a transposed operand). For every batch row b and target j:
//
//   val[b, j] = max_i WE[b, i] + trans[i, j]      arg[b, j] = that i
//
// Sources i are scanned in ascending order with a strict `>`, so the first
// maximum wins (jnp.argmax, torch.max(dim)). The accumulator starts at
// (LZERO, 0) when `floor` is set (the TPU kernels' contract) and at
// (-inf, 0) otherwise (the decoder's dense XLA branch,
// htk_tpu/algo/decode.py : _make_uniform_step). Each candidate is one fp32
// add, as in the plain torch version (ops/maxplus.py), so the two agree
// bit for bit. Any B >= 1 and C >= 1; nothing is padded.
//
// Design: one thread per target column j, kThreads columns per block; a
// block takes kBatch batch rows, so grid = (ceil(C / kThreads),
// ceil(B / kBatch)). The block stages WE[b0:b0+kBatch, i0:i0+kTile] in
// shared memory; each thread then streams trans[i, j] down its column
// (neighbouring threads read neighbouring addresses) and updates kBatch
// (value, index) pairs held in registers. `trans` is read once per block
// row of the batch, i.e. once per frame for up to kBatch utterances, which
// is the point of the TPU kernel: the (C, C) matrix is shared by the batch.
//
// What bounds it: bytes. Per launch it must read trans (4 C^2 bytes) and
// WE and write val and arg; the operations (an add and a compare per
// (b, i, j)) take a fifth of that time at the card's FP32 rate. At C = 1,000
// the grid has only 8 blocks, so the read of trans runs at the rate 8 SMs
// can pull; spreading the i range over more blocks (a second reduction
// pass) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr int kThreads = 128;  // target columns per block
constexpr int kTile = 128;     // source rows staged per step
constexpr int kBatch = 8;      // batch rows per block

__global__ void __launch_bounds__(kThreads)
maxplus_kernel(const float* __restrict__ we,     // (B, C)
               const float* __restrict__ trans,  // (C, C)
               float* __restrict__ val,          // (B, C)
               int* __restrict__ arg,            // (B, C)
               int B, int C, int floor) {
  __shared__ float we_s[kBatch][kTile];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);
  const bool live = j < C;
  const float init = floor ? kLZero : -CUDART_INF_F;
  float best[kBatch];
  int bi[kBatch];
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    best[r] = init;
    bi[r] = 0;
  }
  for (int i0 = 0; i0 < C; i0 += kTile) {
    const int n = min(kTile, C - i0);
    __syncthreads();  // the previous tile is no longer read
    for (int r = 0; r < kBatch; ++r) {
      const int i = i0 + threadIdx.x;
      we_s[r][threadIdx.x] =
          (r < nb && i < C) ? we[static_cast<size_t>(b0 + r) * C + i]
                            : -CUDART_INF_F;
    }
    __syncthreads();
    if (!live) continue;
    const float* col = trans + static_cast<size_t>(i0) * C + j;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float t = __ldg(col + static_cast<size_t>(k) * C);
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const float c = we_s[r][k] + t;
        if (c > best[r]) {
          best[r] = c;
          bi[r] = i0 + k;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    if (r < nb) {
      const size_t o = static_cast<size_t>(b0 + r) * C + j;
      val[o] = best[r];
      arg[o] = bi[r];
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int maxplus_launch(const void* we, const void* trans, void* val,
                              void* arg, int B, int C, int floor,
                              void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, (B + kBatch - 1) / kBatch);
  maxplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const float*>(trans),
      static_cast<float*>(val), static_cast<int*>(arg), B, C, floor);
  return static_cast<int>(cudaGetLastError());
}
