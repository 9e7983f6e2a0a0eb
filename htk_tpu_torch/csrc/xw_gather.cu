// Segmented max-plus with first-slot argmax, and a gather-add, over a
// static slot stream, for Hopper (sm_90a): the explicit-bigram leg of the
// factored cross-word step of the uniform-row LV decoder.
//
// Replaces four TPU kernels, all of which gather word-end scores WE[b, i]
// through a static table of source rows:
//
//   htk_tpu/ops/xw_route.py : routed_explicit_leg   (segmax)
//   benchmarks/gather_probe.py : pallas_leg_build   (segmax, B = 1)
//   htk_tpu/ops/xw_pallas.py : _window_gather_jit   (gather_add)
//   benchmarks/dyngather_probe.py : build           (gather_add, no add)
//
// segmax, for every segment r of [seg_off[r], seg_off[r+1]) and batch row b:
//
//   val[b, out_row[r]] = max_k WE[b, preds[k]] + scores[k]
//   arg[b, out_row[r]] = preds[k*], k* the first slot reaching the max
//
// The running max is seeded with the segment's first slot and updated only
// on a strict `>`, so it is exactly jnp.max / jnp.argmax over a padded
// bucket row (pads included) and torch.max(dim). Each candidate is one fp32
// add of WE and the already-scaled score, as in the plain torch version
// (ops/xw_gather.py), so values agree bit for bit. An empty segment writes
// (2 * LZERO, -1).
//
// gather_add: out[b, n] = WE[b, pred[n]] + lp[n], or WE[b, pred[n]] alone
// when lp is null (the probe's plain lane gather).
//
// Design. segmax: one thread per segment, kBatch batch rows of (value,
// index) pairs in registers, so each slot's (pred, score) is read once a
// frame for up to kBatch utterances; grid = (ceil(R / kSegThreads),
// ceil(B / kBatch)). At the 20k-word net (R = 20,000 segments, ~430k slots,
// B = 8) that is 157 blocks, and WE (640 KB) stays in L2. gather_add: one
// thread per output, coalesced over n, grid = (ceil(N / kGatherThreads), B).
//
// What bounds them: bytes. segmax must read the slot stream (8 B a slot),
// WE and the segment tables and write val and arg; its operations (an add
// and a compare per (b, slot)) take a tenth of that time at the card's FP32
// rate. Both kernels gather WE at random rows, so each gathered 4 bytes
// costs an L2 sector; the segments of skewed in-degree run serially in
// one thread (a warp per long segment is later work).

#include <cuda_runtime.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr int kSegThreads = 128;     // segments per block
constexpr int kBatch = 8;            // batch rows per block
constexpr int kGatherThreads = 256;  // outputs per block

__global__ void __launch_bounds__(kSegThreads)
segmax_kernel(const float* __restrict__ we,       // (B, C)
              const int* __restrict__ preds,      // (N,)
              const float* __restrict__ scores,   // (N,)
              const int* __restrict__ seg_off,    // (R + 1,)
              const int* __restrict__ out_row,    // (R,)
              float* __restrict__ val,            // (B, C_out)
              int* __restrict__ arg,              // (B, C_out)
              int B, int C, int R, int C_out) {
  const int r = blockIdx.x * kSegThreads + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);
  const int k0 = seg_off[r];
  const int k1 = seg_off[r + 1];
  const size_t o = static_cast<size_t>(out_row[r]);
  const float* w = we + static_cast<size_t>(b0) * C;
  float best[kBatch];
  int bi[kBatch];
  if (k0 < k1) {
    const int p = __ldg(preds + k0);
    const float s = __ldg(scores + k0);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      best[q] = q < nb ? __ldg(w + static_cast<size_t>(q) * C + p) + s : 0.f;
      bi[q] = p;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      best[q] = 2.f * kLZero;
      bi[q] = -1;
    }
  }
#pragma unroll 2
  for (int k = k0 + 1; k < k1; ++k) {
    const int p = __ldg(preds + k);
    const float s = __ldg(scores + k);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (q < nb) {
        const float c = __ldg(w + static_cast<size_t>(q) * C + p) + s;
        if (c > best[q]) {
          best[q] = c;
          bi[q] = p;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (q < nb) {
      const size_t at = static_cast<size_t>(b0 + q) * C_out + o;
      val[at] = best[q];
      arg[at] = bi[q];
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_add_kernel(const float* __restrict__ we,    // (B, C)
                  const int* __restrict__ pred,    // (N,)
                  const float* __restrict__ lp,    // (N,) or null
                  float* __restrict__ out,         // (B, N)
                  int C, int N) {
  const int n = blockIdx.x * kGatherThreads + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float g = __ldg(we + static_cast<size_t>(b) * C + __ldg(pred + n));
  out[static_cast<size_t>(b) * N + n] = lp ? g + __ldg(lp + n) : g;
}

}  // namespace

// Launch on `stream`; each returns the cudaError_t of its launch.
extern "C" int segmax_launch(const void* we, const void* preds,
                             const void* scores, const void* seg_off,
                             const void* out_row, void* val, void* arg,
                             int B, int C, int R, int C_out, void* stream) {
  const dim3 grid((R + kSegThreads - 1) / kSegThreads,
                  (B + kBatch - 1) / kBatch);
  segmax_kernel<<<grid, kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const int*>(preds),
      static_cast<const float*>(scores), static_cast<const int*>(seg_off),
      static_cast<const int*>(out_row), static_cast<float*>(val),
      static_cast<int*>(arg), B, C, R, C_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_add_launch(const void* we, const void* pred,
                                 const void* lp, void* out, int B, int C,
                                 int N, void* stream) {
  const dim3 grid((N + kGatherThreads - 1) / kGatherThreads, B);
  gather_add_kernel<<<grid, kGatherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const int*>(pred),
      static_cast<const float*>(lp), static_cast<float*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}
