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
// (2 * LZERO, -1). `skip` is an optional device flag (a 0-dim bool, or
// null): where it is set every block returns before it reads a slot and
// val / arg are left unspecified, so a caller can gate the launch on a
// value computed on the device (the adaptive-exact leg's certificate)
// without waiting for it on the host.
//
// gather_add: out[b, n] = WE[b, pred[n]] + lp[n], or WE[b, pred[n]] alone
// when lp is null (the probe's plain lane gather).
//
// Design. segmax: one thread per segment, kBatch batch rows of (value,
// index) pairs in registers, so each slot's (pred, score) is read once a
// frame for up to kBatch utterances; grid = (ceil(R / kSegThreads),
// ceil(B / kBatch)). At the 20k-word net (R = 20,000 segments, ~430k slots,
// B = 8) that is 157 blocks, and WE (640 KB) stays in L2. gather_add: each
// thread takes 4 consecutive slots, reads their pred (and lp) once with one
// 16-byte load each and loops over all B rows, gathering 4 values of WE and
// writing them with one 16-byte store; grid = ceil(N / (4 kGatherThreads)).
// Where WE is at most 48 KB (the probe's table row: 8 KB) every block first
// copies it into shared memory, so that the gathers, which depend on the
// pred loads, read shared memory instead of making a second trip to L2.
// Where a pointer is not 16-byte aligned (a view at an odd element offset,
// or an output row when N % 4 != 0) and at the tail, it falls to scalar
// loads and stores.
//
// What bounds them: bytes. segmax must read the slot stream (8 B a slot),
// WE and the segment tables and write val and arg; its operations (an add
// and a compare per (b, slot)) take a tenth of that time at the card's FP32
// rate. Both kernels gather WE at random rows, so each gathered 4 bytes
// costs an L2 sector; the segments of skewed in-degree run serially in
// one thread (a warp per long segment is later work). gather_add moves the
// slot tables once and the B output rows once: at B = 1 (the probe's lane
// gather) half of its bytes are the pred it reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr int kSegThreads = 128;     // segments per block
constexpr int kBatch = 8;            // batch rows per block
constexpr int kGatherThreads = 256;  // threads per block, 4 slots each
constexpr int kStageMax = 12288;     // WE staged in shared memory up to 48 KB
constexpr int kStage = 8;            // staging loads a thread keeps in flight

__global__ void __launch_bounds__(kSegThreads)
segmax_kernel(const float* __restrict__ we,       // (B, C)
              const int* __restrict__ preds,      // (N,)
              const float* __restrict__ scores,   // (N,)
              const int* __restrict__ seg_off,    // (R + 1,)
              const int* __restrict__ out_row,    // (R,)
              const unsigned char* __restrict__ skip,  // () or null
              float* __restrict__ val,            // (B, C_out)
              int* __restrict__ arg,              // (B, C_out)
              int B, int C, int R, int C_out) {
  if (skip && *skip) return;
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out[b, n + k] = WE[b, p[k]] (+ l[k]) for k < m and every row b; WE from
// shared memory (kShared) or through the read-only cache
template <bool kShared>
__device__ __forceinline__ void gather_rows(const float* we, const int* p,
                                            const float* l, bool add,
                                            float* out, int B, int C, int N,
                                            int n, int m) {
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float* w = we + static_cast<size_t>(b) * C;
    float g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g[k] = k < m ? (kShared ? w[p[k]] : __ldg(w + p[k])) : 0.f;
      if (add) g[k] += l[k];  // without lp the values are WE's exactly
    }
    float* dst = out + static_cast<size_t>(b) * N + n;
    if (m == 4 && aligned16(dst)) {
      *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
      for (int k = 0; k < m; ++k) dst[k] = g[k];
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_add_kernel(const float* __restrict__ we,    // (B, C)
                  const int* __restrict__ pred,    // (N,)
                  const float* __restrict__ lp,    // (N,) or null
                  float* __restrict__ out,         // (B, N)
                  int B, int C, int N, int staged) {
  extern __shared__ float table[];  // WE, when `staged`
  const int n = (blockIdx.x * kGatherThreads + threadIdx.x) * 4;
  const int m = max(0, min(4, N - n));
  int p[4] = {0, 0, 0, 0};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  if (m == 4 && aligned16(pred + n)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(pred + n));
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  } else {
    for (int k = 0; k < m; ++k) p[k] = __ldg(pred + n + k);
  }
  if (lp) {
    if (m == 4 && aligned16(lp + n)) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(lp + n));
      l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
    } else {
      for (int k = 0; k < m; ++k) l[k] = __ldg(lp + n + k);
    }
  }
  if (staged) {  // the whole of WE, kStage loads in flight a thread
    const int total = B * C;
    for (int q0 = threadIdx.x; q0 < total; q0 += kGatherThreads * kStage) {
      float r[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + u * kGatherThreads;
        r[u] = q < total ? __ldg(we + q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + u * kGatherThreads;
        if (q < total) table[q] = r[u];
      }
    }
    __syncthreads();
  }
  if (m == 0) return;
  if (staged) {
    gather_rows<true>(table, p, l, lp != nullptr, out, B, C, N, n, m);
  } else {
    gather_rows<false>(we, p, l, lp != nullptr, out, B, C, N, n, m);
  }
}

}  // namespace

// Launch on `stream`; each returns the cudaError_t of its launch.
extern "C" int segmax_launch(const void* we, const void* preds,
                             const void* scores, const void* seg_off,
                             const void* out_row, const void* skip,
                             void* val, void* arg, int B, int C, int R,
                             int C_out, void* stream) {
  const dim3 grid((R + kSegThreads - 1) / kSegThreads,
                  (B + kBatch - 1) / kBatch);
  segmax_kernel<<<grid, kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const int*>(preds),
      static_cast<const float*>(scores), static_cast<const int*>(seg_off),
      static_cast<const int*>(out_row),
      static_cast<const unsigned char*>(skip), static_cast<float*>(val),
      static_cast<int*>(arg), B, C, R, C_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_add_launch(const void* we, const void* pred,
                                 const void* lp, void* out, int B, int C,
                                 int N, void* stream) {
  const int per_block = 4 * kGatherThreads;
  const int staged = static_cast<long long>(B) * C <= kStageMax;
  gather_add_kernel<<<(N + per_block - 1) / per_block, kGatherThreads,
                      staged ? B * C * sizeof(float) : 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const int*>(pred),
      static_cast<const float*>(lp), static_cast<float*>(out), B, C, N,
      staged);
  return static_cast<int>(cudaGetLastError());
}
