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
// Design: the source range is spread over the card. A block takes kCols
// target columns (one warp's width, so each row of its trans tile is one
// coalesced 128-byte read), kBatch batch rows and one chunk of the source
// rows; grid = (ceil(C / kCols), chunks, ceil(B / kBatch)), with `chunks`
// chosen by the wrapper so that the grid holds at least twice the card's
// 132 SMs in blocks (9 chunks, 288 blocks at C = 1,000, B = 8). Inside a
// block the chunk is cut again among kWarps warps; each thread keeps
// kBatch (value, index) pairs in registers over its rows, seeded with
// (-inf, 0). A warp walks its rows in tiles of 32 with every load of the
// tile in flight at once (the walk is bound by L2 latency, not by
// bytes): each lane loads one row's WE for the kBatch batch rows
// (coalesced), broadcast to the warp by shuffles, and its own column's
// trans values for all 32 rows. The partials are merged in ascending
// source order with a strict `>`, which keeps "larger value, then
// smaller index", i.e. the serial first maximum: the warps' partials
// through shared memory, then the chunks' through a (chunks, B, C)
// scratch in global memory, merged by whichever block of a column tile
// arrives last (a ticket counter per tile, which that block resets to 0
// for the next launch), starting from the contract's seed. A chunk
// without a candidate above -inf keeps (-inf, 0) and never wins against
// the seed. With one chunk a block writes its result directly.
//
// What bounds it: bytes. Per launch it must read trans (4 C^2 bytes) and
// WE and write val and arg; the operations (an add and a compare per
// (b, i, j)) take a fifth of that time at the card's FP32 rate. On the
// decoder's path trans (4 MB at C = 1,000) is read every frame and stays
// resident in the 50 MB L2 from frame to frame, so the floor that matters
// is L2's rate rather than the HBM rate the bound is stated against. A
// launch this small is held to a few microseconds by L2 latency: the row
// walk's, the fence and ticket, and the merge's, which grows with the
// chunks (hence no more chunks than twice the card's SMs need).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr int kCols = 32;                 // target columns per block
constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kCols * kWarps;  // 256
constexpr int kBatch = 8;                 // batch rows per block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == kBatch, "the merge gives each warp one batch row");

__global__ void __launch_bounds__(kThreads)
maxplus_kernel(const float* __restrict__ we,     // (B, C)
               const float* __restrict__ trans,  // (C, C)
               float* __restrict__ val,          // (B, C)
               int* __restrict__ arg,            // (B, C)
               float* part_v,                    // (chunks, B, C) scratch
               int* part_i,                      // (chunks, B, C) scratch
               int* tickets,                     // one per column tile, 0
               int B, int C, int chunks, int floor) {
  __shared__ float sv[kWarps][kBatch][kCols];
  __shared__ int si[kWarps][kBatch][kCols];
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kCols + lane;
  const int b0 = blockIdx.z * kBatch;
  const int nb = min(kBatch, B - b0);
  const int chunk = blockIdx.y;
  const int c0 = static_cast<int>(static_cast<long long>(C) * chunk / chunks);
  const int c1 = static_cast<int>(static_cast<long long>(C) * (chunk + 1)
                                  / chunks);
  const int n = c1 - c0;
  const int r0 = c0 + n * warp / kWarps;
  const int r1 = c0 + n * (warp + 1) / kWarps;

  float best[kBatch];
  int bi[kBatch];
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    best[r] = -CUDART_INF_F;
    bi[r] = 0;
  }
  // the warp's rows in tiles of 32, every load of a tile issued before
  // the first compare; lanes past C load nothing and write nothing, but
  // take part in the shuffles
  for (int i0 = r0; i0 < r1; i0 += 32) {
    const int n = min(32, r1 - i0);
    float w[kBatch];  // WE[b0 + r, i0 + lane], broadcast below
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      w[r] = r < nb && lane < n
          ? __ldg(we + static_cast<size_t>(b0 + r) * C + i0 + lane)
          : -CUDART_INF_F;
    float t[32];  // trans[i0 + k, j]
#pragma unroll
    for (int k = 0; k < 32; ++k)
      t[k] = k < n && j < C
          ? __ldg(trans + static_cast<size_t>(i0 + k) * C + j) : 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < n) {  // n is the same in every lane
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const float c = __shfl_sync(kFull, w[r], k) + t[k];
          if (c > best[r]) {
            best[r] = c;
            bi[r] = i0 + k;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    sv[warp][r][lane] = best[r];
    si[warp][r][lane] = bi[r];
  }
  __syncthreads();
  // thread (warp r, lane) merges batch row r of column j over the warps
  const int r = warp;
  float v = -CUDART_INF_F;
  int a = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (sv[w][r][lane] > v) {
      v = sv[w][r][lane];
      a = si[w][r][lane];
    }
  }
  const bool mine = r < nb && j < C;
  const float init = floor ? kLZero : -CUDART_INF_F;
  const size_t o = static_cast<size_t>(b0 + r) * C + j;
  if (chunks == 1) {
    if (mine) {
      const bool win = v > init;
      val[o] = win ? v : init;
      arg[o] = win ? a : 0;
    }
    return;
  }
  const size_t BC = static_cast<size_t>(B) * C;
  if (mine) {
    part_v[chunk * BC + o] = v;
    part_i[chunk * BC + o] = a;
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  if (mine) {  // loads independent of the comparisons, so they overlap
    float acc = init;
    int acc_i = 0;
#pragma unroll 4
    for (int k = 0; k < chunks; ++k) {
      const float pv = __ldcg(part_v + k * BC + o);
      const int pi = __ldcg(part_i + k * BC + o);
      if (pv > acc) {
        acc = pv;
        acc_i = pi;
      }
    }
    val[o] = acc;
    arg[o] = acc_i;
  }
  if (threadIdx.x == 0) tickets[tile] = 0;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// part_v / part_i hold chunks * B * C elements and tickets
// ceil(C / 32) * ceil(B / 8) zeros (left zero again) when chunks > 1.
extern "C" int maxplus_launch(const void* we, const void* trans, void* val,
                              void* arg, void* part_v, void* part_i,
                              void* tickets, int B, int C, int chunks,
                              int floor, void* stream) {
  const dim3 grid((C + kCols - 1) / kCols, chunks, (B + kBatch - 1) / kBatch);
  maxplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const float*>(trans),
      static_cast<float*>(val), static_cast<int*>(arg),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<int*>(tickets), B, C, chunks, floor);
  return static_cast<int>(cudaGetLastError());
}
