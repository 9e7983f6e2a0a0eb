// The pointwise cell of an LSTMP layer's frame step, for Hopper (sm_90a):
// the gates, the cell state and the cell output of every batch row of one
// frame, in one launch.
//
// Replaces no TPU kernel: htk_tpu has no recurrent layer. The port's
// hybrid LSTMP-HMM (models/ann.LSTMPLayer: Sak, Senior and Beaufays,
// Interspeech 2014, projected LSTM with peepholes) runs a layer as one
// GEMM of W_x over all its rows, then a loop over the frames; a frame is
// the recurrent GEMM (W_r r_{t-1}, cuBLAS), this cell, and the projection
// GEMM (r_t = W_rm m_t, cuBLAS). Written out in torch the cell is about
// 15 elementwise launches; here it is one. For batch row b and cell j,
// with z = (gx + gr) + bias over the four gate rows i, f, c, o:
//
//   i = sigmoid(z_i + p_i c_{t-1})     f = sigmoid(z_f + p_f c_{t-1})
//   c_t = f c_{t-1} + i tanh(z_c)
//   o = sigmoid(z_o + p_o c_t)         m_t = o tanh(c_t)
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into a fused multiply-add) and sigmoid(x) is
// 1 / (1 + exp(-x)), the operations and the order of the plain torch
// version (ops/lstmp.py) on the card, so the two agree bit for bit.
//
// What bounds it: bytes, and at the cells' shape the launch itself. Per
// launch it reads the two gate rows (8 x 4 n_c bytes a batch row),
// c_{t-1}, the peepholes and the bias, and writes c_t and m_t: 499 KB at
// B = 13, n_c = 832, 0.15 us at 3.35 TB/s, far below a launch's few
// microseconds. Design: a thread a (batch row, cell), consecutive threads
// on consecutive cells, so that each of the nine rows a warp reads or
// writes is one coalesced run; nothing is staged, nothing is reused.

#include <cuda_runtime.h>

struct LstmpCellArgs {
  const float* gx;    // (B, 4 n_c), batch rows gx_bstride apart
  const float* gr;    // (B, 4 n_c), contiguous
  const float* c;     // (B, n_c) c_{t-1}
  const float* peep;  // (3, n_c): p_i, p_f, p_o
  const float* bias;  // (4 n_c,)
  float* c_out;       // (B, n_c) c_t
  float* m_out;       // (B, n_c) m_t
  long long gx_bstride;
  int B;
  int n_c;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads) lstmp_cell_kernel(LstmpCellArgs a) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int n = a.n_c;
  if (k >= static_cast<long long>(a.B) * n) return;
  const int b = static_cast<int>(k / n);
  const int j = static_cast<int>(k - static_cast<long long>(b) * n);
  const float* gx = a.gx + b * a.gx_bstride + j;
  const float* gr = a.gr + static_cast<long long>(b) * 4 * n + j;
  const float* bias = a.bias + j;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    z[g] = __fadd_rn(__fadd_rn(gx[g * n], gr[g * n]), bias[g * n]);
  const float c = a.c[k];
  const float i = sigmoid(__fadd_rn(z[0], __fmul_rn(a.peep[j], c)));
  const float f = sigmoid(__fadd_rn(z[1], __fmul_rn(a.peep[n + j], c)));
  const float ct = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, tanhf(z[2])));
  const float o = sigmoid(__fadd_rn(z[3], __fmul_rn(a.peep[2 * n + j], ct)));
  a.c_out[k] = ct;
  a.m_out[k] = __fmul_rn(o, tanhf(ct));
}

}  // namespace

extern "C" int lstmp_cell_launch(const LstmpCellArgs* a, void* stream) {
  const long long n = static_cast<long long>(a->B) * a->n_c;
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads);
  lstmp_cell_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
