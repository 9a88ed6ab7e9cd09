// Fused tensor-train chain of any depth d >= 2 for Hopper (sm_90a), fp and
// int8-resident cores.  Replaces the Pallas TPU kernels
// tt_fused_chain_pallas and tt_fused_chain_int8_pallas
// (src/repro/kernels/tt_contract.py, bodies _fused_chain_body and
// _fused_chain_int8_body).
//
// Computes, for every row of x [B, N] and for steps j = 0 .. d-1 (core
// t = d-j, executed d first):
//   out[b, m, i, r] = sum_k state[b, i*K + k] * P_j[k, m*R + r]     (* s_j)
// with K = n_t*r_t, R = r_{t-1}, P_j [K, m_t*R] the packed core and the
// output written straight in the relaid order [m_t, b_t, r_{t-1}], which is
// the next step's input state.  The state is fp32 for every activation
// type, as in the TPU body; y [B, M] is written in x's type.
//
// What bounds it on the H100: at the deepseek-7b length-3 shapes one row
// does 3-6 MFLOP against 8-22 KB of activations and 93 KB of bf16 cores, so
// by the data sheet it is bound by bytes at both the decode batch (4 rows:
// the cores dominate) and the prefill batch (256 rows: the activations).
// This first version does the arithmetic as fp32 FMAs on the CUDA cores
// with one load per FMA, so in practice it is bound by load latency and
// instruction issue, far from that byte bound.
//
// Design:
//  * The relayout between steps costs nothing: each step writes its output
//    in the permuted order the next step reads.  The intermediate states
//    s_1 .. s_{d-1} ping-pong between two fp32 shared-memory buffers and
//    never leave the SM (64 KB per row at the full-width d=3 shapes, so a
//    block holds 3 rows; the TPU kept 128 in VMEM).
//  * The first step reads x from device memory and the last step writes y
//    there, so neither row is staged.  The packed cores are small (46,592
//    elements at the full-width d=3 shapes) and are read from device memory
//    through L1/L2.
//  * One block per tile of bb rows (blockIdx.x); the ragged last tile is
//    masked here, so the host pads nothing.  blockIdx.y splits the last
//    step's output columns across blocks, each block recomputing steps
//    0 .. d-2 for its rows: with 4 decode rows a block per tile alone would
//    leave 128 of 132 SMs idle.
//  * Within a step, adjacent threads take adjacent core columns (coalesced
//    core reads, one broadcast state read per k) and keep kJ accumulators
//    over b_t.
//  * int8 cores are widened to fp32 in registers; the d scales come from a
//    device pointer, so the host never reads them back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJ = 8;      // accumulators per thread (over b_t)
constexpr int kMaxD = 8;   // deepest chain a launch takes

struct Chain {
  int d;
  const void* p[kMaxD];    // packed cores, execution order
  int K[kMaxD];            // contraction depth n_t*r_t
  int C[kMaxD];            // output columns m_t*r_{t-1}
  int R[kMaxD];            // r_{t-1}
  int bt[kMaxD];           // b_t
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One step for `rows` rows: src rows of stride src_stride, dst rows of
// stride dst_stride, output columns [c_begin, c_begin + ncols).
template <typename S, typename W, typename D>
__device__ __forceinline__ void chain_step(
    const S* __restrict__ src, size_t src_stride, const W* __restrict__ P,
    int K, int C, int R, int bt, int rows, int c_begin, int ncols, float s,
    D* __restrict__ dst, size_t dst_stride) {
  const int ichunks = (bt + kJ - 1) / kJ;
  const int items = rows * ichunks * ncols;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int c = c_begin + item % ncols;
    const int rest = item / ncols;
    const int i0 = (rest % ichunks) * kJ;
    const int b = rest / ichunks;
    const int in = min(kJ, bt - i0);
    const S* sr = src + (size_t)b * src_stride + (size_t)i0 * K;
    float acc[kJ];
#pragma unroll
    for (int ii = 0; ii < kJ; ++ii) acc[ii] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = widen(P[(size_t)k * C + c]);
#pragma unroll
      for (int ii = 0; ii < kJ; ++ii)
        if (ii < in) acc[ii] += widen(sr[(size_t)ii * K + k]) * w;
    }
    const int m = c / R;
    const int r = c - m * R;
    D* dr = dst + (size_t)b * dst_stride + ((size_t)m * bt + i0) * R + r;
#pragma unroll
    for (int ii = 0; ii < kJ; ++ii)
      if (ii < in) store(dr + (size_t)ii * R, acc[ii] * s);
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_chain_kernel(const T* __restrict__ x, const Chain ch,
                const float* __restrict__ scales, T* __restrict__ y, int B,
                int N, int M, int bb, int maxf, int cols_per_block) {
  extern __shared__ float smem[];  // two buffers [bb][maxf], fp32
  const int row0 = blockIdx.x * bb;
  const int rows = min(bb, B - row0);
  const int last = ch.d - 1;
  const int c_begin = blockIdx.y * cols_per_block;
  const int ncols = min(ch.C[last], c_begin + cols_per_block) - c_begin;
  if (ncols <= 0) return;
  const size_t buf = (size_t)bb * maxf;  // step j writes buffer j & 1
  const T* xr = x + (size_t)row0 * N;
  T* yr = y + (size_t)row0 * M;

  for (int j = 0; j < ch.d; ++j) {
    const W* P = static_cast<const W*>(ch.p[j]);
    const float s = scales != nullptr ? scales[j] : 1.f;
    const float* in = smem + ((j - 1) & 1) * buf;
    float* out = smem + (j & 1) * buf;
    if (j == 0) {
      chain_step(xr, N, P, ch.K[j], ch.C[j], ch.R[j], ch.bt[j], rows, 0,
                 ch.C[j], s, out, maxf);
    } else if (j == last) {
      chain_step(in, maxf, P, ch.K[j], ch.C[j], ch.R[j], ch.bt[j], rows,
                 c_begin, ncols, s, yr, M);
    } else {
      chain_step(in, maxf, P, ch.K[j], ch.C[j], ch.R[j], ch.bt[j], rows, 0,
                 ch.C[j], s, out, maxf);
    }
    __syncthreads();
  }
}

// ns, ms, ranks: host arrays in core order (ranks has d+1 entries).
template <typename T, typename W>
int launch(const void* x, const void* const* packed, const int* ns,
           const int* ms, const int* ranks, int d, const float* scales,
           void* y, int B, int bb, int splits, cudaStream_t stream) {
  if (d < 2 || d > kMaxD) return (int)cudaErrorInvalidValue;
  Chain ch;
  ch.d = d;
  long long f = 1;
  for (int t = 0; t < d; ++t) f *= ns[t];
  const int N = (int)f;
  long long maxf = 0;
  for (int j = 0; j < d; ++j) {
    const int t = d - 1 - j;
    ch.p[j] = packed[j];
    ch.K[j] = ns[t] * ranks[t + 1];
    ch.R[j] = ranks[t];
    ch.C[j] = ms[t] * ranks[t];
    ch.bt[j] = (int)(f / ch.K[j]);
    f = (long long)ms[t] * ch.bt[j] * ranks[t];
    if (j < d - 1 && f > maxf) maxf = f;
  }
  const int M = (int)f;
  const int nbuf = d == 2 ? 1 : 2;
  const size_t smem = (size_t)nbuf * bb * maxf * sizeof(float);
  auto kernel = tt_chain_kernel<T, W>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const int cols = (ch.C[d - 1] + splits - 1) / splits;
  const dim3 grid((B + bb - 1) / bb, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ch, scales, static_cast<T*>(y), B, N, M, bb,
      (int)maxf, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  x, y, scales and every entry of
// `packed` are device pointers; `packed`, ns, ms and ranks are host arrays.
// The kernel runs on ``stream`` and the call returns cudaGetLastError().
extern "C" {

int tt_fused_chain_f32(const void* x, const void* const* packed,
                       const int* ns, const int* ms, const int* ranks, int d,
                       void* y, int B, int bb, int splits, void* stream) {
  return launch<float, float>(x, packed, ns, ms, ranks, d, nullptr, y, B,
                              bb, splits, (cudaStream_t)stream);
}

int tt_fused_chain_bf16(const void* x, const void* const* packed,
                        const int* ns, const int* ms, const int* ranks, int d,
                        void* y, int B, int bb, int splits, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      x, packed, ns, ms, ranks, d, nullptr, y, B, bb, splits,
      (cudaStream_t)stream);
}

int tt_fused_chain_int8_f32(const void* x, const void* const* packed,
                            const int* ns, const int* ms, const int* ranks,
                            int d, const void* scales, void* y, int B, int bb,
                            int splits, void* stream) {
  return launch<float, int8_t>(x, packed, ns, ms, ranks, d,
                               (const float*)scales, y, B, bb, splits,
                               (cudaStream_t)stream);
}

int tt_fused_chain_int8_bf16(const void* x, const void* const* packed,
                             const int* ns, const int* ms, const int* ranks,
                             int d, const void* scales, void* y, int B,
                             int bb, int splits, void* stream) {
  return launch<__nv_bfloat16, int8_t>(x, packed, ns, ms, ranks, d,
                                       (const float*)scales, y, B, bb,
                                       splits, (cudaStream_t)stream);
}

}  // extern "C"
