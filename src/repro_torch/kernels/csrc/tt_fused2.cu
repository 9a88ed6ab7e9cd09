// Fused d=2 tensor-train layer for Hopper (sm_90a), fp and int8-resident
// cores.  Replaces the Pallas TPU kernels tt_fused2_pallas and
// tt_fused2_int8_pallas (src/repro/kernels/tt_contract.py, bodies
// _fused2_body and _fused2_int8_body).
//
// Computes, for every row b of x [B, n1*n2]:
//   stage 1  A[b, j, i2, r] = sum_k x[b, j*n2 + k] * P2[k, i2*r1 + r]    (* s2)
//   stage 2  y[b, i1*m2 + i2] = sum_{j,r} A[b, j, i2, r] * P1[j*r1 + r, i1] (* s1)
// with P2 [n2, m2*r1] and P1 [n1*r1, m1] the packed cores.  Accumulation and
// the intermediate A are fp32 for every activation type, as in the TPU body.
//
// What bounds it on the H100: at the deepseek-7b shapes the layer does
// about 3.9 MFLOP per row against 8 KB (4096->4096) to 30 KB (4096->11008)
// of activations per row plus 0.5 MB of bf16 cores, so by the data sheet it
// is bound by bytes at both the decode batch (4 rows: the cores dominate)
// and the prefill batch (256 rows: activations dominate).  This first
// version does the arithmetic as fp32 FMAs on the CUDA cores with about one
// dependent load per FMA and few warps per SM at decode, so in practice it is
// bound by load latency and instruction issue, far from that byte bound.
//
// Design:
//  * The inter-stage relayout costs nothing: stage 1 writes straight into
//    the permuted shared-memory layout A[b][i2][j][r], which is the row-major
//    [m2, n1*r1] left operand of stage 2.  The intermediate never leaves the
//    SM (4 KB per row at the deepseek-7b shapes).
//  * One block per tile of bb rows (blockIdx.x); the ragged last tile is
//    masked here, so the host pads nothing.  blockIdx.y splits stage 2's m1
//    columns across blocks, each block recomputing stage 1 for its rows:
//    with 4 decode rows a single block per tile would leave 128 of 132 SMs
//    idle, and stage 1 is the smaller of the two stages.
//  * Stage 1 maps adjacent threads to adjacent P2 columns (coalesced core
//    reads, one broadcast x read per k) and keeps kJ accumulators over j.
//    Stage 2 maps adjacent threads to adjacent m1 columns (coalesced P1
//    reads, broadcast shared-memory reads of A) and keeps kI accumulators
//    over i2.
//  * int8 cores are widened to fp32 in registers; the two scales come from
//    a device pointer ([s2, s1]), so the host never reads them back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJ = 8;   // stage-1 accumulators per thread (over n1)
constexpr int kI = 8;   // stage-2 accumulators per thread (over m2)

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

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_fused2_kernel(const T* __restrict__ x, const W* __restrict__ p2,
                 const W* __restrict__ p1, const float* __restrict__ scales,
                 T* __restrict__ y, int B, int n1, int n2, int m1, int m2,
                 int r1, int bb, int cols_per_block) {
  extern __shared__ float smem[];  // A[bb][m2][n1*r1], fp32
  const int row0 = blockIdx.x * bb;
  const int rows = min(bb, B - row0);
  const int c2 = m2 * r1;          // stage-1 output width per j
  const int k2 = n1 * r1;          // stage-2 contraction depth
  const size_t N = (size_t)n1 * n2;
  const size_t M = (size_t)m1 * m2;
  const float s2 = scales != nullptr ? scales[0] : 1.f;
  const float s1 = scales != nullptr ? scales[1] : 1.f;

  // ---- stage 1: x-tile @ P2 into the permuted intermediate -------------
  const int jchunks = (n1 + kJ - 1) / kJ;
  const int items1 = rows * jchunks * c2;
  for (int item = threadIdx.x; item < items1; item += blockDim.x) {
    const int c = item % c2;
    const int rest = item / c2;
    const int j0 = (rest % jchunks) * kJ;
    const int b = rest / jchunks;
    const int jn = min(kJ, n1 - j0);
    const T* xr = x + (size_t)(row0 + b) * N + (size_t)j0 * n2;
    float acc[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[jj] = 0.f;
    for (int k = 0; k < n2; ++k) {
      const float w = widen(p2[(size_t)k * c2 + c]);
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        if (jj < jn) acc[jj] += widen(xr[(size_t)jj * n2 + k]) * w;
    }
    const int i2 = c / r1;
    const int r = c - i2 * r1;
    float* ab = smem + ((size_t)b * m2 + i2) * k2 + r;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      if (jj < jn) ab[(size_t)(j0 + jj) * r1] = acc[jj] * s2;
  }
  __syncthreads();

  // ---- stage 2: A @ P1 for this block's m1 columns, m-major output ------
  const int i1_begin = blockIdx.y * cols_per_block;
  const int ncols = min(m1, i1_begin + cols_per_block) - i1_begin;
  if (ncols <= 0) return;
  const int ichunks = (m2 + kI - 1) / kI;
  const int items2 = rows * ichunks * ncols;
  for (int item = threadIdx.x; item < items2; item += blockDim.x) {
    const int i1 = i1_begin + item % ncols;
    const int rest = item / ncols;
    const int i20 = (rest % ichunks) * kI;
    const int b = rest / ichunks;
    const int in = min(kI, m2 - i20);
    const float* ab = smem + ((size_t)b * m2 + i20) * k2;
    float acc[kI];
#pragma unroll
    for (int ii = 0; ii < kI; ++ii) acc[ii] = 0.f;
    for (int k = 0; k < k2; ++k) {
      const float w = widen(p1[(size_t)k * m1 + i1]);
#pragma unroll
      for (int ii = 0; ii < kI; ++ii)
        if (ii < in) acc[ii] += ab[(size_t)ii * k2 + k] * w;
    }
    T* yr = y + (size_t)(row0 + b) * M + (size_t)i1 * m2 + i20;
#pragma unroll
    for (int ii = 0; ii < kI; ++ii)
      if (ii < in) store(yr + ii, acc[ii] * s1);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* p2, const void* p1,
           const float* scales, void* y, int B, int n1, int n2, int m1,
           int m2, int r1, int bb, int splits, cudaStream_t stream) {
  const size_t smem = (size_t)bb * m2 * n1 * r1 * sizeof(float);
  auto kernel = tt_fused2_kernel<T, W>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const int cols = (m1 + splits - 1) / splits;
  const dim3 grid((B + bb - 1) / bb, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(p2),
      static_cast<const W*>(p1), scales, static_cast<T*>(y), B, n1, n2, m1,
      m2, r1, bb, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer; the kernel runs on ``stream`` and returns cudaGetLastError().
extern "C" {

int tt_fused2_f32(const void* x, const void* p2, const void* p1, void* y,
                  int B, int n1, int n2, int m1, int m2, int r1, int bb,
                  int splits, void* stream) {
  return launch<float, float>(x, p2, p1, nullptr, y, B, n1, n2, m1, m2, r1,
                              bb, splits, (cudaStream_t)stream);
}

int tt_fused2_bf16(const void* x, const void* p2, const void* p1, void* y,
                   int B, int n1, int n2, int m1, int m2, int r1, int bb,
                   int splits, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      x, p2, p1, nullptr, y, B, n1, n2, m1, m2, r1, bb, splits,
      (cudaStream_t)stream);
}

int tt_fused2_int8_f32(const void* x, const void* p2, const void* p1,
                       const void* scales, void* y, int B, int n1, int n2,
                       int m1, int m2, int r1, int bb, int splits,
                       void* stream) {
  return launch<float, int8_t>(x, p2, p1, (const float*)scales, y, B, n1,
                               n2, m1, m2, r1, bb, splits,
                               (cudaStream_t)stream);
}

int tt_fused2_int8_bf16(const void* x, const void* p2, const void* p1,
                        const void* scales, void* y, int B, int n1, int n2,
                        int m1, int m2, int r1, int bb, int splits,
                        void* stream) {
  return launch<__nv_bfloat16, int8_t>(x, p2, p1, (const float*)scales, y,
                                       B, n1, n2, m1, m2, r1, bb, splits,
                                       (cudaStream_t)stream);
}

}  // extern "C"
