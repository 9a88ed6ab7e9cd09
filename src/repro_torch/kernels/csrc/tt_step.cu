// One tensor-train step on the raw core for Hopper (sm_90a), fp and
// int8-resident cores.  Replaces the Pallas TPU kernels tt_step_pallas and
// tt_step_int8_pallas (src/repro/kernels/tt_contract.py, bodies
// _tt_step_body and _tt_step_int8_body).
//
// Computes out[m, b, r0] = sum_{n, r1} G[r0, n, m, r1] * X[b, n, r1]  (* s)
// with G the core as stored (no packing per call), X the chain state viewed
// as [b, n, r1] and out fp32, as in the TPU body.  The executor runs one
// launch per core and casts the state to the activation type between them.
//
// What bounds it on the H100: at the deepseek-7b shapes a step does 0.5-2
// FLOP per byte it must move (the state in, the fp32 state out), far below
// the card's ridge, so it is bound by bytes; unlike the fused chain, every
// intermediate state makes a round trip through device memory.  This first
// version does the arithmetic as fp32 FMAs on the CUDA cores from shared
// memory, about one shared load per FMA, so in practice it is bound by
// shared-memory issue, not by that byte bound.
//
// Design:
//  * The grid is (b tiles, m tiles of kM, r0 chunks): each block owns the
//    outputs (m tile, b0 .. b0+tb-1, r0 chunk), kM fp32 accumulators per
//    thread (one per m), and loops over n in chunks inside the block, as the
//    TPU grid's innermost n axis accumulated into its revisited output block.
//  * Each n chunk stages X[b tile, n chunk, :] and G[r0 chunk, n chunk,
//    m tile, :] in shared memory with coalesced loads (both are contiguous
//    in r1), rows padded to an odd stride so that neither operand's reads
//    conflict.  One staged X value feeds kM FMAs.
//  * Threads are ordered r0 fastest, then b, which is the order of out, so
//    the stores are coalesced.  Ragged b tiles, m tiles, n chunks and r0
//    chunks are masked here; the host pads nothing.
//  * int8 G is widened to fp32 in registers and the sum is multiplied once
//    by the core's scale, read from a device pointer, at the end (the TPU
//    body scaled each n block's partial sum; the two agree within fp32
//    rounding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kM = 8;   // m values per block (STEP_M_TILE in tt_contract.py)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_step_kernel(const W* __restrict__ G, const T* __restrict__ X,
               const float* __restrict__ scale, float* __restrict__ out,
               int r0, int n, int m, int r1, int b, int tb, int rc, int nc,
               int stride) {
  extern __shared__ float smem[];  // Xs [tb][stride], Gs [kM][rc][stride]
  float* xs = smem;
  float* gs = smem + (size_t)tb * stride;
  const int b0 = blockIdx.x * tb;
  const int m0 = blockIdx.y * kM;
  const int rr0 = blockIdx.z * rc;
  const int tbv = min(tb, b - b0);    // rows of this b tile
  const int mv = min(kM, m - m0);     // m values of this m tile
  const int rcv = min(rc, r0 - rr0);  // ranks of this r0 chunk
  const int bl = threadIdx.x / rc;
  const int rl = threadIdx.x - bl * rc;
  const bool active = bl < tbv && rl < rcv;
  const size_t nr1 = (size_t)n * r1;
  float acc[kM];
#pragma unroll
  for (int mm = 0; mm < kM; ++mm) acc[mm] = 0.f;

  for (int n0 = 0; n0 < n; n0 += nc) {
    const int len = min(nc, n - n0) * r1;   // contraction length this chunk
    for (int e = threadIdx.x; e < tbv * len; e += blockDim.x) {
      const int row = e / len;
      const int q = e - row * len;
      xs[(size_t)row * stride + q] =
          widen(X[(size_t)(b0 + row) * nr1 + (size_t)n0 * r1 + q]);
    }
    for (int e = threadIdx.x; e < mv * rcv * len; e += blockDim.x) {
      const int q = e % len;
      const int row = (e / len) % rcv;
      const int mm = e / (len * rcv);
      const int nn = q / r1;
      const int k = q - nn * r1;
      gs[((size_t)mm * rc + row) * stride + q] = widen(
          G[(((size_t)(rr0 + row) * n + n0 + nn) * m + m0 + mm) * r1 + k]);
    }
    __syncthreads();
    if (active) {
      const float* xr = xs + (size_t)bl * stride;
      const float* gr = gs + (size_t)rl * stride;
      const size_t gm = (size_t)rc * stride;   // one m further in Gs
      for (int q = 0; q < len; ++q) {
        const float xv = xr[q];
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
          if (mm < mv) acc[mm] += xv * gr[mm * gm + q];
      }
    }
    __syncthreads();
  }
  if (active) {
    const float s = scale != nullptr ? scale[0] : 1.f;
#pragma unroll
    for (int mm = 0; mm < kM; ++mm)
      if (mm < mv)
        out[((size_t)(m0 + mm) * b + b0 + bl) * r0 + rr0 + rl] = acc[mm] * s;
  }
}

template <typename T, typename W>
int launch(const void* G, const void* X, const float* scale, void* out,
           int r0, int n, int m, int r1, int b, int tb, int rc, int nc,
           cudaStream_t stream) {
  const int stride = (nc * r1) | 1;   // odd: conflict-free row reads
  const size_t smem = (size_t)(tb + kM * rc) * stride * sizeof(float);
  auto kernel = tt_step_kernel<T, W>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid((b + tb - 1) / tb, (m + kM - 1) / kM, (r0 + rc - 1) / rc);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(G), static_cast<const T*>(X), scale,
      static_cast<float*>(out), r0, n, m, r1, b, tb, rc, nc, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer; the kernel runs on ``stream`` and returns cudaGetLastError().
// tb * rc must not exceed 256 (one output per thread).
extern "C" {

int tt_step_f32(const void* G, const void* X, void* out, int r0, int n,
                int m, int r1, int b, int tb, int rc, int nc, void* stream) {
  return launch<float, float>(G, X, nullptr, out, r0, n, m, r1, b, tb, rc,
                              nc, (cudaStream_t)stream);
}

int tt_step_bf16(const void* G, const void* X, void* out, int r0, int n,
                 int m, int r1, int b, int tb, int rc, int nc, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      G, X, nullptr, out, r0, n, m, r1, b, tb, rc, nc, (cudaStream_t)stream);
}

int tt_step_int8_f32(const void* G, const void* X, const void* scale,
                     void* out, int r0, int n, int m, int r1, int b, int tb,
                     int rc, int nc, void* stream) {
  return launch<float, int8_t>(G, X, (const float*)scale, out, r0, n, m, r1,
                               b, tb, rc, nc, (cudaStream_t)stream);
}

int tt_step_int8_bf16(const void* G, const void* X, const void* scale,
                      void* out, int r0, int n, int m, int r1, int b, int tb,
                      int rc, int nc, void* stream) {
  return launch<__nv_bfloat16, int8_t>(G, X, (const float*)scale, out, r0, n,
                                       m, r1, b, tb, rc, nc,
                                       (cudaStream_t)stream);
}

}  // extern "C"
