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
// What bounds it on the H100: bytes, at both row counts.  At the
// deepseek-7b shapes one row does about 20 MFLOP per decoder layer (7
// projections).  At 4 rows (decode) the layer moves 2.5 MB, mostly bf16
// cores; at 256 rows it moves about 42 MB of activations for 5.1 GFLOP,
// 12.7 us of bytes at 3.35 TB/s against 5.2 us of bf16 tensor-core work.
//
// The per-i2 decomposition.  Output column i2 depends only on the r1
// columns P2[:, i2*r1 : (i2+1)*r1]:
//   Y_i2 [B, m1] = (X [B*n1, n2] @ P2_i2 [n2, r1]).reshape(B, n1*r1) @ P1
// and the reshape between the stages is free: stage 1's rows are (b, j),
// which is the row-major order of stage 2's left operand.  So the layer is
// m2 independent pairs of products sharing P1.
//
// Grid: (row tile of bb rows, group of g consecutive i2, slice of nc i1),
// 512 threads per block.  The host (tt_contract.fused2_geometry) picks the
// tiles per launch from B, m1, m2 and the SM count.
//  * Stage 1 runs once per (row tile, i2 group): [bb*n1, n2] @ [n2, g*r1].
//    It is never recomputed across i2.
//  * Stage 2 is [g*bb, n1*r1] @ [n1*r1, nc] with rows (i2, b), looped over
//    column chunks of nct.
//  * How decode fills the card: 4 rows make one row tile, and g = 1 gives
//    m2 = 8 i2 groups, 8 blocks.  m1 is then cut into slices of >= 16
//    columns until the blocks cover the SMs (16 slices of 32 columns: 128
//    blocks), each recomputing its stage 1, 0.26 M MACs on the tensor
//    cores.  All of x and the block's P2 slice are in flight at once, and
//    the first P1 chunk is issued before stage 1 starts.
//  * Prefill (256 rows): g = m2 = 8 and 2 rows per block (one 16-row
//    stage-2 tile) give 128 blocks with no recompute; each block reads only
//    its own rows of x and writes its rows of y in whole 16-byte runs.
//
// Experts.  The expert-batched entries (tt_fused2_experts_*, kernel
// tt_fused2_experts_kernel) run the same block body on E independent
// problems of one stack in one launch, the port of the Pallas kernels
// under jax.vmap over a mixture-of-experts layer's experts: x [E, C,
// n1*n2], P2 [E, n2, m2*r1], P1 [E, n1*r1, m1], scales [E, 2] and y [E, C,
// m1*m2], every block on one expert.  The grid's three axes are all in
// use, so the expert index is folded into the first: block x = e *
// row_tiles + row tile, and each block offsets its operands by e.  A
// block's work is that of the plain entry at C rows; the host
// (fused2_geometry(..., experts=E)) counts the blocks of all experts when
// it cuts m1, so decode (8 experts x 8 rows) takes 2 slices, not 16.
//
// Staging.  Operands go through shared memory with 16-byte cp.async copies
// (adjacent threads on adjacent addresses, per-thread offsets stepped by
// adds) in rings: stage 1 keeps kStages1 chunks of kc n2 values of the x
// tile and the P2 slice, stage 2 kStages2 column chunks of P1.  Ragged
// edges (m1 = 43, n2 = 86, r1 = 3, row counts that are no multiple of a
// tile) are zero-filled in shared memory, and nothing is read past an
// array.  An operand whose rows are not 16-byte aligned is staged by a
// scalar loop in the same kernel.  Stage 1's fp32 result stays in shared
// memory as stage 2's left operand.
//
// Arithmetic.  bf16 activations run both stages on the tensor cores
// (mma.sync m16n8k16, bf16 operands from ldmatrix, fp32 accumulators);
// int8 cores are widened to bf16 in shared memory, which is exact for codes
// up to 127.  Stage 2's left operand is fp32 in the reference, so it is
// split into a bf16 high part and a bf16 low part (A - hi) and both are
// multiplied: A is kept to about 16 significant bits.  When A is one 16-row
// tile (decode and prefill alike), every warp holds both parts in
// registers for all of stage 2.  s2 multiplies stage 1's fp32 sums before
// the split, s1 the output.  fp32 activations use fp32 FMAs on the CUDA
// cores (no TF32) in the same grid and staging.  One launch per
// projection; every sum is taken in a fixed order and each output is
// written by one thread, so the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages1 = 4;   // stage-1 ring depth (FUSED2_STAGES[0])
constexpr int kStages2 = 2;   // stage-2 ring depth (FUSED2_STAGES[1])
constexpr int kMaxAcc = 2;    // 16x16 accumulator tiles per warp
constexpr int kMaxOut = 8;    // outputs per thread on the fp32 path
constexpr int kRegK = 8;      // stage-2 k-steps whose A operands stay in
                              // registers

// Block geometry and shared-memory layout, computed on the host by
// make_geo (and, for the fit rule and the launch, by
// tt_contract.fused2_smem_bytes, which must agree).
struct Geo {
  int B, n1, n2, m1, m2, r1;  // B: rows of one expert's problem
  int bb, g, nc, kc, nct;   // row tile, i2 group, i1 slice, chunk sizes
  int M1p, N1p, K2, K2p, M2p;
  int ldx, ldp2, ldp2c, ldS, ldA, ldp1, ldp1c, ldO;
  int split1, split2;       // k-split of each stage over the warps
  int slotx, slot1, slot2;  // ring slot bytes
  int offAlo, offP1, offP1c, offR1, offP2c, size;
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}
__host__ __device__ constexpr int align128(int a) { return round_up(a, 128); }

__host__ __device__ inline int pow2_at_least(int a, int lo) {
  int p = lo;
  while (p < a) p *= 2;
  return p;
}

// kWarps warps over T output tiles: one tile or more per warp when
// T >= kWarps, else the k-steps of each tile split over the largest power
// of two of warps that T tiles leave room for.
__host__ __device__ inline int ksplit(int tiles) {
  int split = 1;
  while (2 * split * tiles <= kWarps) split *= 2;
  return split;
}

template <typename T, typename W>
Geo make_geo(int B, int n1, int n2, int m1, int m2, int r1, int bb, int g,
             int nc, int kc, int nct) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr bool conv = tc && std::is_same<W, int8_t>::value;
  constexpr int a = sizeof(T), w = sizeof(W);
  Geo s{};
  s.B = B; s.n1 = n1; s.n2 = n2; s.m1 = m1; s.m2 = m2; s.r1 = r1;
  s.bb = bb; s.g = g; s.nc = nc; s.kc = kc; s.nct = nct;
  s.M1p = round_up(bb * n1, 16);
  // fp32: each thread owns one column of a stage tile, so its width
  // divides the block's threads
  s.N1p = tc ? round_up(g * r1, 16) : pow2_at_least(g * r1, 16);
  s.K2 = n1 * r1;
  s.K2p = round_up(s.K2, 16);
  s.M2p = round_up(g * bb, 16);
  s.ldx = kc + 16 / a;
  s.ldp2 = s.N1p + 16 / w;
  s.ldp2c = s.N1p + 8;
  s.ldS = s.N1p + 4;
  s.ldA = s.K2p + (tc ? 8 : 4);
  s.ldp1 = nct + 16 / w;
  s.ldp1c = nct + 8;
  s.ldO = nct + 4;
  s.split1 = tc ? ksplit((s.M1p / 16) * (s.N1p / 16)) : 1;
  s.split2 = tc ? ksplit((s.M2p / 16) * (nct / 16)) : 1;
  s.slotx = align128(s.M1p * s.ldx * a);
  s.slot1 = s.slotx + align128(kc * s.ldp2 * w);
  s.slot2 = align128(s.K2p * s.ldp1 * w);
  const int a_part = tc ? align128(s.M2p * s.ldA * 2)
                        : align128(s.M2p * s.ldA * 4);
  s.offAlo = a_part;                       // bf16 low part (tc only)
  s.offP1 = tc ? 2 * a_part : a_part;
  s.offP1c = s.offP1 + kStages2 * s.slot2;
  s.offR1 = s.offP1c + (conv ? align128(s.K2p * s.ldp1c * 2) : 0);
  s.offP2c = kStages1 * s.slot1;           // within R1
  int r1b = s.offP2c + (conv ? align128(kc * s.ldp2c * 2) : 0);
  r1b = std::max(r1b, s.split1 * s.M1p * s.ldS * 4);
  r1b = std::max(r1b, s.split2 * s.M2p * s.ldO * 4);
  s.size = s.offR1 + align128(r1b);
  return s;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

template <typename E> __device__ __forceinline__ E zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Call f(r, c) for every r < rows, c < cols (c fastest), spread over the
// block's threads.  Index math is a few adds per element; the two
// divisions happen once per call.
template <typename F>
__device__ __forceinline__ void for_each_2d(int rows, int cols, F f) {
  const int dr = kThreads / cols;
  const int dc = kThreads - dr * cols;
  int r = threadIdx.x / cols;
  int c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// A thread's share of a [rows, cols] walk over the block (row-major, c
// fastest): it starts at (r, c) and steps by kThreads elements, dr rows
// and dc columns at a time.  Made once per tile shape, so that staging a
// chunk costs a few adds per copy and no division.
struct Walk {
  int r, c, dr, dc;
};

__device__ __forceinline__ Walk make_walk(int cols) {
  Walk w;
  w.dr = kThreads / cols;
  w.dc = kThreads - w.dr * cols;
  w.r = threadIdx.x / cols;
  w.c = threadIdx.x - w.r * cols;
  return w;
}

// Stage the tile [rowsp, colsp] of a row-major matrix (row stride ld
// elements) whose element (0, 0) is at src into shared memory (row stride
// lds).  Elements outside the rv x cv valid corner are zero.  vec: 16-byte
// cp.async copies along w, a walk over colsp / (16 / sizeof(E)) vectors
// per row (src, ld and colsp 16-byte aligned); else a scalar loop.
template <typename E>
__device__ __forceinline__ void stage_tile(E* dst, int lds, const E* src,
                                           int ld, int rowsp, int colsp,
                                           int rv, int cv, bool vec,
                                           const Walk& w) {
  if (vec) {
    constexpr int V = 16 / sizeof(E);
    int r = w.r, c = w.c * V;
    int so = r * lds + c, go = r * ld + c;
    const int sstep = w.dr * lds + w.dc * V, gstep = w.dr * ld + w.dc * V;
    while (r < rowsp) {
      const int n = r < rv ? min(V, cv - c) : 0;
      cp_async16(dst + so, n > 0 ? src + go : src, max(n, 0) * (int)sizeof(E));
      r += w.dr;
      c += w.dc * V;
      so += sstep;
      go += gstep;
      if (c >= colsp) {
        c -= colsp;
        ++r;
        so += lds - colsp;
        go += ld - colsp;
      }
    }
  } else {
    for_each_2d(rowsp, colsp, [&](int r, int c) {
      dst[r * lds + c] = r < rv && c < cv ? src[r * ld + c] : zero<E>();
    });
  }
}

// int8 codes -> bf16 (exact), [rows, cols] from row stride lds to ldd, 16
// codes per step (cols, lds and 2*ldd are multiples of 16).
__device__ __forceinline__ void widen_tile(bf16* dst, int ldd,
                                           const int8_t* src, int lds,
                                           int rows, int cols) {
  for_each_2d(rows, cols / 16, [&](int r, int c16) {
    const int4 q = *reinterpret_cast<const int4*>(src + r * lds + c16 * 16);
    const int w[4] = {q.x, q.y, q.z, q.w};
    __align__(16) __nv_bfloat162 out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // bytes i, i + 1 sign-extended, then exactly to float: the bits of
      // 1.5 * 2^23 plus v are the float 1.5 * 2^23 + v
      const int i = 2 * (k % 2);
      const int lo = (w[k / 2] << (24 - 8 * i)) >> 24;
      const int hi = (w[k / 2] << (16 - 8 * i)) >> 24;
      out[k] = __floats2bfloat162_rn(
          __int_as_float(0x4B400000 + lo) - 12582912.f,
          __int_as_float(0x4B400000 + hi) - 12582912.f);
    }
    int4* d = reinterpret_cast<int4*>(dst + r * ldd + c16 * 16);
    d[0] = reinterpret_cast<const int4*>(out)[0];
    d[1] = reinterpret_cast<const int4*>(out)[1];
  });
}

// ---- tensor cores: mma.sync m16n8k16, bf16 operands, fp32 accumulators --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 16x16 tile at p (row-major, row stride ld, rows 16-byte aligned) as
// an m16n8k16 A operand.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p + (lane % 16) * ld + (lane / 16) * 8)));
}

// The 16 (k) x 16 (n) tile at p (row-major [k][n]) as the B operands of two
// m16n8k16 products: b[0..1] for columns 0-7, b[2..3] for columns 8-15.
__device__ __forceinline__ void load_b(unsigned (&b)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p + (lane % 16) * ld + (lane / 16) * 8)));
}

// A 16x16 fp32 accumulator tile: two m16n8 halves.
struct Acc {
  float c[2][4];
};

__device__ __forceinline__ void clear(Acc& d) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) d.c[h][e] = 0.f;
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16) @ b (16x16)
__device__ __forceinline__ void mma16(Acc& d, const unsigned (&a)[4],
                                      const unsigned (&b)[4]) {
  mma(d.c[0], a, b[0], b[1]);
  mma(d.c[1], a, b[2], b[3]);
}

// Store d (plus e, when given) to the fp32 tile at p, row stride ld (even).
__device__ __forceinline__ void store_acc(float* p, int ld, const Acc& d,
                                          const Acc* e = nullptr) {
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;
  const int c = (lane % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = d.c[h][q] + (e ? e->c[h][q] : 0.f);
    *reinterpret_cast<float2*>(p + r * ld + h * 8 + c) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(p + (r + 8) * ld + h * 8 + c) =
        make_float2(v[2], v[3]);
  }
}

// ---- fp32 activations: FMAs on the CUDA cores ----------------------------

// acc[j] += sum_{k < K} a[(m0 + j*mstep)*lda + k] * b[k*ldb + n], K a
// multiple of 4 and a's rows 16-byte aligned: each thread's NOUT outputs
// share one column of b, so a b value feeds NOUT FMAs and a float4 of a
// feeds four.
template <int NOUT, typename W>
__device__ __forceinline__ void fma_tile(float (&acc)[kMaxOut],
                                         const float* a, int lda, int m0,
                                         int mstep, const W* b, int ldb,
                                         int n, int K) {
  for (int k = 0; k < K; k += 4) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = widen(b[(k + q) * ldb + n]);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(a + (m0 + j * mstep) * lda + k);
      acc[j] = fmaf(v.x, w[0], acc[j]);
      acc[j] = fmaf(v.y, w[1], acc[j]);
      acc[j] = fmaf(v.z, w[2], acc[j]);
      acc[j] = fmaf(v.w, w[3], acc[j]);
    }
  }
}

// fma_tile for the run-time output count nout (0 .. kMaxOut).
template <typename W>
__device__ __forceinline__ void fma_tile_n(int nout, float (&acc)[kMaxOut],
                                           const float* a, int lda, int m0,
                                           int mstep, const W* b, int ldb,
                                           int n, int K) {
  switch (nout) {
    case 0: break;
    case 1: fma_tile<1>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 2: fma_tile<2>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 3: fma_tile<3>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 4: fma_tile<4>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 5: fma_tile<5>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 6: fma_tile<6>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    case 7: fma_tile<7>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
    default: fma_tile<8>(acc, a, lda, m0, mstep, b, ldb, n, K); break;
  }
}

// Which 16x16 tiles of a T-tile product a warp owns, and which k-steps:
// tiles warp, warp + 8, ... with every k-step when T >= 8 (split 1), else
// tile warp % T with the k-steps ks = warp / T (mod split), split = 8 / T.
struct WarpTiles {
  bool active;
  int kpart;
  int row[kMaxAcc], col[kMaxAcc];  // tile origins; row -1: no tile
};

__device__ __forceinline__ WarpTiles warp_tiles(int warp, int T, int ntc,
                                                int split) {
  WarpTiles w;
  w.active = split == 1 || warp / T < split;
  w.kpart = split == 1 ? 0 : warp / T;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int t = split == 1 ? warp + i * kWarps : (i == 0 ? warp % T : T);
    w.row[i] = t < T && w.active ? (t / ntc) * 16 : -1;
    w.col[i] = t < T ? (t % ntc) * 16 : 0;
  }
  return w;
}

// One block's work: row tile `tile` of one problem (x, P2, P1, scales, y
// already at that problem's operands), i2 group blockIdx.y, i1 slice
// blockIdx.z.
template <typename T, typename W>
__device__ __forceinline__ void fused2_block(
    const T* __restrict__ x, const W* __restrict__ p2,
    const W* __restrict__ p1, const float* __restrict__ scales,
    T* __restrict__ y, const Geo& s, const int tile) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr bool conv = tc && std::is_same<W, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;

  const int row0 = tile * s.bb;
  const int rows = min(s.bb, s.B - row0);
  const int i20 = blockIdx.y * s.g;
  const int gn = min(s.g, s.m2 - i20);
  const int cbeg = blockIdx.z * s.nc;
  const int ncols = min(s.m1, cbeg + s.nc) - cbeg;
  const size_t M = (size_t)s.m1 * s.m2;
  const float s2 = scales != nullptr ? scales[0] : 1.f;
  const float s1 = scales != nullptr ? scales[1] : 1.f;

  const bool vec_x = (s.n2 * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_p2 = (s.m2 * s.r1 * sizeof(W)) % 16 == 0 &&
                      (s.r1 * sizeof(W)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p2) % 16 == 0;
  const bool vec_p1 = (s.m1 * sizeof(W)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p1) % 16 == 0;

  // The left operand of stage 2, zero where no (i2, b, j, r) maps.
  for (int i = threadIdx.x; i < s.offP1 / 4; i += kThreads)
    reinterpret_cast<float*>(smem)[i] = 0.f;

  constexpr int kVt = 16 / sizeof(T), kVw = 16 / sizeof(W);
  const Walk walk_x = make_walk(s.kc / kVt);
  const Walk walk_p2 = make_walk(s.N1p / kVw);
  const Walk walk_p1 = make_walk(s.nct / kVw);

  // Stage 2's first column chunks are in flight during stage 1.
  const int nch2 = (ncols + s.nct - 1) / s.nct;
  auto stage_p1 = [&](int chunk) {
    const int c0 = chunk * s.nct;
    W* dst = reinterpret_cast<W*>(smem + s.offP1 +
                                  (chunk % kStages2) * s.slot2);
    stage_tile(dst, s.ldp1, p1 + cbeg + c0, s.m1, s.K2p, s.nct, s.K2,
               min(s.nct, ncols - c0), vec_p1, walk_p1);
  };
  for (int c = 0; c < kStages2 - 1; ++c) {
    if (c < nch2) stage_p1(c);
    cp_async_commit();
  }

  // ---- stage 1: S [bb*n1, g*r1] = x tile @ P2 slice ------------------
  const int nch1 = (s.n2 + s.kc - 1) / s.kc;
  const T* xt = x + (size_t)row0 * s.n1 * s.n2;
  const W* p2t = p2 + (size_t)i20 * s.r1;
  auto stage_s1 = [&](int chunk) {
    const int k0 = chunk * s.kc;
    unsigned char* slot = smem + s.offR1 + (chunk % kStages1) * s.slot1;
    const int kv = min(s.kc, s.n2 - k0);
    stage_tile(reinterpret_cast<T*>(slot), s.ldx, xt + k0, s.n2, s.M1p,
               s.kc, rows * s.n1, kv, vec_x, walk_x);
    stage_tile(reinterpret_cast<W*>(slot + s.slotx), s.ldp2,
               p2t + (size_t)k0 * s.m2 * s.r1, s.m2 * s.r1, s.kc, s.N1p, kv,
               gn * s.r1, vec_p2, walk_p2);
  };
  for (int c = 0; c < kStages1 - 1; ++c) {
    if (c < nch1) stage_s1(c);
    cp_async_commit();
  }

  float* part = reinterpret_cast<float*>(smem + s.offR1);  // k-split sums
  if constexpr (tc) {
    const WarpTiles wt = warp_tiles(warp, (s.M1p / 16) * (s.N1p / 16),
                                    s.N1p / 16, s.split1);
    Acc acc[kMaxAcc];
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) clear(acc[i]);
    for (int c = 0; c < nch1; ++c) {
      cp_async_wait<kStages1 - 2>();
      __syncthreads();
      if (c + kStages1 - 1 < nch1) stage_s1(c + kStages1 - 1);
      cp_async_commit();
      unsigned char* slot = smem + s.offR1 + (c % kStages1) * s.slot1;
      const bf16* xs = reinterpret_cast<const bf16*>(slot);
      const bf16* ps = reinterpret_cast<const bf16*>(slot + s.slotx);
      int ldp = s.ldp2;
      if constexpr (conv) {
        bf16* pc = reinterpret_cast<bf16*>(smem + s.offR1 + s.offP2c);
        widen_tile(pc, s.ldp2c, reinterpret_cast<const int8_t*>(
                                    slot + s.slotx), s.ldp2, s.kc, s.N1p);
        __syncthreads();
        ps = pc;
        ldp = s.ldp2c;
      }
      const int ksteps = (min(s.kc, s.n2 - c * s.kc) + 15) / 16;
      for (int ks = wt.kpart; ks < ksteps; ks += s.split1) {
#pragma unroll
        for (int i = 0; i < kMaxAcc; ++i) {
          if (wt.row[i] >= 0) {
            unsigned a[4], b[4];
            load_a(a, xs + wt.row[i] * s.ldx + ks * 16, s.ldx);
            load_b(b, ps + ks * 16 * ldp + wt.col[i], ldp);
            mma16(acc[i], a, b);
          }
        }
      }
    }
    __syncthreads();  // the ring is dead; its bytes take the partial sums
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i)
      if (wt.row[i] >= 0)
        store_acc(part + (size_t)wt.kpart * s.M1p * s.ldS +
                      wt.row[i] * s.ldS + wt.col[i],
                  s.ldS, acc[i]);
  } else {
    // fp32: thread owns column n of the [M1p, N1p] tile (N1p a power of
    // two) and rows m0, m0 + kThreads/N1p, ... below M1p
    const int n = threadIdx.x % s.N1p;
    const int m0 = threadIdx.x / s.N1p;
    const int mstep = kThreads / s.N1p;
    const int nout = m0 < s.M1p ? (s.M1p - m0 + mstep - 1) / mstep : 0;
    float acc[kMaxOut];
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
    for (int c = 0; c < nch1; ++c) {
      cp_async_wait<kStages1 - 2>();
      __syncthreads();
      if (c + kStages1 - 1 < nch1) stage_s1(c + kStages1 - 1);
      cp_async_commit();
      unsigned char* slot = smem + s.offR1 + (c % kStages1) * s.slot1;
      const int kv = min(s.kc, s.n2 - c * s.kc);
      fma_tile_n(nout, acc, reinterpret_cast<const float*>(slot), s.ldx, m0,
                 mstep, reinterpret_cast<const W*>(slot + s.slotx), s.ldp2,
                 n, (kv + 3) / 4 * 4);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j)
      if (j < nout) part[(m0 + j * mstep) * s.ldS + n] = acc[j];
  }
  __syncthreads();

  // ---- S -> A: A[gi*bb + b, j*r1 + r] = s2 * S[b*n1 + j, gi*r1 + r] ---
  // Lanes take adjacent columns, warps adjacent rows (b, j).
  {
    const int lane = threadIdx.x % 32;
    const int ncol = gn * s.r1;
    for (int col = lane; col < ncol; col += 32) {
      const int gi = col / s.r1;
      const int r = col - gi * s.r1;
      int b = warp / s.n1;
      int j = warp - b * s.n1;
      for (int m = warp; m < rows * s.n1; m += kWarps) {
        float v = 0.f;
        for (int p = 0; p < s.split1; ++p)
          v += part[(size_t)p * s.M1p * s.ldS + m * s.ldS + col];
        v *= s2;
        const int ai = (gi * s.bb + b) * s.ldA + j * s.r1 + r;
        if constexpr (tc) {
          const bf16 hi = __float2bfloat16(v);
          reinterpret_cast<bf16*>(smem)[ai] = hi;
          reinterpret_cast<bf16*>(smem + s.offAlo)[ai] =
              __float2bfloat16(v - __bfloat162float(hi));
        } else {
          reinterpret_cast<float*>(smem)[ai] = v;
        }
        j += kWarps;
        while (j >= s.n1) {
          j -= s.n1;
          ++b;
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: O [g*bb, nct] = A @ P1 chunk, per column chunk --------
  float* out = reinterpret_cast<float*>(smem + s.offR1);
  const WarpTiles wt2 = warp_tiles(warp, (s.M2p / 16) * (s.nct / 16),
                                   s.nct / 16, s.split2);
  // With one row tile (g*bb <= 16) and n1*r1 <= 16*kRegK, every warp keeps
  // the whole of A (high and low parts) in registers for every column
  // chunk, and a k-step loads only its P1 operands.  The split over warps
  // is 1 or 8 / T2 then, a power of two.
  const bool a_in_regs = tc && s.M2p == 16 && s.K2p <= 16 * kRegK;
  unsigned ah[kRegK][4], al[kRegK][4];
  if (a_in_regs) {
#pragma unroll
    for (int ks = 0; ks < kRegK; ++ks) {
      if (ks < s.K2p / 16) {
        load_a(ah[ks], reinterpret_cast<const bf16*>(smem) + ks * 16, s.ldA);
        load_a(al[ks], reinterpret_cast<const bf16*>(smem + s.offAlo) +
                           ks * 16, s.ldA);
      }
    }
  }
  const int lg_gn = (gn & (gn - 1)) == 0 ? __ffs(gn) - 1 : -1;  // log2
  // y's runs of gn outputs are whole, aligned 16-byte words
  constexpr int kVecY = 16 / sizeof(T);
  const bool vec_y = gn == kVecY && (s.m2 * sizeof(T)) % 16 == 0 &&
                     (i20 * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int n2c = threadIdx.x % s.nct;           // fp32 path
  const int m20 = threadIdx.x / s.nct;
  const int mstep2 = kThreads / s.nct;
  const int nout2 = m20 < s.M2p ? (s.M2p - m20 + mstep2 - 1) / mstep2 : 0;
  for (int c = 0; c < nch2; ++c) {
    cp_async_wait<kStages2 - 2>();
    __syncthreads();
    if (c + kStages2 - 1 < nch2) stage_p1(c + kStages2 - 1);
    cp_async_commit();
    const W* praw = reinterpret_cast<const W*>(smem + s.offP1 +
                                               (c % kStages2) * s.slot2);
    if constexpr (tc) {
      const bf16* ps = reinterpret_cast<const bf16*>(praw);
      int ldp = s.ldp1;
      if constexpr (conv) {
        bf16* pc = reinterpret_cast<bf16*>(smem + s.offP1c);
        widen_tile(pc, s.ldp1c, reinterpret_cast<const int8_t*>(praw),
                   s.ldp1, s.K2p, s.nct);
        __syncthreads();
        ps = pc;
        ldp = s.ldp1c;
      }
      // the high and low parts accumulate apart (two independent chains)
      Acc hi[kMaxAcc], lo[kMaxAcc];
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i) {
        clear(hi[i]);
        clear(lo[i]);
      }
      if (a_in_regs) {
#pragma unroll
        for (int ks = 0; ks < kRegK; ++ks) {
          if (ks < s.K2p / 16 && (ks & (s.split2 - 1)) == wt2.kpart) {
#pragma unroll
            for (int i = 0; i < kMaxAcc; ++i) {
              if (wt2.row[i] >= 0) {
                unsigned b[4];
                load_b(b, ps + ks * 16 * ldp + wt2.col[i], ldp);
                mma16(hi[i], ah[ks], b);
                mma16(lo[i], al[ks], b);
              }
            }
          }
        }
      } else {
        const bf16* ahi = reinterpret_cast<const bf16*>(smem);
        const bf16* alo = reinterpret_cast<const bf16*>(smem + s.offAlo);
        for (int ks = wt2.kpart; ks < s.K2p / 16; ks += s.split2) {
#pragma unroll
          for (int i = 0; i < kMaxAcc; ++i) {
            if (wt2.row[i] >= 0) {
              unsigned a[4], b[4];
              load_b(b, ps + ks * 16 * ldp + wt2.col[i], ldp);
              load_a(a, ahi + wt2.row[i] * s.ldA + ks * 16, s.ldA);
              mma16(hi[i], a, b);
              load_a(a, alo + wt2.row[i] * s.ldA + ks * 16, s.ldA);
              mma16(lo[i], a, b);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i)
        if (wt2.row[i] >= 0)
          store_acc(out + (size_t)wt2.kpart * s.M2p * s.ldO +
                        wt2.row[i] * s.ldO + wt2.col[i],
                    s.ldO, hi[i], &lo[i]);
    } else {
      float acc[kMaxOut];
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
      fma_tile_n(nout2, acc, reinterpret_cast<const float*>(smem), s.ldA,
                 m20, mstep2, praw, s.ldp1, n2c, s.K2p);
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j)
        if (j < nout2) out[(m20 + j * mstep2) * s.ldO + n2c] = acc[j];
    }
    __syncthreads();
    // y[row0 + b, i1*m2 + i20 + gi] = s1 * O[gi*bb + b, i1 - cbeg - c0],
    // gi fastest: adjacent threads write adjacent outputs
    const int c0 = c * s.nct;
    const int cn = min(s.nct, ncols - c0);
    T* yc = y + (size_t)row0 * M + (size_t)(cbeg + c0) * s.m2 + i20;
    auto o_at = [&](int m, int t) {
      float v = 0.f;
      for (int p = 0; p < s.split2; ++p)
        v += out[(size_t)p * s.M2p * s.ldO + m * s.ldO + t];
      return v * s1;
    };
    if (vec_y) {
      // a group of 16 bytes of i2 values per (b, i1): one 16-byte store
      for_each_2d(rows, cn, [&](int b, int t) {
        __align__(16) T v[kVecY];
#pragma unroll
        for (int gi = 0; gi < kVecY; ++gi) store(&v[gi], o_at(gi * s.bb + b, t));
        *reinterpret_cast<int4*>(yc + (size_t)b * M + (size_t)t * s.m2) =
            *reinterpret_cast<const int4*>(v);
      });
    } else {
      for_each_2d(rows, cn * gn, [&](int b, int q) {
        const int t = lg_gn >= 0 ? q >> lg_gn : q / gn;
        const int gi = q - t * gn;
        store(yc + (size_t)b * M + (size_t)t * s.m2 + gi,
              o_at(gi * s.bb + b, t));
      });
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_fused2_kernel(const T* __restrict__ x, const W* __restrict__ p2,
                 const W* __restrict__ p1, const float* __restrict__ scales,
                 T* __restrict__ y, const Geo s) {
  fused2_block<T, W>(x, p2, p1, scales, y, s, blockIdx.x);
}

// The expert-batched launch: block x = e * row_tiles + row tile, each
// block on expert e's operands.  A kernel of its own name, so that a trace
// tells the experts' projections from the plain ones.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_fused2_experts_kernel(const T* __restrict__ x, const W* __restrict__ p2,
                         const W* __restrict__ p1,
                         const float* __restrict__ scales,
                         T* __restrict__ y, const Geo s) {
  const int tiles = (s.B + s.bb - 1) / s.bb;
  const int e = blockIdx.x / tiles;
  fused2_block<T, W>(x + (size_t)e * s.B * s.n1 * s.n2,
                     p2 + (size_t)e * s.n2 * s.m2 * s.r1,
                     p1 + (size_t)e * s.n1 * s.r1 * s.m1,
                     scales != nullptr ? scales + 2 * e : nullptr,
                     y + (size_t)e * s.B * s.m1 * s.m2, s,
                     blockIdx.x - e * tiles);
}

template <typename T, typename W, bool kExperts>
int launch(const void* x, const void* p2, const void* p1,
           const float* scales, void* y, int E, int B, int n1, int n2,
           int m1, int m2, int r1, int bb, int g, int nc, int kc, int nct,
           int smem_expected, cudaStream_t stream) {
  const Geo s = make_geo<T, W>(B, n1, n2, m1, m2, r1, bb, g, nc, kc, nct);
  // the host's fit rule (tt_contract.fused2_smem_bytes) and this layout
  // must agree, and the tiles must fit the accumulators
  constexpr int max_tile = std::is_same<T, bf16>::value
                               ? kWarps * kMaxAcc * 256  // 16x16 tiles
                               : kThreads * kMaxOut;
  constexpr bool tc = std::is_same<T, bf16>::value;
  if (s.size != smem_expected || kc % 16 != 0 || nct % 16 != 0 ||
      nc % 16 != 0 || s.M1p * s.N1p > max_tile || s.M2p * nct > max_tile ||
      (!tc && (nct & (nct - 1)) != 0) || E < 1 || (!kExperts && E != 1) ||
      (long long)E * ((B + bb - 1) / bb) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = kExperts ? tt_fused2_experts_kernel<T, W>
                         : tt_fused2_kernel<T, W>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static int opted = 48 * 1024;
  if (s.size > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.size);
    if (err != cudaSuccess) return (int)err;
    opted = s.size;
  }
  const dim3 grid(E * ((B + bb - 1) / bb), (m2 + g - 1) / g,
                  (m1 + nc - 1) / nc);
  kernel<<<grid, kThreads, s.size, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(p2),
      static_cast<const W*>(p1), scales, static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer; the tiles (bb, g, nc, kc, nct) and the shared memory they need
// come from tt_contract.fused2_geometry.  The kernel runs on ``stream`` and
// the call returns cudaGetLastError(), or cudaErrorInvalidValue when the
// tiles do not match this file's layout.
extern "C" {

int tt_fused2_f32(const void* x, const void* p2, const void* p1, void* y,
                  int B, int n1, int n2, int m1, int m2, int r1, int bb,
                  int g, int nc, int kc, int nct, int smem, void* stream) {
  return launch<float, float, false>(x, p2, p1, nullptr, y, 1, B, n1, n2,
                                     m1, m2, r1, bb, g, nc, kc, nct, smem,
                                     (cudaStream_t)stream);
}

int tt_fused2_bf16(const void* x, const void* p2, const void* p1, void* y,
                   int B, int n1, int n2, int m1, int m2, int r1, int bb,
                   int g, int nc, int kc, int nct, int smem, void* stream) {
  return launch<bf16, bf16, false>(x, p2, p1, nullptr, y, 1, B, n1, n2, m1,
                                   m2, r1, bb, g, nc, kc, nct, smem,
                                   (cudaStream_t)stream);
}

int tt_fused2_int8_f32(const void* x, const void* p2, const void* p1,
                       const void* scales, void* y, int B, int n1, int n2,
                       int m1, int m2, int r1, int bb, int g, int nc, int kc,
                       int nct, int smem, void* stream) {
  return launch<float, int8_t, false>(x, p2, p1, (const float*)scales, y, 1,
                                      B, n1, n2, m1, m2, r1, bb, g, nc, kc,
                                      nct, smem, (cudaStream_t)stream);
}

int tt_fused2_int8_bf16(const void* x, const void* p2, const void* p1,
                        const void* scales, void* y, int B, int n1, int n2,
                        int m1, int m2, int r1, int bb, int g, int nc,
                        int kc, int nct, int smem, void* stream) {
  return launch<bf16, int8_t, false>(x, p2, p1, (const float*)scales, y, 1,
                                     B, n1, n2, m1, m2, r1, bb, g, nc, kc,
                                     nct, smem, (cudaStream_t)stream);
}

// Expert-batched: E problems of B rows each (x [E, B, n1*n2], P2 [E, n2,
// m2*r1], P1 [E, n1*r1, m1], scales [E, 2], y [E, B, m1*m2]), one launch.
int tt_fused2_experts_f32(const void* x, const void* p2, const void* p1,
                          void* y, int E, int B, int n1, int n2, int m1,
                          int m2, int r1, int bb, int g, int nc, int kc,
                          int nct, int smem, void* stream) {
  return launch<float, float, true>(x, p2, p1, nullptr, y, E, B, n1, n2, m1,
                                    m2, r1, bb, g, nc, kc, nct, smem,
                                    (cudaStream_t)stream);
}

int tt_fused2_experts_bf16(const void* x, const void* p2, const void* p1,
                           void* y, int E, int B, int n1, int n2, int m1,
                           int m2, int r1, int bb, int g, int nc, int kc,
                           int nct, int smem, void* stream) {
  return launch<bf16, bf16, true>(x, p2, p1, nullptr, y, E, B, n1, n2, m1,
                                  m2, r1, bb, g, nc, kc, nct, smem,
                                  (cudaStream_t)stream);
}

int tt_fused2_experts_int8_f32(const void* x, const void* p2, const void* p1,
                               const void* scales, void* y, int E, int B,
                               int n1, int n2, int m1, int m2, int r1, int bb,
                               int g, int nc, int kc, int nct, int smem,
                               void* stream) {
  return launch<float, int8_t, true>(x, p2, p1, (const float*)scales, y, E,
                                     B, n1, n2, m1, m2, r1, bb, g, nc, kc,
                                     nct, smem, (cudaStream_t)stream);
}

int tt_fused2_experts_int8_bf16(const void* x, const void* p2,
                                const void* p1, const void* scales, void* y,
                                int E, int B, int n1, int n2, int m1, int m2,
                                int r1, int bb, int g, int nc, int kc,
                                int nct, int smem, void* stream) {
  return launch<bf16, int8_t, true>(x, p2, p1, (const float*)scales, y, E,
                                    B, n1, n2, m1, m2, r1, bb, g, nc, kc,
                                    nct, smem, (cudaStream_t)stream);
}

}  // extern "C"
