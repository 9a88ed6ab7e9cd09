// Fused tensor-train chain of any depth 2 <= d <= 8 for Hopper (sm_90a), fp
// and int8-resident cores.  Replaces the Pallas TPU kernels
// tt_fused_chain_pallas and tt_fused_chain_int8_pallas
// (src/repro/kernels/tt_contract.py, bodies _fused_chain_body and
// _fused_chain_int8_body).
//
// Computes, for every row of x [B, N] and for steps j = 0 .. d-1 (core
// t = d-1-j, 0-based, executed last core first):
//   out[b, m, i, r] = sum_k state[b, i*K + k] * P_j[k, m*R + r]     (* s_j)
// with K = n_t*r_{t+1}, R = r_t, P_j [K, m_t*R] the packed core and the
// output in the relaid order [m_t, b_t, r_t], which is the next step's
// state.  The state is fp32 for every activation type, as in the TPU body;
// y [B, M] is written in x's type.  Boundary ranks are 1.
//
// What bounds it on the H100: by the data sheet bytes at both row counts
// (at 4 rows the 93 KB of bf16 cores of a full-width deepseek-7b length-3
// projection, at 256 the activations).  In practice a block's dependent
// phases do: issuing its copies, then per step a wait, a barrier, a short
// product and its epilogue, each a chain of dependent instructions that a
// few warps per SM cannot hide (clock64 traces of one block; PERF.md §6).
//
// The decomposition.  The first step works on core d-1; its output mode
// m_{d-1} is never contracted again and rides in the batch part of every
// later state: after core t the layout is [m_t, ..., m_{d-1}, n_0, ...,
// n_{t-1}, r_t].  So the layer is m_{d-1} independent chains, and a block
// owns (a tile of bb rows, a group of g consecutive m_{d-1} values) with
// no recompute.  Where that leaves SMs idle (decode: 4 rows x 8 groups), a
// block also takes a group of g2 m_{d-2} values: the second step computes
// only those columns, and every block of the same (rows, g group)
// recomputes the first step alone.  Nothing is split deeper.  A block's
// states are the global ones with m_{d-1} (and m_{d-2}) restricted to its
// groups, and the last step writes y's rows in runs of g values at stride
// m_{d-1}.  The host (tt_contract.chain_geometry) picks bb, g, g2 and the
// column chunk per launch.
//
// Staging.  x's row tile goes to shared memory as the first step's left
// operand [bb*N/n_{d-1}, n_{d-1}], padded.  Each step's core slice (the
// block's column group at steps 0 and 1, all columns later) is staged in
// column chunks through a ring of two slots, one item (step, chunk) ahead:
// the next step's core arrives while the current step computes.  (A chain
// whose core chunk is too tall for two slots, such as a length-2 core of
// 1376 rows in fp32, gets one slot and waits for each chunk.)  Copies
// are cp.async of 16, 8 or 4 bytes, as wide as the operand's alignment
// allows (adjacent threads on adjacent addresses, offsets stepped by
// adds); a misaligned operand is staged by a scalar loop in the same
// kernel.  Ragged edges are zero-filled.  The states of steps 1 .. d-1
// alternate between two shared-memory buffers and never leave the SM; each
// step's epilogue writes its outputs straight into the next step's
// operand layout (row (b, i / n), column (i % n, r)), or into y.  An
// output's address is a row part plus a column part, read from tables that
// the host builds once per launch geometry (tt_contract.chain_tables, four
// variants for the ragged last groups) and each block stages with x, so a
// block does no integer division for addresses.
//
// Arithmetic.  A block has 512 threads: 16 warps hide the latency of each
// warp's chain of products and stores better than 8 (measured at both row
// counts).  bf16 activations run every step on the tensor cores (ldmatrix
// + mma.sync m16n8k16, fp32 accumulators, 2x2 tiles of 16x16 per warp, one
// where the product is small).  The first step's operand is x itself,
// exact in bf16.  Later states are fp32, so each is stored as a bf16 high
// part and a bf16 low part (v - hi) and both are multiplied, keeping about
// 16 significant bits; with an even rank two adjacent outputs are
// converted and stored as one bf16 pair per part.  int8 cores are widened
// to bf16 in shared memory, exact for codes up to 127; each step's fp32
// output is multiplied by its scale before the split.  fp32 activations
// use fp32 FMAs on the CUDA cores in 4x4 register tiles (no TF32) in the
// same grid and staging.  Every sum is taken in a fixed order and each
// output is written by one thread, so the result is deterministic.  One
// launch per projection; no cluster, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8;   // deepest chain a launch takes (MAX_CHAIN_DEPTH)
constexpr int kRT = 4;     // fp32 register tile: kRT x kRT outputs

// The launch's geometry and shared-memory layout, computed on the host by
// make_geo (and by tt_contract.chain_smem_bytes, which must agree).  Per
// step j: contraction K (padded Kp), core columns C, rank R, the n of the
// next core (nn; 1 at the last step), the column chunk cc, and the row
// strides of the left operand (ldA) and of a staged chunk (ldB), where
// its address tables for rows and for columns start (int entries into a
// variant of tabInts entries), and the block's b rows per row of x divided
// by its g (from step 1) and g2 (from step 2) values (unit).
struct Geo {
  int d, B, N, M, bb, g, g2, ncc, stages;
  int ns[kMaxD], ms[kMaxD];
  int K[kMaxD], Kp[kMaxD], C[kMaxD], R[kMaxD], nn[kMaxD];
  int cc[kMaxD], ldA[kMaxD], ldB[kMaxD], tabRow[kMaxD], tabCol[kMaxD];
  int unit[kMaxD];
  int offBuf[2], offSlot[2], offConv, offTab, tabInts, size;
  const void* p[kMaxD];
  const int* tabs;
};

__host__ __device__ constexpr long long round_up(long long a, long long b) {
  return (a + b - 1) / b * b;
}

template <typename T, typename W>
Geo make_geo(int d, const int* ns, const int* ms, const int* ranks, int B,
             int bb, int g, int g2, int ncc, int stages) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr bool conv = tc && std::is_same<W, int8_t>::value;
  constexpr int a = sizeof(T), w = sizeof(W);
  Geo s{};
  s.d = d; s.B = B; s.bb = bb; s.g = g; s.g2 = g2; s.ncc = ncc;
  s.stages = stages;
  long long N = 1, M = 1;
  for (int t = 0; t < d; ++t) {
    s.ns[t] = ns[t];
    s.ms[t] = ms[t];
    N *= ns[t];
    M *= ms[t];
  }
  s.N = (int)N;
  s.M = (int)M;
  long long bl = N / ns[d - 1];   // the block's b rows per row of x
  long long unit = bl;
  long long buf[2] = {0, 0}, slot = 0, cbuf = 0, tab = 0;
  for (int j = 0; j < d; ++j) {
    const int t = d - 1 - j;
    s.K[j] = ns[t] * ranks[t + 1];
    s.Kp[j] = (int)round_up(s.K[j], 16);
    s.R[j] = ranks[t];
    s.C[j] = ms[t] * ranks[t];
    s.nn[j] = t > 0 ? ns[t - 1] : 1;
    const int mloc = j == 0 ? g : j == 1 ? g2 : ms[t];
    s.cc[j] = (int)std::min(round_up((long long)mloc * s.R[j], 16),
                            (long long)ncc);
    s.ldA[j] = s.Kp[j] + (tc ? 8 : 4);
    s.ldB[j] = s.cc[j] + 16 / w;
    buf[j % 2] = std::max(buf[j % 2], round_up(bb * bl, 16) * s.ldA[j] *
                                          (j == 0 ? a : 4));
    slot = std::max(slot, (long long)s.Kp[j] * s.ldB[j] * w);
    if (conv) cbuf = std::max(cbuf, (long long)s.Kp[j] * (s.cc[j] + 8) * 2);
    s.tabRow[j] = (int)tab;
    tab += round_up(bb * bl, 16);
    s.tabCol[j] = (int)tab;
    tab += round_up((long long)mloc * s.R[j], 16);
    s.unit[j] = (int)unit;
    unit = (j >= 2 ? mloc : 1) * unit / s.nn[j];
    bl = mloc * bl / s.nn[j];
  }
  const long long off1 = round_up(buf[0], 128);
  const long long offs = off1 + round_up(buf[1], 128);
  const long long offc = offs + stages * round_up(slot, 128);
  const long long offt = offc + round_up(cbuf, 128);
  const long long size = offt + round_up(tab * 4, 128);
  s.offBuf[0] = 0;
  s.offBuf[1] = (int)off1;
  s.offSlot[0] = (int)offs;
  s.offSlot[1] = (int)(offs + (stages - 1) * round_up(slot, 128));
  s.offConv = (int)offc;
  s.offTab = (int)offt;
  s.tabInts = (int)tab;
  s.size = size > INT_MAX ? -1 : (int)size;
  return s;
}

template <typename E> __device__ __forceinline__ E zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <> __device__ __forceinline__ int zero<int>() { return 0; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(VB), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Call f(r, c) for every r < rows, c < cols (c fastest), spread over nt
// threads of which this one is t (by default the block's).  Index math is a
// few adds per element; the two divisions happen once per call.
template <typename F>
__device__ __forceinline__ void for_each_2d(int rows, int cols, F f,
                                            int t = threadIdx.x,
                                            int nt = kThreads) {
  const int dr = nt / cols;
  const int dc = nt - dr * cols;
  int r = t / cols;
  int c = t - r * cols;
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

// The widest cp.async (16, 8 or 4 bytes) that an operand at p with rows of
// row_bytes bytes allows; 0: scalar.
__device__ __forceinline__ int vec_bytes(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | (uintptr_t)row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

// Stage the tile [rowsp, colsp] of a row-major matrix (row stride ld
// elements) whose element (0, 0) is at src into shared memory (row stride
// lds, 16-byte rows) by nt threads of which this one is t; elements outside
// the rv x cv valid corner are zero.  VB-byte copies, a walk over colsp / V
// vectors per row stepped by adds.
template <typename E, int VB>
__device__ __forceinline__ void stage_vec(E* dst, int lds, const E* src,
                                          int ld, int rowsp, int colsp,
                                          int rv, int cv, int t, int nt) {
  constexpr int V = VB / sizeof(E);
  const int vpr = colsp / V;
  const int dr = nt / vpr, dc = nt - dr * vpr;
  int r = t / vpr;
  int c = (t - r * vpr) * V;
  int so = r * lds + c, go = r * ld + c;
  const int sstep = dr * lds + dc * V, gstep = dr * ld + dc * V;
  while (r < rowsp) {
    const int n = r < rv ? min(V, cv - c) : 0;
    cp_async<VB>(dst + so, n > 0 ? src + go : src,
                 max(n, 0) * (int)sizeof(E));
    r += dr;
    c += dc * V;
    so += sstep;
    go += gstep;
    if (c >= colsp) {
      c -= colsp;
      ++r;
      so += lds - colsp;
      go += ld - colsp;
    }
  }
}

template <typename E>
__device__ __forceinline__ void stage_tile(E* dst, int lds, const E* src,
                                           int ld, int rowsp, int colsp,
                                           int rv, int cv,
                                           int t = threadIdx.x,
                                           int nt = kThreads) {
  const int vb = vec_bytes(src, ld * (int)sizeof(E));
  if (vb == 16) {
    stage_vec<E, 16>(dst, lds, src, ld, rowsp, colsp, rv, cv, t, nt);
  } else if (vb == 8) {
    stage_vec<E, 8>(dst, lds, src, ld, rowsp, colsp, rv, cv, t, nt);
  } else if (vb == 4 && sizeof(E) <= 4) {
    stage_vec<E, 4>(dst, lds, src, ld, rowsp, colsp, rv, cv, t, nt);
  } else {
    for_each_2d(rowsp, colsp, [&](int r, int c) {
      dst[r * lds + c] = r < rv && c < cv ? src[r * ld + c] : zero<E>();
    }, t, nt);
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
    int4* o = reinterpret_cast<int4*>(dst + r * ldd + c16 * 16);
    o[0] = reinterpret_cast<const int4*>(out)[0];
    o[1] = reinterpret_cast<const int4*>(out)[1];
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

// Where a tensor-core step stores its fp32 sums, times the step's scale:
// one(o, v) stores one output at offset o, two(o, v0, v1) the outputs of
// two adjacent fragment columns at o and o + 1 (kPairs: their addresses
// are adjacent and 4-byte aligned).
//  * Split: the next state as a bf16 high part and a bf16 low part (v -
//    hi).  With an even rank, columns c and c + 1 (c even) are ranks r and
//    r + 1 of one output, adjacent in the next state, so a pair is one
//    conversion and one 4-byte store per part.
//  * YSink: y from the block's first output, in x's type (a pair's
//    outputs are m_0 values apart).
template <bool kPair>
struct Split {
  static constexpr bool kPairs = kPair;
  bf16* hi;
  bf16* lo;
  float sc;
  __device__ __forceinline__ void one(int o, float v) const {
    v *= sc;
    const bf16 h = __float2bfloat16(v);
    hi[o] = h;
    lo[o] = __float2bfloat16(v - __bfloat162float(h));
  }
  __device__ __forceinline__ void two(int o, float v0, float v1) const {
    v0 *= sc;
    v1 *= sc;
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(hi + o) = h;
    *reinterpret_cast<__nv_bfloat162*>(lo + o) = __floats2bfloat162_rn(
        v0 - __low2float(h), v1 - __high2float(h));
  }
};

template <typename T>
struct YSink {
  static constexpr bool kPairs = false;
  T* y;
  float sc;
  __device__ __forceinline__ void one(int o, float v) const {
    store(y + o, v * sc);
  }
  __device__ __forceinline__ void two(int, float, float) const {}
};

// One column chunk of one step on the tensor cores: [Mt*16, Ks*16] @
// [Ks*16, Nt*16] in warp tiles of WM x WN 16x16 tiles, A's high part and,
// when Alo is given, its low part.  Stores every output (r < Mv, c < Nv)
// at rowT[r] + colT[c] through the sink (Split, YSink); a warp loads all
// its table entries before it stores.
template <int WM, int WN, typename S>
__device__ __forceinline__ void mma_tiles(const bf16* Ahi, const bf16* Alo,
                                          int lda, int Mt, const bf16* Bs,
                                          int ldb, int Nt, int Ks,
                                          const int* rowT, int Mv,
                                          const int* colT, int Nv,
                                          const S& sink) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int WTn = (Nt + WN - 1) / WN;
  const int WT = (Mt + WM - 1) / WM * WTn;
  for (int wt = warp; wt < WT; wt += kWarps) {
    const int tm0 = wt / WTn * WM, tn0 = (wt % WTn) * WN;
    Acc hi[WM][WN], lo[WM][WN];
#pragma unroll
    for (int im = 0; im < WM; ++im)
#pragma unroll
      for (int jn = 0; jn < WN; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hi[im][jn].c[h][q] = lo[im][jn].c[h][q] = 0.f;
    // a tile past the edge repeats the last one and is not stored
    const bf16* ap[WM];
    const bf16* bp[WN];
#pragma unroll
    for (int im = 0; im < WM; ++im)
      ap[im] = Ahi + min(tm0 + im, Mt - 1) * 16 * lda;
#pragma unroll
    for (int jn = 0; jn < WN; ++jn) bp[jn] = Bs + min(tn0 + jn, Nt - 1) * 16;
    const long long lo_off = Alo != nullptr ? Alo - Ahi : 0;
#pragma unroll 2
    for (int ks = 0; ks < Ks; ++ks) {
      unsigned b[WN][4];
#pragma unroll
      for (int jn = 0; jn < WN; ++jn)
        load_b(b[jn], bp[jn] + ks * 16 * ldb, ldb);
#pragma unroll
      for (int im = 0; im < WM; ++im) {
        unsigned a[4];
        load_a(a, ap[im] + ks * 16, lda);
#pragma unroll
        for (int jn = 0; jn < WN; ++jn) mma16(hi[im][jn], a, b[jn]);
        if (Alo != nullptr) {
          load_a(a, ap[im] + lo_off + ks * 16, lda);
#pragma unroll
          for (int jn = 0; jn < WN; ++jn) mma16(lo[im][jn], a, b[jn]);
        }
      }
    }
    // fragment (h, q): row lane/4 (+8 for q >= 2), column h*8 + 2*(lane%4)
    // + q%2 of the tile; -1 marks a row or column past the edge
    int ro[WM][2], co[WN][4];
#pragma unroll
    for (int im = 0; im < WM; ++im)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = (tm0 + im) * 16 + lane / 4 + rr * 8;
        ro[im][rr] = tm0 + im < Mt && r < Mv ? rowT[r] : -1;
      }
#pragma unroll
    for (int jn = 0; jn < WN; ++jn)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = (tn0 + jn) * 16 + (k / 2) * 8 + 2 * (lane % 4) + k % 2;
        co[jn][k] = tn0 + jn < Nt && c < Nv ? colT[c] : -1;
      }
#pragma unroll
    for (int im = 0; im < WM; ++im)
#pragma unroll
      for (int jn = 0; jn < WN; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = ro[im][rr];
            const int c0 = co[jn][h * 2], c1 = co[jn][h * 2 + 1];
            const float v0 = hi[im][jn].c[h][rr * 2] + lo[im][jn].c[h][rr * 2];
            const float v1 =
                hi[im][jn].c[h][rr * 2 + 1] + lo[im][jn].c[h][rr * 2 + 1];
            if (r < 0) continue;
            if (S::kPairs && c1 >= 0) {   // c1 valid: so is c0 = c1 - 1
              sink.two(r + c0, v0, v1);
            } else {
              if (c0 >= 0) sink.one(r + c0, v0);
              if (c1 >= 0) sink.one(r + c1, v1);
            }
          }
  }
}

// mma_tiles with one tile per warp where the warps outnumber the tiles or
// the product is one tile tall or wide, else 2x2 tiles per warp (each A
// and B operand loaded once for two products).
template <typename S>
__device__ __forceinline__ void mma_chunk(const bf16* Ahi, const bf16* Alo,
                                          int lda, int Mt, const bf16* Bs,
                                          int ldb, int Nt, int Ks,
                                          const int* rowT, int Mv,
                                          const int* colT, int Nv,
                                          const S& sink) {
  if (Mt * Nt <= kWarps || Mt == 1 || Nt == 1) {
    mma_tiles<1, 1>(Ahi, Alo, lda, Mt, Bs, ldb, Nt, Ks, rowT, Mv, colT, Nv,
                    sink);
  } else {
    mma_tiles<2, 2>(Ahi, Alo, lda, Mt, Bs, ldb, Nt, Ks, rowT, Mv, colT, Nv,
                    sink);
  }
}

// ---- fp32 activations: FMAs on the CUDA cores ----------------------------

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const int8_t* p) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// One column chunk of one step: [Mv, Kp] @ [Kp, Nv] (Kp a multiple of 4;
// the padding of A and B is zero), each thread a kRT x kRT register tile
// of outputs; out(r, c, v) for every output.
template <typename W, typename F>
__device__ __forceinline__ void fma_chunk(const float* A, int lda, int Mv,
                                          const W* Bs, int ldb, int Nv,
                                          int Kp, F out) {
  const int TM = (Mv + kRT - 1) / kRT, TN = (Nv + kRT - 1) / kRT;
  for (int t = threadIdx.x; t < TM * TN; t += kThreads) {
    const int m0 = t / TN * kRT, n0 = (t % TN) * kRT;
    float acc[kRT][kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
    const float* a = A + m0 * lda;
    const W* b = Bs + n0;
    for (int k = 0; k < Kp; k += 4) {
      float av[kRT][4], bv[4][kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) load4(av[i], a + i * lda + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(bv[q], b + (k + q) * ldb);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kRT; ++j)
            acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
    }
    out(m0, n0, acc);
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
tt_chain_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                T* __restrict__ y, const Geo s) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr bool conv = tc && std::is_same<W, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = s.d;
  const int row0 = blockIdx.x * s.bb;
  const int rows = min(s.bb, s.B - row0);
  const int gs = blockIdx.y * s.g;
  const int gn = min(s.g, s.ms[d - 1] - gs);
  const int g2s = blockIdx.z * s.g2;
  const int g2n = min(s.g2, s.ms[d - 2] - g2s);

  // The block's share of each step: b rows per row of x, its first core
  // column and column count, its column chunks.
  int bl[kMaxD + 1], col0[kMaxD], cw[kMaxD], nch[kMaxD];
  for (int j = 0; j < d; ++j) {
    const int mloc = j == 0 ? gn : j == 1 ? g2n : s.ms[d - 1 - j];
    bl[j] = s.unit[j] * (j >= 1 ? gn : 1) * (j >= 2 ? g2n : 1);
    col0[j] = (j == 0 ? gs : j == 1 ? g2s : 0) * s.R[j];
    cw[j] = mloc * s.R[j];
    nch[j] = 0;
    for (int c = 0; c < cw[j]; c += s.cc[j]) ++nch[j];
  }
  // The copies ahead of step 0 go out from four quarters of the block at
  // once, each issuing one: x's row tile as the first step's left operand
  // [rows*bl0, n_{d-1}], the block's variant of the address tables and the
  // first item (commit group 0), the second item (group 1).
  constexpr int nq = kThreads / 4;
  const int quarter = threadIdx.x / nq;
  const int tq = threadIdx.x - quarter * nq;
  int* tabs = reinterpret_cast<int*>(smem + s.offTab);
  if (quarter == 0) {
    stage_tile(reinterpret_cast<T*>(smem + s.offBuf[0]), s.ldA[0],
               x + (size_t)row0 * s.N, s.ns[d - 1],
               (int)round_up(rows * bl[0], 16), s.Kp[0], rows * bl[0],
               s.ns[d - 1], tq, nq);
  } else if (quarter == 1) {
    const int variant = (gn < s.g) + 2 * (g2n < s.g2);
    stage_tile(tabs, s.tabInts, s.tabs + variant * s.tabInts, s.tabInts, 1,
               s.tabInts, 1, s.tabInts, tq, nq);
  }
  // y offsets in the tables are from the block's first output
  const int ybase = row0 * s.M + (d == 2 ? gs + g2s * s.ms[1]
                                        : g2s * s.ms[d - 1] + gs);
  // Items (step, column chunk) in order; the ring stages the next one into
  // the slot the current one frees (with one slot, after it is used), by
  // the threads t < nt of the block where mine.
  int pj = 0, pc = 0;
  auto stage_next = [&](int slot, bool mine, int t, int nt) {
    if (pj < d) {
      if (mine)
        stage_tile(reinterpret_cast<W*>(smem + s.offSlot[slot]), s.ldB[pj],
                   static_cast<const W*>(s.p[pj]) + col0[pj] +
                       pc * s.cc[pj],
                   s.C[pj], s.Kp[pj], s.cc[pj], s.K[pj],
                   min(s.cc[pj], cw[pj] - pc * s.cc[pj]), t, nt);
      if (++pc == nch[pj]) {
        pc = 0;
        ++pj;
      }
    }
    cp_async_commit();
  };
  stage_next(0, quarter == 2, tq, nq);
  if (s.stages == 2) stage_next(1, quarter == 3, tq, nq);

  int slot = 0;
  for (int j = 0; j < d; ++j) {
    const bool last = j == d - 1;
    const int Mv = rows * bl[j];
    const int Mp = (int)round_up(Mv, 16);
    const float sc = scales != nullptr ? scales[j] : 1.f;
    // the next state: high and low bf16 parts, or fp32
    const int ld2 = last ? 0 : s.ldA[j + 1];
    const int MpN = last ? 0 : (int)round_up(rows * bl[j + 1], 16);
    unsigned char* next = smem + s.offBuf[(j + 1) & 1];
    bf16* nhi = reinterpret_cast<bf16*>(next);
    bf16* nlo = nhi + (size_t)MpN * ld2;
    float* nf = reinterpret_cast<float*>(next);
    if (!last && s.K[j + 1] % 16 != 0) {
      // its padding columns multiply the zero rows of the next core
      const int K2 = s.K[j + 1];
      for_each_2d(MpN, s.Kp[j + 1] - K2, [&](int r, int k) {
        const int o = r * ld2 + K2 + k;
        if constexpr (tc) {
          nhi[o] = zero<bf16>();
          nlo[o] = zero<bf16>();
        } else {
          nf[o] = 0.f;
        }
      });
    }
    const int* rowT = tabs + s.tabRow[j];

    for (int c = 0; c < nch[j]; ++c) {
      if (s.stages == 2) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int cv = min(s.cc[j], cw[j] - c * s.cc[j]);
      const int* colC = tabs + s.tabCol[j] + c * s.cc[j];
      const W* braw = reinterpret_cast<const W*>(smem + s.offSlot[slot]);
      if constexpr (tc) {
        const bf16* Bs;
        int ldb;
        if constexpr (conv) {
          bf16* cb = reinterpret_cast<bf16*>(smem + s.offConv);
          widen_tile(cb, s.cc[j] + 8, braw, s.ldB[j], s.Kp[j], s.cc[j]);
          __syncthreads();
          Bs = cb;
          ldb = s.cc[j] + 8;
        } else {
          Bs = braw;
          ldb = s.ldB[j];
        }
        const bf16* Ahi = reinterpret_cast<const bf16*>(smem + s.offBuf[j & 1]);
        const bf16* Alo = j > 0 ? Ahi + (size_t)Mp * s.ldA[j] : nullptr;
        const int Mt = Mp / 16, Nt = (cv + 15) / 16, Ks = s.Kp[j] / 16;
        if (last) {
          mma_chunk(Ahi, Alo, s.ldA[j], Mt, Bs, ldb, Nt, Ks, rowT, Mv, colC,
                    cv, YSink<T>{y + ybase, sc});
        } else if (s.R[j] % 2 == 0) {
          mma_chunk(Ahi, Alo, s.ldA[j], Mt, Bs, ldb, Nt, Ks, rowT, Mv, colC,
                    cv, Split<true>{nhi, nlo, sc});
        } else {
          mma_chunk(Ahi, Alo, s.ldA[j], Mt, Bs, ldb, Nt, Ks, rowT, Mv, colC,
                    cv, Split<false>{nhi, nlo, sc});
        }
      } else {
        fma_chunk(reinterpret_cast<const float*>(smem + s.offBuf[j & 1]),
                  s.ldA[j], Mv, braw, s.ldB[j], cv, s.Kp[j],
                  [&](int m0, int n0, const float (&acc)[kRT][kRT]) {
                    // every table entry before the first store
                    int ro[kRT], co[kRT];
#pragma unroll
                    for (int i = 0; i < kRT; ++i) {
                      ro[i] = m0 + i < Mv ? rowT[m0 + i] : -1;
                      co[i] = n0 + i < cv ? colC[n0 + i] : -1;
                    }
#pragma unroll
                    for (int i = 0; i < kRT; ++i)
#pragma unroll
                      for (int q = 0; q < kRT; ++q) {
                        if (ro[i] < 0 || co[q] < 0) continue;
                        const float v = acc[i][q] * sc;
                        if (last) {
                          store(y + ybase + ro[i] + co[q], v);
                        } else {
                          nf[ro[i] + co[q]] = v;
                        }
                      }
                  });
      }
      __syncthreads();
      stage_next(slot, true, threadIdx.x, kThreads);
      slot ^= s.stages - 1;
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* const* packed, const int* ns,
           const int* ms, const int* ranks, int d, const float* scales,
           const void* tables, void* y, int B, int bb, int g, int g2,
           int ncc, int stages, int smem_expected, cudaStream_t stream) {
  if (d < 2 || d > kMaxD || ranks[0] != 1 || ranks[d] != 1 || B < 1 ||
      bb < 1 || g < 1 || g > ms[d - 1] || g2 < 1 || g2 > ms[d - 2] ||
      ncc < 16 || ncc % 16 != 0 || stages < 1 || stages > 2)
    return (int)cudaErrorInvalidValue;
  Geo s = make_geo<T, W>(d, ns, ms, ranks, B, bb, g, g2, ncc, stages);
  // the host's price (tt_contract.chain_smem_bytes) and this layout must
  // agree
  if (s.size != smem_expected) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < d; ++j) s.p[j] = packed[j];
  s.tabs = static_cast<const int*>(tables);
  auto kernel = tt_chain_kernel<T, W>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static int opted = 48 * 1024;
  if (s.size > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.size);
    if (err != cudaSuccess) return (int)err;
    opted = s.size;
  }
  const dim3 grid((B + bb - 1) / bb, (ms[d - 1] + g - 1) / g,
                  (ms[d - 2] + g2 - 1) / g2);
  kernel<<<grid, kThreads, s.size, stream>>>(
      static_cast<const T*>(x), scales, static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  x, y, scales, tables
// (tt_contract.chain_tables) and every entry of `packed` (execution order)
// are device pointers; `packed`, ns, ms and ranks are host arrays.  The
// tiles (bb, g, g2, ncc), the ring depth and the shared memory they need
// come from tt_contract.chain_geometry.  The kernel runs on ``stream`` and
// the call returns cudaGetLastError(), or cudaErrorInvalidValue when the
// tiles do not match this file's layout.
extern "C" {

int tt_fused_chain_f32(const void* x, const void* const* packed,
                       const int* ns, const int* ms, const int* ranks, int d,
                       const void* tables, void* y, int B, int bb, int g,
                       int g2, int ncc, int stages, int smem, void* stream) {
  return launch<float, float>(x, packed, ns, ms, ranks, d, nullptr, tables,
                              y, B, bb, g, g2, ncc, stages, smem,
                              (cudaStream_t)stream);
}

int tt_fused_chain_bf16(const void* x, const void* const* packed,
                        const int* ns, const int* ms, const int* ranks, int d,
                        const void* tables, void* y, int B, int bb, int g,
                        int g2, int ncc, int stages, int smem, void* stream) {
  return launch<bf16, bf16>(x, packed, ns, ms, ranks, d, nullptr, tables, y,
                            B, bb, g, g2, ncc, stages, smem,
                            (cudaStream_t)stream);
}

int tt_fused_chain_int8_f32(const void* x, const void* const* packed,
                            const int* ns, const int* ms, const int* ranks,
                            int d, const void* scales, const void* tables,
                            void* y, int B, int bb, int g, int g2, int ncc,
                            int stages, int smem, void* stream) {
  return launch<float, int8_t>(x, packed, ns, ms, ranks, d,
                               (const float*)scales, tables, y, B, bb, g, g2,
                               ncc, stages, smem,
                               (cudaStream_t)stream);
}

int tt_fused_chain_int8_bf16(const void* x, const void* const* packed,
                             const int* ns, const int* ms, const int* ranks,
                             int d, const void* scales, const void* tables,
                             void* y, int B, int bb, int g, int g2, int ncc,
                             int stages, int smem, void* stream) {
  return launch<bf16, int8_t>(x, packed, ns, ms, ranks, d,
                              (const float*)scales, tables, y, B, bb, g, g2,
                              ncc, stages, smem,
                              (cudaStream_t)stream);
}

}  // extern "C"
