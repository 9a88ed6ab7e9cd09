// One tensor-train step on the raw core for Hopper (sm_90a), fp and
// int8-resident cores.  Replaces the Pallas TPU kernels tt_step_pallas and
// tt_step_int8_pallas (src/repro/kernels/tt_contract.py, bodies
// _tt_step_body and _tt_step_int8_body).
//
// Computes out[m, b, r0] = sum_{n, r1} G[r0, n, m, r1] * X[b, n, r1]  (* s)
// with G the core as stored (no packing per call), X the chain state viewed
// as [b, n, r1] and out fp32, as in the TPU body.  The executor runs one
// launch per core and casts the state to the activation type between them.
// As a product it is out[b, (m, r0)] = X[b, (n, r1)] @ G[(n, r1), (m, r0)]
// with a reduction of n*r1 (128 to 1376 at the deepseek-7b shapes).
//
// What bounds it on the H100: at the deepseek-7b shapes a step does 0.5-2
// FLOP per byte it must move, far below the card's ridge, so the bound is
// bytes; at 4 rows that is well under a microsecond per step, so decode is
// set by latency and by how many SMs get work, prefill by the FMAs the
// CUDA cores issue (fp32 accumulation, no tensor cores).
//
// Design:
//  * Grid (column tiles, b tiles).  A block owns the outputs of tb rows of
//    b by tm values of m by tr values of r0 (tm*tr columns) and the whole
//    reduction.  The host (tt_contract.step_geometry) picks the tile per
//    shape: the largest that still gives 90% of the SMs a block, so small
//    tiles at decode (4 rows: 128-344 blocks at every full-width step)
//    and 32x64 or 64x64 tiles at prefill.
//  * Register tiles.  A thread holds kRB b rows by kRJ columns of fp32
//    accumulators, so one value read from shared memory feeds kRB or kRJ
//    FMAs.  The block's 256 threads are TB x TJ such tiles times KS groups
//    that split the reduction.  The groups' partial tiles are added in a
//    fixed order, so the result is deterministic: by a butterfly of warp
//    shuffles among a warp's lanes, then, across the warps, at most 8
//    partials per output in shared memory as the output is written.
//  * Staging in the core's stored order.  Each chunk of nc n-values of G
//    (r0 slowest, then n, then m, then r1) and of X is copied into a ring
//    of kStages slots with 16-byte cp.async, consecutive threads on
//    consecutive addresses, each thread's offsets stepped by adds along a
//    four-digit walk (no division per copy).  For step 1 of a length-2
//    chain (r1 = 1, the tile holding all m) G[r0, n0:n0+nc, :, 0] is one run
//    of nc*m values per r0.  Ragged tiles and chunks are zero-filled; an
//    operand that is not 16-byte aligned (or whose runs are not whole
//    16-byte units) is staged by a scalar loop in the same kernel.
//  * Three inner products (KV).  When r1 is a multiple of a 16-byte vector
//    of activations (KV = 4 fp32 or 8 bf16 values), each shared load takes
//    KV consecutive r1 values of X and of G (G's columns padded to an odd
//    number of 16-byte units, so the loads of a warp do not conflict).
//    When r1 = 1 (step 1 of every chain; KV = 2), a thread's kRJ columns
//    are consecutive m of one r0, one load of G each, and a load of X takes
//    two consecutive n, so each loaded value feeds 8 or 16 FMAs.
//    Otherwise (ragged test shapes; KV = 1) one value at a time, the lanes
//    of a warp on consecutive m.
//  * int8 G is widened to fp32 in registers and the sum is multiplied once
//    by the core's scale, read from a device pointer, at the end (the TPU
//    body scaled each n block's partial sum; the two agree within fp32
//    rounding).  No cluster, no atomics, one launch per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // STEP_THREADS in tt_contract.py
constexpr int kRB = 4;         // b rows per thread (STEP_RB)
constexpr int kRJ = 4;         // output columns per thread (STEP_RJ)
constexpr int kStages = 2;     // ring depth (STEP_STAGES)

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Elements of a row stride of at least len elements of `bytes` each: an odd
// number of 16-byte units, so that rows read by neighbouring lanes fall in
// different bank groups.
__host__ __device__ constexpr int odd_units(int len, int bytes) {
  const int q = (len * bytes + 15) / 16;
  return (q % 2 == 0 ? q + 1 : q) * 16 / bytes;
}

__host__ __device__ inline int pow2_at_least(int a) {
  int p = 1;
  while (p < a) p *= 2;
  return p;
}

// Block geometry and shared-memory layout, computed on the host by make_geo
// (and, for the launch, by tt_contract.step_smem_bytes, which must agree).
// A ring slot holds G's chunk [tr][nc][tm][s0] (strides s2, s1, s0) and
// then X's chunk [tb][ldx]; after the last chunk the ring's bytes hold the
// KW partial output tiles [KW][tm][tb][tr].
struct Geo {
  int r0, n, m, r1, b;
  int tb, tm, tr, nc;     // block tile and n chunk
  int tj, TB, TJ, KS;     // columns; threads: TB x TJ tiles x KS groups
  int KW;                 // partial tiles left after the warps' shuffles
  int s0, s1, s2, ldx;    // shared strides in elements
  int slotG, slot;        // bytes of G's part of a slot, of a slot
  int chunks, osz, size;  // chunks of n, outputs per block, shared bytes
};

Geo make_geo(int r0, int n, int m, int r1, int b, int tb, int tm, int tr,
             int nc, int kv, int a, int w) {
  Geo s{};
  s.r0 = r0; s.n = n; s.m = m; s.r1 = r1; s.b = b;
  s.tb = tb; s.tm = tm; s.tr = tr; s.nc = nc;
  s.tj = tm * tr;
  s.TB = tb / kRB;
  s.TJ = pow2_at_least((s.tj + kRJ - 1) / kRJ);
  s.KS = std::max(1, kThreads / std::max(1, s.TB * s.TJ));
  s.KW = std::min(s.KS, kThreads / 32);
  if (kv > 2) {  // a padded column per (r0, n, m)
    s.s0 = odd_units(r1, w);
    s.s1 = tm * s.s0;
    s.s2 = nc * s.s1;
  } else {       // dense (n, m, r1) runs, 8 or 16 values between r0 values
    s.s0 = r1;
    s.s1 = tm * r1;
    s.s2 = round_up(nc * s.s1, 16 / w) + std::max(8, 16 / w);
  }
  s.ldx = odd_units(nc * r1, a);
  s.slotG = round_up(tr * s.s2 * w, 128);
  s.slot = s.slotG + round_up(tb * s.ldx * a, 128);
  s.chunks = (n + nc - 1) / nc;
  s.osz = tb * tm * tr;
  s.size = std::max(std::min(kStages, s.chunks) * s.slot, s.KW * s.osz * 4);
  return s;
}

template <typename E> __device__ __forceinline__ E zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

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

// A piece of an array walked by the whole block: four digits, slowest
// first.  Digit d runs over cnt[d] values, of which the first val[d] are
// valid; the last digit is the unit (16 bytes, or one element) within a
// row, and val[3] is the row's valid length in elements.  One step of
// digit d moves gs[d] elements in global memory and ss[d] in shared
// memory (or in the partial-sum tile).
struct Piece {
  int cnt[4], val[4], gs[4], ss[4];
  int unit;
};

// A thread's place on a Piece: it starts at unit threadIdx.x and steps by
// kThreads units; both are split into digits once per block.
struct Walk {
  int d[4], t[4];
};

__device__ __forceinline__ Walk make_walk(const Piece& p) {
  Walk w;
  int a = threadIdx.x, t = kThreads;
#pragma unroll
  for (int i = 3; i > 0; --i) {
    w.d[i] = a % p.cnt[i];
    a /= p.cnt[i];
    w.t[i] = t % p.cnt[i];
    t /= p.cnt[i];
  }
  w.d[0] = a;
  w.t[0] = t;
  return w;
}

// Call f(global offset, shared offset, valid elements from there) for each
// of the thread's units of the piece; stepping is adds and carries.
template <typename F>
__device__ __forceinline__ void walk(const Piece& p, const Walk& w, F f) {
  int d[4], go = 0, so = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = w.d[i];
    go += d[i] * p.gs[i];
    so += d[i] * p.ss[i];
  }
  while (d[0] < p.cnt[0]) {
    const bool ok = d[0] < p.val[0] && d[1] < p.val[1] && d[2] < p.val[2];
    f(go, so, ok ? p.val[3] - d[3] * p.unit : 0);
    int carry = 0;
#pragma unroll
    for (int i = 3; i > 0; --i) {
      const int step = w.t[i] + carry;
      d[i] += step;
      go += step * p.gs[i];
      so += step * p.ss[i];
      carry = d[i] >= p.cnt[i];
      if (carry) {
        d[i] -= p.cnt[i];
        go -= p.cnt[i] * p.gs[i];
        so -= p.cnt[i] * p.ss[i];
      }
    }
    const int step = w.t[0] + carry;
    d[0] += step;
    go += step * p.gs[0];
    so += step * p.ss[0];
  }
}

// Copy the piece at src into shared memory at dst: 16-byte cp.async units
// (zero-filled past the valid length) when vec, else element by element.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, const Piece& p,
                                      const Walk& w, bool vec) {
  if (vec) {
    walk(p, w, [&](int go, int so, int len) {
      const int n = max(0, min(p.unit, len));
      cp_async16(dst + so, n > 0 ? src + go : src, n * (int)sizeof(E));
    });
  } else {
    walk(p, w, [&](int go, int so, int len) {
      dst[so] = len > 0 ? src[go] : zero<E>();
    });
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- loads from shared memory, widened to fp32 ---------------------------

__device__ __forceinline__ void i8x4(unsigned q, float* v) {
  // byte k sign-extended, then exactly to float: the bits of 1.5 * 2^23
  // plus c are the float 1.5 * 2^23 + c
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = __int_as_float(0x4B400000 + ((int)(q << (24 - 8 * k)) >> 24)) -
           12582912.f;
}

template <int KV>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[KV]) {
  if constexpr (KV == 1) {
    v[0] = *p;
  } else if constexpr (KV == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    static_assert(KV == 4, "fp32: 1, 2 or 4 values");
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

template <int KV>
__device__ __forceinline__ void load_vals(const bf16* p, float (&v)[KV]) {
  if constexpr (KV == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    static_assert(KV == 2 || KV == 4 || KV == 8, "bf16: 1, 2, 4 or 8");
    unsigned u[KV / 2];
    if constexpr (KV == 2) {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (KV == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      u[0] = q.x; u[1] = q.y;
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < KV / 2; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
}

template <int KV>
__device__ __forceinline__ void load_vals(const int8_t* p, float (&v)[KV]) {
  if constexpr (KV == 1) {
    v[0] = static_cast<float>(*p);
  } else if constexpr (KV == 4) {
    i8x4(*reinterpret_cast<const unsigned*>(p), v);
  } else {
    static_assert(KV == 8, "int8: 1, 4 or 8 values");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    i8x4(q.x, v);
    i8x4(q.y, v + 4);
  }
}

// ---- the kernel -----------------------------------------------------------

template <typename T, typename W, int KV>
__global__ void __launch_bounds__(kThreads, 2)
tt_step_kernel(const W* __restrict__ G, const T* __restrict__ X,
               const float* __restrict__ scale, float* __restrict__ out,
               const Geo s) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int UG = 16 / sizeof(W), UX = 16 / sizeof(T);
  const int mtiles = (s.m + s.tm - 1) / s.tm;
  const int rt = blockIdx.x / mtiles;
  const int mt = blockIdx.x - rt * mtiles;
  const int m0 = mt * s.tm, rr0 = rt * s.tr, b0 = blockIdx.y * s.tb;
  const int tmv = min(s.tm, s.m - m0);
  const int trv = min(s.tr, s.r0 - rr0);
  const int tbv = min(s.tb, s.b - b0);
  const int mr1 = s.m * s.r1, nr1 = s.n * s.r1;
  const W* gbase = G + ((size_t)rr0 * s.n * s.m + m0) * s.r1;
  const T* xbase = X + (size_t)b0 * nr1;
  const bool one = s.chunks == 1;

  // G's piece of a chunk, in the core's order: padded columns (KV > 2), one
  // run per r0 when the tile holds all of m, else one run per (r0, n)
  const bool merged = KV <= 2 && s.tm == s.m;
  const int rowlen = KV > 2 ? s.r1 : merged ? s.nc * mr1 : s.tm * s.r1;
  const bool vecg =
      aligned16(gbase) && rowlen % UG == 0 && (s.n * mr1) % UG == 0 &&
      (one || (s.nc * mr1) % UG == 0) && (merged || mr1 % UG == 0);
  const int gu = vecg ? UG : 1;
  const int gunits = (rowlen + gu - 1) / gu;
  Piece pg =
      KV > 2 ? Piece{{s.tr, s.nc, s.tm, gunits}, {trv, 0, tmv, s.r1},
                     {s.n * mr1, mr1, s.r1, gu}, {s.s2, s.s1, s.s0, gu}, gu}
      : merged ? Piece{{s.tr, 1, 1, gunits}, {trv, 1, 1, 0},
                       {s.n * mr1, 0, 0, gu}, {s.s2, 0, 0, gu}, gu}
               : Piece{{s.tr, s.nc, 1, gunits}, {trv, 0, 1, tmv * s.r1},
                       {s.n * mr1, mr1, 0, gu}, {s.s2, s.s1, 0, gu}, gu};
  // X's piece: one run of nc*r1 values per row of b
  const bool vecx = aligned16(xbase) && nr1 % UX == 0 &&
                    (one || (s.nc * s.r1) % UX == 0);
  const int xunit = vecx ? UX : 1;
  Piece px{{s.tb, 1, 1, (s.nc * s.r1 + xunit - 1) / xunit},
           {tbv, 1, 1, 0}, {nr1, 0, 0, xunit}, {s.ldx, 0, 0, xunit}, xunit};
  const Walk wg = make_walk(pg), wx = make_walk(px);

  auto issue = [&](int c) {
    if (c < s.chunks) {
      const int n0 = c * s.nc, ncv = min(s.nc, s.n - n0);
      unsigned char* slot = smem + (c % kStages) * s.slot;
      if (merged) pg.val[3] = ncv * mr1;
      else pg.val[1] = ncv;
      px.val[3] = ncv * s.r1;
      stage(reinterpret_cast<W*>(slot), gbase + (size_t)n0 * mr1, pg, wg,
            vecg);
      stage(reinterpret_cast<T*>(slot + s.slotG), xbase + (size_t)n0 * s.r1,
            px, wx, vecx);
    }
    cp_async_commit();
  };

  // the thread's tile: rows bi + TB*i, columns ji + TJ*c (KV = 2:
  // kRJ*ji + c, consecutive m of one r0), reduction group kg
  const int t = threadIdx.x;
  const int ji = t % s.TJ;
  const int bi = (t / s.TJ) % s.TB;
  const int kg = t / (s.TJ * s.TB);
  int xo[kRB], go[kRJ], oo[kRJ];
  bool jok[kRJ];
#pragma unroll
  for (int i = 0; i < kRB; ++i) xo[i] = (bi + s.TB * i) * s.ldx;
#pragma unroll
  for (int c = 0; c < kRJ; ++c) {
    const int j = KV == 2 ? kRJ * ji + c : ji + s.TJ * c;
    jok[c] = j < s.tj;
    const int jj = jok[c] ? j : 0;
    const int rr = jj / s.tm, mm = jj - rr * s.tm;
    go[c] = rr * s.s2 + mm * s.s0;
    oo[c] = mm * s.tb * s.tr + rr;
  }
  // the reduction of a chunk in units of KV values: unit u is X[u*KV]; for
  // KV = 2 (r1 = 1) G at n = 2u and 2u + 1, else G at (u / upr)*s1 +
  // (u % upr)*KV, stepped by KS
  const int upr = KV == 2 ? 1 : s.r1 / KV;
  const int dn = s.KS / upr, dk = s.KS - dn * upr;
  const int g_start = (kg / upr) * s.s1 + (kg % upr) * KV;
  const int dg = dn * s.s1 + dk * KV, wrap = s.s1 - s.r1;

  float acc[kRB][kRJ];
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int c = 0; c < kRJ; ++c) acc[i][c] = 0.f;

  issue(0);
  for (int c = 0; c < s.chunks; ++c) {
    issue(c + 1);
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* slot = smem + (c % kStages) * s.slot;
    const W* gsm = reinterpret_cast<const W*>(slot);
    const T* xsm = reinterpret_cast<const T*>(slot + s.slotG);
    const int units = min(s.nc, s.n - c * s.nc) * s.r1 / KV;
    if constexpr (KV == 2) {
      // r1 = 1: two n values of X per load, kRJ consecutive m of G per load
#pragma unroll 2
      for (int u = kg; u < units; u += s.KS) {
        float xv[kRB][2], gv[2][kRJ];
#pragma unroll
        for (int i = 0; i < kRB; ++i) load_vals<2>(xsm + xo[i] + 2 * u, xv[i]);
        load_vals<kRJ>(gsm + go[0] + 2 * u * s.s1, gv[0]);
        load_vals<kRJ>(gsm + go[0] + (2 * u + 1) * s.s1, gv[1]);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < kRB; ++i)
#pragma unroll
            for (int cc = 0; cc < kRJ; ++cc)
              acc[i][cc] = fmaf(xv[i][q], gv[q][cc], acc[i][cc]);
      }
    } else {
      int kv = kg % upr, gk = g_start;
#pragma unroll 1
      for (int u = kg; u < units; u += s.KS) {
        float xv[kRB][KV], gv[kRJ][KV];
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          load_vals<KV>(xsm + xo[i] + u * KV, xv[i]);
#pragma unroll
        for (int cc = 0; cc < kRJ; ++cc)
          load_vals<KV>(gsm + go[cc] + gk, gv[cc]);
#pragma unroll
        for (int q = 0; q < KV; ++q)
#pragma unroll
          for (int i = 0; i < kRB; ++i)
#pragma unroll
            for (int cc = 0; cc < kRJ; ++cc)
              acc[i][cc] = fmaf(xv[i][q], gv[cc][q], acc[i][cc]);
        kv += dk;
        gk += dg;
        if (kv >= upr) {
          kv -= upr;
          gk += wrap;
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // The KS groups' partial tiles are added in a fixed order.  When a
  // warp's lanes hold several groups (fewer than 32 tiles), a butterfly of
  // shuffles adds them first (both lanes of a pair add the same two
  // values, so every lane ends with the same sum); then the KW partial
  // tiles [KW][tm][tb][tr] in shared memory are added output by output as
  // the outputs are written.
  const int tiles = s.TB * s.TJ;
  int kw = kg;
  if (tiles < 32) {
    for (int off = tiles; off < 32; off *= 2)
#pragma unroll
      for (int i = 0; i < kRB; ++i)
#pragma unroll
        for (int c = 0; c < kRJ; ++c)
          acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
    kw = t / 32;
  }
  float* part = reinterpret_cast<float*>(smem);
  if (tiles >= 32 || t % 32 < tiles) {
    float* mine = part + kw * s.osz;
#pragma unroll
    for (int i = 0; i < kRB; ++i)
#pragma unroll
      for (int c = 0; c < kRJ; ++c)
        if (jok[c]) mine[oo[c] + (bi + s.TB * i) * s.tr] = acc[i][c];
  }
  __syncthreads();

  // out[m0 + mm, b0 + bl, rr0 + rr], rr fastest: runs of tr values, each
  // the sum of the KW partials in order
  const float sc = scale != nullptr ? scale[0] : 1.f;
  float* obase = out + ((size_t)m0 * s.b + b0) * s.r0 + rr0;
  const Piece po{{s.tm, s.tb, 1, s.tr}, {tmv, tbv, 1, trv},
                 {s.b * s.r0, s.r0, 0, 1}, {s.tb * s.tr, s.tr, 0, 1}, 1};
  walk(po, make_walk(po), [&](int g, int o, int len) {
    if (len > 0) {
      float v = part[o];
      for (int k = 1; k < s.KW; ++k) v += part[k * s.osz + o];
      obase[g] = v * sc;
    }
  });
}

template <typename T, typename W, int KV>
int run(const void* G, const void* X, const float* scale, void* out,
        const Geo& s, cudaStream_t stream) {
  auto kernel = tt_step_kernel<T, W, KV>;
  // Above the 48 KB default, dynamic shared memory must be opted into.
  static int opted = 48 * 1024;
  if (s.size > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.size);
    if (err != cudaSuccess) return (int)err;
    opted = s.size;
  }
  const dim3 grid(((s.m + s.tm - 1) / s.tm) * ((s.r0 + s.tr - 1) / s.tr),
                  (s.b + s.tb - 1) / s.tb);
  kernel<<<grid, kThreads, s.size, stream>>>(
      static_cast<const W*>(G), static_cast<const T*>(X), scale,
      static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* G, const void* X, const float* scale, void* out,
           int r0, int n, int m, int r1, int b, int tb, int tm, int tr,
           int nc, int kv, int smem_expected, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (tb < kRB || tb % kRB != 0 || tm < 1 || tm > m || tr < 1 || tr > r0 ||
      nc < 1 || nc > n || (kv != 1 && kv != 2 && kv != V) ||
      (kv == V && r1 % kv != 0) ||
      (kv == 2 && (r1 != 1 || tm % kRJ != 0 || n % 2 != 0 || nc % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  const Geo s = make_geo(r0, n, m, r1, b, tb, tm, tr, nc, kv, sizeof(T),
                         sizeof(W));
  // the host's price (tt_contract.step_smem_bytes) and this layout must
  // agree, and the thread tiles must cover the block tile exactly
  if (s.size != smem_expected || (s.TB & (s.TB - 1)) != 0 ||
      s.TB * s.TJ > kThreads || (b + tb - 1) / tb > 65535)
    return (int)cudaErrorInvalidValue;
  return kv == 1   ? run<T, W, 1>(G, X, scale, out, s, stream)
         : kv == 2 ? run<T, W, 2>(G, X, scale, out, s, stream)
                   : run<T, W, V>(G, X, scale, out, s, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer; the tile (tb, tm, tr), the n chunk nc, the inner product's
// vector width kv and the shared memory they need come from
// tt_contract.step_geometry.  The kernel runs on ``stream`` and the call
// returns cudaGetLastError(), or cudaErrorInvalidValue when the tiles do
// not match this file's layout.
extern "C" {

int tt_step_f32(const void* G, const void* X, void* out, int r0, int n,
                int m, int r1, int b, int tb, int tm, int tr, int nc, int kv,
                int smem, void* stream) {
  return launch<float, float>(G, X, nullptr, out, r0, n, m, r1, b, tb, tm,
                              tr, nc, kv, smem, (cudaStream_t)stream);
}

int tt_step_bf16(const void* G, const void* X, void* out, int r0, int n,
                 int m, int r1, int b, int tb, int tm, int tr, int nc, int kv,
                 int smem, void* stream) {
  return launch<bf16, bf16>(G, X, nullptr, out, r0, n, m, r1, b, tb, tm, tr,
                            nc, kv, smem, (cudaStream_t)stream);
}

int tt_step_int8_f32(const void* G, const void* X, const void* scale,
                     void* out, int r0, int n, int m, int r1, int b, int tb,
                     int tm, int tr, int nc, int kv, int smem, void* stream) {
  return launch<float, int8_t>(G, X, (const float*)scale, out, r0, n, m, r1,
                               b, tb, tm, tr, nc, kv, smem,
                               (cudaStream_t)stream);
}

int tt_step_int8_bf16(const void* G, const void* X, const void* scale,
                      void* out, int r0, int n, int m, int r1, int b, int tb,
                      int tm, int tr, int nc, int kv, int smem,
                      void* stream) {
  return launch<bf16, int8_t>(G, X, (const float*)scale, out, r0, n, m, r1,
                              b, tb, tm, tr, nc, kv, smem,
                              (cudaStream_t)stream);
}

}  // extern "C"
