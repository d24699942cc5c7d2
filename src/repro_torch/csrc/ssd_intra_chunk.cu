// Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_intra_chunk` (src/repro/kernels/ssd_scan.py,
// body `_kernel`).  For every (batch*chunk z, head hh) it computes
//     y[l, c]     = sum_{m <= l} (C_l . B_m) exp(min(la_l - la_m, 0)) xdt[m, c]
//     state[c, k] = sum_m (xdt[m, c] seg[m]) B_m[k],  seg = exp(la_{L-1} - la_m)
// with float32 accumulation and float32 outputs, on CUDA cores (no TF32:
// it keeps ~3 digits and the callers hold 1e-4).
//
// Layout: the tensors come in the SSD caller's own layout, nothing is
// repeated or transposed in device memory:
//     C, B  [Z, L, g, n]   one row per group: head hh reads group hh / (h/g)
//     la    [Z, L, h]      float32 cumulative log-decay within the chunk
//     xdt   [Z, L, h, p]   dt-scaled inputs
//     y     [Z, L, h, p]   float32
//     state [Z, h, p, n]   float32
//
// What bounds it on the H100 (chip_smoke.py's count: each input read once,
// each output written once):
//   * the LM fleet's call, (Z, L, g, h, n, p) = (1024, 32, 1, 64, 128, 64):
//     3.26 GB, two thirds of it the state, against 38.9 GFLOP: bytes, 0.974
//     ms (the float32 FLOP bound is 0.581 ms);
//   * the published chunk, (64, 256, 1, 64, 128, 64): 0.69 GB against 35.0
//     GFLOP: operations, 0.522 ms.
// So the kernel must do no more arithmetic than the function needs, keep
// the FMA pipe fed from registers, and let the state stores stream out
// while the next head computes.
//
// Design.  One block of 256 threads owns (z, group, a slice of up to 16
// heads); the wrapper's launch plan picks the slice, the blocks and the
// 16-byte paths.  The block
//   1. stages the group's B rows (all of L) and C rows (one 32-row l tile)
//      in shared memory once, with 16-byte cp.async copies where every row
//      starts on 16 bytes, else scalar loads;
//   2. forms the undecayed C.B^T tile [32 l, m <= l tile] once per l tile
//      and reuses it for every head of the slice (the kernel this replaces
//      formed it once per head: 64 times at one group);
//   3. walks the slice's heads in 32-row m tiles, double-buffered: while
//      one x tile is used, cp.async brings the next one.  Per tile it
//      scales the head's x rows by seg (B stays unscaled and shared), forms
//      the head's masked, decayed 32x32 score tile, and adds
//        y     += S x           a thread owns rows r and 31 - r (equal
//                               causal work) x 4 columns; a warp owns 4
//                               row pairs x 32 columns, so per 4 rows m it
//                               reads 2 float4 of S and 4 of x (8 distinct
//                               a warp) for 32 FMAs;
//        state += (x*seg)^T B   a thread owns an 8 (c) x 4 (k) register
//                               tile; a warp owns 32 c x 32 k, so per row m
//                               it reads 128 bytes of B and 4 x 32 bytes of
//                               x*seg: 3 loads for 32 FMAs, one shared-
//                               memory wavefront each.
//      Tiles past the diagonal are skipped;
//   4. writes y straight from registers with 16-byte stores (a warp writes
//      whole 128-byte lines).  A head's state is p*n*4 contiguous bytes
//      (32 KB at mamba2-1.3b's widths): the block writes it to shared
//      memory and one thread hands it to the TMA unit as one bulk copy
//      (cp.async.bulk), which streams it out while the warps compute the
//      next head.  Where the state's rows are not 16-byte rows, or its
//      register tiles take several rounds, or shared memory has no room
//      (L = 256), the state goes out by 16-byte (or scalar) stores from
//      registers.  In probes on the card, register stores of the state
//      streamed well below a plain fill's rate, and streaming stores
//      (st.global.cs) were slower than plain ones.
// At L = 32 the whole chunk is one tile, so every head of a slice needs
// one x tile: state and y come from one pass.  At L > 32 the state pass
// covers l tile 0 too, and l tiles 1.. follow, each forming its C.B^T
// tile once and reloading the slice's x tiles (from L2) for m <= l.
// mamba2-1.3b's widths (n 128, p 64) are compiled with their sizes fixed,
// L = 32 too, so that offsets fold into the instructions; other shapes
// take the generic instantiations.
// Resources (nvcc -Xptxas -v, sm_90a): launch bounds of 2 blocks an SM;
// 105-109 registers at mamba2-1.3b's widths and L = 32, 127-128 elsewhere,
// no spills.  Shared memory a block: 102,400 bytes at the LM fleet's shape
// (32 KB of it the bulk copy's state; 2 blocks an SM), 230,912 at the
// published chunk (1 an SM).
// Sums run in an order fixed by the shapes, with no atomics: two calls give
// equal bits.  C.B^T sums k in order, as the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // rows of an l tile and of an m tile
constexpr int kSStride = 36;   // row stride of the score tile (floats)
constexpr int kMaxYQ = 4;      // y items a thread at most: p <= 256
constexpr int kMinBlocks = 2;  // resident blocks an SM the registers allow
constexpr size_t kSmemLimit = 232448;   // 227 KB, one block's most

enum Flags { kVecBC = 1, kVecX = 2, kVecState = 4, kVecY = 8, kBulkState = 16 };

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one bulk copy shared -> global by the TMA unit, in its own group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}
// the issuing thread's bulk copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes become visible to the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 consecutive elements of a shared-memory row as float
__device__ __forceinline__ float4 load4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* s) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// 4 outputs of one row: a 16-byte store, or scalar stores of the
// first `valid` columns
__device__ __forceinline__ void store4(float* dst, const float (&v)[4],
                                       bool vec, int valid) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) dst[i] = v[i];
  }
}

// rows [0, kTile) x cols_pad floats of dst <- rows of src (float32 or
// bf16); rows >= valid and columns >= cols are zero.  vec: every source row
// starts on 16 bytes and cols is a multiple of 16 bytes of elements.
template <typename T>
__device__ void stage_float_rows(float* dst, int ds, const T* src,
                                 long long ss, int valid, int cols,
                                 int cols_pad, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);       // elements a 16-byte chunk
    const int per = cols / E;
    for (int e = tid; e < kTile * per; e += kThreads) {
      const int r = e / per, c = (e % per) * E;
      float* d = dst + r * ds + c;
      if (r >= valid) {
        for (int i = 0; i < E; i += 4)
          *reinterpret_cast<float4*>(d + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if constexpr (std::is_same<T, float>::value) {
        cp_async16(d, src + r * ss + c);
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(src + r * ss + c);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
        const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
        *reinterpret_cast<float4*>(d) = make_float4(f0.x, f0.y, f1.x, f1.y);
        *reinterpret_cast<float4*>(d + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
  } else {
    for (int e = tid; e < kTile * cols_pad; e += kThreads) {
      const int r = e / cols_pad, c = e % cols_pad;
      dst[r * ds + c] = r < valid && c < cols ? to_float(src[r * ss + c]) : 0.f;
    }
  }
}

// rows [0, kTile) x ds elements of dst <- rows of src, in the source type;
// rows >= valid and columns >= cols are zero.
template <typename T>
__device__ void stage_raw_rows(T* dst, int ds, const T* src, long long ss,
                               int valid, int cols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = ds / E;                 // ds is a multiple of E
    for (int e = tid; e < kTile * per; e += kThreads) {
      const int r = e / per, c = (e % per) * E;
      T* d = dst + r * ds + c;
      if (r < valid && c < cols)
        cp_async16(d, src + r * ss + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < kTile * ds; e += kThreads) {
      const int r = e / ds, c = e % ds;
      dst[r * ds + c] = r < valid && c < cols ? src[r * ss + c] : T(0.f);
    }
  }
}

// shared-memory layout, in floats, then the raw x tiles in the input type,
// then (bulk state stores) one head's [p, n] state at byte offset st
struct Layout {
  int nt, Lp, nS, cbS, p8;
  size_t b, c, cb, s, la, xs, xf, raw, st, bytes;
  __host__ __device__ Layout(int L, int n, int p, int S, int esize,
                             bool bulk) {
    nt = (L + kTile - 1) / kTile;
    Lp = nt * kTile;
    nS = round_up(n, 4) + 4;        // + 4: rows 16 bytes apart in banks
    cbS = Lp + 4;
    p8 = round_up(p, 8);
    b = 0;
    c = b + (size_t)Lp * nS;
    cb = c + (size_t)kTile * nS;
    s = cb + (size_t)kTile * cbS;
    la = s + (size_t)kTile * kSStride;
    xs = la + (size_t)Lp * S;
    xf = xs + (size_t)kTile * p8;
    raw = xf + (esize == 4 ? 0 : (size_t)kTile * p8);
    st = raw * 4 + 2 * (size_t)kTile * p8 * esize;
    bytes = st + (bulk ? (size_t)p * n * 4 : 0);
  }
};

// YQ: y items a thread (1 for p <= 64, else kMaxYQ).  kL, kN, kP: L, n and
// p fixed at compile time (0: taken from the arguments), so that the
// published widths fold their sizes and offsets into the instructions.
template <typename T, int YQ, int kL, int kN, int kP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_intra_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                       const float* __restrict__ la,
                       const T* __restrict__ xdt, int L_arg, int g,
                       int n_arg, int h, int p_arg, int S, int flags,
                       float* __restrict__ y, float* __restrict__ state) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int L = kL ? kL : L_arg, n = kN ? kN : n_arg, p = kP ? kP : p_arg;
  const int tid = threadIdx.x;
  const int hg = h / g, slices = (hg + S - 1) / S;
  const int slice = (int)(blockIdx.x % (unsigned)slices);
  const long long zg = blockIdx.x / (unsigned)slices;
  const int grp = (int)(zg % g);
  const long long z = zg / g;
  const int head0 = grp * hg + slice * S, nh = min(S, hg - slice * S);
  const bool bulk = flags & kBulkState;
  const Layout lay(L, n, p, S, (int)sizeof(T), bulk);
  const int nt = lay.nt, nS = lay.nS, cbS = lay.cbS, p8 = lay.p8;
  const int n4 = round_up(n, 4);
  const bool vec_bc = flags & kVecBC, vec_x = flags & kVecX;
  const bool vec_st = flags & kVecState, vec_y = flags & kVecY;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* B_s = smem + lay.b;     // [Lp][nS]   the group's B rows, unscaled
  float* C_s = smem + lay.c;     // [32][nS]   C rows of the current l tile
  float* CB_s = smem + lay.cb;   // [32][cbS]  C.B^T of the l tile, m < Lp
  float* S_s = smem + lay.s;     // [32][36]   one head's decayed score tile
  float* la_s = smem + lay.la;   // [S][Lp]    the slice's log-decays
  float* xs_s = smem + lay.xs;   // [32][p8]   x tile * seg
  float* xf_s = kF32 ? nullptr : smem + lay.xf;   // bf16: x as float
  T* raw_s = reinterpret_cast<T*>(smem + lay.raw);     // [2][32][p8]
  float* st_s = reinterpret_cast<float*>(                // [p][n]
      reinterpret_cast<char*>(smem) + lay.st);

  const long long row_bc = (long long)g * n, row_x = (long long)h * p;
  const T* Cz = C + z * L * row_bc + (long long)grp * n;
  const T* Bz = B + z * L * row_bc + (long long)grp * n;
  const T* xz = xdt + z * L * row_x + (long long)head0 * p;
  float* yz = y + z * L * row_x + (long long)head0 * p;
  float* stz = state + (z * h + head0) * (long long)p * n;

  // ---- prologue: B (all rows), C tile 0, the slice's la
  for (int t = 0; t < nt; ++t)
    stage_float_rows(B_s + t * kTile * nS, nS, Bz + t * kTile * row_bc,
                     row_bc, L - t * kTile, n, n4, vec_bc);
  stage_float_rows(C_s, nS, Cz, row_bc, L, n, n4, vec_bc);
  for (int e = tid; e < lay.Lp * S; e += kThreads) {
    const int m = e / S, j = e % S;
    la_s[j * lay.Lp + m] = m < L && j < nh ? la[(z * L + m) * h + head0 + j] : 0.f;
  }
  cp_async_commit();

  // the C.B^T tile of l tile lt, every m tile at or before it: thread
  // (i, jj) of a 16 x 16 grid owns rows i, i + 16 x columns jj, jj + 16
  auto form_cb = [&](int lt) {
    const int i = tid / 16, jj = tid % 16;
    const float* c0 = C_s + i * nS;
    const float* c1 = c0 + 16 * nS;
    for (int mb = 0; mb <= lt; ++mb) {
      const float* b0 = B_s + (mb * kTile + jj) * nS;
      const float* b1 = b0 + 16 * nS;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      for (int k = 0; k < n4; k += 4) {
        const float4 x0 = load4(c0 + k), x1 = load4(c1 + k);
        const float4 u0 = load4(b0 + k), u1 = load4(b1 + k);
        a00 = fmaf(x0.w, u0.w, fmaf(x0.z, u0.z, fmaf(x0.y, u0.y, fmaf(x0.x, u0.x, a00))));
        a01 = fmaf(x0.w, u1.w, fmaf(x0.z, u1.z, fmaf(x0.y, u1.y, fmaf(x0.x, u1.x, a01))));
        a10 = fmaf(x1.w, u0.w, fmaf(x1.z, u0.z, fmaf(x1.y, u0.y, fmaf(x1.x, u0.x, a10))));
        a11 = fmaf(x1.w, u1.w, fmaf(x1.z, u1.z, fmaf(x1.y, u1.y, fmaf(x1.x, u1.x, a11))));
      }
      float* o = CB_s + i * cbS + mb * kTile + jj;
      o[0] = a00;
      o[16] = a01;
      o[16 * cbS] = a10;
      o[16 * cbS + 16] = a11;
    }
  };

  auto load_x = [&](int buf, int j, int mt) {
    stage_raw_rows(raw_s + (size_t)buf * kTile * p8, p8,
                   xz + (long long)mt * kTile * row_x + (long long)j * p,
                   row_x, L - mt * kTile, p, vec_x);
  };

  // state: a thread's register tile is rows 8 cg .. 8 cg + 7 x columns
  // 4 kq .. 4 kq + 3 of the [p, n] state.  A warp owns a patch of 8 kq x 4
  // cg, so per row m it reads 128 bytes of B and 4 float4 pairs of x*seg;
  // thread t = round * 256 + tid takes patch t / 32
  const int KQ = n4 / 4, CG = p8 / 8;
  const int KP = (KQ + 7) / 8, patches = KP * ((CG + 3) / 4);
  auto state_tile = [&](int round, int& kq, int& cg) {
    const int t = round * kThreads + tid, patch = t / 32, lane = t % 32;
    kq = (patch % KP) * 8 + lane % 8;
    cg = (patch / KP) * 4 + lane / 8;
    return patch < patches && kq < KQ && cg < CG;
  };
  float sacc[8][4];
  // y: a thread owns rows ra and 31 - ra x columns 4 cq .. 4 cq + 3 of
  // the l tile.  A warp owns a patch of 8 cq x 4 ra, so per 4 rows m it
  // reads 8 rows of S and 4 x 128 bytes of x; item q * 256 + tid takes
  // patch (q * 256 + tid) / 32
  const int PQ = p8 / 4, QP = (PQ + 7) / 8;
  auto y_item = [&](int q, int& cq, int& ra) {
    const int it = q * kThreads + tid, patch = it / 32, lane = it % 32;
    cq = (patch % QP) * 8 + lane % 8;
    ra = (patch / QP) * 4 + lane / 8;
    return patch < 4 * QP && cq < PQ;
  };
  float ya[YQ][4], yb[YQ][4];

  auto zero_y = [&]() {
#pragma unroll
    for (int q = 0; q < YQ; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) ya[q][u] = yb[q][u] = 0.f;
  };

  auto store_y = [&](int j, int lt) {
    const int l0 = lt * kTile;
#pragma unroll
    for (int q = 0; q < YQ; ++q) {
      int cq, ra;
      if (!y_item(q, cq, ra) || 4 * cq >= p) continue;
      const int c = 4 * cq, rb = kTile - 1 - ra;
      float* o = yz + (long long)j * p + c;
      if (l0 + ra < L) store4(o + (l0 + ra) * row_x, ya[q], vec_y, p - c);
      if (l0 + rb < L) store4(o + (l0 + rb) * row_x, yb[q], vec_y, p - c);
    }
  };

  // one job: x tile (head j, m tile mt) sits in raw buffer buf.  Adds the
  // tile's y terms for l tile lt (none if lt < 0), stores y if y_done,
  // then adds its state terms (state round `round`, none if round < 0): y's
  // registers are free before the state loop.  Called by every thread; it
  // syncs the block once between the per-tile passes and the products.
  auto job = [&](int buf, int j, int mt, int lt, int round, bool y_done) {
    const T* xr = raw_s + (size_t)buf * kTile * p8;
    const float* xy = kF32 ? reinterpret_cast<const float*>(xr) : xf_s;
    const int m0 = mt * kTile;
    const float* la_j = la_s + j * lay.Lp;
    const float la_last = la_j[L - 1];
    for (int e = tid; e < kTile * PQ; e += kThreads) {
      const int r = e / PQ, c = (e % PQ) * 4;
      const float4 v = load4(xr + r * p8 + c);
      if (!kF32 && lt >= 0)
        *reinterpret_cast<float4*>(xf_s + r * p8 + c) = v;
      if (round >= 0) {
        const float sg = m0 + r < L ? expf(la_last - la_j[m0 + r]) : 0.f;
        *reinterpret_cast<float4*>(xs_s + r * p8 + c) =
            make_float4(v.x * sg, v.y * sg, v.z * sg, v.w * sg);
      }
    }
    if (lt >= 0) {
      const int l0 = lt * kTile;
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, mm = e % kTile;
        const int gl = l0 + r, gm = m0 + mm;
        S_s[r * kSStride + mm] =
            gm <= gl && gl < L
                ? CB_s[r * cbS + gm] *
                      expf(fminf(la_j[gl] - la_j[gm], 0.f))
                : 0.f;
      }
    }
    __syncthreads();

    if (lt >= 0) {
      const bool diag = mt == lt;
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        int cq, ra;
        if (!y_item(q, cq, ra)) continue;
        const int rb = kTile - 1 - ra;
        const int mend = diag ? ((rb + 4) & ~3) : kTile;
        const float* sa = S_s + ra * kSStride;
        const float* sb = S_s + rb * kSStride;
        const float* xp = xy + 4 * cq;
        for (int m = 0; m < mend; m += 4) {
          const float4 wa = load4(sa + m), wb = load4(sb + m);
          const float4 x0 = load4(xp + m * p8), x1 = load4(xp + (m + 1) * p8);
          const float4 x2 = load4(xp + (m + 2) * p8), x3 = load4(xp + (m + 3) * p8);
          fma4(ya[q], wa.x, x0); fma4(yb[q], wb.x, x0);
          fma4(ya[q], wa.y, x1); fma4(yb[q], wb.y, x1);
          fma4(ya[q], wa.z, x2); fma4(yb[q], wb.z, x2);
          fma4(ya[q], wa.w, x3); fma4(yb[q], wb.w, x3);
        }
      }
    }
    if (y_done) store_y(j, lt);
    int kq, cg;
    if (round >= 0 && state_tile(round, kq, cg)) {
      const float* bp = B_s + (size_t)m0 * nS + 4 * kq;
      const float* xp = xs_s + 8 * cg;
      // rows past L are zero in B and in x*seg: the loop runs all 32
      // (unrolled less where runtime sizes hold registers)
      constexpr int kUnroll = kN ? 8 : 4;
#pragma unroll kUnroll
      for (int m = 0; m < kTile; ++m) {
        const float4 b = load4(bp + m * nS);
        const float4 x0 = load4(xp + m * p8), x1 = load4(xp + m * p8 + 4);
        fma4(sacc[0], x0.x, b);
        fma4(sacc[1], x0.y, b);
        fma4(sacc[2], x0.z, b);
        fma4(sacc[3], x0.w, b);
        fma4(sacc[4], x1.x, b);
        fma4(sacc[5], x1.y, b);
        fma4(sacc[6], x1.z, b);
        fma4(sacc[7], x1.w, b);
      }
    }
  };

  // bulk: the block writes the head's state to st_s (free: the previous
  // copy finished reading it before the job's first barrier) and thread 0
  // hands the p*n*4 contiguous bytes to the TMA unit, which streams them
  // out while the warps go on with the next head.  Called by every thread.
  auto store_state = [&](int j, int round) {
    int kq, cg;
    const bool mine = state_tile(round, kq, cg);
    const int k = 4 * kq;
    if (bulk) {
      if (mine) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * cg + i < p)
            *reinterpret_cast<float4*>(st_s + (8 * cg + i) * n + k) =
                make_float4(sacc[i][0], sacc[i][1], sacc[i][2], sacc[i][3]);
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) bulk_store(stz + (long long)j * p * n, st_s, p * n * 4);
      return;
    }
    if (!mine) return;
    float* o = stz + (long long)j * p * n + k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * cg + i;
      if (c < p && k < n) store4(o + (long long)c * n, sacc[i], vec_st, n - k);
    }
  };

  // ---- pass 1: every head's state, in `rounds` rounds of 256 register
  // tiles, and the heads' y for l tile 0
  const int rounds = (patches * 32 + kThreads - 1) / kThreads;
  const int per_head = rounds * nt, jobs1 = nh * per_head;
  load_x(0, 0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  form_cb(0);
  for (int i = 0; i < jobs1; ++i) {
    const int j = i / per_head, round = (i % per_head) / nt, mt = i % nt;
    cp_async_wait<0>();
    if (bulk && tid == 0) bulk_wait_read();
    __syncthreads();
    if (i + 1 < jobs1) {
      const int i1 = i + 1;
      load_x((i1 & 1), i1 / per_head, i1 % nt);
    }
    cp_async_commit();
    if (mt == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sacc[a][b] = 0.f;
    }
    const bool with_y = round == 0 && mt == 0;
    if (with_y) zero_y();
    job(i & 1, j, mt, with_y ? 0 : -1, round, with_y);
    if (mt == nt - 1) store_state(j, round);
  }

  // ---- pass 2: l tiles 1.., each forming its C.B^T tile once for the
  // slice's heads; jobs (head, m tile <= l tile)
  for (int lt = 1; lt < nt; ++lt) {
    const int per = lt + 1, jobs = nh * per;
    __syncthreads();                 // C_s, CB_s and the buffers are free
    stage_float_rows(C_s, nS, Cz + (long long)lt * kTile * row_bc, row_bc,
                     L - lt * kTile, n, n4, vec_bc);
    load_x(0, 0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    form_cb(lt);
    for (int i = 0; i < jobs; ++i) {
      const int j = i / per, mt = i % per;
      cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < jobs) load_x((i + 1) & 1, (i + 1) / per, (i + 1) % per);
      cp_async_commit();
      if (mt == 0) zero_y();
      job(i & 1, j, mt, lt, -1, mt == lt);
    }
  }
  if (bulk && tid == 0) bulk_wait_all();
}

template <typename T, int YQ, int kL, int kN, int kP>
int launch_shape(const void* C, const void* B, const float* la,
                 const void* xdt, int Z, int L, int g, int n, int h, int p,
                 int S, int flags, float* y, float* state, void* stream,
                 size_t smem) {
  auto kernel = ssd_intra_chunk_kernel<T, YQ, kL, kN, kP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int slices = (h / g + S - 1) / S;
  const unsigned blocks = (unsigned)((long long)Z * g * slices);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)C, (const T*)B, la, (const T*)xdt, L, g, n, h, p, S, flags,
      y, state);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* C, const void* B, const float* la, const void* xdt,
           int Z, int L, int g, int n, int h, int p, int S, int flags,
           float* y, float* state, void* stream) {
  if (Z == 0 || h == 0 || L == 0) return 0;
  if (S < 1 || g < 1 || h % g || p > 4 * kMaxYQ * kThreads / 16)
    return (int)cudaErrorInvalidValue;
  // bulk state stores: 16-byte rows, and the whole state in one round of
  // register tiles (8 k quads x 4 c octets a warp)
  const int KP = (round_up(n, 4) / 4 + 7) / 8, CP = (round_up(p, 8) / 8 + 3) / 4;
  if ((flags & kBulkState) && (n % 4 || KP * CP > kThreads / 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      Layout(L, n, p, S, (int)sizeof(T), flags & kBulkState).bytes;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
#define SSD_LAUNCH(YQ, kL, kN, kP)                                        \
  launch_shape<T, YQ, kL, kN, kP>(C, B, la, xdt, Z, L, g, n, h, p, S, flags, \
                                  y, state, stream, smem)
  // mamba2-1.3b's widths (n 128, p 64): the LM fleet's L = 32, any L
  if (n == 128 && p == 64) return L == 32 ? SSD_LAUNCH(1, 32, 128, 64)
                                          : SSD_LAUNCH(1, 0, 128, 64);
  // 16 row pairs x p8 / 4 column quads of y over 256 threads
  if (4 * round_up(p, 8) <= kThreads) return SSD_LAUNCH(1, 0, 0, 0);
  return SSD_LAUNCH(kMaxYQ, 0, 0, 0);
#undef SSD_LAUNCH
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).  S is the
// number of heads a block owns; flags (the wrapper's launch plan): 1 B and
// C rows start on 16 bytes, 2 xdt rows do, 4 state rows (n % 4 == 0), 8 y
// rows (p % 4 == 0).
int ssd_intra_chunk_f32(const void* C, const void* B, const float* la,
                        const void* xdt, int Z, int L, int g, int n, int h,
                        int p, int S, int flags, float* y, float* state,
                        void* stream) {
  return launch<float>(C, B, la, xdt, Z, L, g, n, h, p, S, flags, y, state,
                       stream);
}

int ssd_intra_chunk_bf16(const void* C, const void* B, const float* la,
                         const void* xdt, int Z, int L, int g, int n, int h,
                         int p, int S, int flags, float* y, float* state,
                         void* stream) {
  return launch<__nv_bfloat16>(C, B, la, xdt, Z, L, g, n, h, p, S, flags,
                               y, state, stream);
}

}  // extern "C"
