// Blocked online-softmax attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_flash_kernel`) with its whole contract:
//   * GQA: query head hh reads kv head hh / (H / Hkv); K and V are never
//     repeated in device memory;
//   * causal masking, a sliding window, a logit softcap, keys past Skv
//     masked, and q_offset (query i sits at absolute position q_offset + i,
//     negative too);
//   * scale (the wrapper defaults it to d^-0.5), the -2e38 mask value,
//     m_safe = max(m, -1e30), corr = 0 until a valid key was seen, the
//     1e-20 floor, and a row with no valid key gives 0;
//   * any head dim d from 1 to 256; float32 or bfloat16 in, the output in
//     the input's dtype, float32 accumulation throughout (no TF32).
// Layout: q [B, Sq, H, d], k and v [B, Skv, Hkv, d], o [B, Sq, H, d], all
// contiguous (the layout of the model code; nothing is transposed).
//
// What bounds it on the H100: at the LM fleet's shape (q [1024, 32, 10,
// 64], k and v [1024, 32, 5, 64], float32, causal) the call moves 251.7 MB
// (q, k, v read once, o written once) for ~1.4 GFLOP of causal work: ~6
// flops a byte, under float32's ~20 on CUDA cores, so bytes bound it
// (0.0751 ms at 3.35 TB/s).  At 512 tokens (q [64, 512, 10, 64]) the
// causal work is 21.5 GFLOP on 0.13 GB: operations bound it (0.321 ms at
// 67 TFLOP/s).  Tensor cores (3xTF32 mma.sync or wgmma) would pay there
// and are later work; this kernel stays on CUDA cores in full float32.
//
// Design.  One block owns one (b, kv head), the query heads that read it
// (a whole GQA group, up to 64 heads) and up to 64 query rows of the
// group in all: `rows` rows of each of `heads` heads (the wrapper's launch
// plan; at the LM fleet's shape 2 heads x 32 rows).  So K and V of a
// group come from device memory once per query tile, not once per head.
// The block
//   1. stages its query rows in shared memory (float32, rows d rounded up
//      to 32 + 4 floats apart, so 8 rows that a quarter-warp reads fall in
//      8 distinct 16-byte bank groups), with 16-byte cp.async copies where
//      a tensor's rows are whole 16-byte pieces and it starts on 16 bytes,
//      16-byte loads converted in registers for bfloat16, scalar loads
//      otherwise (two code paths of this one kernel).  A table in shared
//      memory maps each block row to its q (and o) row;
//   2. walks the kv axis in 32-key tiles, double-buffered: while one tile
//      is used, the next one is on its way (cp.async for float32).  Where
//      Skv fits one tile (the LM fleet's 32 tokens) the block holds one
//      stage only, which leaves room for more blocks on an SM;
//   3. per tile, each warp owns 4 x TR query rows and a thread (ty, tx) of
//      it a register tile of TR rows (ty + 4 i) x 4 keys (tx + 8 j):
//        scores  per 4 columns of d, TR + 4 16-byte loads feed 16 TR FMAs;
//        softmax the row max and sum over the 8 lanes of a row by 3
//                shuffles each, then the TPU kernel's update of (m, l,
//                acc), with each row's visible keys [klo, khi] computed
//                once; p goes to a per-warp tile in shared memory;
//        P.V     a thread holds TR rows x d/8 output columns (4 tx + 32 c)
//                in registers; per 4 keys, TR loads of p and d/8 loads of
//                V (a warp reads one 128-byte line of a V row) feed
//                4 TR d/8 FMAs.
//      No per-key shuffle: one shared-memory load feeds 4 to 12 FMAs (8 in
//      the scores and 10.7 in P.V at d = 64);
//   4. skips, per warp, each 16-key half of a tile that the causal mask,
//      the window or Skv masks for every one of its rows, and the block
//      skips whole tiles that are masked for all its rows: on those the
//      online update is the identity, so no bit changes.  Until a row has
//      seen a valid key its (l, acc) are 0 and are not rescaled;
//   5. writes o from registers, acc times 1 / max(l, 1e-20), with 16-byte
//      (float32) or 8-byte (bfloat16) stores where o's rows allow, scalar
//      stores otherwise.
// Query tiles with the most keys are launched first (causal balance).
// Head dims 64, 96, 128, 192 and 256 are compiled with fixed sizes; any
// other d <= 256 takes one generic instantiation that pads d to the next
// multiple of 32 in shared memory and registers (the padding is zero).
// Threads: 128 a block (TR = 4) for d <= 128, 256 (TR = 2) above and in
// the generic instantiation.
// Resources (nvcc -Xptxas -v, sm_90a): 168 registers at d = 64 (launch
// bounds of 3 blocks an SM), no spills in any instantiation.  Shared
// memory a block at d = 64: 45,824 bytes with one kv stage (the LM
// fleet's shape), 63,232 with two.
// What holds it back (PERF.md): at the LM fleet's shape its
// compute alone (shared-memory loads and FMAs) takes longer than its
// loads from device memory, and the two overlap only in part; at 512
// tokens compute takes most of the time.
// Sums run in an order fixed by the shapes, with no atomics: two calls give
// equal bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kBK = 32;          // keys a kv tile
constexpr int kRows = 64;        // query rows a block, over its heads
constexpr int kLdP = kBK + 8;    // p tile row stride (floats): 8 ty rows of
                                 // a store fall in distinct banks
constexpr int kMaxD = 256;
constexpr float kNeg = -2.0e38f;
// the launch plan's flags: rows of q, k, v, o take 16-byte pieces
constexpr int kVecQ = 1, kVecK = 2, kVecV = 4, kVecO = 8;

// HD: the head dim fixed at compile time, 0 for the generic instantiation
template <int HD>
struct Cfg {
  static constexpr int D = HD ? HD : kMaxD;  // register columns, at most
  static constexpr int TR = (HD == 0 || D > 128) ? 2 : 4;  // rows a thread
  static constexpr int WR = 4 * TR;                        // rows a warp
  static constexpr int NT = 32 * (kRows / WR);             // threads
  static constexpr int NPC = D / 32;  // 4-column pieces a thread, a row
  static constexpr int MINB = NT == 256 ? 1 : (D > 64 ? 2 : 3);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, Hkv, d, dp;  // dp: d rounded up to 32
  float scale;
  int causal, window;             // window <= 0: none
  float softcap;                  // <= 0: none
  int q_offset;
  int rows, heads, slices, n_qt;  // rows of a head a query tile, heads a
                                  // block, blocks a group, query tiles
  int vec;
  int stages;  // kv tiles in flight: 1 when no block sees more than one
};

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

__device__ __forceinline__ float4 load4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// 4 consecutive outputs: one 16-byte (float32) or 8-byte (bfloat16) store
__device__ __forceinline__ void store_piece(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_piece(__nv_bfloat16* dst,
                                            const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}
__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// rows x d elements into dst (rows ld floats apart) as float32; a row for
// which row(r) is null is zero.  vec: every row is whole 16-byte pieces
// that start on 16 bytes.  float32 pieces go by cp.async (the caller
// commits and waits), bfloat16 pieces by 16-byte loads converted here.
template <typename T, int NT, typename Row>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int rows,
                                           int d, bool vec, Row row) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
    const int per = d / E;
    for (int e = tid; e < rows * per; e += NT) {
      const int r = e / per, c = (e - r * per) * E;
      const T* src = row(r);
      float* s = dst + r * ld + c;
      if (src == nullptr) {
#pragma unroll
        for (int i = 0; i < E; i += 4)
          *reinterpret_cast<float4*>(s + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if constexpr (sizeof(T) == 4) {
        cp_async16(s, src + c);
      } else {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + c));
        // a bfloat16 is the high half of its float32
        *reinterpret_cast<float4*>(s) = make_float4(
            __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
            __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        *reinterpret_cast<float4*>(s + 4) = make_float4(
            __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
            __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    }
  } else {
    for (int e = tid; e < rows * d; e += NT) {
      const int r = e / d, c = e - r * d;
      const T* src = row(r);
      dst[r * ld + c] = src != nullptr ? to_float(src[c]) : 0.f;
    }
  }
}

// sc[i][j] += q row (ty + 4 i) . k row (tx + 8 j) over the padded head dim,
// for key groups j in [J0, J1), in order of d
template <int HD, int TR, int J0, int J1>
__device__ __forceinline__ void qk(float (&sc)[TR][4], const float* qrow,
                                   const float* krow, int ld, int dp) {
  auto step = [&](int c) {
    float4 a[TR], b[4];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = load4(qrow + 4 * i * ld + c);
#pragma unroll
    for (int j = J0; j < J1; ++j) b[j] = load4(krow + 8 * j * ld + c);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = J0; j < J1; ++j) {
        float s = sc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        sc[i][j] = fmaf(a[i].w, b[j].w, s);
      }
  };
  if constexpr (HD > 0) {
#pragma unroll
    for (int c = 0; c < HD; c += 4) step(c);
  } else {
#pragma unroll 2
    for (int c = 0; c < dp; c += 4) step(c);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT, Cfg<HD>::MINB)
flash_attention_kernel(const Params p) {
  using C = Cfg<HD>;
  constexpr int TR = C::TR, WR = C::WR, NT = C::NT, NPC = C::NPC;
  const int d = HD ? HD : p.d;
  const int dp = HD ? HD : p.dp;
  const int ld = dp + 4;
  const int npc = dp / 32;
  const T* __restrict__ qg = static_cast<const T*>(p.q);
  const T* __restrict__ kg = static_cast<const T*>(p.k);
  const T* __restrict__ vg = static_cast<const T*>(p.v);
  T* __restrict__ og = static_cast<T*>(p.o);
  const int rows = p.rows, Sq = p.Sq, Skv = p.Skv, H = p.H, Hkv = p.Hkv;
  const int causal = p.causal, window = p.window;

  // block -> (query tile, b, kv head, head slice); the query tiles that see
  // the most keys (causal) go first
  unsigned bid = blockIdx.x;
  const int slice = (int)(bid % (unsigned)p.slices);
  bid /= (unsigned)p.slices;
  const int kvh = (int)(bid % (unsigned)Hkv);
  bid /= (unsigned)Hkv;
  const int b = (int)(bid % (unsigned)p.B);
  bid /= (unsigned)p.B;
  const int qt = p.n_qt - 1 - (int)bid;
  const int G = H / Hkv;
  const int h0 = kvh * G + slice * p.heads;
  const int nh = min(p.heads, G - slice * p.heads);
  const int q0 = qt * rows;
  const int qn = min(rows, Sq - q0);  // query rows of each head here

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][ld]
  float* kv_s = q_s + kRows * ld;  // stages of K [kBK][ld], V [kBK][ld]
  float* p_s = kv_s + 2 * p.stages * kBK * ld;  // [kRows][kLdP]
  // block row r -> element offset of its q (and o) row, -1 if none; and
  // its query index in the tile
  __shared__ long long row_off[kRows];
  __shared__ int row_qi[kRows];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 3, tx = lane & 7;
  if (tid < kRows) {
    const int g = tid / rows, qi = tid - g * rows;
    row_qi[tid] = qi;
    row_off[tid] = g < nh && qi < qn
                       ? (((long long)b * Sq + q0 + qi) * H + h0 + g) * d
                       : -1;
  }

  // the keys some row of this block may see
  const int qpos_lo = p.q_offset + q0, qpos_hi = p.q_offset + q0 + qn - 1;
  int kv_hi = Skv, kv_lo = 0;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int t_first = kv_lo / kBK;
  const int n_t =
      kv_hi > t_first * kBK ? (kv_hi - t_first * kBK + kBK - 1) / kBK : 0;
  __syncthreads();

  // this thread's rows ty + 4 i of the warp's WR: the keys [klo, khi]
  // each may see (empty for a row outside the tile), and the range of
  // positions over the warp's rows
  int klo[TR], khi[TR];
  int wlo = INT_MAX, whi = INT_MIN;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = warp * WR + ty + 4 * i;
    const int qpos = p.q_offset + q0 + row_qi[r];
    klo[i] = window > 0 ? max(0, qpos - window + 1) : 0;
    khi[i] = causal ? min(Skv - 1, qpos) : Skv - 1;
    if (row_off[r] < 0) {
      klo[i] = INT_MAX;
      khi[i] = INT_MIN;
    } else {
      wlo = min(wlo, qpos);
      whi = max(whi, qpos);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  float m[TR], l[TR], acc[TR][NPC][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NPC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  if (n_t > 0) {
    // padded columns [d, dp) of every staged row stay zero
    if (dp > d) {
      const int pad = dp - d;
      for (int e = tid; e < (kRows + 2 * p.stages * kBK) * pad; e += NT) {
        const int r = e / pad;
        q_s[r * ld + d + (e - r * pad)] = 0.f;
      }
    }
    stage_rows<T, NT>(q_s, ld, kRows, d, p.vec & kVecQ, [=](int r) {
      const long long off = row_off[r];
      return off >= 0 ? qg + off : nullptr;
    });
    auto load_kv = [&](int t) {
      const int k0 = (t_first + t) * kBK;
      float* ks = kv_s + (t & 1) * 2 * kBK * ld;
      const long long row0 = ((long long)b * Skv + k0) * Hkv + kvh;
      const int nk = min(kBK, Skv - k0);
      stage_rows<T, NT>(ks, ld, kBK, d, p.vec & kVecK, [=](int j) {
        return j < nk ? kg + (row0 + (long long)j * Hkv) * d : nullptr;
      });
      stage_rows<T, NT>(ks + kBK * ld, ld, kBK, d, p.vec & kVecV, [=](int j) {
        return j < nk ? vg + (row0 + (long long)j * Hkv) * d : nullptr;
      });
    };
    load_kv(0);
    cp_async_commit();

    const float* qrow = q_s + (warp * WR + ty) * ld;
    float* prow = p_s + (warp * WR + ty) * kLdP;
    for (int t = 0; t < n_t; ++t) {
      if (t + 1 < n_t) {
        load_kv(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ks = kv_s + (t & 1) * 2 * kBK * ld;
      const float* vs = ks + kBK * ld;
      const int k0 = (t_first + t) * kBK;
      // the 16-key halves of the tile that some row of this warp may see
      bool act[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lo = k0 + 16 * hh, hi = min(lo + 15, Skv - 1);
        act[hh] = wlo <= whi && lo < Skv && (!causal || lo <= whi) &&
                  (window <= 0 || hi > wlo - window);
      }
      if (act[0] || act[1]) {
        float sc[TR][4];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        const float* krow = ks + tx * ld;
        if (act[0] && act[1])
          qk<HD, TR, 0, 4>(sc, qrow, krow, ld, dp);
        else if (act[0])
          qk<HD, TR, 0, 2>(sc, qrow, krow, ld, dp);
        else
          qk<HD, TR, 2, 4>(sc, qrow, krow, ld, dp);

        // online softmax, as the TPU kernel does it
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float s[4];
          bool ok[4];
          float tmax = kNeg;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kv = k0 + tx + 8 * j;
            ok[j] = act[j >> 1] && kv >= klo[i] && kv <= khi[i];
            float x = sc[i][j] * p.scale;
            if (act[j >> 1] && p.softcap > 0.f)
              x = p.softcap * tanhf(x / p.softcap);
            s[j] = ok[j] ? x : kNeg;
            tmax = fmaxf(tmax, s[j]);
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
          const float m_new = fmaxf(m[i], tmax);
          const float m_safe = fmaxf(m_new, -1e30f);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pj = ok[j] ? expf(s[j] - m_safe) : 0.f;
            psum += pj;
            if (act[j >> 1]) prow[4 * i * kLdP + tx + 8 * j] = pj;
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, off);
          if (m[i] > kNeg / 2) {
            const float corr = expf(fmaxf(m[i], -1e30f) - m_safe);
            l[i] = l[i] * corr + psum;
#pragma unroll
            for (int c = 0; c < NPC; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
          } else {
            // no valid key yet: corr = 0 and (l, acc) are still 0
            l[i] = psum;
          }
          m[i] = m_new;
        }
        __syncwarp();

        // acc += p . V over the tile's visible halves
        const float* vcol = vs + 4 * tx;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (!act[hh]) continue;
#pragma unroll
          for (int j4 = 16 * hh; j4 < 16 * hh + 16; j4 += 4) {
            float4 pr[TR];
#pragma unroll
            for (int i = 0; i < TR; ++i)
              pr[i] = load4(prow + 4 * i * kLdP + j4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* vrow = vcol + (j4 + e) * ld;
#pragma unroll
              for (int c = 0; c < NPC; ++c) {
                if (HD == 0 && c >= npc) break;
                const float4 vv = load4(vrow + 32 * c);
#pragma unroll
                for (int i = 0; i < TR; ++i)
                  fma4(acc[i][c], lane4(pr[i], e), vv);
              }
            }
          }
        }
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }
  }

  // o = acc / max(l, 1e-20) from registers
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const long long off = row_off[warp * WR + ty + 4 * i];
    if (off < 0) continue;
    T* out = og + off;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NPC; ++c) {
      if (HD == 0 && c >= npc) break;
      const int col = 4 * tx + 32 * c;
      if (col >= d) continue;
      float v4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v4[e] = acc[i][c][e] * inv;
      if (p.vec & kVecO) {
        store_piece(out + col, v4);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) store_one(out + col + e, v4[e]);
      }
    }
  }
}

size_t smem_bytes(int dp, int stages) {
  return sizeof(float) * ((size_t)(kRows + 2 * stages * kBK) * (dp + 4) +
                          (size_t)kRows * kLdP);
}

template <typename T, int HD>
int launch_hd(const Params& p, void* stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = smem_bytes(p.dp, p.stages);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)p.n_qt * p.B * p.Hkv * p.slices;
  kernel<<<(unsigned)blocks, Cfg<HD>::NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, int d, float scale, int causal,
           int window, float softcap, int q_offset, int rows, int heads,
           int vec, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (d < 1 || d > kMaxD || Hkv < 1 || H % Hkv || heads < 1 || rows < 1 ||
      heads > H / Hkv || (long long)heads * rows > kRows)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.Hkv = Hkv;
  p.d = d;
  p.dp = (d + 31) / 32 * 32;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.rows = rows;
  p.heads = heads;
  p.slices = (H / Hkv + heads - 1) / heads;
  p.n_qt = (Sq + rows - 1) / rows;
  p.vec = vec;
  p.stages = Skv > kBK ? 2 : 1;
  if ((long long)p.n_qt * B * Hkv * p.slices >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch_hd<T, 64>(p, stream);
    case 96:
      return launch_hd<T, 96>(p, stream);
    case 128:
      return launch_hd<T, 128>(p, stream);
    case 192:
      return launch_hd<T, 192>(p, stream);
    case 256:
      return launch_hd<T, 256>(p, stream);
    default:
      return launch_hd<T, 0>(p, stream);
  }
}

}  // namespace

extern "C" {

// window <= 0: no sliding window; softcap <= 0: no softcap.  rows, heads
// and vec are the wrapper's launch plan: rows of each head a query tile,
// query heads a block, and flags 1 q, 2 k, 4 v, 8 o for tensors whose rows
// take 16-byte pieces.  Each returns the cudaError_t of the launch (0 =
// cudaSuccess).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int Hkv, int d,
                        float scale, int causal, int window, float softcap,
                        int q_offset, int rows, int heads, int vec,
                        void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, d, scale, causal,
                       window, softcap, q_offset, rows, heads, vec, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int H, int Hkv, int d,
                         float scale, int causal, int window, float softcap,
                         int q_offset, int rows, int heads, int vec,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, d, scale,
                               causal, window, softcap, q_offset, rows, heads,
                               vec, stream);
}

}  // extern "C"
