// Fused dequantize -> staleness decay -> masked Eq. 1 reduction over the
// stacked device axis, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_aggregate`
// (src/repro/kernels/fused_aggregation.py, body `_kernel`).  For a param
// tree flattened to columns, with device rows i = 0..D-1:
//     dec_i   = 1 | rate^s_i | (1 + s_i)^-rate        (kind none|exp|poly)
//     w_i     = raw_i * dec_i * mask_i
//     alpha_i = w_i, or with `normalize` the masked_normalize guard chain
//               per segment g(i): w_i / max(W_g, 1e-30) if W_g > 0, else
//               mask_i / max(M_g, 1) if M_g > 0, else 1 / max(|g|, 1)
//     out[g, col] = sum_{i: g(i) = g} alpha_i * x[i, col] * scale[i, leaf]
// with float32 accumulation for float32, bf16 or int8 payloads (the scale
// is the int8 dequantize; it is absent for float payloads).  A null
// staleness, mask or segment-id pointer reads as 0, 1 and segment 0.
//
// Layout: the tree's leaves stay where they are.  The host passes up to
// kMaxLeaves leaf pointers, each a contiguous [D, n_l] payload, and as many
// [G, n_l] float32 outputs; no concatenated [D, N] copy is made, so the
// kernel moves the bytes of the function: D*N payload elements in, G*N
// floats out.
//
// What bounds it on the H100: bytes.  One multiply-add per payload element
// against 4 (f32) / 2 (bf16) / 1 (int8) bytes read, far below any compute
// ridge, so the tensor cores have no part in it.  Over 8 copies of the
// 129.4M-parameter SSM tree (f32) the bound is 1.39 ms at 3.35 TB/s; at
// D = 256 x 61,706 LeNet params it is 18.9 us.
//
// Design: a streaming reduction on a persistent grid.
// - The columns of every leaf are cut into tiles of TW = (256 / R) * V
//   columns (V = 16 bytes / element size); the host's tile table gives
//   each leaf's first tile.  About as many 256-thread blocks as fit on the
//   SMs walk the tiles in grid-stride order and find a tile's leaf by
//   binary search over the table (uniform across the block, so the reads
//   are constant-cache broadcasts).
// - Each block builds the [D] weight chain once, not once per tile: the
//   alpha vector, and with segment ids a stable counting sort of the rows
//   by segment in device order (warp 0, `__match_any_sync` ranks), so a
//   segment's pass reads only its own rows and every payload element is
//   still read once.  `normalize` sums each segment's weights and mask
//   with one warp per segment in a fixed shuffle order.
// - A thread owns V neighbouring columns.  Where a leaf's rows start on a
//   16-byte boundary (n_l * sizeof(T) % 16 == 0 and an aligned pointer,
//   decided by the host per leaf) it reads them with 16-byte `ld.global.nc`
//   loads, kUnroll rows at once (64 bytes in flight per thread, no shared
//   memory or barrier in the row loop); other leaves take a scalar path in
//   which lane k reads columns k, k + C, ... so every warp load is still
//   coalesced.  The ragged end of a tile is masked.
// - At most 64 registers a thread (80 for int8) keep 4 blocks (3) resident
//   an SM.  On the H100 that beat 8 rows in flight at 2-3 resident blocks,
//   which either spilled or left too few warps to cover the latency.
// - R > 1 splits the rows of a tile over R groups of 256 / R threads, for
//   large D over few columns (LeNet at D = 256 has ~15K column vectors, 60
//   blocks of 256 without a split).  The host picks R from D and the tile
//   count.  The R partial sums meet in shared memory and are added in row-
//   group order.
// - Deterministic: no atomics, and the summation order depends only on the
//   shapes, so two calls on the same inputs give equal bits.
// - No TMA: plain 16-byte loads already reach ~90% of the byte bound over
//   the LM trees, faster than `torch.mv`.  Bulk copies into a shared-memory
//   ring would add a stage without removing any bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows in flight per thread on the vector path

struct Leaves {
  const void* x[kMaxLeaves];
  float* out[kMaxLeaves];
  const float* scale[kMaxLeaves];  // int8: [D] per leaf; else null
  long long n[kMaxLeaves];         // columns of one device row
  int tile_off[kMaxLeaves + 1];    // first tile of each leaf; [count] = all
  unsigned vec;                    // bit l: leaf l takes 16-byte loads
  int count;
};

// V elements of T from 16 loaded bytes, as floats.
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bf16 is the high half of a float32
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[16]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[4 * k + b] = (float)((int)(w[k] << (24 - 8 * b)) >> 24);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float load1(const int8_t* p) {
  return (float)__ldg(reinterpret_cast<const signed char*>(p));
}

// The coefficient of sorted row j: alpha, times the leaf's int8 scale.
__device__ __forceinline__ float coefficient(const float* coef,
                                             const int* rows,
                                             const float* sc, int j) {
  return sc ? coef[j] * __ldg(sc + rows[j]) : coef[j];
}

// At least 4 resident blocks an SM (64 registers a thread), 3 for int8,
// whose 16 accumulators a thread would spill in 64.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 1 ? 3 : 4)
    fused_aggregate_kernel(const __grid_constant__ Leaves lv, int D, int R,
                           const float* __restrict__ raw,
                           const float* __restrict__ stale,
                           const float* __restrict__ mask,
                           const int* __restrict__ seg, int G, int kind,
                           float rate, int normalize) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kScalarRows = 16 / V > 1 ? 16 / V : 1;
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                 // [kThreads * V] row-group partials
  float* coef = red + kThreads * V;  // [D] alpha, rows in segment order
  float* mcoef = coef + D;           // [D] mask, same order
  int* rows = (int*)(mcoef + D);     // [D] device row of each slot
  int* rseg = rows + D;              // [D] segment of each slot
  int* seg_lo = rseg + D;            // [G + 1] first slot of each segment
  int* cnt = seg_lo + G + 1;         // [G] scratch of the sort
  float* wsum = (float*)(cnt + G);   // [G]
  float* msum = wsum + G;            // [G]
  const int tid = threadIdx.x, lane = tid & 31;

  auto weigh = [&](int i, int slot) {
    const float s = stale ? stale[i] : 0.0f;
    float dec = 1.0f;
    if (kind == 1) dec = powf(rate, s);
    else if (kind == 2) dec = powf(1.0f + s, -rate);
    const float m = mask ? mask[i] : 1.0f;
    coef[slot] = raw[i] * dec * m;
    mcoef[slot] = m;
  };

  // ---- the weight chain, once per block
  if (seg == nullptr) {
    for (int i = tid; i < D; i += kThreads) {
      rows[i] = i;
      rseg[i] = 0;
      weigh(i, i);
    }
    if (tid == 0) {
      seg_lo[0] = 0;
      seg_lo[1] = D;
    }
  } else if (tid < 32) {
    // stable counting sort by segment, in device order; ids outside
    // [0, G) are dropped
    for (int g = lane; g < G; g += 32) cnt[g] = 0;
    __syncwarp();
    for (int pass = 0; pass < 2; ++pass) {
      for (int base = 0; base < D; base += 32) {
        const int i = base + lane;
        int s = i < D ? seg[i] : -1;
        if (s < 0 || s >= G) s = -1;
        const unsigned same = __match_any_sync(0xffffffffu, s);
        const bool leader = s >= 0 && lane == __ffs(same) - 1;
        if (pass == 1 && s >= 0) {
          const int dst = cnt[s] + __popc(same & ((1u << lane) - 1u));
          rows[dst] = i;
          rseg[dst] = s;
          weigh(i, dst);
        }
        __syncwarp();
        if (leader) cnt[s] += __popc(same);
        __syncwarp();
      }
      if (pass == 0 && lane == 0) {
        int acc = 0;
        for (int g = 0; g < G; ++g) {
          seg_lo[g] = acc;
          acc += cnt[g];
          cnt[g] = seg_lo[g];
        }
        seg_lo[G] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (normalize) {
    for (int g = tid >> 5; g < G; g += kThreads / 32) {
      float w = 0.0f, m = 0.0f;
      for (int j = seg_lo[g] + lane; j < seg_lo[g + 1]; j += 32) {
        w += coef[j];
        m += mcoef[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        w += __shfl_xor_sync(0xffffffffu, w, o);
        m += __shfl_xor_sync(0xffffffffu, m, o);
      }
      if (lane == 0) {
        wsum[g] = w;
        msum[g] = m;
      }
    }
    __syncthreads();
    for (int j = tid; j < seg_lo[G]; j += kThreads) {
      const int g = rseg[j];
      const float w = wsum[g], m = msum[g];
      const float uniform =
          m > 0.0f ? mcoef[j] / fmaxf(m, 1.0f)
                   : 1.0f / fmaxf((float)(seg_lo[g + 1] - seg_lo[g]), 1.0f);
      coef[j] = w > 0.0f ? coef[j] / fmaxf(w, 1e-30f) : uniform;
    }
    __syncthreads();
  }

  // ---- the tiles
  const int C = kThreads / R;  // threads across the columns of a tile
  const int rg = tid / C, lc = tid % C;
  const long long TW = (long long)C * V;
  const int tiles = lv.tile_off[lv.count];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int l = 0, hi_l = lv.count;  // the last leaf whose first tile is <= t
    while (hi_l - l > 1) {
      const int mid = (l + hi_l) >> 1;
      if (lv.tile_off[mid] <= t) l = mid;
      else hi_l = mid;
    }
    const long long n = lv.n[l];
    const long long c0 = (long long)(t - lv.tile_off[l]) * TW;
    const T* __restrict__ x = (const T*)lv.x[l];
    float* __restrict__ out = lv.out[l];
    const float* sc = lv.scale[l];
    const bool vec = (lv.vec >> l) & 1u;

    for (int g = 0; g < G; ++g) {
      const int lo = seg_lo[g], hi = seg_lo[g + 1];
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
      if (vec) {
        const long long col = c0 + (long long)lc * V;
        if (col < n) {  // n is a multiple of V: whole vectors only
          for (int j0 = lo + rg; j0 < hi; j0 += R * kUnroll) {
            uint4 r[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int j = j0 + u * R;
              if (j < hi)
                r[u] = __ldg(reinterpret_cast<const uint4*>(
                    x + (long long)rows[j] * n + col));
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int j = j0 + u * R;
              if (j < hi) {
                const float c = coefficient(coef, rows, sc, j);
                float v[V];
                unpack(r[u], v);
#pragma unroll
                for (int k = 0; k < V; ++k) acc[k] = fmaf(c, v[k], acc[k]);
              }
            }
          }
        }
      } else {
        for (int j0 = lo + rg; j0 < hi; j0 += R * kScalarRows) {
          float v[kScalarRows][V];
#pragma unroll
          for (int u = 0; u < kScalarRows; ++u) {
            const int j = j0 + u * R;
            const T* xr = x + (j < hi ? (long long)rows[j] * n : 0);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const long long col = c0 + lc + (long long)k * C;
              v[u][k] = (j < hi && col < n) ? load1(xr + col) : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kScalarRows; ++u) {
            const int j = j0 + u * R;
            if (j < hi) {
              const float c = coefficient(coef, rows, sc, j);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[k] = fmaf(c, v[u][k], acc[k]);
            }
          }
        }
      }

      float* og = out + (long long)g * n;
      if (R == 1) {
        if (vec) {
          const long long col = c0 + (long long)lc * V;
          if (col < n) {
#pragma unroll
            for (int k = 0; k < V; k += 4)
              *reinterpret_cast<float4*>(og + col + k) =
                  make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const long long col = c0 + lc + (long long)k * C;
            if (col < n) og[col] = acc[k];
          }
        }
      } else {
        // the R row groups' partials meet in shared memory, added in
        // row-group order
        float* mine = red + rg * TW;
        if (vec) {
#pragma unroll
          for (int k = 0; k < V; k += 4)
            *reinterpret_cast<float4*>(mine + lc * V + k) =
                make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) mine[lc + k * C] = acc[k];
        }
        __syncthreads();
        for (int c = tid; c < TW; c += kThreads) {
          if (c0 + c < n) {
            float total = red[c];
            for (int r = 1; r < R; ++r) total += red[r * TW + c];
            og[c0 + c] = total;
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename T>
int launch(const void* const* x, float* const* out,
           const float* const* scale, const long long* n,
           const int* tile_off, unsigned vec, int count, int D, int R,
           const float* raw, const float* stale, const float* mask,
           const int* seg, int G, int kind, float rate, int normalize,
           void* stream) {
  if (count < 1 || count > kMaxLeaves || R < 1 || kThreads % R != 0 ||
      (seg == nullptr && G != 1))
    return (int)cudaErrorInvalidValue;
  Leaves lv;
  lv.count = count;
  lv.vec = vec;
  for (int l = 0; l < count; ++l) {
    lv.x[l] = x[l];
    lv.out[l] = out[l];
    lv.scale[l] = scale ? scale[l] : nullptr;
    lv.n[l] = n[l];
    lv.tile_off[l] = tile_off[l];
  }
  lv.tile_off[count] = tile_off[count];
  const int tiles = tile_off[count];
  if (tiles == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const size_t smem =
      (size_t)(kThreads * V + 4 * D + 4 * G + 1) * sizeof(float);
  const auto kernel = fused_aggregate_kernel<T>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int grid = tiles < resident ? tiles : resident;
  fused_aggregate_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      lv, D, R, raw, stale, mask, seg, G, kind, rate, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: count payload pointers ([D, n_l] each); out: count float32 outputs
// ([G, n_l] each); scale: count float32 [D] int8 scales, or null for float
// payloads; n: columns of each leaf; tile_off: count + 1 tile offsets of
// (256 / R) * (16 / sizeof(T)) columns a tile; vec: bit l set where leaf
// l's rows are 16-byte aligned.  raw: float32 [D]; stale, mask: float32
// [D] or null; seg: int32 [D] or null (then G = 1).  kind: 0 none, 1 exp,
// 2 poly.  Returns the cudaError_t of the launch (0 = cudaSuccess).
#define FUSED_AGGREGATE_ENTRY(NAME, T)                                       \
  int NAME(const void* const* x, float* const* out,                          \
           const float* const* scale, const long long* n,                    \
           const int* tile_off, unsigned vec, int count, int D, int R,       \
           const float* raw, const float* stale, const float* mask,          \
           const int* seg, int G, int kind, float rate, int normalize,       \
           void* stream) {                                                   \
    return launch<T>(x, out, scale, n, tile_off, vec, count, D, R, raw,      \
                     stale, mask, seg, G, kind, rate, normalize, stream);    \
  }

FUSED_AGGREGATE_ENTRY(fused_aggregate_f32, float)
FUSED_AGGREGATE_ENTRY(fused_aggregate_bf16, __nv_bfloat16)
FUSED_AGGREGATE_ENTRY(fused_aggregate_i8, int8_t)

}  // extern "C"
