// Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_intra_chunk` (src/repro/kernels/ssd_scan.py,
// body `_kernel`).  For one (batch*chunk z, head hh) it computes
//     y[l, c]     = sum_{m <= l} (C_l . B_m) exp(min(la_l - la_m, 0)) xdt[m, c]
//     state[c, k] = sum_m xdt[m, c] B_m[k] exp(la_{L-1} - la_m)
// with float32 accumulation and float32 outputs.
//
// Layout: the kernel reads the tensors in the layout the SSD caller already
// has, so nothing is repeated or transposed in device memory:
//     C, B  [Z, L, g, n]   one row per group: head hh reads group hh / (h/g)
//     la    [Z, L, h]      float32 cumulative log-decay within the chunk
//     xdt   [Z, L, h, p]   dt-scaled inputs
//     y     [Z, L, h, p]   float32
//     state [Z, h, p, n]   float32
// The TPU caller repeated B and C over the heads of a group and transposed
// them to [Z*h, L, n]; at mamba2-1.3b widths (64 heads, 1 group) that is 64
// copies.  Here every head of a group reads the same rows, which stay in L2.
//
// What bounds it on the H100: at the shapes of the LM fleet (L = 32, n = 128,
// p = 64) each (z, head) does ~0.73 MFLOP (the [p, n] state is most of it)
// and moves ~48 KB of its own (xdt in, y and the state out; B and C rows are
// shared by the 64 heads), ~15 flops per byte against float32's ~20
// flops/byte balance on CUDA cores: close to both limits.  At the published
// chunk (L = 256) the L^2 terms grow and it is compute-bound.
//
// Design (CUDA cores; tensor cores are a later step): one block of 256
// threads per (z, head), the heads of one z on neighbouring blocks.  C and B
// do not fit in shared memory together at L = 256 and n = 128 (2 x 128 KB >
// 227 KB), so the block walks 32-row tiles, and every thread keeps a small
// register tile so that one value read from shared memory feeds several
// fused multiply-adds:
//   1. state: for each 32-row m tile, B_m scaled by exp(la_last - la_m) and
//      xdt_m go to shared memory; a thread owns a 4 (c) x 8 (k) tile of the
//      [p, n] state, 12 reads for 32 FMAs per row (larger states take
//      several passes of 256 tiles);
//   2. y: for each 32-row l tile, C_l stays in shared memory; for each m tile
//      at or before it (causal), a thread forms a 2 x 2 piece of the masked,
//      decayed 32x32 score tile, then adds its 2 (l) x p/16 (c) outputs.
//      Tiles past the diagonal are never visited.
// Threads of a warp read consecutive columns, or rows padded to n + 1
// floats, so shared-memory reads hit distinct banks or broadcast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;    // rows of an l tile and of an m tile
constexpr int kHalf = 16;    // a thread's two rows of a tile: r, r + 16
constexpr int kMaxCI = 16;   // output columns per thread in y: p <= 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                       const float* __restrict__ la,
                       const T* __restrict__ xdt, int L, int g, int n, int h,
                       int p, float* __restrict__ y,
                       float* __restrict__ state) {
  const int hh = (int)(blockIdx.x % (unsigned)h);  // heads of one z adjacent
  const long long z = blockIdx.x / (unsigned)h;
  const int tid = threadIdx.x;
  const int grp = hh / (h / g);
  const long long row_bc = (long long)g * n;   // stride of l in C and B
  const long long row_x = (long long)h * p;    // stride of l in xdt and y
  const T* Cz = C + z * L * row_bc + (long long)grp * n;
  const T* Bz = B + z * L * row_bc + (long long)grp * n;
  const float* laz = la + z * L * h + hh;
  const T* xz = xdt + z * L * row_x + (long long)hh * p;
  float* yz = y + z * L * row_x + (long long)hh * p;
  float* stz = state + (z * h + hh) * (long long)p * n;

  extern __shared__ float smem[];
  const int ns = n + 1, ss = kTile + 1;
  float* la_s = smem;                          // [L]
  float* c_s = la_s + L;                       // [kTile][n + 1]
  float* b_s = c_s + kTile * ns;               // [kTile][n + 1]
  float* x_s = b_s + kTile * ns;               // [kTile][p]
  float* s_s = x_s + kTile * p;                // [kTile][kTile + 1]

  for (int l = tid; l < L; l += kThreads) la_s[l] = laz[(long long)l * h];
  __syncthreads();
  const float la_last = la_s[L - 1];

  // ---- 1. chunk state [p, n], 4 x 8 register tiles strided over (c, k)
  const int nct = (p + 3) / 4, nkt = (n + 7) / 8, n_tiles = nct * nkt;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const bool active = t < n_tiles;
    const int ct = active ? t / nkt : 0, kt = active ? t % nkt : 0;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int m0 = 0; m0 < L; m0 += kTile) {
      const int rows = min(kTile, L - m0);
      for (int e = tid; e < rows * n; e += kThreads) {
        const int mm = e / n, k = e % n;
        b_s[mm * ns + k] = to_float(Bz[(m0 + mm) * row_bc + k]) *
                           expf(la_last - la_s[m0 + mm]);
      }
      for (int e = tid; e < rows * p; e += kThreads) {
        const int mm = e / p, c = e % p;
        x_s[e] = to_float(xz[(m0 + mm) * row_x + c]);
      }
      __syncthreads();
      if (active) {
        for (int mm = 0; mm < rows; ++mm) {
          float xv[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = ct + nct * i;
            xv[i] = c < p ? x_s[mm * p + c] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = kt + nkt * j;
            bv[j] = k < n ? b_s[mm * ns + k] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ct + nct * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = kt + nkt * j;
          if (c < p && k < n) stz[(long long)c * n + k] = acc[i][j];
        }
      }
    }
  }

  // ---- 2. y, one 32-row l tile at a time; thread (r, q) of a 16 x 16 grid
  // owns rows r and r + 16 of the score and output tiles
  const int r = tid / kHalf, q = tid % kHalf;
  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int lrows = min(kTile, L - l0);
    for (int e = tid; e < kTile * n; e += kThreads) {
      const int ll = e / n, k = e % n;
      c_s[ll * ns + k] =
          ll < lrows ? to_float(Cz[(l0 + ll) * row_bc + k]) : 0.0f;
    }
    float acc[2][kMaxCI];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCI; ++j) acc[i][j] = 0.0f;
    for (int m0 = 0; m0 < l0 + lrows; m0 += kTile) {
      const int mrows = min(kTile, L - m0);
      for (int e = tid; e < kTile * n; e += kThreads) {
        const int mm = e / n, k = e % n;
        b_s[mm * ns + k] =
            mm < mrows ? to_float(Bz[(m0 + mm) * row_bc + k]) : 0.0f;
      }
      for (int e = tid; e < kTile * p; e += kThreads) {
        const int mm = e / p, c = e % p;
        x_s[e] = mm < mrows ? to_float(xz[(m0 + mm) * row_x + c]) : 0.0f;
      }
      __syncthreads();
      // scores for rows (r, r + 16) x columns (q, q + 16)
      float dot[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int k = 0; k < n; ++k) {
        const float c0 = c_s[r * ns + k], c1 = c_s[(r + kHalf) * ns + k];
        const float b0 = b_s[q * ns + k], b1 = b_s[(q + kHalf) * ns + k];
        dot[0][0] = fmaf(c0, b0, dot[0][0]);
        dot[0][1] = fmaf(c0, b1, dot[0][1]);
        dot[1][0] = fmaf(c1, b0, dot[1][0]);
        dot[1][1] = fmaf(c1, b1, dot[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ll = r + kHalf * i, mm = q + kHalf * j;
          const int l = l0 + ll, m = m0 + mm;
          s_s[ll * ss + mm] =
              ll < lrows && mm < mrows && m <= l
                  ? dot[i][j] * expf(fminf(la_s[l] - la_s[m], 0.0f))
                  : 0.0f;
        }
      __syncthreads();
      for (int mm = 0; mm < mrows; ++mm) {
        const float s0 = s_s[r * ss + mm], s1 = s_s[(r + kHalf) * ss + mm];
#pragma unroll
        for (int j = 0; j < kMaxCI; ++j) {
          const int c = q + kHalf * j;
          if (c < p) {
            const float xv = x_s[mm * p + c];
            acc[0][j] = fmaf(s0, xv, acc[0][j]);
            acc[1][j] = fmaf(s1, xv, acc[1][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ll = r + kHalf * i;
      if (ll >= lrows) continue;
#pragma unroll
      for (int j = 0; j < kMaxCI; ++j) {
        const int c = q + kHalf * j;
        if (c < p) yz[(l0 + ll) * row_x + c] = acc[i][j];
      }
    }
  }
}

size_t smem_bytes(int L, int n, int p) {
  return sizeof(float) * ((size_t)L + 2 * (size_t)kTile * (n + 1) +
                          (size_t)kTile * p + (size_t)kTile * (kTile + 1));
}

template <typename T>
int launch(const void* C, const void* B, const float* la, const void* xdt,
           int Z, int L, int g, int n, int h, int p, float* y, float* state,
           void* stream) {
  if (Z == 0 || h == 0 || L == 0) return 0;
  const size_t smem = smem_bytes(L, n, p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((long long)Z * h);
  ssd_intra_chunk_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)C, (const T*)B, la, (const T*)xdt, L, g, n, h, p, y, state);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).
int ssd_intra_chunk_f32(const void* C, const void* B, const float* la,
                        const void* xdt, int Z, int L, int g, int n, int h,
                        int p, float* y, float* state, void* stream) {
  return launch<float>(C, B, la, xdt, Z, L, g, n, h, p, y, state, stream);
}

int ssd_intra_chunk_bf16(const void* C, const void* B, const float* la,
                         const void* xdt, int Z, int L, int g, int n, int h,
                         int p, float* y, float* state, void* stream) {
  return launch<__nv_bfloat16>(C, B, la, xdt, Z, L, g, n, h, p, y, state,
                               stream);
}

}  // extern "C"
