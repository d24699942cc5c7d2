// Blocked online-softmax attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_flash_kernel`) with its whole contract:
//   * GQA: query head hh reads kv head hh / (H / Hkv); K and V are never
//     repeated in device memory;
//   * causal masking, a sliding window, a logit softcap, keys past Skv
//     masked, and q_offset (query i sits at absolute position q_offset + i);
//   * scale (the wrapper defaults it to d^-0.5), the -2e38 mask value, and a
//     row with no valid key gives 0;
//   * head_dim 64, 128 or 256; float32 or bfloat16 in, the output in the
//     input's dtype, float32 accumulation throughout.
// Layout: q [B, Sq, H, d], k and v [B, Skv, Hkv, d], o [B, Sq, H, d], all
// contiguous (the layout of the model code; nothing is transposed).
//
// What bounds it on the H100: at the LM fleet's shape (Sq = Skv = 32,
// d = 64) a (batch, head) pair does 2 * 32 * 32 * 64 * 2 = 262 KFLOP on
// 24 KB of q, k, v and o in float32: ~11 flops per byte, under float32's
// ~20 flops/byte balance on CUDA cores, so bytes bound it there.  Long
// sequences are compute-bound and want tensor cores (wgmma) in a later PR.
//
// Design: the TPU kernel padded to 512-row blocks on a (b*H, nq, nkv) grid
// and carried (m, l, acc) in VMEM scratch across the sequential kv axis.
// Here one block of 4 warps owns 16 query rows of one (b, head), 4 rows per
// warp, and walks the kv axis itself in 32-key tiles held in shared memory:
//   * scores: lane j takes key j of the tile, a dot product over d with the
//     query row broadcast from shared memory (K rows padded to d + 1 floats,
//     so the 32 lanes hit 32 banks);
//   * online softmax per row in registers: the tile max and sum by warp
//     shuffles, then the rescale of (l, acc) exactly as the TPU kernel does
//     it (m_safe = max(m, -1e30), corr = 0 until a valid key was seen);
//   * P.V: each lane owns d/32 output columns and accumulates over the 32
//     keys, taking p_j by shuffle.
// Key tiles that are fully masked for every row of the block (past the
// causal diagonal, before the window) are skipped: for them the online
// update is the identity, so skipping changes no bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile, one per lane
constexpr float kNeg = -2.0e38f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int Hkv, float scale, int causal,
                       int window, float softcap, int q_offset) {
  constexpr int DC = HD / 32;  // output columns per lane
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int qt = (int)(blockIdx.x % (unsigned)n_qt);
  const long long bh = blockIdx.x / (unsigned)n_qt;
  const int hh = (int)(bh % H);
  const long long b = bh / H;
  const int kvh = hh / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * kBQ;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][HD]
  float* k_s = q_s + kBQ * HD;         // [kBK][HD + 1]
  float* v_s = k_s + kBK * (HD + 1);   // [kBK][HD]

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    q_s[e] = q0 + r < Sq
                 ? to_float(q[((b * Sq + q0 + r) * H + hh) * HD + c])
                 : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[r][cc] = 0.0f;
  }

  // keys that can be valid for some row of this block
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv, kv_lo = 0;
  if (causal) kv_hi = max(0, min(Skv, q_last + 1));
  if (window > 0) kv_lo = max(0, q_offset + q0 - window + 1);
  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s is loaded)
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, c = e % HD;
      const bool in = k0 + j < Skv;
      const long long off = ((b * Skv + k0 + j) * Hkv + kvh) * HD + c;
      k_s[j * (HD + 1) + c] = in ? to_float(k[off]) : 0.0f;
      v_s[e] = in ? to_float(v[off]) : 0.0f;
    }
    __syncthreads();
    const int kv_pos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (q0 + row >= Sq) continue;  // warp-uniform
      const int q_pos = q_offset + q0 + row;
      float dot = 0.0f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c)
        dot = fmaf(q_s[row * HD + c], k_s[lane * (HD + 1) + c], dot);
      float s = dot * scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      bool valid = kv_pos < Skv;
      if (causal) valid = valid && kv_pos <= q_pos;
      if (window > 0) valid = valid && (q_pos - kv_pos) < window;
      s = valid ? s : kNeg;
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, tmax);
      const float m_safe = fmaxf(m_new, -1e30f);
      const float pj = valid ? expf(s - m_safe) : 0.0f;
      const float corr =
          m_prev > kNeg / 2 ? expf(fmaxf(m_prev, -1e30f) - m_safe) : 0.0f;
      float psum = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = l[r] * corr + psum;
      float pv[DC];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) pv[cc] = 0.0f;
#pragma unroll 8
      for (int jj = 0; jj < kBK; ++jj) {
        const float p = __shfl_sync(0xffffffffu, pj, jj);
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          pv[cc] = fmaf(p, v_s[jj * HD + lane + 32 * cc], pv[cc]);
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[r][cc] = acc[r][cc] * corr + pv[cc];
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    if (q0 + row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-20f);
    T* out = o + ((b * Sq + q0 + row) * H + hh) * HD;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) store(out + lane + 32 * cc, acc[r][cc] * inv);
  }
}

template <int HD>
size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int Hkv, float scale, int causal,
              int window, float softcap, int q_offset, void* stream) {
  const size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)((Sq + kBQ - 1) / kBQ) * B * H;
  flash_attention_kernel<T, HD>
      <<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, Hkv,
          scale, causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, int d, float scale, int causal,
           int window, float softcap, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  switch (d) {
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                              window, softcap, q_offset, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                               window, softcap, q_offset, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                               window, softcap, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// window <= 0: no sliding window; softcap <= 0: no softcap.  Each returns
// the cudaError_t of the launch (0 = cudaSuccess).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int Hkv, int d,
                        float scale, int causal, int window, float softcap,
                        int q_offset, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, d, scale, causal,
                       window, softcap, q_offset, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int H, int Hkv, int d,
                         float scale, int causal, int window, float softcap,
                         int q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, d, scale,
                               causal, window, softcap, q_offset, stream);
}

}  // extern "C"
