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
// is the int8 dequantize; it is absent for float payloads).
//
// Layout: the tree's leaves stay where they are.  The host passes up to
// kMaxLeaves leaf pointers, each a contiguous [D, n_l] payload, with their
// column offsets, and as many [G, n_l] float32 outputs; no concatenated
// [D, N] copy is made, so the kernel moves exactly the bytes of the
// function: D*N payload elements in, G*N floats out.
//
// What bounds it on the H100: bytes.  One multiply-add per payload element
// against 4 (f32) / 2 (bf16) / 1 (int8) bytes read; the main path (D = 256
// devices x N = 61,706 LeNet params, f32, flat, preweighted) reads 63.2 MB,
// a bound of ~18.9 us at 3.35 TB/s.
//
// Design: the TPU kernel padded D to 128 lanes and used a dummy segment
// plus one-hot MXU products; here every block first builds the [D] alpha
// vector (and the segment ids) in shared memory — O(D), formula for
// formula the TPU kernel's weight chain — then a 32 x 8 thread block owns
// 32 columns: each of the 8 row groups walks every 8th device row (a warp
// reads 32 neighbouring columns of one row: coalesced), accumulating in a
// register, and the 8 partial sums are added in a fixed order through
// shared memory (deterministic).  Segment mode loops over the G segments,
// reading each row only for its own segment, so the payload is still read
// once.  The per-segment sums of `normalize` mode are taken by one thread
// in device order (O(D) per block, deterministic; off the main path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kCols = 32;  // columns per block (threadIdx.x)
constexpr int kRowGroups = 8;  // device-row groups per block (threadIdx.y)

struct Leaves {
  const void* x[kMaxLeaves];
  float* out[kMaxLeaves];
  long long off[kMaxLeaves + 1];  // column offsets; off[n] = total columns
  int n;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

template <typename T>
__global__ void __launch_bounds__(kCols* kRowGroups)
    fused_aggregate_kernel(Leaves lv, int D, const float* __restrict__ raw,
                           const float* __restrict__ stale,
                           const float* __restrict__ mask,
                           const int* __restrict__ seg, int G,
                           const float* __restrict__ scales, int scale_stride,
                           int scale_base, int kind, float rate,
                           int normalize) {
  extern __shared__ float smem[];
  float* alpha = smem;                        // [D]
  float* maskv = smem + D;                    // [D]
  int* segv = (int*)(smem + 2 * D);           // [D]
  float* seg_w = smem + 3 * D;                // [G]
  float* seg_m = seg_w + G;                   // [G]
  float* seg_n = seg_m + G;                   // [G]
  __shared__ float red[kRowGroups][kCols + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;

  // ---- the [D] weight vector (the TPU kernel's meta-row chain)
  for (int i = tid; i < D; i += kCols * kRowGroups) {
    const float s = stale[i];
    float dec = 1.0f;
    if (kind == 1) dec = powf(rate, s);
    else if (kind == 2) dec = powf(1.0f + s, -rate);
    const float m = mask[i];
    alpha[i] = raw[i] * dec * m;
    maskv[i] = m;
    segv[i] = seg[i];
  }
  __syncthreads();
  if (normalize) {
    if (tid == 0) {
      for (int g = 0; g < G; ++g) seg_w[g] = seg_m[g] = seg_n[g] = 0.0f;
      for (int i = 0; i < D; ++i) {
        const int g = segv[i];
        if (g < 0 || g >= G) continue;
        seg_w[g] += alpha[i];
        seg_m[g] += maskv[i];
        seg_n[g] += 1.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < D; i += kCols * kRowGroups) {
      const int g = segv[i];
      if (g < 0 || g >= G) { alpha[i] = 0.0f; continue; }
      const float wsum = seg_w[g], msum = seg_m[g];
      const float uniform = msum > 0.0f ? maskv[i] / fmaxf(msum, 1.0f)
                                        : 1.0f / fmaxf(seg_n[g], 1.0f);
      alpha[i] = wsum > 0.0f ? alpha[i] / fmaxf(wsum, 1e-30f) : uniform;
    }
    __syncthreads();
  }

  // ---- this thread's column: which leaf, where in it
  const long long col = (long long)blockIdx.x * kCols + tx;
  const bool valid = col < lv.off[lv.n];
  int l = 0;
  if (valid)
    while (col >= lv.off[l + 1]) ++l;
  const long long n_l = lv.off[l + 1] - lv.off[l];
  const long long local = col - lv.off[l];
  const T* x = (const T*)lv.x[l];
  const float* sc = scales ? scales + scale_base + l : nullptr;

  for (int g = 0; g < G; ++g) {
    float acc = 0.0f;
    if (valid) {
#pragma unroll 4
      for (int i = ty; i < D; i += kRowGroups) {
        if (segv[i] != g) continue;
        float v = to_float(x[(long long)i * n_l + local]);
        if (sc) v *= sc[(long long)i * scale_stride];
        acc += alpha[i] * v;
      }
    }
    red[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && valid) {
      float total = red[0][tx];
      for (int r = 1; r < kRowGroups; ++r) total += red[r][tx];
      lv.out[l][(long long)g * n_l + local] = total;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* x, float* const* out, const long long* offsets,
           int n_leaves, int D, const float* raw, const float* stale,
           const float* mask, const int* seg, int G, const float* scales,
           int scale_stride, int scale_base, int kind, float rate,
           int normalize, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Leaves lv;
  lv.n = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    lv.x[l] = x[l];
    lv.out[l] = out[l];
    lv.off[l] = offsets[l];
  }
  lv.off[n_leaves] = offsets[n_leaves];
  const long long cols = offsets[n_leaves];
  if (cols == 0) return 0;
  const size_t smem = (size_t)(3 * D + 3 * G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_aggregate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kCols, kRowGroups);
  const unsigned grid = (unsigned)((cols + kCols - 1) / kCols);
  fused_aggregate_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      lv, D, raw, stale, mask, seg, G, scales, scale_stride, scale_base, kind,
      rate, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n_leaves payload pointers ([D, n_l] each); out: n_leaves float32
// outputs ([G, n_l] each); offsets: n_leaves + 1 column offsets.  raw,
// stale, mask: float32 [D]; seg: int32 [D]; scales: float32 [D, scale_stride]
// or null, column `scale_base + l` for leaf l.  kind: 0 none, 1 exp, 2 poly.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
#define FUSED_AGGREGATE_ENTRY(NAME, T)                                        \
  int NAME(const void* const* x, float* const* out, const long long* offsets, \
           int n_leaves, int D, const float* raw, const float* stale,         \
           const float* mask, const int* seg, int G, const float* scales,     \
           int scale_stride, int scale_base, int kind, float rate,            \
           int normalize, void* stream) {                                     \
    return launch<T>(x, out, offsets, n_leaves, D, raw, stale, mask, seg, G,  \
                     scales, scale_stride, scale_base, kind, rate, normalize, \
                     stream);                                                 \
  }

FUSED_AGGREGATE_ENTRY(fused_aggregate_f32, float)
FUSED_AGGREGATE_ENTRY(fused_aggregate_bf16, __nv_bfloat16)
FUSED_AGGREGATE_ENTRY(fused_aggregate_i8, int8_t)

}  // extern "C"
