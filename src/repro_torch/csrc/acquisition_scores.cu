// Fused MC-dropout acquisition scores (entropy, BALD, variational ratio)
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `acquisition_scores_fused`
// (src/repro/kernels/acquisition_scores.py, body `_kernel`): from MC
// log-probs it computes, in one pass,
//     pbar_c  = mean_t exp(logp[t, n, c])
//     entropy = -sum_c pbar_c * log(pbar_c + 1e-10)
//     bald    = entropy - mean_t(-sum_c p * logp)
//     vr      = 1 - max_c pbar_c
// Classes past C are simply not visited, which is what the TPU kernel's
// -1e30 class padding achieved (they carried zero probability).
//
// Layout: logp is [R, T, N, C] contiguous (R = devices; R = 1 for the
// reference's [T, N, C]).  Pool rows are independent, so devices fold into
// the row axis: the kernel scores R*N rows and writes three [R*N] float32
// vectors.
//
// What bounds it on the H100: bytes.  Each input element is read once and
// used for three statistics (~5 flops per element), far below the card's
// ~20 flops/byte balance point for float32 outside the tensor cores, so
// the bound is R*T*N*C*sizeof(in) / 3.35 TB/s.  At the paper's main-path
// shape (T=16, 4 devices x 200 rows, C=10, f32) that is 512 KB, ~0.15 us:
// far below one launch, so the kernel is launch-bound there.
//
// Design: one warp per pool row, lanes across classes (c = lane, lane+32,
// ...), a loop over T per class that keeps pbar and sum_t p*logp in
// registers, then warp-shuffle reductions for the two sums and the max.
// No padding of C or N: any C works (C = 257 takes nine classes per lane),
// a ragged N needs no tile.  bf16 input is widened with __bfloat162float;
// all arithmetic and the outputs are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void acquisition_scores_kernel(const T* __restrict__ logp,
                                          int rows_outer, int n_samples,
                                          int n_rows, int n_classes,
                                          float* __restrict__ ent_out,
                                          float* __restrict__ bald_out,
                                          float* __restrict__ vr_out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)rows_outer * n_rows) return;
  const long long r = row / n_rows;  // device
  const long long n = row % n_rows;  // pool row
  const long long t_stride = (long long)n_rows * n_classes;
  const T* base = logp + r * n_samples * t_stride + n * n_classes;
  const float inv_t = 1.0f / (float)n_samples;

  float ent = 0.0f, plogp = 0.0f, pmax = 0.0f;
  for (int c = lane; c < n_classes; c += 32) {
    float psum = 0.0f, pl = 0.0f;
    for (int t = 0; t < n_samples; ++t) {
      const float lp = to_float(base[t * t_stride + c]);
      const float p = expf(lp);
      psum += p;
      pl += p * lp;
    }
    const float pbar = psum * inv_t;
    ent -= pbar * logf(pbar + kEps);
    plogp += pl;
    pmax = fmaxf(pmax, pbar);
  }
  for (int off = 16; off > 0; off >>= 1) {
    ent += __shfl_xor_sync(0xffffffffu, ent, off);
    plogp += __shfl_xor_sync(0xffffffffu, plogp, off);
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
  }
  if (lane == 0) {
    const float exp_ent = -plogp * inv_t;
    ent_out[row] = ent;
    bald_out[row] = ent - exp_ent;
    vr_out[row] = 1.0f - pmax;
  }
}

template <typename T>
int launch(const void* logp, int rows_outer, int n_samples, int n_rows,
           int n_classes, float* ent, float* bald, float* vr, void* stream) {
  const long long rows = (long long)rows_outer * n_rows;
  if (rows == 0) return 0;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  acquisition_scores_kernel<T><<<blocks, kWarpsPerBlock * 32, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)logp, rows_outer, n_samples, n_rows, n_classes, ent, bald,
      vr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int acquisition_scores_f32(const void* logp, int rows_outer, int n_samples,
                           int n_rows, int n_classes, float* ent, float* bald,
                           float* vr, void* stream) {
  return launch<float>(logp, rows_outer, n_samples, n_rows, n_classes, ent,
                       bald, vr, stream);
}

int acquisition_scores_bf16(const void* logp, int rows_outer, int n_samples,
                            int n_rows, int n_classes, float* ent, float* bald,
                            float* vr, void* stream) {
  return launch<__nv_bfloat16>(logp, rows_outer, n_samples, n_rows,
                               n_classes, ent, bald, vr, stream);
}

}  // extern "C"
