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
// the bound is R*T*N*C*sizeof(in) / 3.35 TB/s: 0.0615 ms for the LM
// fleet's [8, 4, 32, 50288] float32 scoring call (206 MB), 0.0401 ms at
// C = 32768.  At the paper's shape (T=16, 4 devices x 200 rows, C=10) it
// is 512 KB, ~0.15 us: far below one launch, so the kernel is
// launch-bound there.
//
// Two modes, chosen per call by the host's plan
// (repro_torch/kernels/acquisition_scores.py::launch_plan):
//
// * warp (C < 1024; the paper and massive paths, C = 10): one warp per
//   pool row, lanes across classes (c = lane, lane+32, ...), a loop over T
//   per class that keeps pbar and sum_t p*logp in registers, then
//   warp-shuffle reductions for the two sums and the max.  Any C works, a
//   ragged N needs no tile.  This is the first design, kept as it was:
//   at C = 10 the split mode, a block a row with 10 of its 256 threads
//   busy, takes 2.9x its time at the paper's 800 rows and 9.9x at the
//   massive path's 8192 (tools/k1_modes.py on an H100).  The same script
//   puts the crossover at C = 128-256 for 256 or 800 rows and at
//   C = 256-1024 for 8192 rows; 1024 is the least measured C at which the
//   split mode wins at every row count.
//
// * split (C >= 1024; the LM vocabularies).  One warp a row starved the
//   memory system there: 256 rows made 32 blocks on 132 SMs, and each
//   warp had only T loads of 128 bytes in flight, ~130 KB over the chip
//   where holding 3.35 TB/s at HBM latency takes 2-3 MB; it ran at 1/24
//   of the byte bound.  Now a row is cut into S class slices and one
//   block of 256 threads owns one (row, slice).  S in 1, 2, 4, 8 is the
//   largest whose rows x S blocks all run in one wave (the launch bounds
//   keep 4 blocks an SM resident, 528 on the card), with no slice under
//   2048 classes: at 256 rows, S = 2 fills the card once and S = 4 runs a
//   second wave that costs more than the slices gain.  A thread reads V
//   classes at once with one 16-byte load (V = 4 float32 or 8 bfloat16)
//   where C is a multiple of V and the tensor starts on 16 bytes, one
//   class otherwise, and issues the loads of 4 MC samples together before
//   it uses any of them: 64 bytes in flight a thread, megabytes over the
//   chip; bfloat16 classes are widened where they are used, so they hold
//   half the registers while in flight.  Each thread keeps its
//   entropy, sum p*logp and max pbar in registers; a warp-shuffle tree
//   and then one thread over the 8 warps' partials (in warp order) give
//   the block's partial.  The S blocks of a row form one thread-block
//   cluster: after cluster.sync() rank 0 reads the other ranks' partials
//   from their shared memory (distributed shared memory), adds them in
//   rank order and writes the three outputs.  So a call is one launch
//   with no workspace, counter or memset, it is safe on any stream, and
//   every sum has a fixed order: two calls on the same input give the
//   same bits.
//
// bf16 input is widened to float32 exactly; all arithmetic and the
// outputs are float32.  Kernel symbols keep "acquisition_scores_kernel"
// in their names (profilers match on it).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitBlocksPerSM = 4;  // launch bounds: <= 64 registers
constexpr int kSampleGroup = 4;   // MC samples whose loads go out together
constexpr int kMaxSlices = 8;     // the portable cluster size
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

// V consecutive classes of one sample row: `load` fetches them as they
// lie in memory (one 16-byte load when V > 1; the plan guarantees 16-byte
// alignment then), `get` widens class j to float32 where it is used, so
// bfloat16 classes take half the registers in flight.
template <typename T, int V>
struct Classes;

template <>
struct Classes<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float get(Raw r, int) { return r; }
};

template <>
struct Classes<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
  }
};

template <>
struct Classes<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return p[0];
  }
  static __device__ __forceinline__ float get(Raw r, int) {
    return __bfloat162float(r);
  }
};

template <>
struct Classes<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    const unsigned w = j < 2 ? r.x : j < 4 ? r.y : j < 6 ? r.z : r.w;
    // class 2i sits in the low half of word i; widening is exact
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// One block owns class slice `rank` of one pool row; the `slices` blocks
// of a row are one cluster, and its rank 0 writes the row's outputs.
template <typename T, int V>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSM)
    acquisition_scores_kernel_split(const T* __restrict__ logp,
                                    int n_samples, int n_rows, int n_classes,
                                    int slices, float* __restrict__ ent_out,
                                    float* __restrict__ bald_out,
                                    float* __restrict__ vr_out) {
  __shared__ float warp_part[3][kSplitWarps];
  __shared__ float block_part[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x / slices;
  const long long r = row / n_rows;  // device
  const long long n = row % n_rows;  // pool row
  const long long t_stride = (long long)n_rows * n_classes;
  const T* base = logp + r * n_samples * t_stride + n * n_classes;
  const long long n_vec = n_classes / V;
  const long long lo = n_vec * rank / slices;
  const long long hi = n_vec * (rank + 1) / slices;
  const float inv_t = 1.0f / (float)n_samples;

  float ent = 0.0f, plogp = 0.0f, pmax = 0.0f;
  for (long long v = lo + threadIdx.x; v < hi; v += kSplitThreads) {
    const T* col = base + v * V;
    float psum[V], pl[V];
#pragma unroll
    for (int j = 0; j < V; ++j) psum[j] = pl[j] = 0.0f;
    for (int t0 = 0; t0 < n_samples; t0 += kSampleGroup) {
      typename Classes<T, V>::Raw x[kSampleGroup];
#pragma unroll
      for (int i = 0; i < kSampleGroup; ++i)
        if (t0 + i < n_samples)
          x[i] = Classes<T, V>::load(col + (t0 + i) * t_stride);
#pragma unroll
      for (int i = 0; i < kSampleGroup; ++i) {
        if (t0 + i < n_samples) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float lp = Classes<T, V>::get(x[i], j);
            const float p = expf(lp);
            psum[j] += p;
            pl[j] += p * lp;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float pbar = psum[j] * inv_t;
      ent -= pbar * logf(pbar + kEps);
      plogp += pl[j];
      pmax = fmaxf(pmax, pbar);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    ent += __shfl_xor_sync(0xffffffffu, ent, off);
    plogp += __shfl_xor_sync(0xffffffffu, plogp, off);
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
  }
  if (lane == 0) {
    warp_part[0][warp] = ent;
    warp_part[1][warp] = plogp;
    warp_part[2][warp] = pmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float e = 0.0f, l = 0.0f, m = 0.0f;
    for (int w = 0; w < kSplitWarps; ++w) {
      e += warp_part[0][w];
      l += warp_part[1][w];
      m = fmaxf(m, warp_part[2][w]);
    }
    block_part[0] = e;
    block_part[1] = l;
    block_part[2] = m;
  }
  cluster.sync();  // every slice's partial is in its shared memory
  if (rank == 0 && warp == 0) {
    // lane s reads rank s's partial; lane 0 then adds them in rank order
    float e = 0.0f, l = 0.0f, m = 0.0f;
    if (lane < slices) {
      const float* part = cluster.map_shared_rank(&block_part[0], lane);
      e = part[0];
      l = part[1];
      m = part[2];
    }
    float se = 0.0f, sl = 0.0f, sm = 0.0f;
    for (int s = 0; s < slices; ++s) {
      se += __shfl_sync(0xffffffffu, e, s);
      sl += __shfl_sync(0xffffffffu, l, s);
      sm = fmaxf(sm, __shfl_sync(0xffffffffu, m, s));
    }
    if (lane == 0) {
      const float exp_ent = -sl * inv_t;
      ent_out[row] = se;
      bald_out[row] = se - exp_ent;
      vr_out[row] = 1.0f - sm;
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read it
}

template <typename T>
int launch_warp(const void* logp, int rows_outer, int n_samples, int n_rows,
                int n_classes, float* ent, float* bald, float* vr,
                cudaStream_t stream) {
  const long long rows = (long long)rows_outer * n_rows;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  acquisition_scores_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const T*)logp, rows_outer, n_samples, n_rows, n_classes, ent, bald,
      vr);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_split(const void* logp, long long rows, int n_samples, int n_rows,
                 int n_classes, int slices, float* ent, float* bald,
                 float* vr, cudaStream_t stream) {
  if (n_classes % V != 0 || (V > 1 && (uintptr_t)logp % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * slices));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, acquisition_scores_kernel_split<T, V>, (const T*)logp, n_samples,
      n_rows, n_classes, slices, ent, bald, vr);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// mode 0 = warp, 1 = split; `vec` must be the plan's, which is the only
// width compiled (a plan that does not fit is refused).
template <typename T, int VW>
int launch(const void* logp, int rows_outer, int n_samples, int n_rows,
           int n_classes, int mode, int slices, int vec, float* ent,
           float* bald, float* vr, void* stream) {
  const long long rows = (long long)rows_outer * n_rows;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    if (vec != 1 || slices != 1) return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    return launch_warp<T>(logp, rows_outer, n_samples, n_rows, n_classes,
                          ent, bald, vr, s);
  }
  if (mode != 1 || slices < 1 || slices > kMaxSlices ||
      (slices & (slices - 1)) != 0 || rows * slices >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (vec == VW)
    return launch_split<T, VW>(logp, rows, n_samples, n_rows, n_classes,
                               slices, ent, bald, vr, s);
  if (vec == 1)
    return launch_split<T, 1>(logp, rows, n_samples, n_rows, n_classes,
                              slices, ent, bald, vr, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int acquisition_scores_f32(const void* logp, int rows_outer, int n_samples,
                           int n_rows, int n_classes, int mode, int slices,
                           int vec, float* ent, float* bald, float* vr,
                           void* stream) {
  return launch<float, 4>(logp, rows_outer, n_samples, n_rows, n_classes,
                          mode, slices, vec, ent, bald, vr, stream);
}

int acquisition_scores_bf16(const void* logp, int rows_outer, int n_samples,
                            int n_rows, int n_classes, int mode, int slices,
                            int vec, float* ent, float* bald, float* vr,
                            void* stream) {
  return launch<__nv_bfloat16, 8>(logp, rows_outer, n_samples, n_rows,
                                  n_classes, mode, slices, vec, ent, bald, vr,
                                  stream);
}

}  // extern "C"
