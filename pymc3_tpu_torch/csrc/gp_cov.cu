// Fused stationary GP covariance for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_body` of pymc3_tpu/ops/pallas/gp_cov.py
// (built by `_build_pallas_call`, wrapped by `_pallas_cov`). For a batch of
// lengthscale-scaled, mean-centred inputs it computes
//
//     K[b, i, j] = f(d2),  d2 = sum_f (X[b, i, f] - Xs[b, j, f])^2
//
// with d2 accumulated as exact differences in float32 (no x^2 + y^2 - 2xy
// cancellation) for any feature count, and one of five covariance functions
// f applied in registers before the single store.
//
// What bounds it on this card: per output it does 3*d FLOPs and one
// transcendental (expf, plus sqrtf for the Matern/exponential kinds), and
// writes 4 bytes; the inputs are (n + m) * d * 4 bytes and are read once per
// tile. At the GP configuration's d = 1 the kernel is bound by the n*m*4
// bytes of stores and by expf throughput, not by arithmetic. The design
// therefore (a) writes every output exactly once, with each warp storing 32
// consecutive floats of a row (128-byte coalesced stores); (b) keeps d2 in
// registers, so no n*m intermediate (distance matrix, sqrt, polynomial)
// ever reaches device memory; (c) stages each 32-row slice of X and Xs in
// shared memory once per block, so global reads are (n + m) * d * 4 bytes
// times the number of tiles along the other axis, small beside the stores.
//
// Layout: one 32x32 output tile per block of 32x8 threads, each thread
// computing 4 rows of one column. The chain batch is gridDim.z. The block
// masks the ragged edge itself: rows and columns past n or m are neither
// loaded nor stored (the TPU kernel padded its inputs with 1e6 instead).
// Built without --use_fast_math: expf and sqrtf are the IEEE-accurate ones.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;           // output tile edge
constexpr int kRowsPerThread = 4;   // blockDim = (32, kTile / kRowsPerThread)
constexpr int kThreadsY = kTile / kRowsPerThread;
constexpr int kFeatChunk = 16;      // features staged in shared memory per pass
constexpr float kEps = 1e-12f;      // as _EPS in the TPU kernel

enum Kind { kExpQuad = 0, kMatern52 = 1, kMatern32 = 2, kMatern12 = 3,
            kExponential = 4 };

template <int K>
__device__ __forceinline__ float cov_fn(float d2);

template <>
__device__ __forceinline__ float cov_fn<kExpQuad>(float d2) {
  return expf(-0.5f * d2);
}

template <>
__device__ __forceinline__ float cov_fn<kMatern52>(float d2) {
  const float t = sqrtf(5.0f * d2 + kEps);
  return (1.0f + t + (t * t) / 3.0f) * expf(-t);
}

template <>
__device__ __forceinline__ float cov_fn<kMatern32>(float d2) {
  const float t = sqrtf(3.0f * d2 + kEps);
  return (1.0f + t) * expf(-t);
}

template <>
__device__ __forceinline__ float cov_fn<kMatern12>(float d2) {
  return expf(-sqrtf(d2 + kEps));
}

template <>
__device__ __forceinline__ float cov_fn<kExponential>(float d2) {
  return expf(-0.5f * sqrtf(d2 + kEps));
}

template <int K>
__global__ void __launch_bounds__(kTile * kThreadsY)
stationary_cov_kernel(const float* __restrict__ X,
                      const float* __restrict__ Xs,
                      float* __restrict__ out, int n, int m, int d) {
  // +1 column of padding: ys[tx][f] across a warp hits distinct banks
  __shared__ float xs[kTile][kFeatChunk + 1];
  __shared__ float ys[kTile][kFeatChunk + 1];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const float* Xb = X + static_cast<size_t>(b) * n * d;
  const float* Yb = Xs + static_cast<size_t>(b) * m * d;
  float* Kb = out + static_cast<size_t>(b) * n * m;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int fchunk = d < kFeatChunk ? d : kFeatChunk;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

  for (int f0 = 0; f0 < d; f0 += fchunk) {
    const int fn = (d - f0) < fchunk ? (d - f0) : fchunk;
    for (int e = tid; e < kTile * fn; e += kTile * kThreadsY) {
      const int r = e / fn;
      const int f = e - r * fn;
      const int gi = row0 + r;
      const int gj = col0 + r;
      xs[r][f] = gi < n ? Xb[static_cast<size_t>(gi) * d + f0 + f] : 0.0f;
      ys[r][f] = gj < m ? Yb[static_cast<size_t>(gj) * d + f0 + f] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      const float y = ys[tx][f];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float diff = xs[ty + r * kThreadsY][f] - y;
        acc[r] += diff * diff;
      }
    }
    __syncthreads();
  }

  const int j = col0 + tx;
  if (j >= m) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + ty + r * kThreadsY;
    if (i < n) {
      Kb[static_cast<size_t>(i) * m + j] = cov_fn<K>(fmaxf(acc[r], 0.0f));
    }
  }
}

template <int K>
void launch(const float* X, const float* Xs, float* out, int B, int n, int m,
            int d, cudaStream_t stream) {
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, B);
  stationary_cov_kernel<K><<<grid, block, 0, stream>>>(X, Xs, out, n, m, d);
}

}  // namespace

// K (B, n, m) = f(d2(X (B, n, d), Xs (B, m, d))), float32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gp_cov_forward_f32(const void* X, const void* Xs, void* out,
                                  int B, int n, int m, int d, int kind,
                                  void* stream) {
  const float* x = static_cast<const float*>(X);
  const float* xs = static_cast<const float*>(Xs);
  float* k = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || m <= 0 || d <= 0 || B > 65535 ||
      (n + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kind) {
    case kExpQuad: launch<kExpQuad>(x, xs, k, B, n, m, d, s); break;
    case kMatern52: launch<kMatern52>(x, xs, k, B, n, m, d, s); break;
    case kMatern32: launch<kMatern32>(x, xs, k, B, n, m, d, s); break;
    case kMatern12: launch<kMatern12>(x, xs, k, B, n, m, d, s); break;
    case kExponential: launch<kExponential>(x, xs, k, B, n, m, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
