// Fused stationary GP covariance for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel `_kernel_body` of pymc3_tpu/ops/pallas/gp_cov.py
// (built by `_build_pallas_call`, wrapped by `_pallas_cov`) and the plain-XLA
// backward `_make_op.bwd` of the same file, which XLA fused on the TPU and
// eager PyTorch does not. For a batch of lengthscale-scaled, mean-centred
// inputs the forward computes
//
//     K[b, i, j] = f(d2),  d2 = sum_f (X[b, i, f] - Xs[b, j, f])^2
//
// and the backward, for a cotangent g of K,
//
//     w[b, i, j]   = g[b, i, j] * f'(d2)
//     dX[b, i, :]  = 2 sum_j w[b, i, j] (X[b, i, :] - Xs[b, j, :])
//     dXs[b, j, :] = 2 sum_i w[b, i, j] (Xs[b, j, :] - X[b, i, :])
//
// with d2 accumulated as exact differences in float32 (no x^2 + y^2 - 2xy
// cancellation, so no tensor cores) for any feature count, and one of five
// covariance functions f. Built without --use_fast_math: expf, sqrtf and the
// divisions are the IEEE-accurate ones, because K feeds a Cholesky.
//
// FORWARD. What bounds it on this card: the B*n*m*4 bytes of stores. Per
// output it does 3*d FLOPs and one expf; the inputs are (n + m)*d*4 bytes.
// At d <= 16 nothing else comes near the stores, but the instruction issue
// rate is within a factor of two of them (about 20 machine ops per output
// against 4 bytes), so the design spends itself on the store path, on few
// machine ops per output, and on blocks in flight:
//  (a) a thread owns rows x 4 consecutive columns and writes each row as one
//      16-byte st.global.v4.f32; a warp writes 512 consecutive bytes of a
//      row. When m or the output pointer is not a multiple of 4 floats, a
//      row's 16-byte alignment changes from row to row and from batch entry
//      to batch entry, so the scalar variant runs instead: a thread owns the
//      columns tx, tx + 32, tx + 64, tx + 96 and a warp stores 128
//      consecutive bytes per instruction. Both variants mask the ragged edge
//      themselves (the TPU kernel padded its inputs with 1e6 instead);
//  (b) the tiled kernel: a block of 32 x 8 threads computes a 64 x 128 tile
//      (8 rows a thread) and stages its X rows and Xs columns in shared
//      memory once, feature-major, so the feature loop reads Xs as one
//      conflict-free 16-byte load and X as a broadcast, with no
//      __syncthreads() inside it for d <= 16 (one staging pass); larger d
//      runs in chunks of 16 features;
//  (c) the small kernel, where 64 x 128 tiles would make fewer than two
//      blocks per SM: 8 x 128 tiles, one row a thread, inputs read straight
//      from global memory (a thread needs d + 4 d floats), no shared memory
//      and no barrier, because such a launch is bound by latency, not by
//      bytes. The GP configuration's (4, 200, 200) is 160,000 outputs:
//      25 x 2 x 4 = 200 blocks of 256 threads, so all 132 SMs hold a block
//      in a single wave (64 x 128 tiles would make 32 blocks).
//
// BACKWARD. What bounds it: one read of g, B*n*m*4 bytes; the outputs are
// (n + m)*d floats. Neither d2, w nor the (B, n, m, d) differences reach
// device memory: a block takes a (32 L) x 128 tile of g in L sub-tiles of 32
// rows, recomputes d2 in registers, forms w, and reduces w * (x - y) along
// the rows with warp shuffles (SplitReduce: about one shuffle per value, not
// five) and along the columns in registers (across the L sub-tiles) and then
// across the 8 warps through shared memory. There are no atomics and every
// sum has a fixed order, so a result is bit-for-bit the same from run to
// run. Each block writes its partial sums (one per tile column for dX, one
// per row block for dXs) to a scratch buffer, and a second small kernel adds
// them in a fixed order and scales by 2: two launches, g read once. The
// second is launched as a programmatic dependent of the first (its launch
// overlaps the first one's tail, and it waits for the first grid's end
// before it reads). The scratch traffic is (n / 128 + m / (32 L)) * d floats
// per output row or column, a few percent of g at the sizes where bytes
// matter. g is read through its three strides, so an expanded (stride-0)
// cotangent is read in place.
// At about 39 machine ops per element (27 of them float arithmetic: the
// differences, f', and two fused multiply-adds per feature) the pass is
// bound by the issue rate, not by bytes. So for d <= 4 (every path the
// repository has) the register kernel keeps a thread's four Xs columns in
// registers for the whole block, reads its X rows as warp-uniform loads,
// reaches g by pointer steps with fixed offsets where the sub-tile lies
// inside a dense g, and has no shared memory and no barrier in its loop.
// Larger d runs the staged kernel: X and Xs through shared memory in chunks
// of 16 features, once per chunk of 16 output features.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                       // blockDim = (32, 8)
constexpr int kThreads = kWarp * kWarps;
constexpr int kColsPerThread = 4;
constexpr int kTileCols = kWarp * kColsPerThread;   // 128
constexpr int kFeatChunk = 16;      // features staged in shared memory per pass
constexpr int kSMs = 132;
constexpr int kFwdRows = 8;                     // rows per thread, tiled forward
constexpr int kFwdTileRows = kWarps * kFwdRows;     // 64
constexpr int kBwdRows = 4;                     // rows per warp and sub-tile
constexpr int kBwdTileRows = kWarps * kBwdRows;     // 32
constexpr float kEps = 1e-12f;      // as _EPS in the TPU kernel
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kExpQuad = 0, kMatern52 = 1, kMatern32 = 2, kMatern12 = 3,
            kExponential = 4 };

// K = f(d2), the five functions of `_apply_covfn`. d2 is a sum of squares
// and never negative, so the plain version's clamp at 0 has no counterpart
// here (and a NaN input stays a NaN).
template <int K>
__device__ __forceinline__ float cov_fn(float d2) {
  if (K == kExpQuad) {
    return expf(-0.5f * d2);
  } else if (K == kMatern52) {
    const float t = sqrtf(5.0f * d2 + kEps);
    // t^2 * (1/3), not t^2 / 3: one rounding apart, and no IEEE division
    return (1.0f + t + (t * t) * (1.0f / 3.0f)) * expf(-t);
  } else if (K == kMatern32) {
    const float t = sqrtf(3.0f * d2 + kEps);
    return (1.0f + t) * expf(-t);
  } else if (K == kMatern12) {
    return expf(-sqrtf(d2 + kEps));
  } else {
    return expf(-0.5f * sqrtf(d2 + kEps));
  }
}

// dK/d(d2) in closed form, the five functions of `_dcov_dd2`.
template <int K>
__device__ __forceinline__ float dcov_fn(float d2) {
  if (K == kExpQuad) {
    return -0.5f * expf(-0.5f * d2);
  } else if (K == kMatern52) {
    const float t = sqrtf(5.0f * d2 + kEps);
    return -(5.0f / 6.0f) * (1.0f + t) * expf(-t);
  } else if (K == kMatern32) {
    return -1.5f * expf(-sqrtf(3.0f * d2 + kEps));
  } else if (K == kMatern12) {
    const float r = sqrtf(d2 + kEps);
    return expf(-r) * (-0.5f / r);
  } else {
    const float r = sqrtf(d2 + kEps);
    return expf(-0.5f * r) * (-0.25f / r);
  }
}

// Stage `rows` rows of M (row-major, d features) from row `r0`, features
// [f0, f0 + fn), into dst[f][r], zero past `limit`.
template <int STRIDE>
__device__ __forceinline__ void stage(float (*dst)[STRIDE], const float* M,
                                      int r0, int rows, int limit, int d,
                                      int f0, int fn, int tid) {
  for (int r = tid; r < rows; r += kThreads) {
    const int gr = r0 + r;
    const float* src = M + static_cast<size_t>(gr) * d + f0;
    for (int f = 0; f < fn; ++f) dst[f][r] = gr < limit ? src[f] : 0.0f;
  }
}

// Grid (column tiles, row tiles, batch): the limits of the last two axes.
bool grid_fits(long long tiles_r, long long B) {
  return tiles_r <= 65535 && B <= 65535;
}

// ---------------------------------------------------------------- forward

// One row and four columns a thread, inputs straight from global memory.
template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
cov_forward_small_kernel(const float* __restrict__ X,
                         const float* __restrict__ Xs,
                         float* __restrict__ out, int n, int m, int d) {
  const int b = blockIdx.z;
  const int tx = threadIdx.x;
  const int i = blockIdx.y * kWarps + threadIdx.y;
  const int col0 = blockIdx.x * kTileCols;
  if (i >= n) return;
  const float* x = X + (static_cast<size_t>(b) * n + i) * d;
  const float* Yb = Xs + static_cast<size_t>(b) * m * d;

  int j[kColsPerThread];
  const float* y[kColsPerThread];
  float acc[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    j[c] = col0 + (VEC ? kColsPerThread * tx + c : tx + kWarp * c);
    // a column past m reads column m - 1 and is not stored
    y[c] = Yb + static_cast<size_t>(j[c] < m ? j[c] : m - 1) * d;
    acc[c] = 0.0f;
  }
  for (int f = 0; f < d; ++f) {
    const float xf = x[f];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const float diff = xf - y[c][f];
      acc[c] = fmaf(diff, diff, acc[c]);
    }
  }
  float* row = out + (static_cast<size_t>(b) * n + i) * m;
  if (VEC) {
    if (j[0] < m) {     // m % 4 == 0: the four columns are inside together
      float4 v;
      v.x = cov_fn<K>(acc[0]);
      v.y = cov_fn<K>(acc[1]);
      v.z = cov_fn<K>(acc[2]);
      v.w = cov_fn<K>(acc[3]);
      *reinterpret_cast<float4*>(row + j[0]) = v;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (j[c] < m) row[j[c]] = cov_fn<K>(acc[c]);
    }
  }
}

// A 64 x 128 tile a block, eight rows and four columns a thread, inputs
// staged in shared memory.
template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
cov_forward_tiled_kernel(const float* __restrict__ X,
                         const float* __restrict__ Xs,
                         float* __restrict__ out, int n, int m, int d) {
  constexpr int R = kFwdRows;
  __shared__ __align__(16) float xs[kFeatChunk][kFwdTileRows];
  __shared__ __align__(16) float ys[kFeatChunk][kTileCols];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kFwdTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const float* Xb = X + static_cast<size_t>(b) * n * d;
  const float* Yb = Xs + static_cast<size_t>(b) * m * d;
  float* Kb = out + static_cast<size_t>(b) * n * m;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;

  float acc[R][kColsPerThread];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;
  }

  for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
    const int fn = (d - f0) < kFeatChunk ? (d - f0) : kFeatChunk;
    if (f0 > 0) __syncthreads();    // the previous chunk has been read
    stage<kFwdTileRows>(xs, Xb, row0, kFwdTileRows, n, d, f0, fn, tid);
    stage<kTileCols>(ys, Yb, col0, kTileCols, m, d, f0, fn, tid);
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      float y[kColsPerThread];
      if (VEC) {
        const float4 v =
            *reinterpret_cast<const float4*>(&ys[f][kColsPerThread * tx]);
        y[0] = v.x; y[1] = v.y; y[2] = v.z; y[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) y[c] = ys[f][tx + kWarp * c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = xs[f][ty * R + r];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const float diff = x - y[c];
          acc[r][c] = fmaf(diff, diff, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty * R + r;
    if (i >= n) break;
    float* row = Kb + static_cast<size_t>(i) * m;
    if (VEC) {
      const int j = col0 + kColsPerThread * tx;
      if (j < m) {      // m % 4 == 0: the four columns are inside together
        float4 v;
        v.x = cov_fn<K>(acc[r][0]);
        v.y = cov_fn<K>(acc[r][1]);
        v.z = cov_fn<K>(acc[r][2]);
        v.w = cov_fn<K>(acc[r][3]);
        *reinterpret_cast<float4*>(row + j) = v;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int j = col0 + tx + kWarp * c;
        if (j < m) row[j] = cov_fn<K>(acc[r][c]);
      }
    }
  }
}

template <int K, bool VEC>
cudaError_t launch_forward_variant(const float* X, const float* Xs,
                                   float* out, int B, int n, int m, int d,
                                   cudaStream_t stream) {
  const int tiles_c = (m + kTileCols - 1) / kTileCols;
  const int big_rows = (n + kFwdTileRows - 1) / kFwdTileRows;
  const dim3 block(kWarp, kWarps);
  if (static_cast<long long>(B) * big_rows * tiles_c >= 2 * kSMs) {
    if (!grid_fits(big_rows, B)) return cudaErrorInvalidValue;
    cov_forward_tiled_kernel<K, VEC>
        <<<dim3(tiles_c, big_rows, B), block, 0, stream>>>(X, Xs, out, n, m,
                                                           d);
  } else {
    const int small_rows = (n + kWarps - 1) / kWarps;
    if (!grid_fits(small_rows, B)) return cudaErrorInvalidValue;
    cov_forward_small_kernel<K, VEC>
        <<<dim3(tiles_c, small_rows, B), block, 0, stream>>>(X, Xs, out, n,
                                                             m, d);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_forward(const float* X, const float* Xs, float* out, int B,
                           int n, int m, int d, cudaStream_t stream) {
  const bool vec = (m % kColsPerThread == 0) &&
                   (reinterpret_cast<size_t>(out) % 16 == 0);
  return vec ? launch_forward_variant<K, true>(X, Xs, out, B, n, m, d, stream)
             : launch_forward_variant<K, false>(X, Xs, out, B, n, m, d,
                                                stream);
}

// Sum CNT values per lane over the 32 lanes of a warp. A plain butterfly
// costs 5 shuffles per value; here each step with more than one value left
// hands half of them to the partner lane, so 16 values cost 16 shuffles.
// Afterwards the lane's v[0 .. max(1, CNT / 32)) hold the full sums of the
// values whose index starts at split_reduce_base(lane); the order of the
// additions is fixed.
template <int CNT, int OFF>
struct SplitReduce {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (OFF > 0) {
      if constexpr (CNT > 1) {
        constexpr int H = CNT / 2;
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float send = upper ? v[k] : v[k + H];
          const float keep = upper ? v[k + H] : v[k];
          v[k] = keep + __shfl_xor_sync(kFullMask, send, OFF);
        }
        SplitReduce<H, OFF / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(kFullMask, v[0], OFF);
        SplitReduce<1, OFF / 2>::run(v, lane);
      }
    }
  }
};

// First index of the sums a lane holds after SplitReduce<CNT, 16>, or -1
// for a lane that holds a copy of another lane's.
template <int CNT>
__device__ __forceinline__ int split_reduce_base(int lane) {
  int base = 0;
  int cnt = CNT;
  bool owner = true;
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    if (cnt > 1) {
      cnt /= 2;
      if (lane & off) base += cnt;
    } else if (lane & off) {
      owner = false;
    }
  }
  return owner ? base : -1;
}

// --------------------------------------------------------------- backward

// Both first-pass kernels run on a grid (column tiles, row blocks, batch) of
// 32 x 8 threads; a block takes `subtiles` sub-tiles of 32 rows x 128
// columns, a warp four rows of each, a lane the columns tx + 32 c. They
// write unscaled partial sums: pX [tiles_c][B][n][d] (row sums, one per
// column tile) and pXs [row_blocks][B][m][d] (column sums, one per row
// block).

// The thread's 4 x 4 cotangents of one sub-tile, zero outside (n, m). `gp`
// points at the element (row0 + 4 ty, col0 + tx); rows and columns are
// reached by adding strides, not by a 64-bit multiply per element.
__device__ __forceinline__ void load_cotangent(
    float (&gv)[kBwdRows][kColsPerThread], const float* gp, long long gsi,
    long long cstep, int row0, int col0, int tx, int ty, int n, int m) {
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const bool row_in = row0 + ty * kBwdRows + r < n;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const bool in = row_in && col0 + tx + kWarp * c < m;
      gv[r][c] = in ? gp[c * cstep] : 0.0f;
    }
    gp += gsi;
  }
}

// Sum the warp's row sums over its 128 columns and write them to pX.
// `pXrow` points at the partial sums of the warp's first row, i0.
template <int FC>
__device__ __forceinline__ void reduce_rows(float (&rowacc)[kBwdRows * FC],
                                            float* pXrow, int i0, int tx,
                                            int n, int d, int fo0, int fo_n,
                                            int sum_base) {
  constexpr int V = kBwdRows * FC;
  constexpr int kSumsPerLane = V / kWarp > 1 ? V / kWarp : 1;
  SplitReduce<V, kWarp / 2>::run(rowacc, tx);
  if (sum_base < 0) return;
  if (d == FC && i0 + kBwdRows <= n) {
    // the warp's rows x features are contiguous, in the order of the sums
#pragma unroll
    for (int k = 0; k < kSumsPerLane; ++k) pXrow[sum_base + k] = rowacc[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < kSumsPerLane; ++k) {
    const int r = (sum_base + k) / FC;
    const int f = (sum_base + k) % FC;
    if (i0 + r < n && f < fo_n) {
      pXrow[static_cast<size_t>(r) * d + fo0 + f] = rowacc[k];
    }
  }
}

// d <= FC <= 4: the thread's four Xs columns stay in registers for the
// whole block, X rows come as warp-uniform loads; no barrier in the loop.
template <int K, int FC>
__global__ void __launch_bounds__(kThreads, 2)
cov_backward_regs_kernel(const float* __restrict__ g, long long gsb,
                         long long gsi, long long gsj,
                         const float* __restrict__ X,
                         const float* __restrict__ Xs, float* __restrict__ pX,
                         float* __restrict__ pXs, int B, int n, int m, int d,
                         int subtiles, int x_vec4) {
  constexpr int R = kBwdRows;
  __shared__ float red[kWarps][FC][kTileCols];

  const int ct = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = ct * kTileCols;
  const int row00 = rb * kBwdTileRows * subtiles;
  const float* Xb = X + static_cast<size_t>(b) * n * d;
  const float* Yb = Xs + static_cast<size_t>(b) * m * d;
  float* pXb = pX + (static_cast<size_t>(ct) * B + b) * n * d;
  float* pXsb = pXs + (static_cast<size_t>(rb) * B + b) * m * d;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int sum_base = split_reduce_base<R * FC>(tx);
  const long long cstep = kWarp * gsj;
  const float* gp = g + b * gsb + (row00 + ty * R) * gsi + (col0 + tx) * gsj;
  const bool cols_inside = col0 + kTileCols <= m;

  float y[kColsPerThread][FC];
  float colacc[kColsPerThread][FC];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int j = col0 + tx + kWarp * c;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      y[c][f] = (j < m && f < d) ? Yb[static_cast<size_t>(j) * d + f] : 0.0f;
      colacc[c][f] = 0.0f;
    }
  }

  for (int s = 0; s < subtiles; ++s) {
    const int row0 = row00 + s * kBwdTileRows;
    if (row0 >= n) break;

    float gv[R][kColsPerThread];
    if (gsj == 1 && cols_inside && row0 + kBwdTileRows <= n) {
      // a sub-tile inside a dense g: four loads at fixed offsets from one
      // pointer per row, no masks
      const float* row = gp;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) gv[r][c] = row[kWarp * c];
        row += gsi;
      }
    } else {
      load_cotangent(gv, gp, gsi, cstep, row0, col0, tx, ty, n, m);
    }
    gp += kBwdTileRows * gsi;

    const int i0 = row0 + ty * R;
    const float* xp = Xb + static_cast<size_t>(i0) * d;
    float rowacc[R * FC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // the warp's row: the same address for the 32 lanes, a broadcast load
      float x[FC];
      bool loaded = false;
      if constexpr (FC == 4) {
        if (x_vec4) {               // d == 4 and X aligned to 16 bytes
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (i0 + r < n) v = *reinterpret_cast<const float4*>(xp + 4 * r);
          x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
          loaded = true;
        }
      }
      if (!loaded) {
#pragma unroll
        for (int f = 0; f < FC; ++f) {
          x[f] = (i0 + r < n && f < d) ? xp[r * d + f] : 0.0f;
        }
      }
      float diff[kColsPerThread][FC];
      float d2[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) d2[c] = 0.0f;
#pragma unroll
      for (int f = 0; f < FC; ++f) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          diff[c][f] = x[f] - y[c][f];
          d2[c] = fmaf(diff[c][f], diff[c][f], d2[c]);
        }
      }
      float w[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        w[c] = gv[r][c] * dcov_fn<K>(d2[c]);
      }
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          sum = fmaf(w[c], diff[c][f], sum);
          colacc[c][f] = fmaf(-w[c], diff[c][f], colacc[c][f]);
        }
        rowacc[r * FC + f] = sum;
      }
    }
    reduce_rows<FC>(rowacc, pXb + static_cast<size_t>(i0) * d, i0, tx, n, d,
                    0, d, sum_base);
  }

  // the second pass may be launched now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // column sums: over the sub-tiles in registers above, over the warps here
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
#pragma unroll
    for (int f = 0; f < FC; ++f) red[ty][f][tx + kWarp * c] = colacc[c][f];
  }
  __syncthreads();
  const int tid = ty * kWarp + tx;
  const int j = col0 + tid;
  if (tid < kTileCols && j < m) {
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      float v = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) v += red[wp][f][tid];
      if (f < d) pXsb[static_cast<size_t>(j) * d + f] = v;
    }
  }
}

// Any d: X and Xs staged in shared memory in chunks of 16 features. One
// launch accumulates the output features [fo0, fo0 + 16), clipped to d.
template <int K>
__global__ void __launch_bounds__(kThreads)
cov_backward_staged_kernel(const float* __restrict__ g, long long gsb,
                           long long gsi, long long gsj,
                           const float* __restrict__ X,
                           const float* __restrict__ Xs,
                           float* __restrict__ pX, float* __restrict__ pXs,
                           int B, int n, int m, int d, int fo0,
                           int subtiles) {
  constexpr int R = kBwdRows;
  constexpr int FC = kFeatChunk;
  __shared__ float xs[kFeatChunk][kBwdTileRows];
  __shared__ float ys[kFeatChunk][kTileCols];
  __shared__ float red[kWarps][kTileCols];

  const int ct = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = ct * kTileCols;
  const int row00 = rb * kBwdTileRows * subtiles;
  const float* Xb = X + static_cast<size_t>(b) * n * d;
  const float* Yb = Xs + static_cast<size_t>(b) * m * d;
  float* pXb = pX + (static_cast<size_t>(ct) * B + b) * n * d;
  float* pXsb = pXs + (static_cast<size_t>(rb) * B + b) * m * d;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;
  const long long cstep = kWarp * gsj;
  const float* gp = g + b * gsb + (row00 + ty * R) * gsi + (col0 + tx) * gsj;
  const bool one_chunk = d <= kFeatChunk;
  const int fo_n = (d - fo0) < FC ? (d - fo0) : FC;
  const int sum_base = split_reduce_base<R * FC>(tx);

  float colacc[kColsPerThread][FC];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
#pragma unroll
    for (int f = 0; f < FC; ++f) colacc[c][f] = 0.0f;
  }

  for (int s = 0; s < subtiles; ++s) {
    const int row0 = row00 + s * kBwdTileRows;
    if (row0 >= n) break;           // the same for every thread of the block

    // the cotangent first: its latency hides behind the staging and d2
    float w[R][kColsPerThread];
    load_cotangent(w, gp, gsi, cstep, row0, col0, tx, ty, n, m);
    gp += kBwdTileRows * gsi;

    float d2[R][kColsPerThread];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) d2[r][c] = 0.0f;
    }
    for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
      const int fn = (d - f0) < kFeatChunk ? (d - f0) : kFeatChunk;
      __syncthreads();              // the previous contents have been read
      stage<kBwdTileRows>(xs, Xb, row0, kBwdTileRows, n, d, f0, fn, tid);
      if (s == 0 || !one_chunk) {   // the columns stay when d fits one chunk
        stage<kTileCols>(ys, Yb, col0, kTileCols, m, d, f0, fn, tid);
      }
      __syncthreads();
      for (int f = 0; f < fn; ++f) {
        float y[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) y[c] = ys[f][tx + kWarp * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = xs[f][ty * R + r];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const float diff = x - y[c];
            d2[r][c] = fmaf(diff, diff, d2[r][c]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        w[r][c] *= dcov_fn<K>(d2[r][c]);
      }
    }

    if (!one_chunk) {               // bring the output features back
      __syncthreads();
      stage<kBwdTileRows>(xs, Xb, row0, kBwdTileRows, n, d, fo0, fo_n, tid);
      stage<kTileCols>(ys, Yb, col0, kTileCols, m, d, fo0, fo_n, tid);
      __syncthreads();
    }

    float rowacc[R * FC];
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (f < fo_n) {
        float y[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) y[c] = ys[f][tx + kWarp * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = xs[f][ty * R + r];
          float sum = 0.0f;
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const float diff = x - y[c];
            sum = fmaf(w[r][c], diff, sum);
            colacc[c][f] = fmaf(-w[r][c], diff, colacc[c][f]);
          }
          rowacc[r * FC + f] = sum;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) rowacc[r * FC + f] = 0.0f;
      }
    }
    const int i0 = row0 + ty * R;
    reduce_rows<FC>(rowacc, pXb + static_cast<size_t>(i0) * d, i0, tx, n, d,
                    fo0, fo_n, sum_base);
  }

  // column sums: over the sub-tiles in registers above, over the warps here
#pragma unroll
  for (int f = 0; f < FC; ++f) {
    if (f >= fo_n) break;           // the same for every thread of the block
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      red[ty][tx + kWarp * c] = colacc[c][f];
    }
    __syncthreads();
    const int j = col0 + tid;
    if (tid < kTileCols && j < m) {
      float v = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) v += red[wp][tid];
      pXsb[static_cast<size_t>(j) * d + fo0 + f] = v;
    }
  }
}

// dX = 2 sum_t pX[t], dXs = 2 sum_t pXs[t]. A block takes 32 consecutive
// outputs; its warp w adds the tiles w, w + 8, ... (coalesced, independent
// loads), and the first warp adds the eight sums in warp order: a fixed
// order again. Launched as a programmatic dependent of the first pass, so
// its launch overlaps that kernel's tail; it waits for the partial sums
// before it reads them.
__global__ void __launch_bounds__(kThreads)
cov_backward_finish(const float* __restrict__ pX,
                    const float* __restrict__ pXs, float* __restrict__ dX,
                    float* __restrict__ dXs, long long nX, long long nXs,
                    int tiles_c, int row_blocks) {
  __shared__ float part[kWarps][kWarp];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // blocks [0, bX) cover dX, the rest dXs
  const long long bX = (nX + kWarp - 1) / kWarp;
  const bool second = blockIdx.x >= bX;
  const long long idx =
      (second ? blockIdx.x - bX : blockIdx.x) * kWarp + tx;
  const long long count = second ? nXs : nX;
  const float* src = second ? pXs : pX;
  const int tiles = second ? row_blocks : tiles_c;
  float v = 0.0f;
  if (idx < count) {
    for (int t = ty; t < tiles; t += kWarps) v += src[t * count + idx];
  }
  part[ty][tx] = v;
  __syncthreads();
  if (ty == 0 && idx < count) {
    float sum = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += part[wp][tx];
    (second ? dXs : dX)[idx] = 2.0f * sum;
  }
}

struct BackwardPlan {
  int subtiles, row_blocks, tiles_c;
  long long nX, nXs, scratch;
};

// Rows of g per block: 32 times the sub-tiles, the most of 8, 4, 2 that
// still makes three blocks per SM, else 1. More sub-tiles mean fewer
// partial column sums and one column reduction for more rows.
BackwardPlan plan_backward(int B, int n, int m, int d) {
  BackwardPlan p;
  p.tiles_c = (m + kTileCols - 1) / kTileCols;
  p.subtiles = 1;
  for (int L = 8; L > 1; L /= 2) {
    const long long blocks = static_cast<long long>(B) * p.tiles_c *
        ((n + L * kBwdTileRows - 1) / (L * kBwdTileRows));
    if (blocks >= 3 * kSMs) {
      p.subtiles = L;
      break;
    }
  }
  const int rows = kBwdTileRows * p.subtiles;
  p.row_blocks = (n + rows - 1) / rows;
  p.nX = static_cast<long long>(B) * n * d;
  p.nXs = static_cast<long long>(B) * m * d;
  p.scratch = p.tiles_c * p.nX + p.row_blocks * p.nXs;
  return p;
}

template <int K>
cudaError_t launch_backward(const float* g, long long gsb, long long gsi,
                            long long gsj, const float* X, const float* Xs,
                            float* dX, float* dXs, float* scratch, int B,
                            int n, int m, int d, const BackwardPlan& p,
                            cudaStream_t stream) {
  float* pX = scratch;
  float* pXs = scratch + p.tiles_c * p.nX;
  if (!grid_fits(p.row_blocks, B)) return cudaErrorInvalidValue;
  const dim3 grid(p.tiles_c, p.row_blocks, B);
  const dim3 block(kWarp, kWarps);
  const int x_vec4 = d == 4 && reinterpret_cast<size_t>(X) % 16 == 0;
  if (d == 1) {
    cov_backward_regs_kernel<K, 1><<<grid, block, 0, stream>>>(
        g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, p.subtiles, 0);
  } else if (d <= 4) {
    cov_backward_regs_kernel<K, 4><<<grid, block, 0, stream>>>(
        g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, p.subtiles, x_vec4);
  } else {
    for (int fo0 = 0; fo0 < d; fo0 += kFeatChunk) {
      cov_backward_staged_kernel<K><<<grid, block, 0, stream>>>(
          g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, fo0, p.subtiles);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks =
      (p.nX + kWarp - 1) / kWarp + (p.nXs + kWarp - 1) / kWarp;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = block;
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const float* cpX = pX;
  const float* cpXs = pXs;
  return cudaLaunchKernelEx(&config, cov_backward_finish, cpX, cpXs, dX, dXs,
                            p.nX, p.nXs, p.tiles_c, p.row_blocks);
}

bool bad_shape(int B, int n, int m, int d) {
  return B <= 0 || n <= 0 || m <= 0 || d <= 0;
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
  if (bad_shape(B, n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (kind) {
    case kExpQuad:
      err = launch_forward<kExpQuad>(x, xs, k, B, n, m, d, s); break;
    case kMatern52:
      err = launch_forward<kMatern52>(x, xs, k, B, n, m, d, s); break;
    case kMatern32:
      err = launch_forward<kMatern32>(x, xs, k, B, n, m, d, s); break;
    case kMatern12:
      err = launch_forward<kMatern12>(x, xs, k, B, n, m, d, s); break;
    case kExponential:
      err = launch_forward<kExponential>(x, xs, k, B, n, m, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Floats of scratch that gp_cov_backward_f32 needs for these shapes.
extern "C" long long gp_cov_backward_scratch_f32(int B, int n, int m, int d) {
  if (bad_shape(B, n, m, d)) return -1;
  return plan_backward(B, n, m, d).scratch;
}

// dX (B, n, d), dXs (B, m, d) from the cotangent g of K, read at
// g[b * gsb + i * gsi + j * gsj] (strides in floats, any of them 0 for an
// expanded cotangent); X, Xs, dX, dXs contiguous float32. Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int gp_cov_backward_f32(const void* g, long long gsb,
                                   long long gsi, long long gsj,
                                   const void* X, const void* Xs, void* dX,
                                   void* dXs, void* scratch,
                                   long long scratch_floats, int B, int n,
                                   int m, int d, int kind, void* stream) {
  const float* gp = static_cast<const float*>(g);
  const float* x = static_cast<const float*>(X);
  const float* xs = static_cast<const float*>(Xs);
  float* dx = static_cast<float*>(dX);
  float* dxs = static_cast<float*>(dXs);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, n, m, d) || gsb < 0 || gsi < 0 || gsj < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BackwardPlan p = plan_backward(B, n, m, d);
  if (scratch_floats < p.scratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (kind) {
    case kExpQuad:
      err = launch_backward<kExpQuad>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                      B, n, m, d, p, s); break;
    case kMatern52:
      err = launch_backward<kMatern52>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                       B, n, m, d, p, s); break;
    case kMatern32:
      err = launch_backward<kMatern32>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                       B, n, m, d, p, s); break;
    case kMatern12:
      err = launch_backward<kMatern12>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                       B, n, m, d, p, s); break;
    case kExponential:
      err = launch_backward<kExponential>(gp, gsb, gsi, gsj, x, xs, dx, dxs,
                                          sc, B, n, m, d, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
