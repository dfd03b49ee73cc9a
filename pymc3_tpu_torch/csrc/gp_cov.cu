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
//
// FLOAT64. The same source gives the gp_cov_*_f32 and gp_cov_*_f64 entry
// points (one nvcc run each). In double the whole computation is double:
// the differences and d2, exp and sqrt (CUDA's exp and sqrt of double,
// sequences of FP64 instructions on the FP64 pipes, not on the SFU; some
// 20-25 FP64 instructions an exp in the SASS), eps = 1e-12 and the partial
// sums; the counterpart in the JAX package is its float64 `_fallback`,
// not the Pallas body, which accumulates in float32. The float templates
// above, instantiated in double, are the shared design (the float
// layout with doubles; a 16-byte store holds two doubles, so a thread's
// four columns are two pairs 64 apart and a warp still stores 512
// consecutive bytes). On this card a double expquad element at d = 1
// costs the FP64 pipes 28 instructions forward and 26 backward (static
// SASS counts) where they issue at half the float rate, beside 8 bytes
// stored or read: at the repository's GP shapes (B <= 50, n = m = 200)
// the kernels are bound by latency (the exp chains and the memory round
// trips of one wave or two) and at (1, 4096, 4096, 4) by bytes and FP64
// issue together. The float64 design:
//  (a) forward at d = 1 (every GP path of the repository): a flat
//      grid-stride kernel over the (B n m) outputs (cov_forward_flat_f64),
//      two outputs a thread and iteration stored as one
//      st.global.v2.f64, 512 consecutive bytes a warp, no tile and so no
//      ragged tile edge, a thread's next exp running while its last store
//      drains. At d > 1 a unit's strided scalar loads of its d-wide
//      columns cost more L1 wavefronts than it saves (149.7 us against the
//      tiled kernel's 53.4 at (1, 4096, 4096, 4)), so the shared tiled
//      and small kernels run there;
//  (b) backward at d <= 4: cov_backward_f64_kernel, tiles of 64 columns
//      (two a lane) and steps of 32 rows (four a warp): eight elements a
//      thread a step, so at d = 1 it needs 56-64 registers and four
//      blocks fill an SM (the shared kernel's 4 x 4 elements took 134-255
//      registers in double, one block an SM); the cotangent reaches shared memory by cp.async
//      one step ahead, each thread copying the elements it reads itself,
//      so the loads overlap the exp chains with no barrier; about an
//      eighth of the rows a block, so at most eight partial column sums
//      whatever n is, then cov_backward_finish as for float, launched as a
//      programmatic dependent. Two one-launch finishes were built and
//      timed at (4, 200, 200, 1) and (50, 200, 200, 1), and both lost to
//      this one: a thread-block cluster over a batch entry adding through
//      distributed shared memory (at most 16 blocks a cluster, so 64 SMs
//      at B = 4, and a dearer launch), and the entry's last block, found by
//      an integer atomic count, adding the partial sums (a fence, the
//      atomic's round trip and one block's loads, where the finishing
//      pass's launch overlaps the first pass's tail). d > 4 (on no path
//      of the repository) runs the shared staged kernel, 8 features a
//      pass.

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
constexpr unsigned kFullMask = 0xffffffffu;

// Elements of T in one 16-byte vector: 4 floats, 2 doubles.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));
// Features a pass of the staged backward: 16 floats, 8 doubles.
template <typename T>
constexpr int kStagedChunk = sizeof(T) == 4 ? kFeatChunk : kFeatChunk / 2;
// Blocks per SM the register backward asks registers for.
template <typename T>
constexpr int kBwdMinBlocks = sizeof(T) == 4 ? 2 : 1;

enum Kind { kExpQuad = 0, kMatern52 = 1, kMatern32 = 2, kMatern12 = 3,
            kExponential = 4 };

// The IEEE-accurate exp, sqrt and fused multiply-add of each type.
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// One 16-byte load or store of kVec<T> elements.
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void load_vec(float* v, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_vec(double* v, const double* p) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x; v[1] = x.y;
}

// The tile column of a forward thread's slot c (0-3): in the vector variant
// kVec<T> consecutive columns a vector, a warp's vectors side by side (4 tx
// + c in float; 2 tx + c, then 64 + 2 tx + c - 2 in double); in the scalar
// variant tx + 32 c.
template <typename T, bool VEC>
__device__ __forceinline__ int tile_col(int tx, int c) {
  constexpr int V = kVec<T>;
  return VEC ? (c / V) * (kWarp * V) + V * tx + c % V : tx + kWarp * c;
}

// K = f(d2), the five functions of `_apply_covfn`. d2 is a sum of squares
// and never negative, so the plain version's clamp at 0 has no counterpart
// here (and a NaN input stays a NaN). eps is 1e-12 as _EPS in the TPU
// kernel, in the element type.
template <int K, typename T>
__device__ __forceinline__ T cov_fn(T d2) {
  const T eps = T(1e-12);
  if (K == kExpQuad) {
    return exp_t(T(-0.5) * d2);
  } else if (K == kMatern52) {
    const T t = sqrt_t(T(5) * d2 + eps);
    // t^2 * (1/3), not t^2 / 3: one rounding apart, and no IEEE division
    return (T(1) + t + (t * t) * (T(1) / T(3))) * exp_t(-t);
  } else if (K == kMatern32) {
    const T t = sqrt_t(T(3) * d2 + eps);
    return (T(1) + t) * exp_t(-t);
  } else if (K == kMatern12) {
    return exp_t(-sqrt_t(d2 + eps));
  } else {
    return exp_t(T(-0.5) * sqrt_t(d2 + eps));
  }
}

// dK/d(d2) in closed form, the five functions of `_dcov_dd2`.
template <int K, typename T>
__device__ __forceinline__ T dcov_fn(T d2) {
  const T eps = T(1e-12);
  if (K == kExpQuad) {
    return T(-0.5) * exp_t(T(-0.5) * d2);
  } else if (K == kMatern52) {
    const T t = sqrt_t(T(5) * d2 + eps);
    return -(T(5) / T(6)) * (T(1) + t) * exp_t(-t);
  } else if (K == kMatern32) {
    return T(-1.5) * exp_t(-sqrt_t(T(3) * d2 + eps));
  } else if (K == kMatern12) {
    const T r = sqrt_t(d2 + eps);
    return exp_t(-r) * (T(-0.5) / r);
  } else {
    const T r = sqrt_t(d2 + eps);
    return exp_t(T(-0.5) * r) * (T(-0.25) / r);
  }
}

// Stage `rows` rows of M (row-major, d features) from row `r0`, features
// [f0, f0 + fn), into dst[f][r], zero past `limit`.
template <int STRIDE, typename T>
__device__ __forceinline__ void stage(T (*dst)[STRIDE], const T* M, int r0,
                                      int rows, int limit, int d, int f0,
                                      int fn, int tid) {
  for (int r = tid; r < rows; r += kThreads) {
    const int gr = r0 + r;
    const T* src = M + static_cast<size_t>(gr) * d + f0;
    for (int f = 0; f < fn; ++f) dst[f][r] = gr < limit ? src[f] : T(0);
  }
}

// Grid (column tiles, row tiles, batch): the limits of the last two axes.
bool grid_fits(long long tiles_r, long long B) {
  return tiles_r <= 65535 && B <= 65535;
}

// ---------------------------------------------------------------- forward

// Write a thread's four values of one output row: in the vector variant as
// 16-byte vectors (m a multiple of kVec<T>, so a vector is inside or
// outside the row whole), else one by one, masked at m.
template <int K, bool VEC, typename T>
__device__ __forceinline__ void store_row(T* row, const T (&acc)[kColsPerThread],
                                          int col0, int tx, int m) {
  constexpr int V = kVec<T>;
  if (VEC) {
#pragma unroll
    for (int c0 = 0; c0 < kColsPerThread; c0 += V) {
      const int j = col0 + tile_col<T, VEC>(tx, c0);
      if (j < m) {
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = cov_fn<K>(acc[c0 + k]);
        store_vec(row + j, v);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = col0 + tile_col<T, VEC>(tx, c);
      if (j < m) row[j] = cov_fn<K>(acc[c]);
    }
  }
}

// One row and four columns a thread, inputs straight from global memory.
template <int K, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads)
cov_forward_small_kernel(const T* __restrict__ X, const T* __restrict__ Xs,
                         T* __restrict__ out, int n, int m, int d) {
  const int b = blockIdx.z;
  const int tx = threadIdx.x;
  const int i = blockIdx.y * kWarps + threadIdx.y;
  const int col0 = blockIdx.x * kTileCols;
  if (i >= n) return;
  const T* x = X + (static_cast<size_t>(b) * n + i) * d;
  const T* Yb = Xs + static_cast<size_t>(b) * m * d;

  const T* y[kColsPerThread];
  T acc[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int j = col0 + tile_col<T, VEC>(tx, c);
    // a column past m reads column m - 1 and is not stored
    y[c] = Yb + static_cast<size_t>(j < m ? j : m - 1) * d;
    acc[c] = T(0);
  }
  for (int f = 0; f < d; ++f) {
    const T xf = x[f];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const T diff = xf - y[c][f];
      acc[c] = fma_t(diff, diff, acc[c]);
    }
  }
  store_row<K, VEC>(out + (static_cast<size_t>(b) * n + i) * m, acc, col0, tx,
                    m);
}

// A 64 x 128 tile a block, eight rows and four columns a thread, inputs
// staged in shared memory.
template <int K, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads)
cov_forward_tiled_kernel(const T* __restrict__ X, const T* __restrict__ Xs,
                         T* __restrict__ out, int n, int m, int d) {
  constexpr int R = kFwdRows;
  constexpr int V = kVec<T>;
  __shared__ __align__(16) T xs[kFeatChunk][kFwdTileRows];
  __shared__ __align__(16) T ys[kFeatChunk][kTileCols];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kFwdTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const T* Xb = X + static_cast<size_t>(b) * n * d;
  const T* Yb = Xs + static_cast<size_t>(b) * m * d;
  T* Kb = out + static_cast<size_t>(b) * n * m;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;

  T acc[R][kColsPerThread];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = T(0);
  }

  for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
    const int fn = (d - f0) < kFeatChunk ? (d - f0) : kFeatChunk;
    if (f0 > 0) __syncthreads();    // the previous chunk has been read
    stage<kFwdTileRows>(xs, Xb, row0, kFwdTileRows, n, d, f0, fn, tid);
    stage<kTileCols>(ys, Yb, col0, kTileCols, m, d, f0, fn, tid);
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      T y[kColsPerThread];
#pragma unroll
      for (int c0 = 0; c0 < kColsPerThread; c0 += (VEC ? V : 1)) {
        if (VEC) {
          load_vec(y + c0, &ys[f][tile_col<T, VEC>(tx, c0)]);
        } else {
          y[c0] = ys[f][tile_col<T, VEC>(tx, c0)];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T x = xs[f][ty * R + r];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const T diff = x - y[c];
          acc[r][c] = fma_t(diff, diff, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty * R + r;
    if (i >= n) break;
    store_row<K, VEC>(Kb + static_cast<size_t>(i) * m, acc[r], col0, tx, m);
  }
}

template <int K, bool VEC, typename T>
cudaError_t launch_forward_variant(const T* X, const T* Xs, T* out, int B,
                                   int n, int m, int d, cudaStream_t stream) {
  const int tiles_c = (m + kTileCols - 1) / kTileCols;
  const int big_rows = (n + kFwdTileRows - 1) / kFwdTileRows;
  const dim3 block(kWarp, kWarps);
  if (static_cast<long long>(B) * big_rows * tiles_c >= 2 * kSMs) {
    if (!grid_fits(big_rows, B)) return cudaErrorInvalidValue;
    cov_forward_tiled_kernel<K, VEC, T>
        <<<dim3(tiles_c, big_rows, B), block, 0, stream>>>(X, Xs, out, n, m,
                                                           d);
  } else {
    const int small_rows = (n + kWarps - 1) / kWarps;
    if (!grid_fits(small_rows, B)) return cudaErrorInvalidValue;
    cov_forward_small_kernel<K, VEC, T>
        <<<dim3(tiles_c, small_rows, B), block, 0, stream>>>(X, Xs, out, n,
                                                             m, d);
  }
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_forward(const T* X, const T* Xs, T* out, int B, int n,
                           int m, int d, cudaStream_t stream) {
  const bool vec = (m % kVec<T> == 0) &&
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
  template <typename T>
  static __device__ __forceinline__ void run(T* v, int lane) {
    if constexpr (OFF > 0) {
      if constexpr (CNT > 1) {
        constexpr int H = CNT / 2;
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const T send = upper ? v[k] : v[k + H];
          const T keep = upper ? v[k + H] : v[k];
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
template <typename T>
__device__ __forceinline__ void load_cotangent(
    T (&gv)[kBwdRows][kColsPerThread], const T* gp, long long gsi,
    long long cstep, int row0, int col0, int tx, int ty, int n, int m) {
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const bool row_in = row0 + ty * kBwdRows + r < n;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const bool in = row_in && col0 + tx + kWarp * c < m;
      gv[r][c] = in ? gp[c * cstep] : T(0);
    }
    gp += gsi;
  }
}

// Sum the warp's row sums over its 128 columns and write them to pX.
// `pXrow` points at the partial sums of the warp's first row, i0.
template <int FC, typename T>
__device__ __forceinline__ void reduce_rows(T (&rowacc)[kBwdRows * FC],
                                            T* pXrow, int i0, int tx, int n,
                                            int d, int fo0, int fo_n,
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
template <int K, int FC, typename T>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks<T>)
cov_backward_regs_kernel(const T* __restrict__ g, long long gsb,
                         long long gsi, long long gsj,
                         const T* __restrict__ X, const T* __restrict__ Xs,
                         T* __restrict__ pX, T* __restrict__ pXs, int B,
                         int n, int m, int d, int subtiles, int x_vec4) {
  constexpr int R = kBwdRows;
  __shared__ T red[kWarps][FC][kTileCols];

  const int ct = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = ct * kTileCols;
  const int row00 = rb * kBwdTileRows * subtiles;
  const T* Xb = X + static_cast<size_t>(b) * n * d;
  const T* Yb = Xs + static_cast<size_t>(b) * m * d;
  T* pXb = pX + (static_cast<size_t>(ct) * B + b) * n * d;
  T* pXsb = pXs + (static_cast<size_t>(rb) * B + b) * m * d;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int sum_base = split_reduce_base<R * FC>(tx);
  const long long cstep = kWarp * gsj;
  const T* gp = g + b * gsb + (row00 + ty * R) * gsi + (col0 + tx) * gsj;
  const bool cols_inside = col0 + kTileCols <= m;

  T y[kColsPerThread][FC];
  T colacc[kColsPerThread][FC];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int j = col0 + tx + kWarp * c;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      y[c][f] = (j < m && f < d) ? Yb[static_cast<size_t>(j) * d + f] : T(0);
      colacc[c][f] = T(0);
    }
  }

  for (int s = 0; s < subtiles; ++s) {
    const int row0 = row00 + s * kBwdTileRows;
    if (row0 >= n) break;

    T gv[R][kColsPerThread];
    if (gsj == 1 && cols_inside && row0 + kBwdTileRows <= n) {
      // a sub-tile inside a dense g: four loads at fixed offsets from one
      // pointer per row, no masks
      const T* row = gp;
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
    const T* xp = Xb + static_cast<size_t>(i0) * d;
    T rowacc[R * FC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // the warp's row: the same address for the 32 lanes, a broadcast load
      T x[FC];
      bool loaded = false;
      if constexpr (FC == 4 && sizeof(T) == 4) {
        if (x_vec4) {               // d == 4 and X aligned to 16 bytes
          T v[4] = {T(0), T(0), T(0), T(0)};
          if (i0 + r < n) load_vec(v, xp + 4 * r);
#pragma unroll
          for (int f = 0; f < 4; ++f) x[f] = v[f];
          loaded = true;
        }
      }
      if (!loaded) {
#pragma unroll
        for (int f = 0; f < FC; ++f) {
          x[f] = (i0 + r < n && f < d) ? xp[r * d + f] : T(0);
        }
      }
      T diff[kColsPerThread][FC];
      T d2[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) d2[c] = T(0);
#pragma unroll
      for (int f = 0; f < FC; ++f) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          diff[c][f] = x[f] - y[c][f];
          d2[c] = fma_t(diff[c][f], diff[c][f], d2[c]);
        }
      }
      T w[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        w[c] = gv[r][c] * dcov_fn<K>(d2[c]);
      }
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        T sum = T(0);
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          sum = fma_t(w[c], diff[c][f], sum);
          colacc[c][f] = fma_t(-w[c], diff[c][f], colacc[c][f]);
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
      T v = T(0);
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) v += red[wp][f][tid];
      if (f < d) pXsb[static_cast<size_t>(j) * d + f] = v;
    }
  }
}

// Any d: X and Xs staged in shared memory in chunks of FC features (16
// floats, 8 doubles). One launch accumulates the output features
// [fo0, fo0 + FC), clipped to d.
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
cov_backward_staged_kernel(const T* __restrict__ g, long long gsb,
                           long long gsi, long long gsj,
                           const T* __restrict__ X, const T* __restrict__ Xs,
                           T* __restrict__ pX, T* __restrict__ pXs, int B,
                           int n, int m, int d, int fo0, int subtiles) {
  constexpr int R = kBwdRows;
  constexpr int FC = kStagedChunk<T>;
  __shared__ T xs[FC][kBwdTileRows];
  __shared__ T ys[FC][kTileCols];
  __shared__ T red[kWarps][kTileCols];

  const int ct = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = ct * kTileCols;
  const int row00 = rb * kBwdTileRows * subtiles;
  const T* Xb = X + static_cast<size_t>(b) * n * d;
  const T* Yb = Xs + static_cast<size_t>(b) * m * d;
  T* pXb = pX + (static_cast<size_t>(ct) * B + b) * n * d;
  T* pXsb = pXs + (static_cast<size_t>(rb) * B + b) * m * d;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;
  const long long cstep = kWarp * gsj;
  const T* gp = g + b * gsb + (row00 + ty * R) * gsi + (col0 + tx) * gsj;
  const bool one_chunk = d <= FC;
  const int fo_n = (d - fo0) < FC ? (d - fo0) : FC;
  const int sum_base = split_reduce_base<R * FC>(tx);

  T colacc[kColsPerThread][FC];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
#pragma unroll
    for (int f = 0; f < FC; ++f) colacc[c][f] = T(0);
  }

  for (int s = 0; s < subtiles; ++s) {
    const int row0 = row00 + s * kBwdTileRows;
    if (row0 >= n) break;           // the same for every thread of the block

    // the cotangent first: its latency hides behind the staging and d2
    T w[R][kColsPerThread];
    load_cotangent(w, gp, gsi, cstep, row0, col0, tx, ty, n, m);
    gp += kBwdTileRows * gsi;

    T d2[R][kColsPerThread];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) d2[r][c] = T(0);
    }
    for (int f0 = 0; f0 < d; f0 += FC) {
      const int fn = (d - f0) < FC ? (d - f0) : FC;
      __syncthreads();              // the previous contents have been read
      stage<kBwdTileRows>(xs, Xb, row0, kBwdTileRows, n, d, f0, fn, tid);
      if (s == 0 || !one_chunk) {   // the columns stay when d fits one chunk
        stage<kTileCols>(ys, Yb, col0, kTileCols, m, d, f0, fn, tid);
      }
      __syncthreads();
      for (int f = 0; f < fn; ++f) {
        T y[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) y[c] = ys[f][tx + kWarp * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T x = xs[f][ty * R + r];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const T diff = x - y[c];
            d2[r][c] = fma_t(diff, diff, d2[r][c]);
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

    T rowacc[R * FC];
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (f < fo_n) {
        T y[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) y[c] = ys[f][tx + kWarp * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T x = xs[f][ty * R + r];
          T sum = T(0);
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const T diff = x - y[c];
            sum = fma_t(w[r][c], diff, sum);
            colacc[c][f] = fma_t(-w[r][c], diff, colacc[c][f]);
          }
          rowacc[r * FC + f] = sum;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) rowacc[r * FC + f] = T(0);
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
      T v = T(0);
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
cov_backward_finish(const T* __restrict__ pX, const T* __restrict__ pXs,
                    T* __restrict__ dX, T* __restrict__ dXs, long long nX,
                    long long nXs, int tiles_c, int row_blocks) {
  __shared__ T part[kWarps][kWarp];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // blocks [0, bX) cover dX, the rest dXs
  const long long bX = (nX + kWarp - 1) / kWarp;
  const bool second = blockIdx.x >= bX;
  const long long idx =
      (second ? blockIdx.x - bX : blockIdx.x) * kWarp + tx;
  const long long count = second ? nXs : nX;
  const T* src = second ? pXs : pX;
  const int tiles = second ? row_blocks : tiles_c;
  T v = T(0);
  if (idx < count) {
    for (int t = ty; t < tiles; t += kWarps) v += src[t * count + idx];
  }
  part[ty][tx] = v;
  __syncthreads();
  if (ty == 0 && idx < count) {
    T sum = T(0);
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += part[wp][tx];
    (second ? dXs : dX)[idx] = T(2) * sum;
  }
}

struct BackwardPlan {
  int subtiles, row_blocks, tiles_c;
  long long nX, nXs, scratch;
};

// Rows of g per block: 32 times the sub-tiles, the most of 8, 4, 2 that
// still makes three blocks per SM, else 1. More sub-tiles mean fewer
// partial column sums and one column reduction for more rows. `scratch`
// counts elements of the kernel's type.
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

template <int K, typename T>
cudaError_t launch_backward(const T* g, long long gsb, long long gsi,
                            long long gsj, const T* X, const T* Xs, T* dX,
                            T* dXs, T* scratch, int B, int n, int m, int d,
                            const BackwardPlan& p, cudaStream_t stream) {
  T* pX = scratch;
  T* pXs = scratch + p.tiles_c * p.nX;
  if (!grid_fits(p.row_blocks, B)) return cudaErrorInvalidValue;
  const dim3 grid(p.tiles_c, p.row_blocks, B);
  const dim3 block(kWarp, kWarps);
  const int x_vec4 = d == 4 && reinterpret_cast<size_t>(X) % 16 == 0;
  if (d == 1) {
    cov_backward_regs_kernel<K, 1, T><<<grid, block, 0, stream>>>(
        g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, p.subtiles, 0);
  } else if (d <= 4) {
    cov_backward_regs_kernel<K, 4, T><<<grid, block, 0, stream>>>(
        g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, p.subtiles, x_vec4);
  } else {
    for (int fo0 = 0; fo0 < d; fo0 += kStagedChunk<T>) {
      cov_backward_staged_kernel<K, T><<<grid, block, 0, stream>>>(
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
  const T* cpX = pX;
  const T* cpXs = pXs;
  return cudaLaunchKernelEx(&config, cov_backward_finish<T>, cpX, cpXs, dX,
                            dXs, p.nX, p.nXs, p.tiles_c, p.row_blocks);
}

#ifdef GP_COV_F64
// ------------------------------------------------- float64 forward, flat

// A grid-stride pass over units of V consecutive outputs of the flat
// (B n m) output (V = 2: one st.global.v2.f64, m even and the output
// 16-byte aligned; V = 1: scalar stores). A warp takes 32 consecutive units
// (512 bytes at V = 2) per iteration; a unit finds its (b, i, j) by two
// 32-bit divisions (integer pipes, beside the FP64 ones) and reads its X
// row and Xs columns straight from global memory (L1 and L2 hits). A
// thread's store does not wait, so its next unit's exp runs while the last
// one drains: a grid of at most eight blocks an SM keeps the stores and the
// FP64 work overlapped, where one unit a thread in a single wave would
// compute everything first and then store everything. No tile, so no
// ragged tile edge. Taken for d = 1: at larger d a unit's scalar loads of
// V d columns at a stride of d doubles cost more L1 wavefronts than the
// tiled kernel's staging.
template <int K, int V>
__global__ void __launch_bounds__(kThreads)
cov_forward_flat_f64(const double* __restrict__ X,
                     const double* __restrict__ Xs, double* __restrict__ out,
                     int n, int m, int d, int units) {
  const int stride = gridDim.x * kThreads;
  for (int unit = blockIdx.x * kThreads + threadIdx.y * kWarp + threadIdx.x;
       unit < units; unit += stride) {
    const unsigned e = static_cast<unsigned>(unit) * V;
    const unsigned row = e / static_cast<unsigned>(m);     // b n + i
    const unsigned j = e - row * static_cast<unsigned>(m);
    const unsigned b = row / static_cast<unsigned>(n);
    const double* x = X + static_cast<size_t>(row) * d;
    const double* y = Xs + (static_cast<size_t>(b) * m + j) * d;
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
    for (int f = 0; f < d; ++f) {
      const double xf = __ldg(x + f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const double diff = xf - __ldg(y + v * d + f);
        acc[v] = fma(diff, diff, acc[v]);
      }
    }
    double k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = cov_fn<K>(acc[v]);
    if constexpr (V == 2) {
      store_vec(out + static_cast<size_t>(unit) * 2, k);
    } else {
      out[unit] = k[0];
    }
  }
}

template <int K, int V>
cudaError_t launch_flat_f64(const double* X, const double* Xs, double* out,
                            long long total, int n, int m, int d,
                            cudaStream_t stream) {
  const int units = static_cast<int>(total / V);
  const long long blocks = (units + kThreads - 1) / kThreads;
  const long long grid = blocks < 8 * kSMs ? blocks : 8 * kSMs;
  cov_forward_flat_f64<K, V><<<static_cast<unsigned>(grid),
                               dim3(kWarp, kWarps), 0, stream>>>(
      X, Xs, out, n, m, d, units);
  return cudaGetLastError();
}

// The float64 forward: the flat kernel at d = 1 (the repository's GP
// paths) where its int unit index stays in range, its stride included;
// else the shared tiled and small kernels (the float design in double).
template <int K>
cudaError_t launch_forward_f64(const double* X, const double* Xs, double* out,
                               int B, int n, int m, int d,
                               cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * n * m;
  if (d != 1 || total > 2147483647LL - 8LL * kSMs * kThreads) {
    return launch_forward<K>(X, Xs, out, B, n, m, d, stream);
  }
  const bool vec = (m % 2 == 0) && (reinterpret_cast<size_t>(out) % 16 == 0);
  return vec ? launch_flat_f64<K, 2>(X, Xs, out, total, n, m, d, stream)
             : launch_flat_f64<K, 1>(X, Xs, out, total, n, m, d, stream);
}

// ------------------------------------------------ float64 backward

// A block takes C column tiles of 64 (two columns a lane, tx and tx + 32)
// times S sub-tiles of 32 rows (four a warp), step by step (one 32 x 64
// sub-tile a step, eight elements a thread). The cotangent reaches shared
// memory by cp.async one step ahead of use: each thread copies the eight
// elements it will read itself, so no barrier guards the ring, and the
// next step's loads are in flight while the FP64 exp chains of this one
// run. A step's X rows and the tile's Xs columns are loaded before the
// wait, beside the copies. Row sums (dX) are reduced over the warp by
// SplitReduce and kept per block row in shared memory across the column
// tiles; column sums (dXs) are kept in registers across the sub-tiles and
// reduced over the warps through shared memory at the end of a column
// tile. A one-dimensional grid of B gx gy blocks writes the partial sums
// to scratch, pX [gx][B][n][d] and pXs [gy][B][m][d], which
// cov_backward_finish adds as for float, a programmatic dependent of this
// grid.
constexpr int kB64Cols = 2 * kWarp;                    // 64
constexpr int kB64Rows = 4;
constexpr int kB64TileRows = kWarps * kB64Rows;        // 32
constexpr int kB64Stages = 2;
constexpr int kB64StageElems = kWarps * kB64Rows * 2 * kWarp;   // 2048
constexpr int kB64MaxS = 16;                   // sub-tiles a block at most
// Blocks an SM: registers for four at d = 1 (64 a thread), two at d <= 4
// (128).
template <int FC>
constexpr int kB64MinBlocks = FC == 1 ? 4 : 2;

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Doubles of dynamic shared memory: the cotangent ring, the warps' column
// sums and the row sums [S 32][FC].
__host__ __device__ constexpr int b64_smem_elems(int FC, int S) {
  return kB64Stages * kB64StageElems + kWarps * kB64Cols +
         S * kB64TileRows * FC;
}

template <int K, int FC>
__global__ void __launch_bounds__(kThreads, kB64MinBlocks<FC>)
cov_backward_f64_kernel(const double* __restrict__ g, long long gsb,
                        long long gsi, long long gsj,
                        const double* __restrict__ X,
                        const double* __restrict__ Xs,
                        double* __restrict__ pX, double* __restrict__ pXs,
                        int B, int n, int m, int d, int C, int S, int gx,
                        int gy) {
  constexpr int R = kB64Rows;
  extern __shared__ __align__(16) double smem[];
  double* ring = smem;
  double* red = ring + kB64Stages * kB64StageElems;       // [8][64]
  double* rowpart = red + kWarps * kB64Cols;              // [S 32][FC]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;
  const int sum_base = split_reduce_base<R * FC>(tx);
  constexpr int kSumsPerLane = R * FC / kWarp > 1 ? R * FC / kWarp : 1;
  const long long cstep = kWarp * gsj;
  const int steps = C * S;
  // the block's place: column block bx fastest, then row block by, then b
  const int bx = blockIdx.x % gx;
  const int by = (blockIdx.x / gx) % gy;
  const int b = blockIdx.x / (gx * gy);
  const int col00 = bx * C * kB64Cols;
  const int row00 = by * S * kB64TileRows;
  const double* Xb = X + static_cast<size_t>(b) * n * d;
  const double* Yb = Xs + static_cast<size_t>(b) * m * d;
  const double* gb = g + b * gsb;

  // this thread's eight cotangents of step t into ring slot t % 2, zero
  // outside (n, m)
  auto issue = [&](int t) {
    const int ct = t / S;
    const int i0 = row00 + (t - ct * S) * kB64TileRows + ty * R;
    const int j0 = col00 + ct * kB64Cols + tx;
    const double* gp = gb + i0 * gsi + j0 * gsj;
    double* dst = ring + (t & 1) * kB64StageElems + ty * (R * 2 * kWarp) +
                  tx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = i0 + r < n && j0 + kWarp * c < m;
        cp_async8(dst + (r * 2 + c) * kWarp, in ? gp + c * cstep : g, in);
      }
      gp += gsi;
    }
  };

  double y[2][FC];
  double colacc[2][FC];
  issue(0);
  cp_async_commit();
  int ct = 0;
  int s = 0;
  for (int t = 0; t < steps; ++t) {
    const int i0 = row00 + s * kB64TileRows + ty * R;
    // the warp's rows (one address for the 32 lanes, broadcast loads)
    // and, at a new column tile, the lane's columns: before the wait
    double x[R][FC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        x[r][f] = (i0 + r < n && f < d)
                      ? Xb[static_cast<size_t>(i0 + r) * d + f] : 0.0;
      }
    }
    if (s == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = col00 + ct * kB64Cols + tx + kWarp * c;
#pragma unroll
        for (int f = 0; f < FC; ++f) {
          y[c][f] = (j < m && f < d) ? Yb[static_cast<size_t>(j) * d + f]
                                     : 0.0;
          colacc[c][f] = 0.0;
        }
      }
    }
    if (t + 1 < steps) issue(t + 1);
    cp_async_commit();
    cp_async_wait_one();            // this step's own copies have landed

    const double* gs = ring + (t & 1) * kB64StageElems +
                       ty * (R * 2 * kWarp) + tx;
    double rowacc[R * FC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      double diff[2][FC];
      double w[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        double d2 = 0.0;
#pragma unroll
        for (int f = 0; f < FC; ++f) {
          diff[c][f] = x[r][f] - y[c][f];
          d2 = fma(diff[c][f], diff[c][f], d2);
        }
        w[c] = gs[(r * 2 + c) * kWarp] * dcov_fn<K>(d2);
      }
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        double sum = 0.0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sum = fma(w[c], diff[c][f], sum);
          colacc[c][f] = fma(-w[c], diff[c][f], colacc[c][f]);
        }
        rowacc[r * FC + f] = sum;
      }
    }
    SplitReduce<R * FC, kWarp / 2>::run(rowacc, tx);
    if (sum_base >= 0) {
#pragma unroll
      for (int k = 0; k < kSumsPerLane; ++k) {
        const int r = (sum_base + k) / FC;
        const int f = (sum_base + k) % FC;
        // the same lane adds a row's sums of every column tile, in order
        double* p = rowpart + (s * kB64TileRows + ty * R + r) * FC + f;
        const double v = ct == 0 ? rowacc[k] : *p + rowacc[k];
        if (C > 1) *p = v;
        if (ct == C - 1 && i0 + r < n && f < d) {
          pX[(static_cast<size_t>(bx) * B + b) * n * d +
             static_cast<size_t>(i0 + r) * d + f] = v;
        }
      }
    }

    if (s == S - 1) {               // the column tile's sums over the rows
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        if (f >= d) break;          // the same for the whole block
        __syncthreads();            // red has been read
        red[ty * kB64Cols + tx] = colacc[0][f];
        red[ty * kB64Cols + kWarp + tx] = colacc[1][f];
        __syncthreads();
        const int j = col00 + ct * kB64Cols + tid;
        if (tid < kB64Cols && j < m) {
          double v = 0.0;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) {
            v += red[wp * kB64Cols + tid];
          }
          pXs[(static_cast<size_t>(by) * B + b) * m * d +
              static_cast<size_t>(j) * d + f] = v;
        }
      }
    }
    if (++s == S) {
      s = 0;
      ++ct;
    }
  }

  // the finishing pass may be launched now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

struct B64Plan {
  int gx, gy, C, S;
  long long nX, nXs, scratch;
};

// Two column tiles a block where there are eight or more (fewer partial
// row sums), and about an eighth of the rows a block (at most 16
// sub-tiles, at least 1), so that about eight partial column sums are
// added whatever n is. gx = 0 where the grid would not fit.
B64Plan plan_backward_f64(int B, int n, int m, int d) {
  B64Plan p = {};
  const int tiles = (m + kB64Cols - 1) / kB64Cols;
  const int subs = (n + kB64TileRows - 1) / kB64TileRows;
  p.nX = static_cast<long long>(B) * n * d;
  p.nXs = static_cast<long long>(B) * m * d;
  p.C = tiles >= 8 ? 2 : 1;
  p.S = subs / 8 < 1 ? 1 : (subs / 8 > kB64MaxS ? kB64MaxS : subs / 8);
  p.gx = (tiles + p.C - 1) / p.C;
  p.gy = (subs + p.S - 1) / p.S;
  if (static_cast<long long>(B) * p.gx * p.gy > 2147483647LL) {
    p.gx = 0;
    return p;
  }
  p.scratch = p.gx * p.nX + p.gy * p.nXs;
  return p;
}

template <int K, int FC>
cudaError_t launch_backward_f64_fc(const B64Plan& p, const double* g,
                                   long long gsb, long long gsi,
                                   long long gsj, const double* X,
                                   const double* Xs, double* dX, double* dXs,
                                   double* scratch, int B, int n, int m,
                                   int d, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory (FC = 4 and S > 12) the kernel
  // must opt in, on the current device: set before each such launch
  const int smem = b64_smem_elems(FC, p.S) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cov_backward_f64_kernel<K, FC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  double* pX = scratch;
  double* pXs = scratch + p.gx * p.nX;
  const unsigned blocks = static_cast<unsigned>(B) * p.gx * p.gy;
  cov_backward_f64_kernel<K, FC>
      <<<blocks, dim3(kWarp, kWarps), smem, stream>>>(
          g, gsb, gsi, gsj, X, Xs, pX, pXs, B, n, m, d, p.C, p.S, p.gx, p.gy);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long fin =
      (p.nX + kWarp - 1) / kWarp + (p.nXs + kWarp - 1) / kWarp;
  if (fin > 2147483647LL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(fin));
  config.blockDim = dim3(kWarp, kWarps);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const double* cpX = pX;
  const double* cpXs = pXs;
  return cudaLaunchKernelEx(&config, cov_backward_finish<double>, cpX, cpXs,
                            dX, dXs, p.nX, p.nXs, p.gx, p.gy);
}

// The float64 backward: the design above for d <= 4, the shared one (the
// float design in double) for larger d.
template <int K>
cudaError_t launch_backward_f64(const double* g, long long gsb,
                                long long gsi, long long gsj,
                                const double* X, const double* Xs,
                                double* dX, double* dXs, double* scratch,
                                long long scratch_elems, int B, int n, int m,
                                int d, cudaStream_t stream) {
  if (d > 4) {
    const BackwardPlan p = plan_backward(B, n, m, d);
    if (scratch_elems < p.scratch) return cudaErrorInvalidValue;
    return launch_backward<K>(g, gsb, gsi, gsj, X, Xs, dX, dXs, scratch, B,
                              n, m, d, p, stream);
  }
  const B64Plan p = plan_backward_f64(B, n, m, d);
  if (p.gx == 0 || scratch_elems < p.scratch) return cudaErrorInvalidValue;
  return d == 1
      ? launch_backward_f64_fc<K, 1>(p, g, gsb, gsi, gsj, X, Xs, dX, dXs,
                                     scratch, B, n, m, d, stream)
      : launch_backward_f64_fc<K, 4>(p, g, gsb, gsi, gsj, X, Xs, dX, dXs,
                                     scratch, B, n, m, d, stream);
}

// Scratch elements of the float64 backward (-1: a grid too large).
long long scratch_f64(int B, int n, int m, int d) {
  if (d > 4) return plan_backward(B, n, m, d).scratch;
  const B64Plan p = plan_backward_f64(B, n, m, d);
  return p.gx == 0 ? -1 : p.scratch;
}

#endif  // GP_COV_F64

bool bad_shape(int B, int n, int m, int d) {
  return B <= 0 || n <= 0 || m <= 0 || d <= 0;
}

// Forward and backward of one kind: the float design above, and in double
// the float64 launchers (launch_forward_f64, launch_backward_f64).
template <int K>
cudaError_t forward_kind(const float* X, const float* Xs, float* out, int B,
                         int n, int m, int d, cudaStream_t s) {
  return launch_forward<K>(X, Xs, out, B, n, m, d, s);
}
template <int K>
cudaError_t backward_kind(const float* g, long long gsb, long long gsi,
                          long long gsj, const float* X, const float* Xs,
                          float* dX, float* dXs, float* scratch,
                          long long scratch_elems, int B, int n, int m, int d,
                          cudaStream_t s) {
  const BackwardPlan p = plan_backward(B, n, m, d);
  if (scratch_elems < p.scratch) return cudaErrorInvalidValue;
  return launch_backward<K>(g, gsb, gsi, gsj, X, Xs, dX, dXs, scratch, B, n,
                            m, d, p, s);
}
long long scratch_elems_of(float*, int B, int n, int m, int d) {
  return plan_backward(B, n, m, d).scratch;
}
#ifdef GP_COV_F64
template <int K>
cudaError_t forward_kind(const double* X, const double* Xs, double* out,
                         int B, int n, int m, int d, cudaStream_t s) {
  return launch_forward_f64<K>(X, Xs, out, B, n, m, d, s);
}
template <int K>
cudaError_t backward_kind(const double* g, long long gsb, long long gsi,
                          long long gsj, const double* X, const double* Xs,
                          double* dX, double* dXs, double* scratch,
                          long long scratch_elems, int B, int n, int m,
                          int d, cudaStream_t s) {
  return launch_backward_f64<K>(g, gsb, gsi, gsj, X, Xs, dX, dXs, scratch,
                                scratch_elems, B, n, m, d, s);
}
long long scratch_elems_of(double*, int B, int n, int m, int d) {
  return scratch_f64(B, n, m, d);
}
#endif

template <typename T>
int forward_entry(const void* X, const void* Xs, void* out, int B, int n,
                  int m, int d, int kind, void* stream) {
  const T* x = static_cast<const T*>(X);
  const T* xs = static_cast<const T*>(Xs);
  T* k = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (kind) {
    case kExpQuad:
      err = forward_kind<kExpQuad>(x, xs, k, B, n, m, d, s); break;
    case kMatern52:
      err = forward_kind<kMatern52>(x, xs, k, B, n, m, d, s); break;
    case kMatern32:
      err = forward_kind<kMatern32>(x, xs, k, B, n, m, d, s); break;
    case kMatern12:
      err = forward_kind<kMatern12>(x, xs, k, B, n, m, d, s); break;
    case kExponential:
      err = forward_kind<kExponential>(x, xs, k, B, n, m, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename T>
int backward_entry(const void* g, long long gsb, long long gsi,
                   long long gsj, const void* X, const void* Xs, void* dX,
                   void* dXs, void* scratch, long long scratch_elems, int B,
                   int n, int m, int d, int kind, void* stream) {
  const T* gp = static_cast<const T*>(g);
  const T* x = static_cast<const T*>(X);
  const T* xs = static_cast<const T*>(Xs);
  T* dx = static_cast<T*>(dX);
  T* dxs = static_cast<T*>(dXs);
  T* sc = static_cast<T*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, n, m, d) || gsb < 0 || gsi < 0 || gsj < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (kind) {
    case kExpQuad:
      err = backward_kind<kExpQuad>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                    scratch_elems, B, n, m, d, s); break;
    case kMatern52:
      err = backward_kind<kMatern52>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                     scratch_elems, B, n, m, d, s); break;
    case kMatern32:
      err = backward_kind<kMatern32>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                     scratch_elems, B, n, m, d, s); break;
    case kMatern12:
      err = backward_kind<kMatern12>(gp, gsb, gsi, gsj, x, xs, dx, dxs, sc,
                                     scratch_elems, B, n, m, d, s); break;
    case kExponential:
      err = backward_kind<kExponential>(gp, gsb, gsi, gsj, x, xs, dx, dxs,
                                        sc, scratch_elems, B, n, m, d, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// The entry points of one element type: the library is built once with
// -DGP_COV_F32 and once with -DGP_COV_F64, two nvcc runs side by side.
//
// K (B, n, m) = f(d2(X (B, n, d), Xs (B, m, d))), contiguous, all float32
// (_f32) or all float64 (_f64). Returns the cudaError_t of the launch (0 on
// success).
//
// gp_cov_backward_scratch_*: elements of scratch (of the entry point's
// type) that gp_cov_backward_* needs for these shapes.
//
// gp_cov_backward_*: dX (B, n, d), dXs (B, m, d) from the cotangent g of K,
// read at g[b * gsb + i * gsi + j * gsj] (strides in elements, any of them 0
// for an expanded cotangent); X, Xs, dX, dXs contiguous; everything of the
// entry point's type. Returns the cudaError_t of the first launch that
// failed (0 on success).
#define GP_COV_ENTRY_POINTS(T, SUFFIX)                                       \
  extern "C" int gp_cov_forward_##SUFFIX(                                    \
      const void* X, const void* Xs, void* out, int B, int n, int m, int d,  \
      int kind, void* stream) {                                              \
    return forward_entry<T>(X, Xs, out, B, n, m, d, kind, stream);           \
  }                                                                          \
  extern "C" long long gp_cov_backward_scratch_##SUFFIX(int B, int n, int m, \
                                                        int d) {             \
    if (bad_shape(B, n, m, d)) return -1;                                    \
    return scratch_elems_of(static_cast<T*>(nullptr), B, n, m, d);           \
  }                                                                          \
  extern "C" int gp_cov_backward_##SUFFIX(                                   \
      const void* g, long long gsb, long long gsi, long long gsj,            \
      const void* X, const void* Xs, void* dX, void* dXs, void* scratch,     \
      long long scratch_elems, int B, int n, int m, int d, int kind,         \
      void* stream) {                                                        \
    return backward_entry<T>(g, gsb, gsi, gsj, X, Xs, dX, dXs, scratch,      \
                             scratch_elems, B, n, m, d, kind, stream);       \
  }

#ifdef GP_COV_F32
GP_COV_ENTRY_POINTS(float, f32)
#endif
#ifdef GP_COV_F64
GP_COV_ENTRY_POINTS(double, f64)
#endif
