// Adversary kernel #7: the weight cotangents of the discriminator's value
// and input gradient, the backward of ops/kernels/disc_train.py ::
// VDvFused. It replaces, in the JAX package's ops/pallas/disc_train.py,
//
//   #7 _v_bwd_kernel -> disc_bwd_launch  (weight cotangents, summed over M)
//
// The forward, #6 (disc_fwd_launch), is in disc_fwd.cu; the network and its
// packing are in disc_net.cuh.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000): about
// 136,650 multiply-adds a point (21.9 GFLOP, 0.33 ms) against 4.2 MB: bound
// by operations. No tensor cores: TF32 would break the f32 parity with the
// plain version at about 1e-3.
//
// #7 design: an MLP over a batch. A block of XD_BWD_THREADS threads takes a
// TILE of P points (P = 16, or 8 where 16 does not fit) and
// works layer by layer on the tile with all of its vectors in shared memory,
// feature-major [width][P] with rows padded to P + 1 floats:
//   1. the forward, keeping every pre-activation A_0..A_L;
//   2. the sweep, keeping every G_0..G_L;
//   3. the sweep's reverse (it ran last), i = 0..L-1, and the output layer
//      (the second-order tanh term);
//   4. the forward's reverse, i = L-1..0.
// In every step the block's threads first split the P x width outputs of
// the layer's matrix product (consecutive threads on consecutive points:
// activation reads hit distinct banks, weight reads are broadcasts), and
// then split the layer's weight entries: each thread owns a set of entries
// and adds their sum over the tile's P points to the block's accumulator in
// shared memory. An entry has exactly one owner in a step, so there are no
// atomics, and the padding keeps the owners' reads on distinct banks. The
// block walks its tiles in a fixed order, writes its accumulator as one
// partial, and disc_reduce_kernel sums the partials over blocks in a fixed
// order: the result does not depend on scheduling. The weights stay in
// device memory (read-only path, L1-resident), so an untied net at d=5
// (93 KB of weights) still fits a block with its accumulator.
#include "disc_net.cuh"

#define XD_BWD_THREADS 512

// Shared memory of one #7 block (ops/kernels/disc_train.py :: bwd_smem_bytes).
__host__ inline size_t xd_bwd_smem(int F, int H, int L, int n_params,
                                   int P) {
  const size_t rows = 2 * (size_t)(L + 1) * H + 2 * H + 2 * F + 1;
  return sizeof(float) * ((size_t)n_params + (size_t)(P + 1) * rows);
}

// ---------------------------------------------------------------------------
// #7: weight cotangents, a tile of P points per step of a block.
// Buffers are [rows][S], S = P + 1; column p is point p of the tile.
// ---------------------------------------------------------------------------

// out[j][p] = (bias ? bias[j] : 0) + sum_k W[j, k] in'[k][p], W [rows, cols]
// row-major, in' = relu(in) when RELU.
template <bool RELU>
__device__ inline void xd_tile_dense(float* out, const float* __restrict__ W,
                                     const float* __restrict__ bias,
                                     const float* in, int rows, int cols,
                                     int P, int S) {
  for (int idx = threadIdx.x; idx < rows * P; idx += blockDim.x) {
    const int j = idx / P, p = idx - j * P;
    const float* row = W + j * cols;
    float s = 0.f;
    for (int k = 0; k < cols; ++k) {
      float x = in[k * S + p];
      if (RELU) x = fmaxf(x, 0.f);
      s = fmaf(__ldg(row + k), x, s);
    }
    out[j * S + p] = bias ? s + __ldg(bias + j) : s;
  }
}

// out[k][p] = [mask[k][p] > 0] sum_j W[j, k] in[j][p]: the transposed
// product, masked by a pre-activation's sign (mask == nullptr: no mask).
__device__ inline void xd_tile_dense_t(float* out,
                                       const float* __restrict__ W,
                                       const float* in, const float* mask,
                                       int rows, int cols, int P, int S) {
  for (int idx = threadIdx.x; idx < cols * P; idx += blockDim.x) {
    const int k = idx / P, p = idx - k * P;
    float s = 0.f;
    for (int j = 0; j < rows; ++j) s = fmaf(__ldg(W + j * cols + k), in[j * S + p], s);
    out[k * S + p] = (mask == nullptr || mask[k * S + p] > 0.f) ? s : 0.f;
  }
}

// acc[j * cols + k] += sum_p X[j][p] Y'[k][p], where Y' is Y masked by
// mask's sign (MASK), relu(Y) (RELU) or Y; one owner thread per entry.
template <bool MASK, bool RELU>
__device__ inline void xd_tile_outer(float* acc, const float* X,
                                     const float* Y, const float* mask,
                                     int rows, int cols, int P, int S) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int j = e / cols, k = e - j * cols;
    const float* x = X + j * S;
    const float* y = Y + k * S;
    const float* mk = MASK ? mask + k * S : nullptr;
    float s = 0.f;
    for (int p = 0; p < P; ++p) {
      float yv = y[p];
      if (MASK) yv = mk[p] > 0.f ? yv : 0.f;
      if (RELU) yv = fmaxf(yv, 0.f);
      s = fmaf(x[p], yv, s);
    }
    acc[e] += s;
  }
}

// acc[j] += sum_p X[j][p]
__device__ inline void xd_tile_rowsum(float* acc, const float* X, int rows,
                                      int P, int S) {
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += X[j * S + p];
    acc[j] += s;
  }
}

__global__ void __launch_bounds__(XD_BWD_THREADS)
disc_bwd_kernel(const float* __restrict__ params, int n_params,
                const float* __restrict__ feats,  // [M, F]
                const float* __restrict__ vb,     // [M]
                const float* __restrict__ gb,     // [M, F]
                float* __restrict__ partial,      // [gridDim.x, n_params]
                int M, int F, int H, int L, int tied, int P) {
  extern __shared__ float smem[];
  const int S = P + 1;
  float* acc = smem;
  float* A = acc + n_params;           // A_0..A_L, each [H][S]
  float* G = A + (size_t)(L + 1) * H * S;
  float* cur = G + (size_t)(L + 1) * H * S;
  float* nxt = cur + H * S;
  float* Z = nxt + H * S;              // [F][S]
  float* GB = Z + F * S;               // [F][S]
  float* VB = GB + F * S;              // [S]
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) acc[i] = 0.f;

  const float* W0 = params;
  const float* b0 = params + H * F;
  const int oo = xd_out_off(F, H, L, tied);
  const float* wo = params + oo;
  const int n_tiles = (M + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * P;
    __syncthreads();  // the previous tile's last reads are done
    for (int idx = threadIdx.x; idx < F * P; idx += blockDim.x) {
      const int p = idx / F, f = idx - p * F;  // consecutive threads: one row
      const int m = m0 + p;
      const bool live = m < M;
      Z[f * S + p] = live ? feats[(size_t)m * F + f] : 0.f;
      GB[f * S + p] = live ? gb[(size_t)m * F + f] : 0.f;
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      VB[p] = m0 + p < M ? vb[m0 + p] : 0.f;
    __syncthreads();

    // 1. forward
    xd_tile_dense<false>(A, W0, b0, Z, H, F, P, S);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const float* W = params + xd_hidden_off(F, H, i, tied);
      xd_tile_dense<true>(A + (size_t)(i + 1) * H * S, W, W + H * H,
                          A + (size_t)i * H * S, H, H, P, S);
      __syncthreads();
    }
    // 2. sweep
    const float* AL = A + (size_t)L * H * S;
    float* GL = G + (size_t)L * H * S;
    for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float y = tanhf(AL[j * S + p]);
      GL[j * S + p] = __ldg(wo + j) * (1.f - y * y);
    }
    __syncthreads();
    for (int i = L - 1; i >= 0; --i) {
      const float* W = params + xd_hidden_off(F, H, i, tied);
      xd_tile_dense_t(G + (size_t)i * H * S, W, G + (size_t)(i + 1) * H * S,
                      A + (size_t)i * H * S, H, H, P, S);
      __syncthreads();
    }
    // 3. the sweep's reverse: gbar_0 = W0 gb, dW0 += g_0 gb^T; then per
    // layer tbar = [a_i > 0] gbar_i, dW_h += g_{i+1} tbar^T,
    // gbar_{i+1} = W_h tbar
    xd_tile_dense<false>(cur, W0, nullptr, GB, H, F, P, S);
    xd_tile_outer<false, false>(acc, G, GB, nullptr, H, F, P, S);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const int off = xd_hidden_off(F, H, i, tied);
      const float* Ai = A + (size_t)i * H * S;
      for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
        const int j = idx / P, p = idx - j * P;
        const float* row = params + off + j * H;
        float s = 0.f;
        for (int k = 0; k < H; ++k) {
          const float t = Ai[k * S + p] > 0.f ? cur[k * S + p] : 0.f;
          s = fmaf(__ldg(row + k), t, s);
        }
        nxt[j * S + p] = s;
      }
      xd_tile_outer<true, false>(acc + off, G + (size_t)(i + 1) * H * S, cur,
                                 Ai, H, H, P, S);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // output layer: dw_o += gbar_L (1 - y^2) + vb y, db_o += vb,
    // abar_L = (vb w_o - 2 y w_o gbar_L)(1 - y^2)
    for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float y = tanhf(AL[j * S + p]), s = 1.f - y * y;
      const float w = __ldg(wo + j);
      nxt[j * S + p] = (VB[p] * w - 2.f * y * w * cur[j * S + p]) * s;
    }
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) {
        const float y = tanhf(AL[j * S + p]);
        s = fmaf(cur[j * S + p], 1.f - y * y, s);
        s = fmaf(VB[p], y, s);
      }
      acc[oo + j] += s;
    }
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += VB[p];
      acc[oo + H] += s;
    }
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    // 4. the forward's reverse: dW_h += abar relu(a_i)^T, db_h += abar,
    // abar = [a_i > 0] (W_h^T abar)
    for (int i = L - 1; i >= 0; --i) {
      const int off = xd_hidden_off(F, H, i, tied);
      const float* Ai = A + (size_t)i * H * S;
      xd_tile_outer<false, true>(acc + off, cur, Ai, nullptr, H, H, P, S);
      xd_tile_rowsum(acc + off + H * H, cur, H, P, S);
      xd_tile_dense_t(nxt, params + off, cur, Ai, H, H, P, S);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    xd_tile_outer<false, false>(acc, cur, Z, nullptr, H, F, P, S);
    xd_tile_rowsum(acc + H * F, cur, H, P, S);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_params; i += blockDim.x)
    partial[(size_t)blockIdx.x * n_params + i] = acc[i];
}

// grad[i] = sum over blocks b, in order, of partial[b, i].
__global__ void disc_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ grad, int n_blocks,
                                   int n_params) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * n_params + i];
  grad[i] = s;
}

// tile: points per tile (1..32); blocks: the grid, one partial row each
// (partial holds blocks x n_params floats).
extern "C" int disc_bwd_launch(int device, void* stream, const float* params,
                               int n_params, const float* feats,
                               const float* vb, const float* gb,
                               float* partial, float* grad, int M, int F,
                               int H, int L, int tied, int tile,
                               int blocks) {
  if (M < 0 || !xd_caps_ok(F, H, L, tied, n_params) || tile < 1 ||
      tile > 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = xd_bwd_smem(F, H, L, n_params, tile);
  e = xd_allow_smem((const void*)disc_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0)
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  disc_bwd_kernel<<<blocks, XD_BWD_THREADS, smem, (cudaStream_t)stream>>>(
      params, n_params, feats, vb, gb, partial, M, F, H, L, tied, tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  disc_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(partial, grad, blocks,
                                               n_params);
  return (int)cudaGetLastError();
}

extern "C" const char* xn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
