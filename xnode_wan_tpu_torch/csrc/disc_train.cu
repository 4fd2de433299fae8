// Adversary kernels: the discriminator's value with its input gradient, and
// the weight cotangents of both, the custom VJP of
// ops/kernels/disc_train.py :: VDvFused. They replace, in the JAX
// package's ops/pallas/disc_train.py,
//
//   #6 _v_fwd_kernel -> disc_fwd_launch  (v [M], gin [M, F])
//   #7 _v_bwd_kernel -> disc_bwd_launch  (weight cotangents, summed over M)
//
// Network (ops/kernels/disc_train.py, per point with features z [F]):
//   a0 = W0 z + b0;  a_{i+1} = W_h relu(a_i) + b_h  (i < L);  y = tanh(a_L);
//   v = w_o . y + b_o;  reverse sweep g_L = w_o (1 - y^2),
//   g_i = [a_i > 0] (W_h^T g_{i+1}),  gin = W0^T g_0.
// Packed weights: W0 [H, F], b0 [H], then (W_h [H, H], b_h [H]) once when
// tied or L times, then w_o [H], b_o; each W row-major [out, in].
//
// Bounds on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000): #6 does
// 45,650 multiply-adds a point (7.30 GFLOP, 0.109 ms) against 4.2 MB; #7
// about 136,650 (21.9 GFLOP, 0.33 ms) against 4.2 MB. Both are bound by
// operations; neither uses the tensor cores, whose TF32 would break the
// f32 parity with the plain versions at about 1e-3.
//
// #6 design: ONE THREAD PER POINT. The packed weights sit in shared memory
// (11.8 KB at d=5, 32.8 KB at the d=20 geometry) and every read of them is
// a broadcast. The sweep needs the sign of every a_i: the thread keeps them
// as bits (ceil(L*H/32) words, 15 at d=5), not as L*H floats; the one live
// activation vector and the sweep vector are the only float arrays.
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
#include <cuda_runtime.h>

#define XD_MAX_WIDTH 64   // cap on H (v_hidden_dim)
#define XD_MAX_FEATS 128  // cap on F (feature width)
#define XD_MAX_LAYERS 32  // cap on L (v_layers)
#define XD_MAX_BITS ((XD_MAX_LAYERS * XD_MAX_WIDTH + 31) / 32)
#define XD_FWD_THREADS 256
#define XD_BWD_THREADS 512
#define XD_MAX_SMEM 232448

__host__ __device__ inline int xd_n_params(int F, int H, int L, int tied) {
  return F * H + H + (tied ? 1 : L) * (H * H + H) + H + 1;
}

// Offset of hidden layer i's W_h (b_h follows it).
__host__ __device__ inline int xd_hidden_off(int F, int H, int i, int tied) {
  return F * H + H + (tied ? 0 : i) * (H * H + H);
}

__host__ __device__ inline int xd_out_off(int F, int H, int L, int tied) {
  return F * H + H + (tied ? 1 : L) * (H * H + H);
}

// Shared memory of one #7 block (ops/kernels/disc_train.py :: bwd_smem_bytes).
__host__ inline size_t xd_bwd_smem(int F, int H, int L, int n_params,
                                   int P) {
  const size_t rows = 2 * (size_t)(L + 1) * H + 2 * H + 2 * F + 1;
  return sizeof(float) * ((size_t)n_params + (size_t)(P + 1) * rows);
}

__host__ inline bool xd_caps_ok(int F, int H, int L, int tied,
                                int n_params) {
  return F >= 1 && F <= XD_MAX_FEATS && H >= 1 && H <= XD_MAX_WIDTH &&
         L >= 1 && L <= XD_MAX_LAYERS && (tied == 0 || tied == 1) &&
         n_params == xd_n_params(F, H, L, tied);
}

// ---------------------------------------------------------------------------
// #6: value and input gradient, one thread per point.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(XD_FWD_THREADS)
disc_fwd_kernel(const float* __restrict__ params, int n_params,
                const float* __restrict__ feats,  // [M, F]
                float* __restrict__ v,            // [M]
                float* __restrict__ gin,          // [M, F]
                int M, int F, int H, int L, int tied) {
  extern __shared__ float sw[];
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) sw[i] = params[i];
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;

  float z[XD_MAX_FEATS], a[XD_MAX_WIDTH], r[XD_MAX_WIDTH];
  unsigned bits[XD_MAX_BITS];
  const int n_words = (L * H + 31) / 32;
  for (int w = 0; w < n_words; ++w) bits[w] = 0u;
  for (int f = 0; f < F; ++f) z[f] = feats[(size_t)m * F + f];

  const float* W0 = sw;
  const float* b0 = sw + H * F;
  for (int j = 0; j < H; ++j) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(W0[j * F + f], z[f], s);
    a[j] = s + b0[j];
  }
  for (int i = 0; i < L; ++i) {
    for (int k = 0; k < H; ++k) {
      const bool on = a[k] > 0.f;
      const int bit = i * H + k;
      bits[bit >> 5] |= (unsigned)on << (bit & 31);
      r[k] = on ? a[k] : 0.f;
    }
    const float* W = sw + xd_hidden_off(F, H, i, tied);
    const float* b = W + H * H;
    for (int j = 0; j < H; ++j) {
      float s = 0.f;
      for (int k = 0; k < H; ++k) s = fmaf(W[j * H + k], r[k], s);
      a[j] = s + b[j];
    }
  }
  const float* wo = sw + xd_out_off(F, H, L, tied);
  float val = 0.f;
  for (int j = 0; j < H; ++j) {
    const float y = tanhf(a[j]);
    val = fmaf(wo[j], y, val);
    a[j] = wo[j] * (1.f - y * y);  // g_L
  }
  v[m] = val + wo[H];
  for (int i = L - 1; i >= 0; --i) {
    const float* W = sw + xd_hidden_off(F, H, i, tied);
    for (int k = 0; k < H; ++k) {
      float s = 0.f;
      for (int j = 0; j < H; ++j) s = fmaf(W[j * H + k], a[j], s);
      const int bit = i * H + k;
      r[k] = (bits[bit >> 5] >> (bit & 31)) & 1u ? s : 0.f;
    }
    for (int k = 0; k < H; ++k) a[k] = r[k];
  }
  for (int f = 0; f < F; ++f) {
    float s = 0.f;
    for (int j = 0; j < H; ++j) s = fmaf(W0[j * F + f], a[j], s);
    gin[(size_t)m * F + f] = s;
  }
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

static cudaError_t xd_allow_smem(const void* kernel, size_t smem) {
  if (smem > XD_MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" int disc_fwd_launch(int device, void* stream, const float* params,
                               int n_params, const float* feats, float* v,
                               float* gin, int M, int F, int H, int L,
                               int tied) {
  if (M < 0 || !xd_caps_ok(F, H, L, tied, n_params))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * (size_t)n_params;
  e = xd_allow_smem((const void*)disc_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return 0;
  const int blocks = (M + XD_FWD_THREADS - 1) / XD_FWD_THREADS;
  disc_fwd_kernel<<<blocks, XD_FWD_THREADS, smem, (cudaStream_t)stream>>>(
      params, n_params, feats, v, gin, M, F, H, L, tied);
  return (int)cudaGetLastError();
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
