// Adversary kernels on tiles of points: #7, the weight cotangents of the
// discriminator's value and input gradient (the backward of
// ops/kernels/disc_train.py :: VDvFused), and the tile variant of #6, its
// value and input gradient (the forward). They replace, in the JAX
// package's ops/pallas/disc_train.py,
//
//   #7 _v_bwd_kernel -> disc_bwd_launch         (accumulator in shared memory)
//                       disc_bwd_cluster_launch (the same on thread-block
//                                                clusters, the accumulator
//                                                split over their blocks:
//                                                disc_train_cluster.cuh)
//                       disc_bwd_global_launch  (accumulator in its block's
//                                                row of `partial`)
//   #6 _v_fwd_kernel -> disc_tile_fwd_launch    (v [M], gin [M, F]:
//                       disc_tile_fwd.cuh; the register kernel of
//                       disc_fwd.cu takes the nets up to 64 wide whose
//                       staged weights fit a block)
//
// The network and its packing are in disc_net.cuh. Built ONCE, with the
// width H, the feature width F, the depth L and `tied` all runtime values:
// no loop over a layer is unrolled by its width, so one library takes every
// width the JAX package's Pallas kernels take (ops/kernels/disc_train.py ::
// disc_route picks the variant and the tile from the shapes).
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000): #7 about
// 136,650 multiply-adds a point (21.9 GFLOP, 0.33 ms) against 4.2 MB: bound
// by operations. The shared and global variants use no tensor cores: TF32
// alone would break the f32 parity with the plain version at about 1e-3.
// The cluster variant runs its sweep, both reverses and its weight sums on
// them in 3xTF32 (a TF32 value and a rest for each operand, three
// products: about FP32 accuracy), and its forward recompute in FP32 FMAs
// (disc_train_cluster.cuh); the tile #6 its sweep and gin, the forward in
// FP32 (disc_tile_fwd.cuh).
//
// Design of #7's shared and global variants: an MLP over a batch. A block
// takes a TILE of P points (32, 16, 8 or 4: the largest whose buffers fit)
// and works layer by layer on the tile with all of its vectors in shared
// memory, feature-major [width][S], S = P + 4 floats (P below 16 points,
// where the pad would not fit): rows start on 16 bytes and 8 rows spaced
// by an odd count fall on distinct banks.
// Stages:
//   1. the forward, keeping relu(a_0) .. relu(a_{L-1}) and a_L (a relu
//      output is > 0 exactly where its input is, so it serves as the mask);
//   2. the sweep: y = tanh(a_L) in place of a_L, and G_L .. G_0;
//   3. the sweep's reverse (it ran last), i = 0..L-1, each product masked
//      at its output by the next layer's sign, then the output layer (the
//      second-order tanh term);
//   4. the forward's reverse, i = L-1..0.
// Every matrix product of a step goes through REGISTER MICRO-TILES:
//   - xd_dense: a thread computes 2 outputs x 4 consecutive points. Per
//     input it loads the 2 weights (__ldg: the packed buffer stays in
//     device memory and L1; one 8-byte load where the pair is adjacent and
//     the paired dimension even, or one per two inputs) and one float4 of
//     the tile, so each weight feeds 4 FMAs and each activation 2. The
//     input loop takes 8 inputs a step, their loads first, and the step
//     loop is not unrolled (#pragma unroll 1), so ptxas cannot hoist loads
//     across steps. Each output sums its inputs in index order and adds its
//     bias last, as the plain version does (a bias added first moves points
//     across a relu kink);
//   - xd_outer, a layer's weight cotangent: a thread owns R x XD_OC entries
//     (R = 2 up to 50 wide, else 4) and, per four points, loads R + XD_OC
//     float4s of the two factors for 4 R XD_OC FMAs, summing the points in
//     order; it then adds its sums to the block's accumulator. An entry has
//     exactly one owner in a step, so there are no atomics.
// The block walks its tiles in a fixed order. With the accumulator in
// shared memory it writes it as one partial at the end; with the global
// variant (nets whose n_params floats do not fit beside the tile) the same
// owners add into the block's own row of `partial` in the same order, the
// __syncthreads that order the shared phases ordering these writes too, and
// the features and gb are read from global memory instead of staged. So the
// two variants are bitwise equal at the same tile and grid, and
// disc_reduce_kernel sums the partials over blocks in a fixed order: the
// result does not depend on scheduling, and two launches are bitwise equal.
// The global variant keeps 2 (L + 1) H + 2 H + 1 floats a point, at most
// the JAX package's VMEM rows (F + H (2L + 4) + 2 <= 12,288), so 4 points
// fit a block (196,608 bytes) wherever the Pallas kernels run.
#include <type_traits>

#include "disc_net.cuh"

// Threads of a block (ops/kernels/disc_train.py :: BWD_THREADS)
#define XD_BWD_THREADS 256
// xd_dense's micro-tile: XD_DR outputs x XD_DC points, XD_KU inputs a step
#define XD_DR 2
#define XD_DC 4
constexpr int XD_KU = 8;
// xd_outer's micro-tile: R rows x XD_OC columns of a weight matrix; XD_OC
// odd (bank spread above)
constexpr int XD_OC = 5;

// The variants, as disc_tile_smem_bytes numbers them
// (ops/kernels/disc_train.py :: VARIANT_IDS; the tile #6's layout is in
// disc_tile_fwd.cuh)
enum XdVariant { XD_BWD_SHARED = 0, XD_BWD_GLOBAL = 1, XD_FWD_TILE = 2 };

// Row stride of the tile's buffers for P points (P a multiple of 4).
__host__ __device__ constexpr int xd_bwd_stride(int P) {
  return P >= 16 ? P + 4 : P;
}

// Rows of a block's tile buffers: #7's A_0..A_L, G_0..G_L, two cotangent
// buffers and vb, plus the features and gb where they are staged (the
// shared variant).
__host__ inline size_t xd_tile_rows(int variant, int F, int H, int L) {
  const size_t rows = 2 * (size_t)(L + 1) * H + 2 * (size_t)H + 1;
  return variant == XD_BWD_SHARED ? rows + 2 * (size_t)F : rows;
}

// Shared memory of one block (ops/kernels/disc_train.py ::
// tile_smem_bytes): the tile's rows, then the shared variant's
// accumulator.
__host__ inline size_t xd_tile_smem(int variant, int F, int H, int L,
                                    int n_params, int P) {
  return sizeof(float) *
         ((variant == XD_BWD_SHARED ? (size_t)n_params : 0) +
          (size_t)xd_bwd_stride(P) * xd_tile_rows(variant, F, H, L));
}

// Rows [k][p] of the tile's P points staged in shared memory at stride S.
struct XdStaged {
  const float* rows;
  int S;
  static __device__ __forceinline__ XdStaged make(const float* staged, int S,
                                                  const float*, int, int) {
    return {staged, S};
  }
  __device__ __forceinline__ float4 load4(int k, int p) const {
    return *reinterpret_cast<const float4*>(rows + k * S + p);
  }
};

// The same rows read from a point-major [M, F] array in global memory:
// row k of point p is pts[p * F + k], zero past the tile's n live points.
struct XdPoints {
  const float* pts;
  int F, n;
  static __device__ __forceinline__ XdPoints make(const float*, int,
                                                  const float* pts, int F,
                                                  int n) {
    return {pts, F, n};
  }
  __device__ __forceinline__ float at(int k, int p) const {
    return p < n ? __ldg(pts + (size_t)p * F + k) : 0.f;
  }
  __device__ __forceinline__ float4 load4(int k, int p) const {
    return make_float4(at(k, p), at(k, p + 1), at(k, p + 2), at(k, p + 3));
  }
};

enum XdEpilogue { XD_BIAS, XD_BIAS_RELU, XD_MASK, XD_NONE };
// Where weight (o, k) of a product of O outputs and K inputs is: XD_ROWS,
// W [O, K] row-major (W0, W_h); XD_COLS, the transpose of W [K, O]
// row-major (W_h^T, W0^T): W(o, k) = W[k O + o].
enum XdLayout { XD_ROWS, XD_COLS };

// c[u][r] = W(o0 + r, k + u) for r < XD_DR (a row past O reads row O - 1
// and is not stored), u < U. Two rows of XD_COLS at an even O, or two
// consecutive k of a row of XD_ROWS at an even K, are one 8-byte load (the
// packed layers start at even offsets where that dimension is even).
template <int LAYOUT, int U>
__device__ __forceinline__ void xd_weights(float (&c)[U][XD_DR],
                                           const float* __restrict__ W,
                                           int o0, int k, int O, int K) {
  static_assert(XD_DR == 2, "the 8-byte loads pair two rows");
  if (LAYOUT == XD_COLS && O % 2 == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float2 w =
          __ldg(reinterpret_cast<const float2*>(W + (k + u) * O + o0));
      c[u][0] = w.x;
      c[u][1] = w.y;
    }
  } else if (LAYOUT == XD_ROWS && K % 2 == 0 && U % 2 == 0) {
#pragma unroll
    for (int r = 0; r < XD_DR; ++r) {
      const int o = min(o0 + r, O - 1);
#pragma unroll
      for (int u = 0; u < U; u += 2) {
        const float2 w =
            __ldg(reinterpret_cast<const float2*>(W + o * K + k + u));
        c[u][r] = w.x;
        c[u + 1][r] = w.y;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < XD_DR; ++r) {
        const int o = min(o0 + r, O - 1);
        c[u][r] = __ldg(W + (LAYOUT == XD_COLS ? (k + u) * O + o
                                               : o * K + k + u));
      }
    }
  }
}

// s[r][c] += sum over U inputs of c[u][r] v[u].c, in input order
template <int U>
__device__ __forceinline__ void xd_fma(float (&s)[XD_DR][XD_DC],
                                       const float (&c)[U][XD_DR],
                                       const float4 (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < XD_DR; ++r) {
      s[r][0] = fmaf(c[u][r], v[u].x, s[r][0]);
      s[r][1] = fmaf(c[u][r], v[u].y, s[r][1]);
      s[r][2] = fmaf(c[u][r], v[u].z, s[r][2]);
      s[r][3] = fmaf(c[u][r], v[u].w, s[r][3]);
    }
  }
}

// out[o][p] = epilogue(sum_{k < K} W(o, k) in[k][p]) for o < O and the
// tile's P points. Epilogues: + b[o] (then relu), or keep the sum where
// mask[o][p] > 0. The input loop takes XD_KU inputs a step (their loads
// first), and is not unrolled further.
template <int EPI, int LAYOUT, class In>
__device__ __forceinline__ void xd_dense(float* out,
                                         const float* __restrict__ W,
                                         const float* __restrict__ b, In in,
                                         const float* mask, int O, int K,
                                         int P, int S) {
  constexpr int R = XD_DR;
  const int nrb = (O + R - 1) / R, npb = P / XD_DC;
  for (int t = threadIdx.x; t < nrb * npb; t += blockDim.x) {
    const int rb = t / npb, p0 = (t - rb * npb) * XD_DC, o0 = rb * R;
    float s[R][XD_DC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < XD_DC; ++c) s[r][c] = 0.f;
    int k = 0;
#pragma unroll 1
    for (; k + XD_KU <= K; k += XD_KU) {
      float4 v[XD_KU];
      float c[XD_KU][R];
#pragma unroll
      for (int u = 0; u < XD_KU; ++u) v[u] = in.load4(k + u, p0);
      xd_weights<LAYOUT, XD_KU>(c, W, o0, k, O, K);
      xd_fma<XD_KU>(s, c, v);
    }
#pragma unroll 1
    for (; k < K; ++k) {
      float4 v[1] = {in.load4(k, p0)};
      float c[1][R];
      xd_weights<LAYOUT, 1>(c, W, o0, k, O, K);
      xd_fma<1>(s, c, v);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      if (o >= O) continue;
      float4 y = make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      if (EPI == XD_BIAS || EPI == XD_BIAS_RELU) {
        const float bo = __ldg(b + o);
        y.x += bo; y.y += bo; y.z += bo; y.w += bo;
      }
      if (EPI == XD_BIAS_RELU) {
        y.x = fmaxf(y.x, 0.f); y.y = fmaxf(y.y, 0.f);
        y.z = fmaxf(y.z, 0.f); y.w = fmaxf(y.w, 0.f);
      }
      if (EPI == XD_MASK) {
        const float4 m = *reinterpret_cast<const float4*>(mask + o * S + p0);
        y.x = m.x > 0.f ? y.x : 0.f; y.y = m.y > 0.f ? y.y : 0.f;
        y.z = m.z > 0.f ? y.z : 0.f; y.w = m.w > 0.f ? y.w : 0.f;
      }
      *reinterpret_cast<float4*>(out + o * S + p0) = y;
    }
  }
}

// acc[j * K + k] += sum_p X[j][p] Y[k][p] for j < H, k < K over the tile's
// P points in order (X staged at stride S); with BIAS also accb[j] += sum_p
// X[j][p] (by the owners of column block 0).
template <bool BIAS, int R, class In>
__device__ __forceinline__ void xd_outer(float* acc, float* accb,
                                         const float* X, In Y, int H, int K,
                                         int P, int S) {
  constexpr int C = XD_OC;
  const int njb = (H + R - 1) / R, nkb = (K + C - 1) / C;
  for (int t = threadIdx.x; t < njb * nkb; t += blockDim.x) {
    const int jb = t / nkb, kb = t - jb * nkb;
    const float* x[R];
    int y[C];
    float s[R][C], sb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = X + min(jb * R + r, H - 1) * S;  // past the edge: not stored
      sb[r] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = min(kb * C + c, K - 1);
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 xv[R], yv[C];
#pragma unroll
      for (int r = 0; r < R; ++r)
        xv[r] = *reinterpret_cast<const float4*>(x[r] + p);
#pragma unroll
      for (int c = 0; c < C; ++c) yv[c] = Y.load4(y[c], p);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[r][c] = fmaf(xv[r].x, yv[c].x, s[r][c]);
          s[r][c] = fmaf(xv[r].y, yv[c].y, s[r][c]);
          s[r][c] = fmaf(xv[r].z, yv[c].z, s[r][c]);
          s[r][c] = fmaf(xv[r].w, yv[c].w, s[r][c]);
        }
        if (BIAS) {
          sb[r] += xv[r].x; sb[r] += xv[r].y;
          sb[r] += xv[r].z; sb[r] += xv[r].w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = jb * R + r;
      if (j >= H) continue;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (kb * C + c < K) acc[j * K + kb * C + c] += s[r][c];
      if (BIAS && kb == 0) accb[j] += sb[r];
    }
  }
}

// 1. the forward on a tile: A_i = relu(a_i) for i < L, A_L = a_L (A_i at
// A + i H S), from the features z.
template <class In>
__device__ __forceinline__ void xd_tile_forward(float* A,
                                                const float* params, In z,
                                                int F, int H, int L,
                                                int tied, int P, int S) {
  const int HS = H * S;
  xd_dense<XD_BIAS_RELU, XD_ROWS>(A, params, params + H * F, z, nullptr, H,
                                  F, P, S);
  __syncthreads();
  for (int i = 0; i < L; ++i) {
    const float* W = params + xd_hidden_off(F, H, i, tied);
    const XdStaged in{A + i * HS, S};
    if (i + 1 < L)
      xd_dense<XD_BIAS_RELU, XD_ROWS>(A + (i + 1) * HS, W, W + H * H, in,
                                      nullptr, H, H, P, S);
    else
      xd_dense<XD_BIAS, XD_ROWS>(A + L * HS, W, W + H * H, in, nullptr, H,
                                 H, P, S);
    __syncthreads();
  }
}

// 2. the sweep from G_L at G + L H S: G_i = [a_i > 0] (W_h^T G_{i+1}) for
// i = L-1 .. 0, masked by A_i.
__device__ __forceinline__ void xd_tile_sweep(float* G, const float* params,
                                              const float* A, int F, int H,
                                              int L, int tied, int P,
                                              int S) {
  const int HS = H * S;
  for (int i = L - 1; i >= 0; --i) {
    xd_dense<XD_MASK, XD_COLS>(G + i * HS,
                               params + xd_hidden_off(F, H, i, tied), nullptr,
                               XdStaged{G + (i + 1) * HS, S}, A + i * HS, H,
                               H, P, S);
    __syncthreads();
  }
}

// Kernel #7. GACC: the accumulator in the block's row of partial, the
// features and gb read from global memory; else both in shared memory.
template <int R, bool GACC>
__global__ void __launch_bounds__(XD_BWD_THREADS, 1)
disc_bwd_kernel(const float* __restrict__ params, int n_params,
                const float* __restrict__ feats,  // [M, F]
                const float* __restrict__ vb,     // [M]
                const float* __restrict__ gb,     // [M, F]
                float* __restrict__ partial,      // [gridDim.x, n_params]
                int M, int F, int H, int L, int tied, int P) {
  using In = typename std::conditional<GACC, XdPoints, XdStaged>::type;
  extern __shared__ float4 sw4[];
  const int S = xd_bwd_stride(P);
  const int HS = H * S;
  float* const A = reinterpret_cast<float*>(sw4);  // A_0..A_L, each [H][S]
  float* const G = A + (L + 1) * HS;               // G_0..G_L
  float* const T0 = G + (L + 1) * HS;              // two cotangent buffers
  float* const T1 = T0 + HS;
  float* const Z = T1 + HS;                        // [F][S] when staged
  float* const GB = Z + (GACC ? 0 : F * S);        // [F][S] when staged
  float* const VB = GB + (GACC ? 0 : F * S);       // [S]
  float* const acc =
      GACC ? partial + (size_t)blockIdx.x * n_params : VB + S;  // [n_params]
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) acc[i] = 0.f;

  const float* W0 = params;
  const int oo = xd_out_off(F, H, L, tied);
  const float* wo = params + oo;
  float* const Y = A + L * HS;  // a_L, then y = tanh(a_L)
  const int n_tiles = (M + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * P, n = min(P, M - m0);
    float* cur = T0;
    float* nxt = T1;
    __syncthreads();  // the previous tile's last reads are done
    if (!GACC) {
      for (int idx = threadIdx.x; idx < F * P; idx += blockDim.x) {
        const int p = idx / F, f = idx - p * F;  // consecutive threads: a row
        const bool live = p < n;
        Z[f * S + p] = live ? feats[(size_t)(m0 + p) * F + f] : 0.f;
        GB[f * S + p] = live ? gb[(size_t)(m0 + p) * F + f] : 0.f;
      }
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      VB[p] = p < n ? vb[m0 + p] : 0.f;
    __syncthreads();
    const In z = In::make(Z, S, feats + (size_t)m0 * F, F, n);
    const In gbt = In::make(GB, S, gb + (size_t)m0 * F, F, n);

    // 1. forward: A_i = relu(a_i) for i < L, A_L = a_L
    xd_tile_forward(A, params, z, F, H, L, tied, P, S);
    // 2. sweep: y = tanh(a_L), G_L = w_o (1 - y^2),
    // G_i = [a_i > 0] (W_h^T G_{i+1})
    for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float y = tanhf(Y[j * S + p]);
      Y[j * S + p] = y;
      G[L * HS + j * S + p] = __ldg(wo + j) * (1.f - y * y);
    }
    __syncthreads();
    xd_tile_sweep(G, params, A, F, H, L, tied, P, S);
    // 3. the sweep's reverse: tbar_0 = [a_0 > 0] (W0 gb), dW0 += g_0 gb^T;
    // then per layer dW_h += g_{i+1} tbar_i^T and tbar_{i+1} = [a_{i+1} >
    // 0] (W_h tbar_i), unmasked at the last layer: gbar_L
    xd_dense<XD_MASK, XD_ROWS>(cur, W0, nullptr, gbt, A, H, F, P, S);
    xd_outer<false, R>(acc, nullptr, G, gbt, H, F, P, S);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const int off = xd_hidden_off(F, H, i, tied);
      const XdStaged in{cur, S};
      xd_outer<false, R>(acc + off, nullptr, G + (i + 1) * HS, in, H, H, P,
                         S);
      if (i + 1 < L)
        xd_dense<XD_MASK, XD_ROWS>(nxt, params + off, nullptr, in,
                                   A + (i + 1) * HS, H, H, P, S);
      else
        xd_dense<XD_NONE, XD_ROWS>(nxt, params + off, nullptr, in, nullptr,
                                   H, H, P, S);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // output layer: dw_o += gbar_L (1 - y^2) + vb y, db_o += vb,
    // abar_L = (vb w_o - 2 y w_o gbar_L)(1 - y^2)
    for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float y = Y[j * S + p], s = 1.f - y * y;
      const float w = __ldg(wo + j);
      nxt[j * S + p] = (VB[p] * w - 2.f * y * w * cur[j * S + p]) * s;
    }
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) {
        const float y = Y[j * S + p];
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
      xd_outer<true, R>(acc + off, acc + off + H * H, cur,
                        XdStaged{A + i * HS, S}, H, H, P, S);
      xd_dense<XD_MASK, XD_COLS>(nxt, params + off, nullptr,
                                 XdStaged{cur, S}, A + i * HS, H, H, P, S);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    xd_outer<true, R>(acc, acc + H * F, cur, z, H, F, P, S);
  }
  if (GACC) return;  // the row is already in partial
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

#include "disc_train_cluster.cuh"
#include "disc_tile_fwd.cuh"

// Host side

// Bytes of shared memory a block of `variant` asks for (disc_train.py's
// tile_smem_bytes is its twin; chip_smoke.py holds the two together).
// The tile #6's (XD_FWD_TILE) at its slice, or at 8-input slices where
// none fits.
extern "C" long long disc_tile_smem_bytes(int variant, int F, int H, int L,
                                          int tied, int tile) {
  if (variant == XD_FWD_TILE) {
    const int ks = xf_slice(F, H, L, tile);
    return (long long)sizeof(float) *
           xf_layout(F, H, L, tile, ks ? ks : 8).total;
  }
  return (long long)xd_tile_smem(variant, F, H, L, xd_n_params(F, H, L, tied),
                                 tile);
}

static bool xd_tile_ok(int tile) {
  return tile >= 4 && tile <= 32 && tile % 4 == 0;
}

template <bool GACC>
static int xd_bwd_launch(int device, void* stream, const float* params,
                         int n_params, const float* feats, const float* vb,
                         const float* gb, float* partial, float* grad, int M,
                         int F, int H, int L, int tied, int tile,
                         int blocks) {
  if (M < 0 || !xd_caps_ok(F, H, L, tied, n_params) ||
      reinterpret_cast<size_t>(params) % 8 != 0 || !xd_tile_ok(tile) ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = xd_tile_smem(GACC ? XD_BWD_GLOBAL : XD_BWD_SHARED, F,
                                   H, L, n_params, tile);
  const void* kernel = H > 50 ? (const void*)disc_bwd_kernel<4, GACC>
                              : (const void*)disc_bwd_kernel<2, GACC>;
  e = xd_allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0)
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  if (H > 50)
    disc_bwd_kernel<4, GACC><<<blocks, XD_BWD_THREADS, smem,
                               (cudaStream_t)stream>>>(
        params, n_params, feats, vb, gb, partial, M, F, H, L, tied, tile);
  else
    disc_bwd_kernel<2, GACC><<<blocks, XD_BWD_THREADS, smem,
                               (cudaStream_t)stream>>>(
        params, n_params, feats, vb, gb, partial, M, F, H, L, tied, tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  disc_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(partial, grad, blocks,
                                               n_params);
  return (int)cudaGetLastError();
}

// tile: points per tile (a multiple of 4, at most 32); blocks: the grid of
// XD_BWD_THREADS-thread blocks, one partial row each (partial holds blocks
// x n_params floats). params must sit on 8 bytes (xd_weights' paired
// loads).
extern "C" int disc_bwd_launch(int device, void* stream, const float* params,
                               int n_params, const float* feats,
                               const float* vb, const float* gb,
                               float* partial, float* grad, int M, int F,
                               int H, int L, int tied, int tile,
                               int blocks) {
  return xd_bwd_launch<false>(device, stream, params, n_params, feats, vb, gb,
                              partial, grad, M, F, H, L, tied, tile, blocks);
}

// The same with the accumulator in the block's row of partial, so its
// shared memory holds no accumulator and no features.
extern "C" int disc_bwd_global_launch(int device, void* stream,
                                      const float* params, int n_params,
                                      const float* feats, const float* vb,
                                      const float* gb, float* partial,
                                      float* grad, int M, int F, int H,
                                      int L, int tied, int tile,
                                      int blocks) {
  return xd_bwd_launch<true>(device, stream, params, n_params, feats, vb, gb,
                             partial, grad, M, F, H, L, tied, tile, blocks);
}

using XfKernel = void (*)(const float*, const float*, float*, float*, int,
                          int, int, int, int, int);

static XfKernel xf_kernel(int tile) {
  switch (tile) {
    case 8: return disc_tile_fwd_kernel<8>;
    case 16: return disc_tile_fwd_kernel<16>;
    case 32: return disc_tile_fwd_kernel<32>;
    case 64: return disc_tile_fwd_kernel<64>;
    case 128: return disc_tile_fwd_kernel<128>;
    default: return nullptr;
  }
}

// The tile #6 at `tile` points a tile (8, 16, 32, 64 or 128), its inputs
// in slices of xf_slice: a persistent grid of as many XF_THREADS-thread
// blocks as the card runs at once, at most one a tile.
extern "C" int disc_tile_fwd_launch(int device, void* stream,
                                    const float* params, int n_params,
                                    const float* feats, float* v, float* gin,
                                    int M, int F, int H, int L, int tied,
                                    int tile) {
  const XfKernel kernel = xf_kernel(tile);
  if (M < 0 || !xd_caps_ok(F, H, L, tied, n_params) || !kernel)
    return (int)cudaErrorInvalidValue;
  const int KF = xf_slice(F, H, L, tile);
  if (!KF) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * (size_t)xf_layout(F, H, L, tile,
                                                        KF).total;
  e = xd_allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return 0;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel, XF_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (M + tile - 1) / tile;
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, XF_THREADS, smem, (cudaStream_t)stream>>>(
      params, feats, v, gin, M, F, H, L, tied, KF);
  return (int)cudaGetLastError();
}

// #7's cluster variant: clusters of `cluster` blocks (2, 4 or 8), each
// block owning a slice of every layer's units and keeping its rows and
// columns of the (tied) hidden layer (disc_train_cluster.cuh).
using XkKernel = void (*)(const float*, int, const float*, const float*,
                          const float*, float*, int, int, int, int, int, int);

static XkKernel xk_kernel(int tile) {
  switch (xk_nb(tile)) {
    case 1: return disc_bwd_cluster_kernel<1>;
    case 2: return disc_bwd_cluster_kernel<2>;
    default: return disc_bwd_cluster_kernel<4>;
  }
}

static cudaError_t xk_config(cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, int device,
                             void* stream, int n_params, int M, int F, int H,
                             int L, int tied, int tile, int clusters,
                             int cluster) {
  if (M < 0 || !xd_caps_ok(F, H, L, tied, n_params) || tied != 1 ||
      !xd_tile_ok(tile) || clusters < 1 || cluster < 2 ||
      cluster > XC_MAX_CLUSTER || H < cluster)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = xk_smem_bytes(xk_layout(F, H, L, cluster, tile));
  e = xd_allow_smem((const void*)xk_kernel(tile), smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * cluster);
  cfg->blockDim = dim3(XK_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Bytes of shared memory a block of the cluster variant asks for, for a
// tied net (disc_train.py's cluster_smem_bytes is its twin).
extern "C" long long disc_cluster_smem_bytes(int F, int H, int L, int cluster,
                                             int tile) {
  return (long long)xk_smem_bytes(xk_layout(F, H, L, cluster, tile));
}

// Clusters of this shape that the card runs at once (the persistent grid's
// cap), or a negative CUDA error.
extern "C" int disc_cluster_occupancy(int device, int F, int H, int L,
                                      int tile, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = xk_config(&cfg, attr, device, nullptr,
                            xd_n_params(F, H, L, 1), 1, F, H, L, 1, tile, 1,
                            cluster);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)xk_kernel(tile), &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// The arguments of disc_bwd_launch but the grid, given as `clusters`
// clusters of `cluster` blocks (partial holds clusters x n_params floats);
// the net must be tied.
extern "C" int disc_bwd_cluster_launch(int device, void* stream,
                                       const float* params, int n_params,
                                       const float* feats, const float* vb,
                                       const float* gb, float* partial,
                                       float* grad, int M, int F, int H,
                                       int L, int tied, int tile,
                                       int clusters, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = xk_config(&cfg, attr, device, stream, n_params, M, F, H, L,
                            tied, tile, clusters, cluster);
  if (e != cudaSuccess) return (int)e;
  if (M == 0)
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&cfg, xk_kernel(tile), params, n_params, feats, vb,
                         gb, partial, M, F, H, L, tile, cluster);
  if (e != cudaSuccess) return (int)e;
  disc_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(partial, grad, clusters,
                                               n_params);
  return (int)cudaGetLastError();
}

extern "C" const char* xn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
