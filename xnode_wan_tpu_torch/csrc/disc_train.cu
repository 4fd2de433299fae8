// Adversary kernel #7: the weight cotangents of the discriminator's value
// and input gradient, the backward of ops/kernels/disc_train.py ::
// VDvFused. It replaces, in the JAX package's ops/pallas/disc_train.py,
//
//   #7 _v_bwd_kernel -> disc_bwd_launch  (weight cotangents, summed over M)
//
// The forward, #6 (disc_fwd_launch), is in disc_fwd.cu; the network and its
// packing are in disc_net.cuh. Built once per adversary width: nvcc
// -DXD_H=<H> (ops/kernels/_build.py), so every loop over a layer's outputs
// and every register micro-tile has a compile-time size. The feature width
// F, the depth L and `tied` stay runtime values.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000): about
// 136,650 multiply-adds a point (21.9 GFLOP, 0.33 ms) against 4.2 MB: bound
// by operations. No tensor cores: TF32 would break the f32 parity with the
// plain version at about 1e-3.
//
// Design: an MLP over a batch. A block takes a TILE of P points (32, 16 or
// 8: the largest whose buffers fit, ops/kernels/disc_train.py :: bwd_tile)
// and works layer by layer on the tile with all of its vectors in shared
// memory, feature-major [width][S], S = P + 4 floats (P when P = 8, where
// the pad would not fit): rows start on 16 bytes and 8 rows spaced by an
// odd count fall on distinct banks. Stages:
//   1. the forward, keeping relu(a_0) .. relu(a_{L-1}) and a_L (a relu
//      output is > 0 exactly where its input is, so it serves as the mask);
//   2. the sweep: y = tanh(a_L) in place of a_L, and every G_0 .. G_L;
//   3. the sweep's reverse (it ran last), i = 0..L-1, each product masked
//      at its output by the next layer's sign, then the output layer (the
//      second-order tanh term);
//   4. the forward's reverse, i = L-1..0.
// Every matrix product of a step goes through REGISTER MICRO-TILES:
//   - xd_dense: a thread computes 2 outputs x 4 consecutive points. Per
//     input it loads the 2 weights (__ldg: the packed buffer stays in
//     device memory and L1; at an even H as one 8-byte load, or one per
//     two inputs) and one float4 of the tile, so each weight feeds 4 FMAs
//     and each activation 2 (2 loads for 8 FMAs). The input loop takes 8
//     inputs a step, their loads first, and the step loop is not unrolled
//     (#pragma unroll 1), so ptxas cannot hoist loads across steps: kernel
//     #6 spilled where it could. Each output sums its inputs in index
//     order and adds its bias last, as the plain version does (a bias
//     added first moves points across a relu kink);
//   - xd_outer, a layer's weight cotangent: a thread owns XD_OR x XD_OC
//     entries and, per four points, loads XD_OR + XD_OC float4s of the two
//     factors for 4 XD_OR XD_OC FMAs, summing the points in order; it then
//     adds its sums to the block's accumulator in shared memory. An entry
//     has exactly one owner in a step, so there are no atomics.
// The block walks its tiles in a fixed order, writes its accumulator as
// one partial, and disc_reduce_kernel sums the partials over blocks in a
// fixed order: the result does not depend on scheduling, and two launches
// are bitwise equal.
// The weights stay in device memory, so an untied net at d=5 (93 KB of
// weights) still fits a block with its accumulator.
#include "disc_net.cuh"

#ifndef XD_H
#error "build with -DXD_H=<adversary width>"
#endif

// Threads of a block (ops/kernels/disc_train.py :: BWD_THREADS)
#define XD_BWD_THREADS 256
// xd_dense's micro-tile: XD_DR outputs x XD_DC points, XD_KU inputs a step
#define XD_DR 2
#define XD_DC 4
constexpr int XD_KU = 8;
// xd_outer's micro-tile: XD_OR rows x XD_OC columns of a weight matrix,
// about 256 of them over an H x H layer; XD_OC odd (bank spread above)
constexpr int XD_OR = XD_H > 50 ? 4 : 2;
constexpr int XD_OC = 5;

// Row stride of the tile's buffers for P points (P a multiple of 4).
__host__ __device__ constexpr int xd_bwd_stride(int P) {
  return P >= 16 ? P + 4 : P;
}

// Shared memory of one #7 block (ops/kernels/disc_train.py ::
// bwd_smem_bytes): the tile's rows, then the block's accumulator.
__host__ inline size_t xd_bwd_smem(int F, int H, int L, int n_params,
                                   int P) {
  const size_t rows = 2 * (size_t)(L + 1) * H + 2 * H + 2 * F + 1;
  return sizeof(float) * ((size_t)n_params + (size_t)xd_bwd_stride(P) * rows);
}

enum XdEpilogue { XD_BIAS, XD_BIAS_RELU, XD_MASK, XD_NONE };
// Where weight (o, k) of a product is: XD_W_F, W [H, K = F] row-major;
// XD_W_H, W [H, H] row-major; XD_WT_H, its transpose, W(o, k) = W[k, o].
enum XdLayout { XD_W_F, XD_W_H, XD_WT_H };

// c[u][r] = W(o0 + r, k + u) for r < XD_DR (a row past H reads row H - 1
// and is not stored), u < U. At an even H the two rows of XD_WT_H, or two
// consecutive k of a row of XD_W_H, are one 8-byte load (the packed layers
// start at even offsets).
template <int LAYOUT, int U>
__device__ __forceinline__ void xd_weights(float (&c)[U][XD_DR],
                                           const float* __restrict__ W,
                                           int o0, int k, int K) {
  constexpr int H = XD_H;
  static_assert(XD_DR == 2, "the 8-byte loads pair two rows");
  if (LAYOUT == XD_WT_H && H % 2 == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float2 w =
          __ldg(reinterpret_cast<const float2*>(W + (k + u) * H + o0));
      c[u][0] = w.x;
      c[u][1] = w.y;
    }
  } else if (LAYOUT == XD_W_H && H % 2 == 0 && U % 2 == 0) {
#pragma unroll
    for (int r = 0; r < XD_DR; ++r) {
#pragma unroll
      for (int u = 0; u < U; u += 2) {
        const float2 w = __ldg(
            reinterpret_cast<const float2*>(W + (o0 + r) * H + k + u));
        c[u][r] = w.x;
        c[u + 1][r] = w.y;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < XD_DR; ++r) {
        const int o = min(o0 + r, H - 1);
        c[u][r] = __ldg(W + (LAYOUT == XD_WT_H ? (k + u) * H + o
                             : o * (LAYOUT == XD_W_H ? H : K) + k + u));
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

// out[o][p] = epilogue(sum_{k < K} W(o, k) in[k][p]) for o < XD_H and the
// tile's P points (K = F for XD_W_F, else H). Epilogues: + b[o] (then
// relu), or keep the sum where mask[o][p] > 0. The input loop takes XD_KU
// inputs a step (their loads first), and is not unrolled further.
template <int EPI, int LAYOUT>
__device__ __forceinline__ void xd_dense(float* out,
                                         const float* __restrict__ W,
                                         const float* __restrict__ b,
                                         const float* in, const float* mask,
                                         int K, int P, int S) {
  constexpr int H = XD_H, R = XD_DR, NRB = (H + R - 1) / R;
  if (LAYOUT != XD_W_F) K = H;
  const int npb = P / XD_DC;
  for (int t = threadIdx.x; t < NRB * npb; t += blockDim.x) {
    const int rb = t / npb, p0 = (t - rb * npb) * XD_DC, o0 = rb * R;
    float s[R][XD_DC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < XD_DC; ++c) s[r][c] = 0.f;
    const float* x = in + p0;
    int k = 0;
#pragma unroll 1
    for (; k + XD_KU <= K; k += XD_KU) {
      float4 v[XD_KU];
      float c[XD_KU][R];
#pragma unroll
      for (int u = 0; u < XD_KU; ++u)
        v[u] = *reinterpret_cast<const float4*>(x + (k + u) * S);
      xd_weights<LAYOUT, XD_KU>(c, W, o0, k, K);
      xd_fma<XD_KU>(s, c, v);
    }
#pragma unroll 1
    for (; k < K; ++k) {
      float4 v[1] = {*reinterpret_cast<const float4*>(x + k * S)};
      float c[1][R];
      xd_weights<LAYOUT, 1>(c, W, o0, k, K);
      xd_fma<1>(s, c, v);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      if (o >= H) continue;
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

// acc[j * K + k] += sum_p X[j][p] Y[k][p] for j < XD_H, k < K over the
// tile's P points in order; with BIAS also accb[j] += sum_p X[j][p] (by
// the owners of column block 0).
template <bool BIAS>
__device__ __forceinline__ void xd_outer(float* acc, float* accb,
                                         const float* X, const float* Y,
                                         int K, int P, int S) {
  constexpr int H = XD_H, R = XD_OR, C = XD_OC, NJB = (H + R - 1) / R;
  const int nkb = (K + C - 1) / C;
  for (int t = threadIdx.x; t < NJB * nkb; t += blockDim.x) {
    const int jb = t / nkb, kb = t - jb * nkb;
    const float* x[R];
    const float* y[C];
    float s[R][C], sb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = X + min(jb * R + r, H - 1) * S;  // past the edge: not stored
      sb[r] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = Y + min(kb * C + c, K - 1) * S;
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 xv[R], yv[C];
#pragma unroll
      for (int r = 0; r < R; ++r)
        xv[r] = *reinterpret_cast<const float4*>(x[r] + p);
#pragma unroll
      for (int c = 0; c < C; ++c)
        yv[c] = *reinterpret_cast<const float4*>(y[c] + p);
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

__global__ void __launch_bounds__(XD_BWD_THREADS, 1)
disc_bwd_kernel(const float* __restrict__ params, int n_params,
                const float* __restrict__ feats,  // [M, F]
                const float* __restrict__ vb,     // [M]
                const float* __restrict__ gb,     // [M, F]
                float* __restrict__ partial,      // [gridDim.x, n_params]
                int M, int F, int L, int tied, int P) {
  constexpr int H = XD_H;
  extern __shared__ float4 sw4[];
  const int S = xd_bwd_stride(P);
  const int HS = H * S;
  float* const A = reinterpret_cast<float*>(sw4);  // A_0..A_L, each [H][S]
  float* const G = A + (L + 1) * HS;               // G_0..G_L
  float* const T0 = G + (L + 1) * HS;              // two cotangent buffers
  float* const T1 = T0 + HS;
  float* const Z = T1 + HS;                        // [F][S]
  float* const GB = Z + F * S;                     // [F][S]
  float* const VB = GB + F * S;                    // [S]
  float* const acc = VB + S;                       // [n_params]
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) acc[i] = 0.f;

  const float* W0 = params;
  const float* b0 = params + H * F;
  const int oo = xd_out_off(F, H, L, tied);
  const float* wo = params + oo;
  float* const Y = A + L * HS;  // a_L, then y = tanh(a_L)
  const int n_tiles = (M + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * P;
    float* cur = T0;
    float* nxt = T1;
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

    // 1. forward: A_i = relu(a_i) for i < L, A_L = a_L
    xd_dense<XD_BIAS_RELU, XD_W_F>(A, W0, b0, Z, nullptr, F, P, S);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const float* W = params + xd_hidden_off(F, H, i, tied);
      if (i + 1 < L)
        xd_dense<XD_BIAS_RELU, XD_W_H>(A + (i + 1) * HS, W, W + H * H,
                                       A + i * HS, nullptr, H, P, S);
      else
        xd_dense<XD_BIAS, XD_W_H>(Y, W, W + H * H, A + i * HS, nullptr, H, P,
                                  S);
      __syncthreads();
    }
    // 2. sweep: y = tanh(a_L), G_L = w_o (1 - y^2),
    // G_i = [a_i > 0] (W_h^T G_{i+1})
    for (int idx = threadIdx.x; idx < H * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float y = tanhf(Y[j * S + p]);
      Y[j * S + p] = y;
      G[L * HS + j * S + p] = __ldg(wo + j) * (1.f - y * y);
    }
    __syncthreads();
    for (int i = L - 1; i >= 0; --i) {
      xd_dense<XD_MASK, XD_WT_H>(G + i * HS,
                                 params + xd_hidden_off(F, H, i, tied),
                                 nullptr, G + (i + 1) * HS, A + i * HS, H, P,
                                 S);
      __syncthreads();
    }
    // 3. the sweep's reverse: tbar_0 = [a_0 > 0] (W0 gb), dW0 += g_0 gb^T;
    // then per layer dW_h += g_{i+1} tbar_i^T and tbar_{i+1} = [a_{i+1} >
    // 0] (W_h tbar_i), unmasked at the last layer: gbar_L
    xd_dense<XD_MASK, XD_W_F>(cur, W0, nullptr, GB, A, F, P, S);
    xd_outer<false>(acc, nullptr, G, GB, F, P, S);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const int off = xd_hidden_off(F, H, i, tied);
      xd_outer<false>(acc + off, nullptr, G + (i + 1) * HS, cur, H, P, S);
      if (i + 1 < L)
        xd_dense<XD_MASK, XD_W_H>(nxt, params + off, nullptr, cur,
                                  A + (i + 1) * HS, H, P, S);
      else
        xd_dense<XD_NONE, XD_W_H>(nxt, params + off, nullptr, cur, nullptr,
                                  H, P, S);
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
      xd_outer<true>(acc + off, acc + off + H * H, cur, A + i * HS, H, P, S);
      xd_dense<XD_MASK, XD_WT_H>(nxt, params + off, nullptr, cur, A + i * HS,
                                 H, P, S);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    xd_outer<true>(acc, acc + H * F, cur, Z, F, P, S);
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

// Bytes of shared memory a block asks for (disc_train.py's bwd_smem_bytes
// is its twin; chip_smoke.py holds the two together).
extern "C" long long disc_bwd_smem_bytes(int F, int H, int L, int tied,
                                         int tile) {
  return (long long)xd_bwd_smem(F, H, L, xd_n_params(F, H, L, tied), tile);
}

// tile: points per tile (a multiple of 4, at most 32); blocks: the grid of
// XD_BWD_THREADS-thread blocks, one partial row each (partial holds blocks
// x n_params floats).
// params must sit on 8 bytes (xd_weights' paired loads).
extern "C" int disc_bwd_launch(int device, void* stream, const float* params,
                               int n_params, const float* feats,
                               const float* vb, const float* gb,
                               float* partial, float* grad, int M, int F,
                               int H, int L, int tied, int tile,
                               int blocks) {
  if (M < 0 || H != XD_H || !xd_caps_ok(F, H, L, tied, n_params) ||
      reinterpret_cast<size_t>(params) % 8 != 0 ||
      tile < 4 || tile > 32 || tile % 4 != 0 || blocks < 1)
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
      params, n_params, feats, vb, gb, partial, M, F, L, tied, tile);
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
