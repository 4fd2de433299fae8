// Adversary kernel #6: the discriminator's value and its input gradient,
// the forward of ops/kernels/disc_train.py :: VDvFused. It replaces, in the
// JAX package's ops/pallas/disc_train.py,
//
//   #6 _v_fwd_kernel -> disc_fwd_launch  (v [M], gin [M, F])
//
// This is #6's register variant, for adversaries up to 64 wide whose staged
// copy fits a block; disc_train.cu's disc_tile_fwd_launch takes every other
// net the JAX package's Pallas kernels take (ops/kernels/disc_train.py ::
// disc_route).
//
// Network and packing: disc_net.cuh. Built once per adversary width:
// nvcc -DXD_H=<H> (ops/kernels/_build.py), so the per-thread vector in
// registers has a compile-time size and is touched only by fully unrolled
// loops. The feature width F and the depth L stay runtime values.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (F = 6, H = 50, L = 9, tied, M = 80,000): 45,650
// multiply-adds a point (7.30 GFLOP, 0.109 ms) against 4.2 MB: bound by
// operations. No tensor cores: TF32 would break the f32 parity with the
// plain version at about 1e-3.
//
// Design: ONE THREAD PER POINT, over a block's staged copy of the weights
// in shared memory, laid out by columns as steppers.cuh lays out the
// XNODE's (xn_stage): column i of W [out, in] at a stride of out rounded up
// to four floats, then b. A thread reads four weights with one 16-byte
// load, the same address across the warp (a broadcast). Each layer's
// product runs as a loop over the columns that is not unrolled, with the
// one vector it writes in registers and the vector it reads in the
// thread's own slot of shared memory (H floats at a stride of the block,
// consecutive threads on consecutive banks):
//   - forward, a = W relu(a) + b: relu(a) goes to the slot, then column k
//     adds W[:, k] relu(a)[k] to the H accumulators (each 16-byte load
//     feeds four independent FMAs), then b;
//   - sweep, g = [a_i > 0] (W_h^T g): column k's dot product with g (four
//     lane sums, so four independent chains) goes to the slot, and the
//     masked slot is read back into g.
// Both vectors in registers, with the layer fully unrolled, spilled at
// both shipped widths (50, 64) at the register cap: ptxas hoisted the loads
// of later columns over the FMAs of earlier ones. The sweep needs the sign
// of every a_i as bits; L is a runtime value, so a register array of them
// would go to the stack: the sign words sit in shared memory too,
// [word][thread]. Layer 0
// is applied column by column, one feature read from global memory at a
// time, and gin[f] is written as it is formed, so no thread holds the
// features. Each output sums its inputs in order and adds its bias last,
// as the plain version does: a bias added first moved a few points'
// pre-activations across a relu kink, where gin then leaves the plain
// version's.
#include "disc_net.cuh"
#include "steppers.cuh"

#ifndef XD_H
#error "build with -DXD_H=<adversary width>"
#endif

// 80,000 points: 625 blocks
#define XD_FWD_THREADS 128

// Floats of the staged copy (twin: ops/kernels/disc_train.py ::
// staged_floats): layer 0 <H, F>, the hidden layer <H, H> once when tied
// or L times, the output layer <1, H>.
__host__ __device__ inline int xd_staged_floats(int F, int H, int L,
                                                int tied) {
  return xn_staged_layer(H, F) + (tied ? 1 : L) * xn_staged_layer(H, H) +
         xn_staged_layer(1, H);
}

__host__ __device__ constexpr int xd_sign_words(int H) {
  return (H + 31) / 32;
}

// Shared memory of one block (ops/kernels/disc_train.py :: fwd_smem_bytes):
// the staged copy, then each thread's sign words of the L relu layers and
// its slot of H floats.
__host__ inline size_t xd_fwd_smem(int F, int H, int L, int tied) {
  return sizeof(float) *
         ((size_t)xd_staged_floats(F, H, L, tied) +
          (size_t)(L * xd_sign_words(H) + H) * XD_FWD_THREADS);
}

// Stage one packed layer, W [OUT, in] row-major followed by b [OUT], by
// columns (whole block, no barrier).
template <int OUT>
__device__ __forceinline__ void xd_stage_layer(float* dst,
                                               const float* __restrict__ src,
                                               int in) {
  constexpr int SO = xn_pad4(OUT);
  const int nw = OUT * in;
  for (int i = threadIdx.x; i < nw + OUT; i += blockDim.x) {
    if (i < nw) {
      const int r = i / in, c = i - r * in;
      dst[c * SO + r] = __ldg(src + i);
    } else {
      dst[in * SO + (i - nw)] = __ldg(src + i);
    }
  }
}

// sum_j col[j] x[j] over a staged column: four lane sums, then their sum.
template <int N>
__device__ __forceinline__ float xd_dot(const float* col,
                                        const float (&x)[N]) {
  const float4* c = reinterpret_cast<const float4*>(col);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int q = 0; q < xn_pad4(N) / 4; ++q) {
    const float4 w = c[q];
    s0 = fmaf(w.x, x[4 * q], s0);
    if (4 * q + 1 < N) s1 = fmaf(w.y, x[4 * q + 1], s1);
    if (4 * q + 2 < N) s2 = fmaf(w.z, x[4 * q + 2], s2);
    if (4 * q + 3 < N) s3 = fmaf(w.w, x[4 * q + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// A minimum of one block lets ptxas use up to 255 registers (as for
// xnode_fwd.cu's kernels, which spilled without it).
__global__ void __launch_bounds__(XD_FWD_THREADS, 1)
disc_fwd_kernel(const float* __restrict__ params,
                const float* __restrict__ feats,  // [M, F]
                float* __restrict__ v,            // [M]
                float* __restrict__ gin,          // [M, F]
                int M, int F, int L, int tied) {
  constexpr int H = XD_H, SH = xn_pad4(H), NW = xd_sign_words(H);
  constexpr int T = XD_FWD_THREADS;
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  const int n_hidden = tied ? 1 : L;
  const int s0 = xn_staged_layer(H, F), sh = xn_staged_layer(H, H);
  float* const hw = sw + s0;
  float* const ow = hw + n_hidden * sh;
  xd_stage_layer<H>(sw, params, F);
  for (int l = 0; l < n_hidden; ++l)
    xd_stage_layer<H>(hw + l * sh, params + xd_hidden_off(F, H, l, tied), H);
  xd_stage_layer<1>(ow, params + xd_out_off(F, H, L, tied), H);
  __syncthreads();
  unsigned* signs =
      reinterpret_cast<unsigned*>(ow + xn_staged_layer(1, H)) + threadIdx.x;
  float* slot = reinterpret_cast<float*>(signs + L * NW * T);
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* z = feats + (size_t)m * F;

  // layer 0, one feature column at a time, then b0
  float a[H];
#pragma unroll
  for (int j = 0; j < H; ++j) a[j] = 0.f;
  const float* w0 = xn_opaque(sw);
#pragma unroll 1
  for (int f = 0; f < F; ++f) xn_axpy<H>(w0 + f * SH, z[f], a);
  xn_axpy<H>(w0 + F * SH, 1.f, a);

  // hidden layers, keeping the signs of each a_i
#pragma unroll 1
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      unsigned word = 0u;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (32 * q + b < H) word |= (unsigned)(a[32 * q + b] > 0.f) << b;
      signs[(i * NW + q) * T] = word;
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
      slot[k * T] = fmaxf(a[k], 0.f);
      a[k] = 0.f;
    }
    const float* W = xn_opaque(hw + (tied ? 0 : i) * sh);
#pragma unroll 1
    for (int k = 0; k < H; ++k) xn_axpy<H>(W + k * SH, slot[k * T], a);
    xn_axpy<H>(W + H * SH, 1.f, a);
  }

  // output: v = w_o . tanh(a_L) + b_o, and g_L = w_o (1 - y^2) into a
  const float* wo = xn_opaque(ow);
  float val = 0.f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float y = tanhf(a[j]), w = wo[4 * j];
    val = fmaf(w, y, val);
    a[j] = w * (1.f - y * y);
  }
  v[m] = val + wo[4 * H];

  // sweep: g_i = [a_i > 0] (W_h^T g_{i+1})
#pragma unroll 1
  for (int i = L - 1; i >= 0; --i) {
    const float* W = xn_opaque(hw + (tied ? 0 : i) * sh);
#pragma unroll 1
    for (int k = 0; k < H; ++k) slot[k * T] = xd_dot<H>(W + k * SH, a);
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const unsigned word = signs[(i * NW + q) * T];
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (32 * q + b < H)
          a[32 * q + b] = (word >> b) & 1u ? slot[(32 * q + b) * T] : 0.f;
    }
  }

  // gin = W0^T g_0, one column of W0 per feature
  float* out = gin + (size_t)m * F;
#pragma unroll 1
  for (int f = 0; f < F; ++f) out[f] = xd_dot<H>(w0 + f * SH, a);
}

// Floats of the staged copy at these widths (disc_train.py's staged_floats
// is its twin; chip_smoke.py holds the two together).
extern "C" int disc_fwd_staged_floats(int F, int H, int L, int tied) {
  return xd_staged_floats(F, H, L, tied);
}

extern "C" int disc_fwd_launch(int device, void* stream, const float* params,
                               int n_params, const float* feats, float* v,
                               float* gin, int M, int F, int H, int L,
                               int tied) {
  if (M < 0 || H != XD_H || !xd_caps_ok(F, H, L, tied, n_params))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = xd_fwd_smem(F, H, L, tied);
  e = xd_allow_smem((const void*)disc_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return 0;
  const int blocks = (M + XD_FWD_THREADS - 1) / XD_FWD_THREADS;
  disc_fwd_kernel<<<blocks, XD_FWD_THREADS, smem, (cudaStream_t)stream>>>(
      params, feats, v, gin, M, F, L, tied);
  return (int)cudaGetLastError();
}
