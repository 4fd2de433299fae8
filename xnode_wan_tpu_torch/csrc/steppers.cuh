// Device-side XNODE network and fixed-step RK stepper of the path-forward
// kernels (xnode_fwd.cu: serving #1 and the metric #2). Device twin of
// ops/kernels/steppers.py and of the JAX package's
// ops/pallas/steppers.py::rk_step. The training kernels (xnode_grad.cu)
// take only the method ids and the weight packing; the adversary's forward
// (disc_fwd.cu) the column staging and the per-thread layer helpers.
//
// Packing in global memory (FlatNet.packed), for every layer in the order
// lift..., field..., readout: W [out, in] row-major, then b [out].
//
// One thread integrates one path. The widths H (hidden state) and Hh
// (field) are template parameters, so every per-thread array has a
// compile-time size and is touched only by fully unrolled loops: ptxas
// keeps them in registers. The depths (n_lift, n_field), the feature
// width F and the method stay runtime values.
//
// A block stages the weights in shared memory once (xn_stage), by columns
// at a stride rounded up to four floats, so a thread reads four weights
// with one 16-byte load; every thread of a warp reads the same address at
// the same time, a broadcast. The feature columns of field layer 0 are
// applied once per path (xn_field_const) and are not staged, so the
// feature width F has no cap: no array and no staged byte depends on it.
#pragma once

#include <cuda_runtime.h>

#define XN_MAX_WIDTH 64      // cap on H (hidden state) and Hh (field width)
#define XN_MAX_SMEM 232448   // shared memory one block may use on Hopper
#define XN_FEAT_CHUNK 32     // features a chunk of xn_field_const's pass

// Order matches FUSED_KERNEL_METHODS in ops/kernels/steppers.py.
enum XnMethod { XN_EULER = 0, XN_MIDPOINT = 1, XN_HEUN = 2, XN_RK4 = 3 };

__host__ __device__ inline int xn_n_params(int H, int Hh, int F, int n_lift,
                                           int n_field) {
  const int fin = F + 1 + H;
  return (H + H) + (n_lift - 1) * (H * H + H)              // lift
         + (fin * Hh + Hh) + (n_field - 2) * (Hh * Hh + Hh)  // field
         + (Hh * H + H)                                      // field out
         + (H + 1);                                          // readout
}

__host__ inline bool xn_caps_ok(int H, int Hh, int F, int n_lift,
                                int n_field) {
  return H >= 1 && Hh >= 1 && F >= 0 && n_lift >= 1 && n_field >= 2 &&
         H <= XN_MAX_WIDTH && Hh <= XN_MAX_WIDTH;
}

// ---------------------------------------------------------------------------
// The staged copy in shared memory. Twin: ops/kernels/steppers.py
// staged_floats. A layer W [out, in], b [out] is stored by columns: column
// i (the weights of input i) at stride pad4(out), then b padded to
// pad4(out); every segment starts on 16 bytes. In order: lift 0 <H, 1>,
// lift l <H, H> (n_lift - 1 times), field 0 <Hh, 1 + H> (its time and h
// columns; the feature columns stay in global memory), field hidden
// <Hh, Hh> (n_field - 2 times), field out <H, Hh>, readout <1, H>.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int xn_pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr int xn_staged_layer(int out, int in) {
  return (in + 1) * xn_pad4(out);
}

__host__ __device__ inline int xn_staged_floats(int H, int Hh, int n_lift,
                                                int n_field) {
  return xn_staged_layer(H, 1) + (n_lift - 1) * xn_staged_layer(H, H) +
         xn_staged_layer(Hh, 1 + H) + (n_field - 2) * xn_staged_layer(Hh, Hh) +
         xn_staged_layer(H, Hh) + xn_staged_layer(1, H);
}

// Stage one layer: W [OUT, IN] at `w` with rows `ws` apart, b [OUT] at `b`.
template <int OUT, int IN>
__device__ __forceinline__ void xn_stage_layer(float* dst,
                                               const float* __restrict__ w,
                                               int ws,
                                               const float* __restrict__ b) {
  constexpr int SO = xn_pad4(OUT), NW = OUT * IN;
#pragma unroll 4
  for (int i = threadIdx.x; i < NW + OUT; i += blockDim.x) {
    if (i < NW) {
      const int r = i / IN, c = i - r * IN;
      dst[c * SO + r] = __ldg(w + r * ws + c);
    } else {
      dst[IN * SO + (i - NW)] = __ldg(b + (i - NW));
    }
  }
}

// Stage the whole net (whole block, ends in a barrier).
template <int H, int Hh>
__device__ void xn_stage(float* sw, const float* __restrict__ params, int F,
                         int n_lift, int n_field) {
  const float* src = params;
  float* dst = sw;
  xn_stage_layer<H, 1>(dst, src, 1, src + H);
  dst += xn_staged_layer(H, 1);
  src += 2 * H;
  for (int l = 1; l < n_lift; ++l) {
    xn_stage_layer<H, H>(dst, src, H, src + H * H);
    dst += xn_staged_layer(H, H);
    src += H * H + H;
  }
  const int fin = F + 1 + H;  // field layer 0: rows [feats, t, h]
  xn_stage_layer<Hh, 1 + H>(dst, src + F, fin, src + Hh * fin);
  dst += xn_staged_layer(Hh, 1 + H);
  src += Hh * fin + Hh;
  for (int l = 0; l < n_field - 2; ++l) {
    xn_stage_layer<Hh, Hh>(dst, src, Hh, src + Hh * Hh);
    dst += xn_staged_layer(Hh, Hh);
    src += Hh * Hh + Hh;
  }
  xn_stage_layer<H, Hh>(dst, src, Hh, src + H * Hh);
  dst += xn_staged_layer(H, Hh);
  src += Hh * H + H;
  xn_stage_layer<1, H>(dst, src, H, src + H);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The per-thread network over the staged copy. Each 16-byte broadcast load
// of a column feeds four independent accumulators; each output still sums
// its inputs in their order, then adds its bias.
// ---------------------------------------------------------------------------

// The staged weights' base as the compiler must re-read it at every call:
// their addresses do not change along a path, so without this the loads of
// field layer 0, the field's out layer and the readout would be hoisted out
// of the step loops and some 500 weights held in registers, which spills.
__device__ __forceinline__ const float* xn_opaque(const float* p) {
  int off = 0;
  asm volatile("" : "+r"(off));
  return p + off;
}

// N floats of a staged segment (16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void xn_load(const float* src, float (&v)[N]) {
  const float4* q4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < xn_pad4(N) / 4; ++q) {
    const float4 w = q4[q];
    v[4 * q] = w.x;
    if (4 * q + 1 < N) v[4 * q + 1] = w.y;
    if (4 * q + 2 < N) v[4 * q + 2] = w.z;
    if (4 * q + 3 < N) v[4 * q + 3] = w.w;
  }
}

// y[j] += col[j] * x for one staged column (16-byte aligned).
template <int N>
__device__ __forceinline__ void xn_axpy(const float* col, float x,
                                        float (&y)[N]) {
  float w[N];
  xn_load<N>(col, w);
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = fmaf(w[j], x, y[j]);
}

// y += sum_i W[:, i] x[i] over a staged layer's columns, then y += b.
template <int OUT, int IN>
__device__ __forceinline__ void xn_layer_acc(const float* W,
                                             const float (&x)[IN],
                                             float (&y)[OUT]) {
  constexpr int SO = xn_pad4(OUT);
#pragma unroll
  for (int i = 0; i < IN; ++i) xn_axpy<OUT>(W + i * SO, x[i], y);
  float b[OUT];
  xn_load<OUT>(W + IN * SO, b);
#pragma unroll
  for (int j = 0; j < OUT; ++j) y[j] = y[j] + b[j];
}

// y[j] = sum_i W[j, i] x[i] + b[j].
template <int OUT, int IN>
__device__ __forceinline__ void xn_dense(const float* W, const float (&x)[IN],
                                         float (&y)[OUT]) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) y[j] = 0.f;
  xn_layer_acc<OUT, IN>(W, x, y);
}

// Lift MLP: seed -> h [H]: linear, then [relu, linear] * (n_lift - 1).
template <int H>
__device__ __forceinline__ void xn_lift(const float* lw, int n_lift,
                                        float seed, float (&h)[H]) {
  const float x[1] = {seed};
  xn_dense<H, 1>(lw, x, h);
  const float* p = lw + xn_staged_layer(H, 1);
  float a[H];
#pragma unroll 1
  for (int l = 1; l < n_lift; ++l) {
#pragma unroll
    for (int i = 0; i < H; ++i) a[i] = fmaxf(h[i], 0.f);
    xn_dense<H, H>(p, a, h);
    p += xn_staged_layer(H, H);
  }
}

// Field layer 0 splits its input [feats, t, h]: the feats part is fixed
// along a path, so each thread computes c0 = W0[:, :F] feats once (W0 at
// `w0`, rows of F + 1 + H, in global memory). The block's T threads pass
// over the features in chunks of XN_FEAT_CHUNK through `scratch` in shared
// memory (before the weights are staged there): their T feature rows by
// coalesced reads into [T][stride] (stride odd, so a thread reading its
// own row hits its own bank), and W0's feature columns by columns at
// pad4(Hh) (a broadcast float4 feeds four accumulators). Each thread sums
// its features in order, as one thread reading its row did. Whole block
// (rows past N read as 0); ends in a barrier.
__host__ __device__ inline int xn_feat_stride(int F) {
  return (F < XN_FEAT_CHUNK ? F : XN_FEAT_CHUNK) | 1;
}

// Floats of the scratch of xn_field_const for T threads a block.
__host__ __device__ inline int xn_feat_floats(int T, int F, int Hh) {
  if (F == 0) return 0;
  const int fc = F < XN_FEAT_CHUNK ? F : XN_FEAT_CHUNK;
  return T * xn_feat_stride(F) + fc * xn_pad4(Hh);
}

template <int H, int Hh, int T>
__device__ __forceinline__ void xn_field_const(float* scratch,
                                               const float* __restrict__ w0,
                                               int F,
                                               const float* __restrict__ feats,
                                               int n_first, int N,
                                               float (&c0)[Hh]) {
  constexpr int SHh = xn_pad4(Hh);
  const int fin = F + 1 + H, ld = xn_feat_stride(F);
  float* sf = scratch;           // [T][ld]: the block's feature rows
  float* sw = scratch + T * ld;  // [chunk][SHh]: W0's feature columns
#pragma unroll
  for (int j = 0; j < Hh; ++j) c0[j] = 0.f;
  for (int i0 = 0; i0 < F; i0 += XN_FEAT_CHUNK) {
    const int fc = F - i0 < XN_FEAT_CHUNK ? F - i0 : XN_FEAT_CHUNK;
    if (i0 > 0) __syncthreads();
    for (int e = threadIdx.x; e < T * fc; e += T) {
      const int r = e / fc, i = e - r * fc;
      sf[r * ld + i] = n_first + r < N
                           ? __ldg(feats + (size_t)(n_first + r) * F + i0 + i)
                           : 0.f;
    }
    for (int e = threadIdx.x; e < Hh * fc; e += T) {
      const int j = e / fc, i = e - j * fc;
      sw[i * SHh + j] = __ldg(w0 + j * fin + i0 + i);
    }
    __syncthreads();
    const float* row = sf + threadIdx.x * ld;
    for (int i = 0; i < fc; ++i) xn_axpy<Hh>(sw + i * SHh, row[i], c0);
  }
  __syncthreads();
}

// ODE field F(x, t, h) -> dh/dt [H] from field layer 0's staged copy `fw`:
// linear, [relu, linear] * n_hidden, tanh, linear. Layer 0 starts from c0
// and takes the time column, then the h columns, then b0.
template <int H, int Hh>
__device__ __forceinline__ void xn_field(const float* fw, int n_hidden,
                                         const float (&c0)[Hh], float t,
                                         const float (&h)[H], float (&out)[H]) {
  constexpr int SHh = xn_pad4(Hh);
  fw = xn_opaque(fw);
  float a[Hh], b[Hh];
#pragma unroll
  for (int j = 0; j < Hh; ++j) a[j] = c0[j];
  xn_axpy<Hh>(fw, t, a);
  xn_layer_acc<Hh, H>(fw + SHh, h, a);
  const float* p = fw + xn_staged_layer(Hh, 1 + H);
#pragma unroll 1
  for (int l = 0; l < n_hidden; ++l) {
#pragma unroll
    for (int i = 0; i < Hh; ++i) b[i] = fmaxf(a[i], 0.f);
    xn_dense<Hh, Hh>(p, b, a);
    p += xn_staged_layer(Hh, Hh);
  }
#pragma unroll
  for (int i = 0; i < Hh; ++i) b[i] = tanhf(a[i]);
  xn_dense<H, Hh>(p, b, out);
}

template <int H>
__device__ __forceinline__ float xn_readout(const float* rw,
                                            const float (&h)[H]) {
  float u[1];
  xn_dense<1, H>(xn_opaque(rw), h, u);
  return u[0];
}

// One fixed step of `method` from state h at time t, in place, as a loop
// over the scheme's stages (one inlined field). Same arithmetic order as
// rk_step in ops/kernels/steppers.py: stage s > 0 evaluates the field at
// h + c k (k the previous stage) and t + c, with c = dt for heun and rk4's
// last stage and dt / 2 otherwise.
template <int H, int Hh>
__device__ __forceinline__ void xn_rk_step(const float* fw, int n_hidden,
                                           int method, const float (&c0)[Hh],
                                           float t, float dt, float (&h)[H]) {
  const float hdt = 0.5f * dt;
  const int n_stages = method == XN_EULER ? 1 : method == XN_RK4 ? 4 : 2;
  float k[H], y[H], acc[H];
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    float ts = t;
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < H; ++j) y[j] = h[j];
    } else {
      const float c = (method == XN_HEUN || s == 3) ? dt : hdt;
      ts = t + c;
#pragma unroll
      for (int j = 0; j < H; ++j) y[j] = h[j] + c * k[j];
    }
    xn_field<H, Hh>(fw, n_hidden, c0, ts, y, k);
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = k[j];
    } else if (method == XN_RK4 && s < 3) {  // heun's acc stays k1
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = acc[j] + 2.f * k[j];
    }
  }
  switch (method) {
    case XN_HEUN:
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = h[j] + hdt * (acc[j] + k[j]);
      break;
    case XN_RK4:
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = h[j] + dt * (acc[j] + k[j]) / 6.f;
      break;
    default:  // euler, midpoint: the last stage's slope
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = h[j] + dt * k[j];
      break;
  }
}

extern "C" const char* xn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
