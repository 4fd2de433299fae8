// Tangentless XNODE path forward for nets the register kernel
// (xnode_fwd.cu) does not take: H or Hh above 64, or a staged weight copy
// above one block's shared memory. Two launchers, one kernel body:
//
// - xnode_serve_tile_launch (serving, #1): u at M points, one fresh path a
//   point from t_start, k_steps fixed RK steps of dt = (t - t_start) /
//   k_steps (the kServe mapping of xnode_fwd.cu). Replaces, for these nets,
//   the JAX package's ops/pallas/xnode_eval.py::_kernel; wrapper
//   ops/kernels/xnode_eval.py::_serve_tile.
// - xnode_path_tile_launch (the trainer's metric, #2): u at every sample
//   of N paths, L intervals of n_sub substeps, u written after each
//   interval; masked samples come with dt = 0 and leave the state as it
//   is, so no branch on the mask. Replaces, for these nets,
//   ops/pallas/xnode_train.py::_fwd_only_kernel; wrapper
//   ops/kernels/xnode_train.py::_path_tile_forward.
//
// Work (chip_smoke.py :: path_work counts it). A field evaluation costs a
// path (1 + H) Hh + (n_field - 2) Hh^2 + Hh H multiply-adds; field layer
// 0's feature columns, F Hh, once a path. At 128/128 on the cube's depth
// (9 field layers) that is about 148k multiply-adds an evaluation and 40
// evaluations a path (midpoint, 20 steps): #2 at N = 4,000 about 47 GFLOP
// (0.71 ms at 67 TFLOP/s FP32), #1 at 65,536 points about 776 GFLOP (11.6
// ms), against a few MB of inputs and weights: bound by FP32 operations.
//
// Design. A block owns a tile of P paths (rows: 16 to 128, a power of
// two; xnode_train.py :: path_tile picks it with the weight slice below)
// and walks them together, so that every layer is one product of the
// tile's rows against the layer's weights: a [P x in] by [in x out]
// product per layer and stage, instead of one thread per path carrying
// its state in registers (what caps the register kernel's widths). Every
// vector lives in shared memory, feature-major [width][S], S = P rounded
// up to a multiple of 4 whose quarter is odd. The products run on the FP32
// units in register micro-tiles: a warp owns 16 rows x 32 units, a thread
// 4 rows x 4 units (one float4 of activations and one float4 of weights a
// step feed 16 FMAs; the eight threads of a row group read one weight
// float4 each, the four row groups one activation float4 each, so a warp's
// two loads take one shared-memory wavefront each). Activations and the RK
// update are applied in the product's epilogue, in registers, before the
// next product reads them. The tensor cores are not used: a 3xTF32
// forward, tried in #5's cluster variant, left the plain version by
// 3.9e-4, past this kernel's f32 limit.
//
// Weights. A pre-pass (xnode_path_tile_stage_kernel) writes the field's
// weights once a launch into a staged copy in global memory, each product
// W^T [in][pad4(out)], zero-padded, so that any run of its columns is one
// contiguous, 16-byte aligned block. Where the whole copy fits beside the
// tile (slice = 0), a block copies it into shared memory once; otherwise it
// streams the field a slice at a time (slice inputs of one product, at most
// `slice`), two slots in turn, by 16-byte cp.async: the copy of the next
// slice runs while the tile multiplies the current one. A product split in
// several slices keeps its partial sums in its output buffer between them
// (the output layer in the stage-input buffer's state rows).
// The lift (once a path), the feature columns (once a tile) and the readout
// (once an interval, split over 256 / P threads a row and summed by warp
// shuffles in a fixed order) read their weights from global memory.
//
// Arithmetic order: each output sums its inputs slice by slice, each slice
// in input order, then adds the feature columns' sum and the bias; two
// launches at the same tile and slice are bitwise equal.
#include <cuda_pipeline.h>

#include "steppers.cuh"

#define XP_THREADS 256  // a block: eight warps, each a 16-row x 32-unit tile
#define XP_WARPS (XP_THREADS / 32)

// Row stride: P rounded up to a multiple of 4 whose quarter is odd.
__host__ __device__ inline int xp_stride(int P) {
  const int q = (P + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

// The field's products, in order: p = 0 field layer 0 (inputs: time, h),
// p = 1 .. n_field - 2 the hidden layers, p = n_field - 1 the output layer.
__host__ __device__ inline int xp_in(int p, int H, int Hh) {
  return p == 0 ? 1 + H : Hh;
}
__host__ __device__ inline int xp_out(int p, int H, int Hh, int n_field) {
  return p == n_field - 1 ? H : Hh;
}

// Float offset of product p's W^T [in][pad4(out)] in the staged copy, and
// the copy's size. Twin: ops/kernels/xnode_train.py ::
// path_tile_staged_floats.
__host__ __device__ inline int xp_woff(int p, int H, int Hh) {
  return p == 0 ? 0 : (1 + H) * xn_pad4(Hh) + (p - 1) * Hh * xn_pad4(Hh);
}
__host__ __device__ inline int xp_staged_floats(int H, int Hh, int n_field) {
  return xp_woff(n_field - 1, H, Hh) + Hh * xn_pad4(H);
}

// A product of `in` inputs in slices of at most KC inputs, all of one
// size (KC = 0: the whole product, the copy resident).
__host__ __device__ inline int xp_slices(int in, int KC) {
  return KC > 0 ? (in + KC - 1) / KC : 1;
}

__host__ __device__ inline bool xp_has_acc(int method) {
  return method == XN_HEUN || method == XN_RK4;
}

// Float offsets of one block's shared buffers. Twin:
// ops/kernels/xnode_train.py :: path_tile_smem_bytes; chip_smoke.py holds
// the two together through xnode_path_tile_smem_bytes.
struct XpLayout {
  int S;
  int w, slot;  // the weights: two slots of `slot` floats, or the copy
  int ht;       // [1 + H][S]: row 0 the substep's time, rows 1.. the state
  int y;        // [1 + H][S]: a later stage's time and input; the output
                // layer's partial sums between its slices
  int acc;      // [H][S]: the stages' sum (heun, rk4)
  int a, b;     // [Hh][S]: the field's activations, in turn
  int c0;       // [Hh][S]: field layer 0's feature columns, once a tile
  int t0, dt;   // [P]: the interval's start time and substep
  int total;
};

__host__ __device__ inline XpLayout xp_layout(int P, int KC, int H, int Hh,
                                              int n_field, int method) {
  XpLayout y;
  const int S = y.S = xp_stride(P);
  const int ld = xn_pad4(H) > xn_pad4(Hh) ? xn_pad4(H) : xn_pad4(Hh);
  int o = 0;
  y.w = o;
  y.slot = KC * ld;
  o += KC > 0 ? 2 * y.slot : xp_staged_floats(H, Hh, n_field);
  y.ht = o;  o += (1 + H) * S;
  y.y = o;   o += (1 + H) * S;
  y.acc = o; o += xp_has_acc(method) ? H * S : 0;
  y.a = o;   o += Hh * S;
  y.b = o;   o += Hh * S;
  y.c0 = o;  o += Hh * S;
  y.t0 = o;  o += xn_pad4(P);
  y.dt = o;  o += xn_pad4(P);
  y.total = o;
  return y;
}

// Offsets of the packed weights (steppers.cuh's packing).
struct XpNet {
  int H, Hh, F, fin, n_lift, n_field;
  int field_off, hid_off, out_off, readout_off;
};

__host__ __device__ inline XpNet xp_net(int H, int Hh, int F, int n_lift,
                                        int n_field) {
  XpNet n;
  n.H = H;
  n.Hh = Hh;
  n.F = F;
  n.fin = F + 1 + H;
  n.n_lift = n_lift;
  n.n_field = n_field;
  n.field_off = 2 * H + (n_lift - 1) * (H * H + H);
  n.hid_off = n.field_off + Hh * n.fin + Hh;
  n.out_off = n.hid_off + (n_field - 2) * (Hh * Hh + Hh);
  n.readout_off = n.out_off + H * Hh + H;
  return n;
}

// Weight (row u, column k of W [out][in]) and bias of product p in the
// packed buffer; field layer 0's columns are its time and h columns.
__host__ __device__ inline int xp_w_at(const XpNet& n, int p, int u, int k) {
  if (p == 0) return n.field_off + u * n.fin + n.F + k;
  if (p == n.n_field - 1) return n.out_off + u * n.Hh + k;
  return n.hid_off + (p - 1) * (n.Hh * n.Hh + n.Hh) + u * n.Hh + k;
}
__host__ __device__ inline int xp_b_at(const XpNet& n, int p) {
  if (p == 0) return n.field_off + n.Hh * n.fin;
  if (p == n.n_field - 1) return n.out_off + n.H * n.Hh;
  return n.hid_off + (p - 1) * (n.Hh * n.Hh + n.Hh) + n.Hh * n.Hh;
}

// The staged copy: staged[woff(p) + k pad4(out) + u] = W_p[u][k], zero for
// u >= out. One pass a launch, before the walk.
__global__ void xnode_path_tile_stage_kernel(const float* __restrict__ params,
                                             float* __restrict__ staged,
                                             int H, int Hh, int F, int n_lift,
                                             int n_field) {
  const XpNet n = xp_net(H, Hh, F, n_lift, n_field);
  const int total = xp_staged_floats(H, Hh, n_field);
  const int l0 = (1 + H) * xn_pad4(Hh), hid = Hh * xn_pad4(Hh);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int p, rel;
    if (i < l0) {
      p = 0;
      rel = i;
    } else if (i - l0 < (n_field - 2) * hid) {
      p = 1 + (i - l0) / hid;
      rel = (i - l0) % hid;
    } else {
      p = n_field - 1;
      rel = i - l0 - (n_field - 2) * hid;
    }
    const int out = xp_out(p, H, Hh, n_field), ld = xn_pad4(out);
    const int k = rel / ld, u = rel - k * ld;
    staged[i] = u < out ? __ldg(params + xp_w_at(n, p, u, k)) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The tile products. A warp takes warp tiles wt = warp, warp + 8, ... of a
// product `out` units wide: 32 units x 16 rows each; a thread 4 units (u0
// ..) x 4 rows (r0 ..), one float4 of rows per unit.
// ---------------------------------------------------------------------------

struct XpPlace {
  int u0, r0;
};

__device__ __forceinline__ XpPlace xp_place(int wt, int nu) {
  const int lane = threadIdx.x & 31;
  XpPlace t;
  t.u0 = (wt % nu) * 32 + (lane & 7) * 4;
  t.r0 = (wt / nu) * 16 + (lane >> 3) * 4;
  return t;
}

__device__ __forceinline__ float4 xp_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void xp_st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void xp_fma4(float4& a, float4 x, float w) {
  a.x = fmaf(x.x, w, a.x);
  a.y = fmaf(x.y, w, a.y);
  a.z = fmaf(x.z, w, a.z);
  a.w = fmaf(x.w, w, a.w);
}
__device__ __forceinline__ float4 xp_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 xp_add1(float4 a, float b) {
  return make_float4(a.x + b, a.y + b, a.z + b, a.w + b);
}
__device__ __forceinline__ float4 xp_relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}
__device__ __forceinline__ float4 xp_tanh4(float4 a) {
  return make_float4(tanhf(a.x), tanhf(a.y), tanhf(a.z), tanhf(a.w));
}

// a[j] += sum over the slice's kc inputs of X[k][r0..] W[k][u0 + j], X at
// the slice's first input, W its [kc][ld] columns. Unrolled by 8 (the
// tile sweep's ablation: faster than by 4, and fewer registers).
__device__ __forceinline__ void xp_slice_fma(float4 (&a)[4], const float* X,
                                             int S, const float* W, int ld,
                                             int kc, int r0, int u0) {
#pragma unroll 8
  for (int k = 0; k < kc; ++k) {
    const float4 x = xp_ld4(X + k * S + r0);
    const float4 w = xp_ld4(W + k * ld + u0);
    xp_fma4(a[0], x, w.x);
    xp_fma4(a[1], x, w.y);
    xp_fma4(a[2], x, w.z);
    xp_fma4(a[3], x, w.w);
  }
}

// The block's walk state: shared memory, its layout and the weight stream.
struct XpRun {
  float* sm;
  XpLayout y;
  const float* staged;
  int H, Hh, n_field, P, KC;
  int slot;  // the slot of the slice being multiplied (streamed)
};

// Queue the copy of slice c of product p into `slot`, 16 bytes a copy,
// and commit it (every thread commits one group).
__device__ __forceinline__ void xp_fetch(const XpRun& r, int p, int c,
                                         int slot) {
  const int in = xp_in(p, r.H, r.Hh);
  const int ld = xn_pad4(xp_out(p, r.H, r.Hh, r.n_field));
  const int nc = xp_slices(in, r.KC), kc = (in + nc - 1) / nc;
  const int k0 = c * kc, k1 = min(in, k0 + kc);
  const float* src = r.staged + xp_woff(p, r.H, r.Hh) + (size_t)k0 * ld;
  float* dst = r.sm + r.y.w + slot * r.y.slot;
  const int n4 = (k1 - k0) * ld / 4;
  for (int i = threadIdx.x; i < n4; i += XP_THREADS)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  __pipeline_commit();
}

// Product p of the field over the tile's rows, input X [in][S]: slice by
// slice (each begins with the wait for its copy and a barrier, then queues
// the next slice of the walk into the other slot), partial sums kept in
// `part` [out][S] between slices, and on the last slice epi(place, sums)
// for each of the thread's warp tiles (units u0 + j < out only are live).
template <class Epi>
__device__ __forceinline__ void xp_product(XpRun& r, int p, const float* X,
                                           float* part, Epi epi) {
  const int in = xp_in(p, r.H, r.Hh), out = xp_out(p, r.H, r.Hh, r.n_field);
  const int ld = xn_pad4(out), S = r.y.S;
  const int nc = xp_slices(in, r.KC), kc = (in + nc - 1) / nc;
  const int nu = (out + 31) / 32, nwt = nu * (r.P / 16);
  const int warp = threadIdx.x >> 5;
  for (int c = 0; c < nc; ++c) {
    __pipeline_wait_prior(0);
    __syncthreads();
    const float* W;
    if (r.KC > 0) {
      W = r.sm + r.y.w + r.slot * r.y.slot;
      const bool last = c + 1 == nc;
      xp_fetch(r, last ? (p + 1) % r.n_field : p, last ? 0 : c + 1,
               r.slot ^ 1);
      r.slot ^= 1;
    } else {
      W = r.sm + r.y.w + xp_woff(p, r.H, r.Hh);
    }
    const int k0 = c * kc, k1 = min(in, k0 + kc);
    for (int wt = warp; wt < nwt; wt += XP_WARPS) {
      const XpPlace t = xp_place(wt, nu);
      float4 a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      // a thread past `out` reads the slice's last units and stores nothing
      xp_slice_fma(a, X + k0 * S, S, W, ld, k1 - k0, t.r0,
                   t.u0 < ld ? t.u0 : ld - 4);
      if (c > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t.u0 + j < out)
            a[j] = xp_add4(xp_ld4(part + (t.u0 + j) * S + t.r0), a[j]);
      }
      if (c + 1 < nc) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t.u0 + j < out) xp_st4(part + (t.u0 + j) * S + t.r0, a[j]);
      } else {
        epi(t, a);
      }
    }
  }
}

// out[u][r] = b[u] + sum_k W[u ldw + k] act(X[k][r]) for u < n_out, every
// row of the tile; W and b in global memory (the lift).
__device__ __forceinline__ void xp_gdense(float* outb, int S,
                                          const float* __restrict__ W,
                                          int ldw,
                                          const float* __restrict__ b,
                                          int n_out, int n_in, const float* X,
                                          bool relu, int P) {
  const int nu = (n_out + 31) / 32, nwt = nu * (P / 16);
  for (int wt = threadIdx.x >> 5; wt < nwt; wt += XP_WARPS) {
    const XpPlace t = xp_place(wt, nu);
    float4 a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < n_in; ++k) {
      float4 x = xp_ld4(X + k * S + t.r0);
      if (relu) x = xp_relu4(x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.u0 + j < n_out)
          xp_fma4(a[j], x, __ldg(W + (size_t)(t.u0 + j) * ldw + k));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t.u0 + j < n_out)
        xp_st4(outb + (t.u0 + j) * S + t.r0, xp_add1(a[j], __ldg(b + t.u0 + j)));
  }
}

// C0[u][r] = sum_i W0[u][i] feats[n0 + r][i], i < F (field layer 0's
// feature columns), from global memory, once a tile; 0 past N.
__device__ __forceinline__ void xp_feat_const(float* C0, int S,
                                              const float* __restrict__ W0,
                                              int fin, int F, int Hh,
                                              const float* __restrict__ feats,
                                              int n0, int live, int P) {
  const int nu = (Hh + 31) / 32, nwt = nu * (P / 16);
  for (int wt = threadIdx.x >> 5; wt < nwt; wt += XP_WARPS) {
    const XpPlace t = xp_place(wt, nu);
    float4 a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < F; ++i) {
      float xr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xr[q] = t.r0 + q < live
                    ? __ldg(feats + (size_t)(n0 + t.r0 + q) * F + i)
                    : 0.f;
      const float4 x = make_float4(xr[0], xr[1], xr[2], xr[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.u0 + j < Hh)
          xp_fma4(a[j], x, __ldg(W0 + (size_t)(t.u0 + j) * fin + i));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t.u0 + j < Hh) xp_st4(C0 + (t.u0 + j) * S + t.r0, a[j]);
  }
}

// u = wr . h + br for every live row, XP_THREADS / P threads a row, each
// summing every (XP_THREADS / P)-th unit, then xor shuffles in a fixed
// order; written at out[(n0 + r) L + l].
__device__ __forceinline__ void xp_readout(const float* HT, int S,
                                           const float* __restrict__ wr,
                                           float br, int H, int P,
                                           float* __restrict__ out, int n0,
                                           int live, int L, int l) {
  const int tpr = XP_THREADS / P;
  const int r = threadIdx.x / tpr, q = threadIdx.x - r * tpr;
  float s = 0.f;
  for (int u = q; u < H; u += tpr)
    s = fmaf(__ldg(wr + u), HT[(1 + u) * S + r], s);
  for (int o = tpr / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (q == 0 && r < live) out[(size_t)(n0 + r) * L + l] = s + br;
}

struct XpArgs {
  const float* params;  // packed weights
  const float* staged;  // the staged copy (xnode_path_tile_stage_kernel)
  const float* feats;   // [N, F]
  const float* ta;      // kServe: t [M]; else t0 [N, L]
  const float* tb;      // kServe: t_start [M]; else dt [N, L] (a substep)
  const float* seed;    // [N]
  float* out;           // [N, L]
  int N, L, H, Hh, F, n_lift, n_field, n_steps, method, P, KC;
};

template <bool kServe>
__global__ void __launch_bounds__(XP_THREADS, 1)
xnode_path_tile_kernel(const XpArgs g) {
  extern __shared__ float4 xp_sm4[];
  XpRun r;
  r.sm = reinterpret_cast<float*>(xp_sm4);
  r.y = xp_layout(g.P, g.KC, g.H, g.Hh, g.n_field, g.method);
  r.staged = g.staged;
  r.H = g.H;
  r.Hh = g.Hh;
  r.n_field = g.n_field;
  r.P = g.P;
  r.KC = g.KC;
  r.slot = 0;
  const int H = g.H, Hh = g.Hh, P = g.P, S = r.y.S, L = kServe ? 1 : g.L;
  const XpNet net = xp_net(H, Hh, g.F, g.n_lift, g.n_field);
  float* HT = r.sm + r.y.ht;
  float* Y = r.sm + r.y.y;
  float* ACC = r.sm + r.y.acc;
  float* const A = r.sm + r.y.a;  // product p writes A (p even) or B
  float* const B = r.sm + r.y.b;
  float* C0 = r.sm + r.y.c0;
  float* T0 = r.sm + r.y.t0;
  float* DT = r.sm + r.y.dt;
  const int n0 = blockIdx.x * P;
  const int live = min(P, g.N - n0);
  const int tid = threadIdx.x;

  // the weights' first slice, or the whole copy, in flight during the lift
  if (g.KC > 0) {
    xp_fetch(r, 0, 0, 0);
  } else {
    const int n4 = xp_staged_floats(H, Hh, g.n_field) / 4;
    for (int i = tid; i < n4; i += XP_THREADS)
      __pipeline_memcpy_async(r.sm + r.y.w + 4 * i, g.staged + 4 * i, 16);
    __pipeline_commit();
  }

  // the lift: seed -> h, linear, then [relu, linear] * (n_lift - 1), in
  // HT's and Y's state rows in turn so that it ends in HT's
  for (int i = tid; i < P; i += XP_THREADS)
    T0[i] = i < live ? g.seed[n0 + i] : 0.f;
  __syncthreads();
  float* cur = (g.n_lift - 1) % 2 == 0 ? HT + S : Y + S;
  float* nxt = (g.n_lift - 1) % 2 == 0 ? Y + S : HT + S;
  xp_gdense(cur, S, g.params, 1, g.params + H, H, 1, T0, false, P);
  const float* lw = g.params + 2 * H;
  for (int l = 1; l < g.n_lift; ++l) {
    __syncthreads();
    xp_gdense(nxt, S, lw, H, lw + H * H, H, H, cur, true, P);
    lw += H * H + H;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  xp_feat_const(C0, S, g.params + net.field_off, net.fin, g.F, Hh, g.feats,
                n0, live, P);
  __syncthreads();

  const int ns = g.method == XN_EULER ? 1 : g.method == XN_RK4 ? 4 : 2;
  const bool has_acc = xp_has_acc(g.method);
  const int nf = g.n_field;
  const float* b0 = g.params + xp_b_at(net, 0);
  const float* bo = g.params + xp_b_at(net, nf - 1);
  const float br = __ldg(g.params + net.readout_off + H);
  for (int l = 0; l < L; ++l) {
    if (tid < P) {
      float t0 = 0.f, d = 0.f;
      if (tid < live) {
        if (kServe) {
          t0 = g.tb[n0 + tid];
          d = (g.ta[n0 + tid] - t0) / (float)g.n_steps;
        } else {
          t0 = g.ta[(size_t)(n0 + tid) * L + l];
          d = g.tb[(size_t)(n0 + tid) * L + l];
        }
      }
      T0[tid] = t0;
      DT[tid] = d;
    }
#pragma unroll 1
    for (int k = 0; k < g.n_steps; ++k) {
      if (tid < P) HT[tid] = T0[tid] + (float)k * DT[tid];
#pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        // field layer 0: C0 + W0 [t, y] + b0, then relu (tanh if it is
        // the last hidden layer)
        xp_product(r, 0, s == 0 ? HT : Y, A,
                   [&](const XpPlace& t, float4 (&a)[4]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = t.u0 + j;
            if (u >= Hh) break;
            float4 v = xp_add1(
                xp_add4(a[j], xp_ld4(C0 + u * S + t.r0)), __ldg(b0 + u));
            v = nf > 2 ? xp_relu4(v) : xp_tanh4(v);
            xp_st4(A + u * S + t.r0, v);
          }
        });
#pragma unroll 1
        for (int p = 1; p < nf - 1; ++p) {
          const float* bp = g.params + xp_b_at(net, p);
          float* dst = p % 2 ? B : A;
          const bool last = p == nf - 2;
          xp_product(r, p, p % 2 ? A : B, dst,
                     [&](const XpPlace& t, float4 (&a)[4]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int u = t.u0 + j;
              if (u >= Hh) break;
              float4 v = xp_add1(a[j], __ldg(bp + u));
              v = last ? xp_tanh4(v) : xp_relu4(v);
              xp_st4(dst + u * S + t.r0, v);
            }
          });
        }
        // the output layer: the stage's slope, and the RK update of the
        // thread's (unit, row) entries (same order as steppers.cuh ::
        // xn_rk_step); its partial sums in Y's state rows, which field
        // layer 0 has read, each entry read back and overwritten by the
        // thread that owns it
        xp_product(r, nf - 1, nf % 2 ? B : A, Y + S,
                   [&](const XpPlace& t, float4 (&a)[4]) {
          const float4 t04 = xp_ld4(T0 + t.r0), dt4 = xp_ld4(DT + t.r0);
          const float tr[4] = {t04.x, t04.y, t04.z, t04.w};
          const float dr[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = t.u0 + j;
            if (u >= H) break;
            const float4 kv4 = xp_add1(a[j], __ldg(bo + u));
            const float kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
            const float4 h4 = xp_ld4(HT + (1 + u) * S + t.r0);
            const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
            float av[4] = {0.f, 0.f, 0.f, 0.f};
            if (has_acc && s > 0) {
              const float4 a4 = xp_ld4(ACC + u * S + t.r0);
              av[0] = a4.x;
              av[1] = a4.y;
              av[2] = a4.z;
              av[3] = a4.w;
            }
            float o[4], tn[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float dt = dr[q], hdt = 0.5f * dt;
              if (s == 0) av[q] = kv[q];
              else if (g.method == XN_RK4 && s < 3) av[q] = av[q] + 2.f * kv[q];
              if (s < ns - 1) {
                const float c = (g.method == XN_HEUN || s + 1 == 3) ? dt : hdt;
                o[q] = hv[q] + c * kv[q];
                tn[q] = (tr[q] + (float)k * dt) + c;
              } else if (g.method == XN_HEUN) {
                o[q] = hv[q] + hdt * (av[q] + kv[q]);
              } else if (g.method == XN_RK4) {
                o[q] = hv[q] + dt * (av[q] + kv[q]) / 6.f;
              } else {
                o[q] = hv[q] + dt * kv[q];
              }
            }
            if (has_acc && s < ns - 1)
              xp_st4(ACC + u * S + t.r0,
                     make_float4(av[0], av[1], av[2], av[3]));
            const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
            if (s < ns - 1) {
              xp_st4(Y + (1 + u) * S + t.r0, o4);
              if (u == 0)
                xp_st4(Y + t.r0, make_float4(tn[0], tn[1], tn[2], tn[3]));
            } else {
              xp_st4(HT + (1 + u) * S + t.r0, o4);
            }
          }
        });
      }
    }
    __syncthreads();
    xp_readout(HT, S, g.params + net.readout_off, br, H, P, g.out, n0, live,
               L, l);
  }
  __pipeline_wait_prior(0);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Floats of the staged copy the wrapper allocates (its twin:
// xnode_train.py :: path_tile_staged_floats).
extern "C" int xnode_path_tile_staged_floats(int H, int Hh, int n_field) {
  return xp_staged_floats(H, Hh, n_field);
}

// Shared bytes of one block at `rows` paths a tile and weight slices of
// `slice` inputs (0: the copy resident): what the launchers ask for.
extern "C" long long xnode_path_tile_smem_bytes(int rows, int slice, int H,
                                                int Hh, int n_field,
                                                int method) {
  return 4LL * xp_layout(rows, slice, H, Hh, n_field, method).total;
}

// The checks both launchers share; then the staging pass and the walk.
// rows: paths a tile (16 to XP_THREADS, a power of two); slice: inputs of
// a streamed weight slice, or 0 for the copy resident; both from
// xnode_train.py :: path_tile.
template <bool kServe>
static int xp_launch(int device, void* stream, const float* params,
                     int n_params, float* staged, const float* feats,
                     const float* ta, const float* tb, const float* seed,
                     float* out, int N, int L, int H, int Hh, int F,
                     int n_lift, int n_field, int n_steps, int method,
                     int rows, int slice) {
  if (N < 0 || L < 0 || n_steps < 1 || H < 1 || Hh < 1 || F < 0 ||
      n_lift < 1 || n_field < 2 || method < XN_EULER || method > XN_RK4 ||
      n_params != xn_n_params(H, Hh, F, n_lift, n_field) || rows < 16 ||
      rows > XP_THREADS || (rows & (rows - 1)) != 0 || slice < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      4 * (size_t)xp_layout(rows, slice, H, Hh, n_field, method).total;
  if (smem > XN_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(xnode_path_tile_kernel<kServe>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (N == 0 || L == 0) return 0;
  const int total = xp_staged_floats(H, Hh, n_field);
  const int sblocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  xnode_path_tile_stage_kernel<<<sblocks, 256, 0, (cudaStream_t)stream>>>(
      params, staged, H, Hh, F, n_lift, n_field);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  XpArgs g;
  g.params = params;
  g.staged = staged;
  g.feats = feats;
  g.ta = ta;
  g.tb = tb;
  g.seed = seed;
  g.out = out;
  g.N = N;
  g.L = L;
  g.H = H;
  g.Hh = Hh;
  g.F = F;
  g.n_lift = n_lift;
  g.n_field = n_field;
  g.n_steps = n_steps;
  g.method = method;
  g.P = rows;
  g.KC = slice;
  xnode_path_tile_kernel<kServe>
      <<<(N + rows - 1) / rows, XP_THREADS, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// #2: u [N, L] from t0 [N, L], dt [N, L] (a substep), n_sub substeps an
// interval. staged: xnode_path_tile_staged_floats(H, Hh, n_field) floats
// of scratch in global memory, 16-byte aligned.
extern "C" int xnode_path_tile_launch(int device, void* stream,
                                      const float* params, int n_params,
                                      float* staged, const float* t0,
                                      const float* dt, const float* feats,
                                      const float* seed, float* u, int N,
                                      int L, int H, int Hh, int F,
                                      int n_lift, int n_field, int n_sub,
                                      int method, int rows, int slice) {
  return xp_launch<false>(device, stream, params, n_params, staged, feats,
                          t0, dt, seed, u, N, L, H, Hh, F, n_lift, n_field,
                          n_sub, method, rows, slice);
}

// #1: out [M], each point one interval from t_start to t in k_steps steps.
extern "C" int xnode_serve_tile_launch(int device, void* stream,
                                       const float* params, int n_params,
                                       float* staged, const float* feats,
                                       const float* t, const float* t_start,
                                       const float* seed, float* out, int M,
                                       int H, int Hh, int F, int n_lift,
                                       int n_field, int k_steps, int method,
                                       int rows, int slice) {
  return xp_launch<true>(device, stream, params, n_params, staged, feats, t,
                         t_start, seed, out, M, 1, H, Hh, F, n_lift, n_field,
                         k_steps, method, rows, slice);
}
