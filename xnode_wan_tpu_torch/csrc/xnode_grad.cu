// Training kernels: the XNODE path forward with spatial tangents and its
// hand-derived backward, the custom VJP of ops/kernels/xnode_train.py ::
// u_du_fused. They replace, in the JAX package's ops/pallas/xnode_train.py,
//
//   #3 _fwd_kernel        -> xnode_udu_fwd_launch        (u, du)
//   #4 _fwd_store_kernel  -> xnode_udu_fwd_store_launch  (u, du, hs, hts)
//   #5 _bwd_kernel        -> xnode_udu_bwd_launch        (weight cotangents)
//                            xnode_udu_bwd_global_launch (the same, with the
//                            gradient accumulator in global memory)
//                            xnode_udu_bwd_cluster_launch (the same on
//                            thread-block clusters, the accumulator split
//                            over their blocks: xnode_grad_cluster.cuh)
//
// #1/#2 past the register kernel's caps run xnode_path_tile.cu. xg_checks
// takes d = 0, a tangentless launch of these kernels.
//
// Work (chip_smoke.py :: path_work counts it). A path carries 1 + d rows,
// its primal and its d tangents; a field evaluation costs a row H Hh +
// (nh - 1) Hh^2 + Hh H multiply-adds (nh = n_field - 1 hidden layers), the
// feature columns of field layer 0 F Hh once a path. #3/#4 do (1 + d) L
// n_sub stages field evaluations a path, #4 also writes the interval
// start states (L (1 + d) H floats a path); #5 recomputes each interval
// and walks it back, about 3x #3's operations, and reads those states. At
// the d=5 cube (N = 4,000, L = 20, midpoint, H = 20, Hh = 10, 9 field
// layers) #3 does about 2.2 GFLOP (~32 us at 67 TFLOP/s FP32) and #5 ~6.5
// GFLOP. All three are bound by operations. At these small tiles the
// instructions of the blocks an SM holds at once set their time, far
// above either bound: the tile sweep (tile_sweep.py) found the same tile
// slower with more threads a block, and a tile that leaves an SM room for
// two blocks (and its L1 cache room for the weights) faster than a larger
// one that fills it (xnode_train.py :: grad_tile takes that rule).
//
// What held the first design back (one thread per (path, direction)):
// every thread walked the whole chain serially (L intervals x stages field
// evaluations, ~89k dependent FMAs for #3/#4); #5 summed each of its ~2,100
// weight contributions per field VJP with five dependent __shfl_xor_sync;
// blocks of 64 (#3/#4) or 128 (#5) threads left about 5 warps on an SM;
// cap-sized per-thread arrays (24,608 bytes of stack in #5) lived in local
// memory; and the primal was recomputed by each of the d direction threads
// (1.67x the multiply-adds at d = 5). #5 took 17.8 ms, #3/#4 2.2 ms.
//
// Tile design. A block owns a TILE of P consecutive paths; its R = P (1 + d)
// ROWS are the P primal rows (row p) and the P d tangent rows (row P + p d +
// k), so the primal is computed once per path. Every vector of the network
// lives in shared memory, feature-major [width][S], the row stride S a
// multiple of 4 whose quarter is odd (float4 reads without bank
// conflicts). Each layer is a product over the tile's rows, split over the
// block's threads by (output unit, 4 consecutive rows read as one float4);
// a thread keeps each weight in a register across its rows. Activations
// are materialised by a pass of their own: relu masks a tangent row by the
// sign of its path's primal pre-activation, tanh scales it by the primal's
// 1 - y^2. The weights stay in device memory, read through the read-only
// cache (8.6 KB at d=5). No thread holds an array, and the launch bound
// names one block a minimum, so ptxas reports no stack for these kernels
// (with the bound alone it held them at 64 and 128 registers and spilled).
//
// Field layer 0 takes [feats, t, h]. The features are fixed along a path,
// so their columns are applied once a tile, into CF [Hh][S], straight from
// global memory (feats, dfeats), and no tile of #3/#4 or of #5's shared
// and global variants keeps a copy of them. #5 sums the layer-0 cotangent
// of every stage, substep and interval of the walk into one buffer GS
// [Hh][S] and adds (that sum) fe^T into the feature columns' gradient
// once, after the walk, reading fe from global memory again: at d = 100
// with F = 300 those columns were half of #5's multiply-adds, and the
// features' copy kept even one path of the full d out of a block.
// The cluster variant keeps its copy and a product a stage: its blocks own
// the feature columns by feature, so the sum would take all Hh units (more
// than 2s's 4-path tile leaves), and reading the features from global
// memory in every stage's product measured 13% slower at 2u.
//
// #3/#4: one tile per block; the lift, then L intervals of n_sub RK
// substeps through the RK table (stage inputs h + A_s dt k_{s-1}, end h +
// dt sum_s B_s k_s), u and du from each interval's end state. #4 writes each
// interval's start state: a tile's rows are contiguous in hs [L, N, H] and
// hts [L, N, d, H], so the stores coalesce. A schedule with the primal
// one layer ahead of the tangents (phase k: the primal rows of layer k and
// the tangent rows of layer k - 1, each activation and the RK update in a
// product's epilogue: 10 __syncthreads a stage at the cube's net for this
// body's 18) was measured and removed: its sums run in the same order and
// give these outputs bitwise, but it was as fast or slower at every d
// measured (5 to 100), in #5's recompute too.
//
// #5: a persistent grid: block b walks tiles b, b + G, ... in that order,
// from interval L-1 down to 0. Per interval it recomputes the stage inputs
// and the end state, keeping every stage's field activations, injects the
// readout cotangents, and walks each stage's field back: per layer the
// input cotangent as the transposed product W^T ab over the rows and the
// weight gradient Σ_rows ab_j z_i, where a tangent row's ab and z are the
// tangent cotangent and input, so one sum over all rows gives abar z^T +
// atbar zt^T. Each gradient entry has exactly one owner thread in a layer's
// phase, which adds the sum into the block's accumulator in shared memory:
// no shuffles, no atomics. The next interval's states, readout cotangents
// and times are copied into a staging buffer with cp.async (16-byte copies
// where H is a multiple of 4, 4-byte ones otherwise) while the tile walks
// the current one. Each block writes one partial row and
// xnode_udu_reduce_kernel sums the rows in a fixed order, so two launches
// give bitwise equal gradients.
//
// Where round4(n_params) floats of accumulator do not fit beside the rest of
// the block (H = Hh = 64 at d = 5: 185 KB), #5 runs on thread-block
// clusters (xnode_grad_cluster.cuh); where not even a block's share on an
// 8-block cluster fits (H = 64, Hh = 256 at d = 5: 1.9 MB), the GACC
// variant accumulates straight into the block's own row of `partial` in
// global memory: the same owner thread adds the same sums in the same
// order, and the __syncthreads that order the shared accumulator's phases
// also order these writes, so the result is bitwise that of the shared
// variant at the same tile, threads and grid.
//
// The shared and global variants use FP32 FMAs throughout. The cluster
// variant runs its VJP on the tensor cores with a 3xTF32 split, which stays
// within the kernel-against-plain limit (2e-4 of each tensor's largest
// value), and its forward recompute in FP32 FMAs. The tangent rows'
// products of #3/#4 (the primal rows kept in FP32, whose signs set the
// relu masks) and #5's VJP, run on the tensor cores the same way, were
// measured and dropped: neither was faster at any shape measured (the cube, d = 20, 50 and 100; level
// only at highdim_d20's #5), whose widths of 10 to 64 leave most of a 16
// x 8 x 8 tile padding.
//
// The tile helpers (xg_dense, xg_dense_t, xg_outer, xg_rowsum) do the jobs
// of #7's xd_tile_* in disc_train.cu, which could not serve here as they
// are: those take one point per thread and scalar reads on a stride of
// P + 1, where these take four rows a thread as one float4 (the step that
// cut #3/#4 from 0.76 to 0.62 ms in the tile sweep), add a bias or a time
// column on the primal rows only, and mask a tangent row by its path's
// primal row. #7's redesign is to move onto these, in a header of their
// own.
#include <cuda_pipeline.h>

#include "steppers.cuh"

#define XG_RPT 4            // rows per thread in a tile product: one float4
#define XG_MAX_THREADS 256  // launch bound; the wrapper's blocks stay under it
#define XG_MAX_SMEM 232448

// The four schemes as RK tables (ops/kernels/steppers.py :: RK_TABLES):
// stage s > 0 starts from h + A[s] dt k[s-1] at t + C[s] dt, and the step
// ends at h + dt sum_s B[s] k[s].
__constant__ int XG_STAGES[4] = {1, 2, 2, 4};
__constant__ float XG_C[4][4] = {
    {0.f}, {0.f, 0.5f}, {0.f, 1.f}, {0.f, 0.5f, 0.5f, 1.f}};
__constant__ float XG_A[4][4] = {
    {0.f}, {0.f, 0.5f}, {0.f, 1.f}, {0.f, 0.5f, 0.5f, 1.f}};
__constant__ float XG_B[4][4] = {{1.f},
                                 {0.f, 1.f},
                                 {0.5f, 0.5f},
                                 {1.f / 6.f, 2.f / 6.f, 2.f / 6.f, 1.f / 6.f}};

// Row stride: R rounded up to a multiple of 4 whose quarter is odd, so that
// float4 reads of one column by consecutive threads (consecutive rows) and
// of consecutive rows' columns (consecutive units) hit distinct banks.
__host__ __device__ inline int xg_stride(int R) {
  const int q = (R + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

__host__ __device__ inline int xg_round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline int xg_stages(int method) {
  return method == XN_EULER ? 1 : method == XN_RK4 ? 4 : 2;
}

// Float offsets of one block's shared buffers (ops/kernels/xnode_train.py
// :: tile_smem_bytes restates the total; chip_smoke.py holds the two
// together through xnode_udu_smem_bytes). Buffers are
// [width][S]; the primal row index of every row (R ints) follows `total`.
struct XgLayout {
  int S, R;
  int acc, gs, cf, sd, ub, t0, dt;    // acc: #5's shared accumulator (-1: GACC)
  int hs, hb, hb0, kb, yb;            // [H][S]: #5's start state, cotangents
  int st, ys, k, accu, he, hcur, fld;  // state, stage inputs, stage, sum, end
  int stage;                          // #5's cp.async staging (16-byte aligned)
  int total;
};

__host__ __device__ inline XgLayout xg_layout(bool bwd, bool gacc, int P,
                                              int d, int H, int Hh, int F,
                                              int n_lift, int n_field,
                                              int method, int n_params) {
  XgLayout y;
  y.R = P * (1 + d);
  const int S = y.S = xg_stride(y.R), ns = xg_stages(method);
  int o = 0;
  const bool shared_acc = bwd && !gacc;
  y.acc = shared_acc ? o : -1;
  o += shared_acc ? xg_round4(n_params) : 0;
  y.gs = bwd && F > 0 ? o : -1;
  o += bwd && F > 0 ? Hh * S : 0;
  y.cf = o;   o += Hh * S;
  y.sd = o;   o += S;
  y.ub = o;   o += bwd ? S : 0;
  y.t0 = o;   o += xg_round4(P);
  y.dt = o;   o += xg_round4(P);
  if (!bwd) {  // state, stage input, stage, stage sum; two field buffers
    y.st = o;   o += H * S;
    y.ys = o;   o += H * S;
    y.k = o;    o += H * S;
    y.accu = o; o += H * S;
    y.fld = o;  o += 2 * Hh * S;
    y.hs = y.hb = y.hb0 = y.kb = y.yb = y.he = y.hcur = y.stage = -1;
    y.total = o;
    return y;
  }
  y.hs = o;  o += H * S;
  y.hb = o;  o += H * S;
  y.hb0 = o; o += H * S;
  y.kb = o;  o += H * S;
  y.yb = o;  o += H * S;
  // the walk's buffers; after the walk the lift's reuse them
  const int main0 = o;
  y.ys = o;   o += (ns - 1) * H * S;
  y.k = o;    o += H * S;
  y.accu = o; o += H * S;
  y.he = o;   o += H * S;
  y.hcur = o; o += H * S;
  // per stage R_1..R_{nh-1}, AL, YT; then AS, AB1
  y.fld = o;  o += (ns * n_field + 2) * Hh * S;
  const int lift = main0 + (n_lift + 1) * H * S;
  if (lift > o) o = lift;
  y.st = -1;
  y.stage = o; o += y.R * H + y.R + 2 * P;
  y.total = o;
  return y;
}

__host__ inline size_t xg_smem_bytes(const XgLayout& y) {
  return sizeof(float) * (size_t)y.total + sizeof(int) * (size_t)y.R;
}

// The packed weights (device memory) and the net's shape; the packing is
// steppers.cuh's: lift, field, readout, each W [out, in] then b [out].
struct XgNet {
  const float* w;
  int H, Hh, F, fin, n_lift, n_field;
  int field_off, hid_off, out_off, readout_off;
};

__device__ __forceinline__ XgNet xg_net(const float* w, int H, int Hh, int F,
                                        int n_lift, int n_field) {
  XgNet n;
  n.w = w;
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

// The tile's shape, the same for every tile of a launch.
struct XgTile {
  int P, d, R, S;
  const int* prim;  // [R]: the primal row of each row
};

// The tile's sample times: t_p = (t0[p] + sub dt[p]) + c dt[p].
struct XgTime {
  const float* t0;
  const float* dt;
  float sub, c;
  __device__ __forceinline__ float at(int p) const {
    const float t = t0[p] + sub * dt[p];
    return t + c * dt[p];
  }
};

// The tile's features in global memory: row r's are feats[n0 + r] on a
// primal row, dfeats[n0 d + r - P] on a tangent row; none past N.
struct XgFeats {
  const float* __restrict__ feats;   // [N, F]
  const float* __restrict__ dfeats;  // [N, d, F]
  int F, n0, live;
  __device__ __forceinline__ const float* row(int r, const XgTile& g) const {
    if (r < g.P) return r < live ? feats + (size_t)(n0 + r) * F : nullptr;
    return r - g.P < live * g.d
               ? dfeats + ((size_t)n0 * g.d + (r - g.P)) * F
               : nullptr;
  }
};

// Calls body(a, b) for every a < n, b < m, the block's threads taking
// consecutive b: no division per element.
template <class Body>
__device__ __forceinline__ void xg_each(int n, int m, Body body) {
  const int bq = blockDim.x / m, br = blockDim.x - bq * m;
  int a = threadIdx.x / m, b = threadIdx.x - a * m;
  while (a < n) {
    body(a, b);
    b += br;
    a += bq;
    if (b >= m) {
      b -= m;
      ++a;
    }
  }
}

// ---------------------------------------------------------------------------
// Tile products and passes. Every thread of the block calls each of them;
// none synchronises: the caller puts a __syncthreads() between a pass and
// the next one that reads what it wrote.
// ---------------------------------------------------------------------------

// out[j][r] = sum_i W[j ldw + i] x[i][r], plus add[j][r] if given, plus on
// the primal rows bias[j] and tw[j ldw] t_p if given, plus out[j][r] if
// ACC; j < n_out, i < n_in. A thread takes XG_RPT consecutive rows of one
// output, reads them as one float4 and keeps each weight in a register
// across them.
template <bool ACC>
__device__ __forceinline__ void xg_dense(float* out,
                                         const float* __restrict__ W, int ldw,
                                         int n_out, int n_in, const float* x,
                                         const XgTile& g,
                                         const float* __restrict__ bias = nullptr,
                                         const float* add = nullptr,
                                         const float* __restrict__ tw = nullptr,
                                         XgTime tm = XgTime{}) {
  const int RC = (g.R + XG_RPT - 1) / XG_RPT, S = g.S, S4 = S / 4;
  xg_each(n_out, RC, [&](int j, int c) {
    const float* w = W + (size_t)j * ldw;
    const float4* xc = reinterpret_cast<const float4*>(x) + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_in; ++i) {
      const float wi = __ldg(w + i);
      const float4 v = xc[i * S4];
      s.x = fmaf(wi, v.x, s.x);
      s.y = fmaf(wi, v.y, s.y);
      s.z = fmaf(wi, v.z, s.z);
      s.w = fmaf(wi, v.w, s.w);
    }
    const float sv[XG_RPT] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int m = 0; m < XG_RPT; ++m) {
      const int r = c * XG_RPT + m;
      if (r < g.R) {
        float v = sv[m];
        if (add) v += add[j * S + r];
        if (r < g.P) {
          if (tw) v = fmaf(__ldg(tw + (size_t)j * ldw), tm.at(r), v);
          if (bias) v += __ldg(bias + j);
        }
        if (ACC) v += out[j * S + r];
        out[j * S + r] = v;
      }
    }
  });
}

// out[i][r] = sum_j W[j ldw + i] y[j][r] for i < n_out, j < n_in: the
// transposed product, zero where msk[i][prim r] <= 0 if msk is given.
__device__ __forceinline__ void xg_dense_t(float* out,
                                           const float* __restrict__ W,
                                           int ldw, int n_out, int n_in,
                                           const float* y, const XgTile& g,
                                           const float* msk = nullptr) {
  const int RC = (g.R + XG_RPT - 1) / XG_RPT, S = g.S, S4 = S / 4;
  xg_each(n_out, RC, [&](int i, int c) {
    const float4* yc = reinterpret_cast<const float4*>(y) + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < n_in; ++j) {
      const float wj = __ldg(W + (size_t)j * ldw + i);
      const float4 v = yc[j * S4];
      s.x = fmaf(wj, v.x, s.x);
      s.y = fmaf(wj, v.y, s.y);
      s.z = fmaf(wj, v.z, s.z);
      s.w = fmaf(wj, v.w, s.w);
    }
    const float sv[XG_RPT] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int m = 0; m < XG_RPT; ++m) {
      const int r = c * XG_RPT + m;
      if (r < g.R)
        out[i * S + r] =
            (msk == nullptr || msk[i * S + g.prim[r]] > 0.f) ? sv[m] : 0.f;
    }
  });
}

// relu of a pre-activation buffer: a primal row keeps a > 0, a tangent row
// its value where its path's primal a > 0.
__device__ __forceinline__ void xg_relu(float* out, const float* a, int n,
                                        const XgTile& g) {
  xg_each(n, g.R, [&](int i, int r) {
    out[i * g.S + r] = a[i * g.S + g.prim[r]] > 0.f ? a[i * g.S + r] : 0.f;
  });
}

// tanh of a pre-activation buffer: y = tanh(a) on a primal row, (1 - y^2)
// at on its tangent rows; one thread per (unit, path).
__device__ __forceinline__ void xg_tanh(float* out, const float* a, int n,
                                        const XgTile& g) {
  xg_each(n, g.P, [&](int i, int p) {
    const float* ai = a + i * g.S;
    float* oi = out + i * g.S;
    const float y = tanhf(ai[p]), s = 1.f - y * y;
    oi[p] = y;
    for (int k = 0, r = g.P + p * g.d; k < g.d; ++k, ++r) oi[r] = s * ai[r];
  });
}

// The cotangent of a from that of the tanh pass's output: s ytb on a
// tangent row, s yb - 2 y s sum_k at_k ytb_k on the primal (s = 1 - y^2).
__device__ __forceinline__ void xg_tanh_vjp(float* ab, const float* yb,
                                            const float* a, int n,
                                            const XgTile& g) {
  xg_each(n, g.P, [&](int i, int p) {
    const float* ai = a + i * g.S;
    const float* bi = yb + i * g.S;
    float* oi = ab + i * g.S;
    const float y = tanhf(ai[p]), s = 1.f - y * y;
    float c = 0.f;
    for (int k = 0, r = g.P + p * g.d; k < g.d; ++k, ++r) {
      c = fmaf(ai[r], bi[r], c);
      oi[r] = s * bi[r];
    }
    oi[p] = s * bi[p] - 2.f * y * s * c;
  });
}

// acc[j lda + i] += sum_{r < nr} X[j][r] Y[i][r] for j < nx, i < ny: each
// entry has one owner thread, which sums over the rows in a fixed order,
// four at a time (float4 reads) and the rest one by one.
__device__ __forceinline__ void xg_outer(float* acc, int lda, const float* X,
                                         int nx, const float* Y, int ny,
                                         int nr, int S) {
  const int n4 = nr / 4;
  xg_each(nx, ny, [&](int j, int i) {
    const float* x = X + j * S;
    const float* y = Y + i * S;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < n4; ++c) {
      const float4 a = x4[c], b = y4[c];
      s.x = fmaf(a.x, b.x, s.x);
      s.y = fmaf(a.y, b.y, s.y);
      s.z = fmaf(a.z, b.z, s.z);
      s.w = fmaf(a.w, b.w, s.w);
    }
    for (int r = 4 * n4; r < nr; ++r) s.x = fmaf(x[r], y[r], s.x);
    acc[j * lda + i] += (s.x + s.y) + (s.z + s.w);
  });
}

// acc[j] += sum over the primal rows of X[j][p] (a bias gradient).
__device__ __forceinline__ void xg_rowsum(float* acc, const float* X, int n,
                                          const XgTile& g) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < g.P; ++p) s += X[j * g.S + p];
    acc[j] += s;
  }
}

// acc[j lda] += sum over the primal rows of X[j][p] t_p (the time column).
__device__ __forceinline__ void xg_time(float* acc, int lda, const float* X,
                                        int n, XgTime tm, const XgTile& g) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < g.P; ++p) s = fmaf(X[j * g.S + p], tm.at(p), s);
    acc[j * lda] += s;
  }
}

// CF[j][r] = sum_{i < F} w0[j fin + i] fe(r, i) for j < n: field layer 0's
// feature columns (rows of w0 fin floats apart) applied to every row's
// features, read from global memory, the sum in index order; 0 on the rows
// of paths past N.
__device__ __forceinline__ void xg_feat_cf(float* CF,
                                           const float* __restrict__ w0,
                                           int fin, int n, const XgFeats& fe,
                                           const XgTile& g) {
  xg_each(n, g.R, [&](int j, int r) {
    const float* x = fe.row(r, g);
    const float* w = w0 + (size_t)j * fin;
    float s = 0.f;
    if (x != nullptr)
      for (int i = 0; i < fe.F; ++i) s = fmaf(__ldg(w + i), __ldg(x + i), s);
    CF[j * g.S + r] = s;
  });
}

// acc[j lda + i] += sum over the tile's rows r of GS[j][r] fe(r, i) for
// j < n, i < F: the feature columns' gradient from the walk's summed
// layer-0 cotangent. One owner thread an entry, consecutive threads
// consecutive features (coalesced reads), four partial sums over the rows
// in a fixed order.
__device__ __forceinline__ void xg_feat_grad(float* acc, int lda,
                                             const float* GS, int n,
                                             const XgFeats& fe,
                                             const XgTile& g) {
  const int P = g.P, F = fe.F, nt = fe.live * g.d;
  xg_each(n, F, [&](int j, int i) {
    const float* gs = GS + j * g.S;
    const float* xp = fe.feats + (size_t)fe.n0 * F + i;
    const float* xt = fe.dfeats + (size_t)fe.n0 * g.d * F + i;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int p = 0; p < fe.live; ++p)
      s0 = fmaf(gs[p], __ldg(xp + (size_t)p * F), s0);
    int k = 0;
    for (; k + 4 <= nt; k += 4) {
      s0 = fmaf(gs[P + k], __ldg(xt + (size_t)k * F), s0);
      s1 = fmaf(gs[P + k + 1], __ldg(xt + (size_t)(k + 1) * F), s1);
      s2 = fmaf(gs[P + k + 2], __ldg(xt + (size_t)(k + 2) * F), s2);
      s3 = fmaf(gs[P + k + 3], __ldg(xt + (size_t)(k + 3) * F), s3);
    }
    for (; k < nt; ++k) s0 = fmaf(gs[P + k], __ldg(xt + (size_t)k * F), s0);
    acc[j * lda + i] += (s0 + s1) + (s2 + s3);
  });
}

// ---------------------------------------------------------------------------
// The network on a tile
// ---------------------------------------------------------------------------

// Field buffers, each [Hh][S]. R holds the relu inputs of hidden layers
// 1 .. nh-1 (nh = n_field - 1) at a stride of rstride floats (0: one buffer
// reused, when nothing is walked back); AS is a scratch pre-activation (and
// the VJP's first cotangent buffer), AL the tanh layer's pre-activation, YT
// its output, AB1 the VJP's second cotangent buffer. R, AL and YT of RK
// stage s sit kstride floats after those of stage s - 1 (0: shared). CF
// holds W0[:, :F] applied to each row's features; GS sums #5's layer-0
// cotangents over the walk (null without features).
struct XgField {
  float *R, *AS, *AL, *YT, *AB1, *GS;
  const float* CF;
  int rstride, kstride;
  __device__ __forceinline__ XgField stage(int s) const {
    XgField f = *this;
    f.R += (size_t)s * kstride;
    f.AL += (size_t)s * kstride;
    f.YT += (size_t)s * kstride;
    return f;
  }
};

// The field F(x, t, h) and its tangents at the rows of X [H][S]: keeps
// every pre-activation in f and, if out is given, writes the field into it.
__device__ __forceinline__ void xg_field_fwd(const XgNet& n, const XgField& f,
                                             const float* X, XgTime tm,
                                             float* out, const XgTile& g) {
  const float* W0 = n.w + n.field_off;
  const int nh = n.n_field - 1, Hh = n.Hh;
  xg_dense<false>(nh == 1 ? f.AL : f.AS, W0 + n.F + 1, n.fin, Hh, n.H, X, g,
                  W0 + Hh * n.fin, f.CF, W0 + n.F, tm);
  __syncthreads();
  for (int l = 1; l < nh; ++l) {
    float* r = f.R + (size_t)(l - 1) * f.rstride;
    xg_relu(r, f.AS, Hh, g);
    __syncthreads();
    const float* W = n.w + n.hid_off + (l - 1) * (Hh * Hh + Hh);
    xg_dense<false>(l == nh - 1 ? f.AL : f.AS, W, Hh, Hh, Hh, r, g,
                    W + Hh * Hh);
    __syncthreads();
  }
  xg_tanh(f.YT, f.AL, Hh, g);
  __syncthreads();
  if (out) {
    const float* Wo = n.w + n.out_off;
    xg_dense<false>(out, Wo, Hh, n.H, Hh, f.YT, g, Wo + n.H * Hh);
    __syncthreads();
  }
}

// One RK substep from X0 [H][S] at the times tm (tm.sub set): the stage
// inputs Y_s (s >= 1) go to ys + (s-1) ystride (ystride 0: one buffer), each
// stage's field activations to f.stage(s), and with `out` the end X0 + dt
// sum_s B_s k_s goes there (out may be X0).
__device__ __forceinline__ void xg_step(const XgNet& n, const XgField& f,
                                        int method, const float* X0, float* ys,
                                        int ystride, float* K, float* ACC,
                                        float* out, XgTime tm,
                                        const XgTile& g) {
  const int ns = XG_STAGES[method], S = g.S;
  const int evals = out ? ns : ns - 1;
  for (int s = 0; s < evals; ++s) {
    tm.c = XG_C[method][s];
    xg_field_fwd(n, f.stage(s), s == 0 ? X0 : ys + (size_t)(s - 1) * ystride,
                 tm, K, g);
    const float b = XG_B[method][s];
    const float a = s + 1 < ns ? XG_A[method][s + 1] : 0.f;
    float* yn = s + 1 < ns ? ys + (size_t)s * ystride : nullptr;
    xg_each(n.H, g.R, [&](int i, int r) {
      const int e = i * S + r;
      const float dt = tm.dt[g.prim[r]], kv = K[e];
      if (out) ACC[e] = s == 0 ? b * kv : fmaf(b, kv, ACC[e]);
      if (yn) yn[e] = X0[e] + (a * dt) * kv;
    });
    __syncthreads();
  }
  if (out) {
    xg_each(n.H, g.R, [&](int i, int r) {
      const int e = i * S + r;
      out[e] = X0[e] + tm.dt[g.prim[r]] * ACC[e];
    });
    __syncthreads();
  }
}

// The lift of the rows' seeds SD [S] (seed on a primal row, its tangent on
// a tangent row) into out [H][S]. The relu inputs of layers 1 .. n_lift-1
// go to LR + (l-1) lstride (lstride 0: one buffer); LS is scratch. With
// `out` null the last layer is not applied (the VJP needs only its input).
__device__ __forceinline__ void xg_lift_fwd(const XgNet& n, const float* SD,
                                            float* LR, int lstride, float* LS,
                                            float* out, const XgTile& g) {
  const int H = n.H;
  xg_dense<false>(n.n_lift == 1 ? out : LS, n.w, 1, H, 1, SD, g, n.w + H);
  __syncthreads();
  for (int l = 1; l < n.n_lift; ++l) {
    float* r = LR + (size_t)(l - 1) * lstride;
    xg_relu(r, LS, H, g);
    __syncthreads();
    if (l == n.n_lift - 1 && out == nullptr) break;
    const float* W = n.w + 2 * H + (l - 1) * (H * H + H);
    xg_dense<false>(l == n.n_lift - 1 ? out : LS, W, H, H, H, r, g,
                    W + H * H);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// #3 / #4: forward with tangents; STORE also writes the interval start
// states hs [L, N, H] and hts [L, N, d, H]. One tile of P paths per block.
// ---------------------------------------------------------------------------

// The tile's rows, seeds and, where FE is given, features: prim, SD [S],
// FE [F][S] (the cluster variant's copy); rows of paths past N get zeros.
__device__ __forceinline__ void xg_load_rows(
    int* prim, float* FE, float* SD, const float* __restrict__ feats,
    const float* __restrict__ dfeats, const float* __restrict__ seed,
    const float* __restrict__ dseed, int n0, int live, int F,
    const XgTile& g) {
  const int P = g.P, d = g.d;
  for (int r = threadIdx.x; r < g.R; r += blockDim.x) {
    const int p = r < P ? r : (r - P) / d;
    prim[r] = p;
    SD[r] = p >= live ? 0.f
            : r < P   ? seed[n0 + r]
                      : dseed[(size_t)n0 * d + (r - P)];
  }
  if (FE != nullptr && F > 0)
    xg_each(g.R, F, [&](int r, int i) {
      const int p = r < P ? r : (r - P) / d;
      FE[i * g.S + r] = p >= live ? 0.f
                        : r < P   ? feats[(size_t)(n0 + r) * F + i]
                                  : dfeats[((size_t)n0 * d + (r - P)) * F + i];
    });
}

template <bool STORE>
__global__ void __launch_bounds__(XG_MAX_THREADS, 1)
xnode_udu_fwd_kernel(const float* __restrict__ params, int n_params,
                     const float* __restrict__ t0,      // [N, L]
                     const float* __restrict__ dt,      // [N, L] substep
                     const float* __restrict__ feats,   // [N, F]
                     const float* __restrict__ dfeats,  // [N, d, F]
                     const float* __restrict__ seed,    // [N]
                     const float* __restrict__ dseed,   // [N, d]
                     float* __restrict__ u,             // [N, L]
                     float* __restrict__ du,            // [N, L, d]
                     float* __restrict__ hs,            // [L, N, H]
                     float* __restrict__ hts,           // [L, N, d, H]
                     int N, int L, int d, int H, int Hh, int F, int n_lift,
                     int n_field, int n_sub, int method, int P) {
  extern __shared__ __align__(16) float smem[];
  const XgNet n = xg_net(params, H, Hh, F, n_lift, n_field);
  const XgLayout y = xg_layout(false, false, P, d, H, Hh, F, n_lift,
                               n_field, method, n_params);
  XgTile g;
  g.P = P;
  g.d = d;
  g.R = y.R;
  g.S = y.S;
  int* prim = reinterpret_cast<int*>(smem + y.total);
  g.prim = prim;
  const int S = g.S, R = g.R;
  float *CF = smem + y.cf, *SD = smem + y.sd;
  float *T0 = smem + y.t0, *DT = smem + y.dt;
  float *HST = smem + y.st, *Y = smem + y.ys, *K = smem + y.k,
        *ACC = smem + y.accu;
  XgField f;
  f.AS = f.AL = smem + y.fld;
  f.R = f.YT = smem + y.fld + Hh * S;
  f.AB1 = f.GS = nullptr;
  f.CF = CF;
  f.rstride = f.kstride = 0;

  const int n0 = blockIdx.x * P, live = min(P, N - n0);
  xg_load_rows(prim, nullptr, SD, feats, dfeats, seed, dseed, n0, live, F,
               g);
  __syncthreads();
  xg_feat_cf(CF, n.w + n.field_off, n.fin, Hh,
             XgFeats{feats, dfeats, F, n0, live}, g);
  xg_lift_fwd(n, SD, Y, 0, K, HST, g);  // its first pass syncs CF too
  const float* wr = n.w + n.readout_off;

  for (int l = 0; l < L; ++l) {
    if (STORE) {
      float* dh = hs + ((size_t)l * N + n0) * H;
      xg_each(live, H, [&](int r, int j) { dh[r * H + j] = HST[j * S + r]; });
      float* dht = hts + ((size_t)l * N + n0) * d * H;
      xg_each(live * d, H,
              [&](int r, int j) { dht[r * H + j] = HST[j * S + P + r]; });
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const size_t nl = (size_t)(n0 + p) * L + l;
      T0[p] = p < live ? t0[nl] : 0.f;
      DT[p] = p < live ? dt[nl] : 0.f;
    }
    __syncthreads();
    XgTime tm{T0, DT, 0.f, 0.f};
    for (int s = 0; s < n_sub; ++s) {
      tm.sub = (float)s;
      xg_step(n, f, method, HST, Y, 0, K, ACC, HST, tm, g);
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const int p = prim[r];
      if (p >= live) continue;
      float s = 0.f;
      for (int i = 0; i < H; ++i) s = fmaf(__ldg(wr + i), HST[i * S + r], s);
      const size_t nl = (size_t)(n0 + p) * L + l;
      if (r < P)
        u[nl] = s + __ldg(wr + H);
      else
        du[nl * d + (r - P - p * d)] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// #5: backward, a persistent grid of tiles.
// ---------------------------------------------------------------------------

// VJP of the field at (X, tm), whose activations xg_field_fwd kept in f,
// for the cotangent OB [H][S] of its output: writes the cotangent of X into
// XB and adds every weight gradient to acc.
__device__ __forceinline__ void xg_field_vjp(const XgNet& n, const XgField& f,
                                             float* acc, const float* X,
                                             XgTime tm, const float* OB,
                                             float* XB, const XgTile& g) {
  const int H = n.H, Hh = n.Hh, nh = n.n_field - 1, R = g.R, S = g.S;
  const float* Wo = n.w + n.out_off;
  xg_outer(acc + n.out_off, Hh, OB, H, f.YT, Hh, R, S);
  xg_rowsum(acc + n.out_off + H * Hh, OB, H, g);
  xg_dense_t(f.AB1, Wo, Hh, Hh, H, OB, g);
  __syncthreads();
  float *cur = f.AS, *nxt = f.AB1;
  xg_tanh_vjp(cur, f.AB1, f.AL, Hh, g);
  __syncthreads();
  for (int l = nh - 1; l >= 1; --l) {
    const int off = n.hid_off + (l - 1) * (Hh * Hh + Hh);
    const float* r = f.R + (size_t)(l - 1) * f.rstride;
    xg_outer(acc + off, Hh, cur, Hh, r, Hh, R, S);
    xg_rowsum(acc + off + Hh * Hh, cur, Hh, g);
    xg_dense_t(nxt, n.w + off, Hh, Hh, Hh, cur, g, r);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // layer 0: input [feats, t, h], tangent [xt, 0, ht]; the feature
  // columns' cotangent joins the walk's sum GS
  const int o0 = n.field_off, fin = n.fin;
  if (f.GS)
    xg_each(Hh, R, [&](int j, int r) { f.GS[j * S + r] += cur[j * S + r]; });
  xg_time(acc + o0 + n.F, fin, cur, Hh, tm, g);
  xg_outer(acc + o0 + n.F + 1, fin, cur, Hh, X, H, R, S);
  xg_rowsum(acc + o0 + Hh * fin, cur, Hh, g);
  xg_dense_t(XB, n.w + o0 + n.F + 1, fin, H, Hh, cur, g);
  __syncthreads();
}

// Buffers of the walk, each [H][S] but ys (ns - 1 of them).
struct XgWalk {
  float *HS, *HB, *HB0, *KB, *YB, *ys, *K, *ACC, *HE, *HCUR;
};

// VJP of one substep from X0 whose stage inputs are in w.ys and stage
// activations in f (xg_step): w.HB holds the cotangent of the substep's
// output on entry and of X0 on exit.
__device__ __forceinline__ void xg_step_vjp(const XgNet& n, const XgField& f,
                                            int method, float* acc,
                                            const float* X0, const XgWalk& w,
                                            XgTime tm, const XgTile& g) {
  const int ns = XG_STAGES[method], S = g.S, hs = n.H * S;
  const float bl = XG_B[method][ns - 1];
  xg_each(n.H, g.R, [&](int i, int r) {
    const int e = i * S + r;
    const float hb = w.HB[e];
    w.HB0[e] = hb;
    w.KB[e] = (tm.dt[g.prim[r]] * bl) * hb;
  });
  __syncthreads();
  for (int s = ns - 1; s >= 0; --s) {
    tm.c = XG_C[method][s];
    xg_field_vjp(n, f.stage(s), acc, s == 0 ? X0 : w.ys + (size_t)(s - 1) * hs,
                 tm, w.KB, w.YB, g);
    const float b = s > 0 ? XG_B[method][s - 1] : 0.f;
    const float a = XG_A[method][s];
    xg_each(n.H, g.R, [&](int i, int r) {
      const int e = i * S + r;
      const float yb = w.YB[e];
      w.HB[e] += yb;
      if (s > 0) {
        const float dt = tm.dt[g.prim[r]];
        w.KB[e] = (dt * b) * w.HB0[e] + (a * dt) * yb;
      }
    });
    __syncthreads();
  }
}

// Start the copies of interval l's start states, readout cotangents and
// times into the staging buffer st: rows [R][H], then ub [R], t0 [P], dt
// [P]. Rows of paths past N get zeros.
__device__ __forceinline__ void xg_prefetch(
    float* st, const float* __restrict__ hs, const float* __restrict__ hts,
    const float* __restrict__ ub, const float* __restrict__ dub,
    const float* __restrict__ t0, const float* __restrict__ dt, int l, int N,
    int L, int H, int n0, int live, bool vec, const XgTile& g) {
  const int P = g.P, d = g.d, R = g.R;
  const int np = live * H, nt = live * d * H;
  const float* sh = hs + ((size_t)l * N + n0) * H;
  const float* sht = hts + ((size_t)l * N + n0) * d * H;
  float* stt = st + P * H;
  if (vec) {
    for (int i = 4 * threadIdx.x; i < np; i += 4 * blockDim.x)
      __pipeline_memcpy_async(st + i, sh + i, 16);
    for (int i = 4 * threadIdx.x; i < nt; i += 4 * blockDim.x)
      __pipeline_memcpy_async(stt + i, sht + i, 16);
  } else {
    for (int i = threadIdx.x; i < np; i += blockDim.x)
      __pipeline_memcpy_async(st + i, sh + i, 4);
    for (int i = threadIdx.x; i < nt; i += blockDim.x)
      __pipeline_memcpy_async(stt + i, sht + i, 4);
  }
  for (int i = np + threadIdx.x; i < P * H; i += blockDim.x) st[i] = 0.f;
  for (int i = nt + threadIdx.x; i < P * d * H; i += blockDim.x) stt[i] = 0.f;
  float* sub = st + R * H;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int p = r < P ? r : (r - P) / d;
    const size_t nl = (size_t)(n0 + p) * L + l;
    if (p >= live)
      sub[r] = 0.f;
    else if (r < P)
      __pipeline_memcpy_async(sub + r, ub + nl, 4);
    else
      __pipeline_memcpy_async(sub + r, dub + nl * d + (r - P - p * d), 4);
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const size_t nl = (size_t)(n0 + p) * L + l;
    if (p >= live) {
      sub[R + p] = sub[R + P + p] = 0.f;
    } else {
      __pipeline_memcpy_async(sub + R + p, t0 + nl, 4);
      __pipeline_memcpy_async(sub + R + P + p, dt + nl, 4);
    }
  }
  __pipeline_commit();
}

template <bool GACC>
__global__ void __launch_bounds__(XG_MAX_THREADS, 1)
xnode_udu_bwd_kernel(const float* __restrict__ params, int n_params,
                     const float* __restrict__ t0,
                     const float* __restrict__ dt,
                     const float* __restrict__ feats,
                     const float* __restrict__ dfeats,
                     const float* __restrict__ seed,
                     const float* __restrict__ dseed,
                     const float* __restrict__ hs,   // [L, N, H]
                     const float* __restrict__ hts,  // [L, N, d, H]
                     const float* __restrict__ ub,   // [N, L]
                     const float* __restrict__ dub,  // [N, L, d]
                     float* __restrict__ partial,    // [gridDim.x, n_params]
                     int N, int L, int d, int H, int Hh, int F, int n_lift,
                     int n_field, int n_sub, int method, int P, int vec) {
  extern __shared__ __align__(16) float smem[];
  const XgNet n = xg_net(params, H, Hh, F, n_lift, n_field);
  const XgLayout y = xg_layout(true, GACC, P, d, H, Hh, F, n_lift, n_field,
                               method, n_params);
  XgTile g;
  g.P = P;
  g.d = d;
  g.R = y.R;
  g.S = y.S;
  int* prim = reinterpret_cast<int*>(smem + y.total);
  g.prim = prim;
  const int S = g.S, R = g.R, HS_ = H * S;
  float* acc = GACC ? partial + (size_t)blockIdx.x * n_params : smem + y.acc;
  float *CF = smem + y.cf, *SD = smem + y.sd, *UB = smem + y.ub,
        *T0 = smem + y.t0, *DT = smem + y.dt, *ST = smem + y.stage;
  XgWalk w;
  w.HS = smem + y.hs;
  w.HB = smem + y.hb;
  w.HB0 = smem + y.hb0;
  w.KB = smem + y.kb;
  w.YB = smem + y.yb;
  w.ys = smem + y.ys;
  w.K = smem + y.k;
  w.ACC = smem + y.accu;
  w.HE = smem + y.he;
  w.HCUR = smem + y.hcur;
  XgField f;
  f.R = smem + y.fld;
  f.rstride = Hh * S;
  f.kstride = n_field * Hh * S;
  f.AL = f.R + (n_field - 2) * Hh * S;
  f.YT = f.AL + Hh * S;
  f.AS = f.R + (size_t)XG_STAGES[method] * f.kstride;
  f.AB1 = f.AS + Hh * S;
  f.GS = y.gs >= 0 ? smem + y.gs : nullptr;
  f.CF = CF;
  const float* wr = n.w + n.readout_off;
  const int ro = n.readout_off;

  for (int i = threadIdx.x; i < n_params; i += blockDim.x) acc[i] = 0.f;
  const int n_tiles = (N + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * P, live = min(P, N - n0);
    const XgFeats fe{feats, dfeats, F, n0, live};
    __syncthreads();  // the previous tile's last reads are done
    xg_load_rows(prim, nullptr, SD, feats, dfeats, seed, dseed, n0, live, F,
                 g);
    for (int idx = threadIdx.x; idx < HS_; idx += blockDim.x) w.HB[idx] = 0.f;
    if (f.GS)
      for (int idx = threadIdx.x; idx < Hh * S; idx += blockDim.x)
        f.GS[idx] = 0.f;
    xg_prefetch(ST, hs, hts, ub, dub, t0, dt, L - 1, N, L, H, n0, live, vec,
                g);
    __syncthreads();
    xg_feat_cf(CF, n.w + n.field_off, n.fin, Hh, fe, g);

    for (int l = L - 1; l >= 0; --l) {
      __pipeline_wait_prior(0);
      __syncthreads();  // the staged interval and CF are in
      xg_each(R, H, [&](int r, int j) { w.HS[j * S + r] = ST[r * H + j]; });
      for (int r = threadIdx.x; r < R; r += blockDim.x) UB[r] = ST[R * H + r];
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        T0[p] = ST[R * H + R + p];
        DT[p] = ST[R * H + R + P + p];
      }
      __syncthreads();
      if (l > 0)
        xg_prefetch(ST, hs, hts, ub, dub, t0, dt, l - 1, N, L, H, n0, live,
                    vec, g);
      for (int sub = n_sub - 1; sub >= 0; --sub) {
        XgTime tm{T0, DT, 0.f, 0.f};
        const float* X0 = w.HS;
        if (sub > 0) {  // the substep's start, recomputed from the interval's
          for (int idx = threadIdx.x; idx < HS_; idx += blockDim.x)
            w.HCUR[idx] = w.HS[idx];
          __syncthreads();
          for (int s = 0; s < sub; ++s) {
            tm.sub = (float)s;
            xg_step(n, f, method, w.HCUR, w.ys, HS_, w.K, w.ACC, w.HCUR, tm,
                    g);
          }
          X0 = w.HCUR;
        }
        // the stage inputs and activations the VJP walks back (and the end
        // state, which the last substep's readout needs)
        tm.sub = (float)sub;
        const bool last = sub == n_sub - 1;
        xg_step(n, f, method, X0, w.ys, HS_, w.K, w.ACC, w.HE, tm, g);
        if (last) {  // readout u = wr.h + br, du_k = wr.ht_k
          xg_outer(acc + ro, 0, UB, 1, w.HE, H, R, S);
          xg_rowsum(acc + ro + H, UB, 1, g);
          xg_each(H, R, [&](int i, int r) {
            w.HB[i * S + r] += __ldg(wr + i) * UB[r];
          });
          __syncthreads();
        }
        xg_step_vjp(n, f, method, acc, X0, w, tm, g);
      }
    }
    // the feature columns' gradient from the walk's summed cotangent (the
    // last VJP's barrier has ordered GS)
    if (f.GS) xg_feat_grad(acc + n.field_off, n.fin, f.GS, Hh, fe, g);
    // the lift's VJP on the rows' seeds; its buffers reuse the walk's
    float* LR = w.ys;
    float* LS = LR + (size_t)(n_lift - 1) * HS_;
    float* LB = LS + HS_;
    xg_lift_fwd(n, SD, LR, HS_, LS, nullptr, g);
    float *cur = w.HB, *nxt = LB;
    for (int l = n_lift - 1; l >= 1; --l) {
      const int off = 2 * H + (l - 1) * (H * H + H);
      const float* r = LR + (size_t)(l - 1) * HS_;
      xg_outer(acc + off, H, cur, H, r, H, R, S);
      xg_rowsum(acc + off + H * H, cur, H, g);
      xg_dense_t(nxt, n.w + off, H, H, H, cur, g, r);
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    xg_outer(acc, 1, cur, H, SD, 1, R, S);
    xg_rowsum(acc + H, cur, H, g);
  }
  if (GACC) return;  // the row is already in partial
  __syncthreads();
  for (int i = threadIdx.x; i < n_params; i += blockDim.x)
    partial[(size_t)blockIdx.x * n_params + i] = acc[i];
}

// grad[i] = sum over blocks b, in order, of partial[b, i].
__global__ void xnode_udu_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ grad,
                                        int n_blocks, int n_params) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * n_params + i];
  grad[i] = s;
}

#include "xnode_grad_cluster.cuh"

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

static cudaError_t xg_checks(int device, int n_params, int N, int L, int d,
                             int H, int Hh, int F, int n_lift, int n_field,
                             int n_sub, int method, int tile, int threads) {
  if (N < 0 || L < 0 || d < 0 || n_sub < 1 || H < 1 || Hh < 1 || F < 0 ||
      n_lift < 1 || n_field < 2 || method < XN_EULER || method > XN_RK4 ||
      n_params != xn_n_params(H, Hh, F, n_lift, n_field) || tile < 1 ||
      threads < 32 || threads % 32 != 0 || threads > XG_MAX_THREADS)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

static cudaError_t xg_allow_smem(const void* kernel, size_t smem) {
  if (smem > XG_MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Shared bytes of one block of #3/#4 (backward 0), #5 (backward 1) or #5's
// GACC variant (backward 2) at this geometry: what the launchers ask for.
extern "C" long long xnode_udu_smem_bytes(int backward, int tile, int d,
                                          int H, int Hh, int F, int n_lift,
                                          int n_field, int method) {
  return (long long)xg_smem_bytes(
      xg_layout(backward != 0, backward == 2, tile, d, H, Hh, F, n_lift,
                n_field, method, xn_n_params(H, Hh, F, n_lift, n_field)));
}

// Shared bytes of one block of #5's cluster variant on clusters of C blocks.
extern "C" long long xnode_udu_cluster_smem_bytes(int cluster, int tile, int d,
                                                  int H, int Hh, int F,
                                                  int n_lift, int n_field,
                                                  int method) {
  return (long long)xc_smem_bytes(
      xc_layout(tile, d, H, Hh, F, n_lift, n_field, method, cluster));
}

template <bool STORE>
static int xg_udu_fwd(int device, void* stream, const float* params,
                      int n_params, const float* t0, const float* dt,
                      const float* feats, const float* dfeats,
                      const float* seed, const float* dseed, float* u,
                      float* du, float* hs, float* hts, int N, int L, int d,
                      int H, int Hh, int F, int n_lift, int n_field,
                      int n_sub, int method, int tile, int threads) {
  cudaError_t e = xg_checks(device, n_params, N, L, d, H, Hh, F, n_lift,
                            n_field, n_sub, method, tile, threads);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = xg_smem_bytes(xg_layout(
      false, false, tile, d, H, Hh, F, n_lift, n_field, method, n_params));
  e = xg_allow_smem((const void*)xnode_udu_fwd_kernel<STORE>, smem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0) return 0;
  const int blocks = (N + tile - 1) / tile;
  xnode_udu_fwd_kernel<STORE><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      params, n_params, t0, dt, feats, dfeats, seed, dseed, u, du, hs, hts, N,
      L, d, H, Hh, F, n_lift, n_field, n_sub, method, tile);
  return (int)cudaGetLastError();
}

// tile: paths per tile; threads: the block size (a multiple of 32, at most
// XG_MAX_THREADS); both chosen by the wrapper (xnode_train.py :: grad_tile).
extern "C" int xnode_udu_fwd_launch(int device, void* stream,
                                    const float* params, int n_params,
                                    const float* t0, const float* dt,
                                    const float* feats, const float* dfeats,
                                    const float* seed, const float* dseed,
                                    float* u, float* du, int N, int L, int d,
                                    int H, int Hh, int F, int n_lift,
                                    int n_field, int n_sub, int method,
                                    int tile, int threads) {
  return xg_udu_fwd<false>(device, stream, params, n_params, t0, dt, feats,
                           dfeats, seed, dseed, u, du, nullptr, nullptr, N,
                           L, d, H, Hh, F, n_lift, n_field, n_sub, method,
                           tile, threads);
}

extern "C" int xnode_udu_fwd_store_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed, float* u,
    float* du, float* hs, float* hts, int N, int L, int d, int H, int Hh,
    int F, int n_lift, int n_field, int n_sub, int method, int tile,
    int threads) {
  return xg_udu_fwd<true>(device, stream, params, n_params, t0, dt, feats,
                          dfeats, seed, dseed, u, du, hs, hts, N, L, d, H,
                          Hh, F, n_lift, n_field, n_sub, method, tile,
                          threads);
}

template <bool GACC>
static int xg_udu_bwd(int device, void* stream, const float* params,
                      int n_params, const float* t0, const float* dt,
                      const float* feats, const float* dfeats,
                      const float* seed, const float* dseed, const float* hs,
                      const float* hts, const float* ub, const float* dub,
                      float* partial, float* grad, int N, int L, int d, int H,
                      int Hh, int F, int n_lift, int n_field, int n_sub,
                      int method, int tile, int threads, int blocks) {
  cudaError_t e = xg_checks(device, n_params, N, L, d, H, Hh, F, n_lift,
                            n_field, n_sub, method, tile, threads);
  if (e != cudaSuccess || blocks < 1 || d < 1)
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  const size_t smem = xg_smem_bytes(xg_layout(
      true, GACC, tile, d, H, Hh, F, n_lift, n_field, method, n_params));
  e = xg_allow_smem((const void*)xnode_udu_bwd_kernel<GACC>, smem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0)
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  // 16-byte copies of the states need H a multiple of 4 and aligned rows
  const int vec = H % 4 == 0 && (size_t)hs % 16 == 0 && (size_t)hts % 16 == 0;
  xnode_udu_bwd_kernel<GACC><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      params, n_params, t0, dt, feats, dfeats, seed, dseed, hs, hts, ub, dub,
      partial, N, L, d, H, Hh, F, n_lift, n_field, n_sub, method, tile, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  xnode_udu_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(partial, grad, blocks,
                                                    n_params);
  return (int)cudaGetLastError();
}

// tile, threads: as for the forward (xnode_train.py :: grad_tile); blocks:
// the persistent grid, one partial row each (partial holds blocks x
// n_params floats).
extern "C" int xnode_udu_bwd_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed,
    const float* hs, const float* hts, const float* ub, const float* dub,
    float* partial, float* grad, int N, int L, int d, int H, int Hh, int F,
    int n_lift, int n_field, int n_sub, int method, int tile, int threads,
    int blocks) {
  return xg_udu_bwd<false>(device, stream, params, n_params, t0, dt, feats,
                           dfeats, seed, dseed, hs, hts, ub, dub, partial,
                           grad, N, L, d, H, Hh, F, n_lift, n_field, n_sub,
                           method, tile, threads, blocks);
}

// The GACC variant: the same arguments; each block accumulates in its row
// of partial, so its shared memory holds no accumulator.
extern "C" int xnode_udu_bwd_global_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed,
    const float* hs, const float* hts, const float* ub, const float* dub,
    float* partial, float* grad, int N, int L, int d, int H, int Hh, int F,
    int n_lift, int n_field, int n_sub, int method, int tile, int threads,
    int blocks) {
  return xg_udu_bwd<true>(device, stream, params, n_params, t0, dt, feats,
                          dfeats, seed, dseed, hs, hts, ub, dub, partial,
                          grad, N, L, d, H, Hh, F, n_lift, n_field, n_sub,
                          method, tile, threads, blocks);
}

// #5's cluster variant: clusters of `cluster` blocks (2, 4 or 8), each
// block owning a slice of every layer's units (xnode_grad_cluster.cuh).
static cudaError_t xc_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                             int device, void* stream, int n_params, int N,
                             int L, int d, int H, int Hh, int F, int n_lift,
                             int n_field, int n_sub, int method, int tile,
                             int threads, int clusters, int cluster) {
  cudaError_t e = xg_checks(device, n_params, N, L, d, H, Hh, F, n_lift,
                            n_field, n_sub, method, tile, threads);
  if (e != cudaSuccess) return e;
  if (d < 1 || clusters < 1 || cluster < 2 || cluster > XC_MAX_CLUSTER ||
      H < cluster || Hh < cluster)
    return cudaErrorInvalidValue;
  const size_t smem = xc_smem_bytes(
      xc_layout(tile, d, H, Hh, F, n_lift, n_field, method, cluster));
  e = xg_allow_smem((const void*)xnode_udu_bwd_cluster_kernel, smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * cluster);
  cfg->blockDim = dim3(threads);
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

// Clusters of this shape that the card runs at once (the persistent grid's
// cap), or a negative CUDA error.
extern "C" int xnode_udu_cluster_occupancy(int device, int d, int H, int Hh,
                                           int F, int n_lift, int n_field,
                                           int method, int tile, int threads,
                                           int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = xc_config(&cfg, attr, device, nullptr,
                            xn_n_params(H, Hh, F, n_lift, n_field), 1, 1, d,
                            H, Hh, F, n_lift, n_field, 1, method, tile,
                            threads, 1, cluster);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, (const void*)xnode_udu_bwd_cluster_kernel, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// The arguments of xnode_udu_bwd_launch but the grid, given as `clusters`
// clusters of `cluster` blocks (partial holds clusters x n_params floats).
extern "C" int xnode_udu_bwd_cluster_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed,
    const float* hs, const float* hts, const float* ub, const float* dub,
    float* partial, float* grad, int N, int L, int d, int H, int Hh, int F,
    int n_lift, int n_field, int n_sub, int method, int tile, int threads,
    int clusters, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = xc_config(&cfg, attr, device, stream, n_params, N, L, d, H,
                            Hh, F, n_lift, n_field, n_sub, method, tile,
                            threads, clusters, cluster);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0)
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  // 16-byte copies of the block's units of the states: every slice a
  // multiple of 4 wide, rows aligned
  const int vec = H % (4 * cluster) == 0 && (size_t)hs % 16 == 0 &&
                  (size_t)hts % 16 == 0;
  e = cudaLaunchKernelEx(&cfg, xnode_udu_bwd_cluster_kernel, params,
                         n_params, t0, dt, feats, dfeats, seed, dseed, hs,
                         hts, ub, dub, partial, N, L, d, H, Hh, F, n_lift,
                         n_field, n_sub, method, tile, vec, cluster);
  if (e != cudaSuccess) return (int)e;
  xnode_udu_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(partial, grad, clusters,
                                                    n_params);
  return (int)cudaGetLastError();
}
