// Training kernels: the XNODE path forward with spatial tangents and its
// hand-derived backward, the custom VJP of ops/kernels/xnode_train.py ::
// u_du_fused. They replace, in the JAX package's ops/pallas/xnode_train.py,
//
//   #3 _fwd_kernel        -> xnode_udu_fwd_launch        (u, du)
//   #4 _fwd_store_kernel  -> xnode_udu_fwd_store_launch  (u, du, hs, hts)
//   #5 _bwd_kernel        -> xnode_udu_bwd_launch        (weight cotangents)
//
// Layout: ONE THREAD PER (path n, tangent direction k), thread q = n*d + k,
// so d = 5 and N = 4,000 give 20,000 threads where the tangentless kernel
// (xnode_train.cu) has 4,000. Each thread recomputes the primal h, which its
// direction's relu masks and tanh derivative need, and carries one tangent
// ht_k [H]: 1.67x the multiply-adds of carrying all d tangents in one
// thread, but a per-thread footprint that does not depend on d (so no
// counterpart of the JAX package's fused_chunk / d_chunk VMEM gates).
// Weights sit in shared memory, read as broadcasts; the feature columns of
// field layer 0 are applied once per path to the features (c0) and to
// their x-tangent (ct0). Masked samples arrive with dt = 0 (identity).
//
// Bounds on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s)
// at the d=5 main path (N = 4,000, L = 20, midpoint, n_sub = 1): #3 does
// about 2.1 GFLOP (~32 us) and moves ~1 MB; #4 adds ~38 MB of state
// writes (~12 us), so both are bound by operations. #5 recomputes each
// interval's stages from the stored states and walks them back, about 3x
// #3's work plus ~38 MB of reads (~0.1 ms). All three are in practice bound
// by the latency of each thread's serial chain (L x stages field
// evaluations) and, for #5, by summing 2,161 weight gradients over 20,000
// threads: the design reduces each contribution within the warp
// (__shfl_xor_sync), adds it to the warp's own accumulator in shared
// memory (no atomics: lane 0 of a warp is its only writer), writes one
// partial per block and sums the partials in a second kernel in a fixed
// order, so the result does not depend on block scheduling.
//
// Backward per thread (derivation in ops/kernels/xnode_train.py ::
// u_du_bwd_plain, which writes the same adjoint as batched tensor math):
// the map (h, ht_1..ht_d) -> (h', ht'_1..ht'_d) has a VJP that is linear
// in the cotangents, and ht'_k depends only on (h, ht_k). So the primal
// cotangent hbar splits into per-direction shares: thread k carries
// hbar^(k) and htbar_k, takes the readout's ub into share 0 only, and
// applies the VJP of the one-direction joint map (h, ht_k) -> (h', ht'_k),
// second-order tanh term included. Summing the weight gradients over the
// threads then sums the shares, exactly as the batched adjoint does.
#include "steppers.cuh"

#define XN_MAX_FIELD_LAYERS 16  // cap on n_field and n_lift (activation store)
#define XN_FWD_THREADS 64

__device__ inline float xn_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Add one weight-gradient contribution of every lane to the warp's
// accumulator. Called by all 32 lanes with the same idx.
__device__ inline void xn_gacc(float* G, int idx, float v, int lane) {
  v = xn_warp_sum(v);
  if (lane == 0) G[idx] += v;
}

// The four schemes as RK tables (ops/kernels/steppers.py :: RK_TABLES).
__device__ inline int xn_rk_table(int method, float* C, float* A, float* B) {
  switch (method) {
    case XN_EULER:
      C[0] = 0.f; A[0] = 0.f; B[0] = 1.f;
      return 1;
    case XN_MIDPOINT:
      C[0] = 0.f; C[1] = 0.5f; A[0] = 0.f; A[1] = 0.5f;
      B[0] = 0.f; B[1] = 1.f;
      return 2;
    case XN_HEUN:
      C[0] = 0.f; C[1] = 1.f; A[0] = 0.f; A[1] = 1.f;
      B[0] = 0.5f; B[1] = 0.5f;
      return 2;
    default:
      C[0] = 0.f; C[1] = 0.5f; C[2] = 0.5f; C[3] = 1.f;
      A[0] = 0.f; A[1] = 0.5f; A[2] = 0.5f; A[3] = 1.f;
      B[0] = 1.f / 6.f; B[1] = 2.f / 6.f; B[2] = 2.f / 6.f; B[3] = 1.f / 6.f;
      return 4;
  }
}

// Per-thread path data shared by the three kernels.
struct XnPath {
  int n, k;
  float feats[XN_MAX_FIELD_IN], xt[XN_MAX_FIELD_IN];
  float c0[XN_MAX_WIDTH], ct0[XN_MAX_WIDTH];
  float seed, st;
};

__device__ inline void xn_load_path(const XnNet& net, int q, int d,
                                    const float* feats, const float* dfeats,
                                    const float* seed, const float* dseed,
                                    XnPath& p) {
  p.n = q / d;
  p.k = q - p.n * d;
  const int F = net.F;
  for (int i = 0; i < F; ++i) {
    p.feats[i] = feats[(size_t)p.n * F + i];
    p.xt[i] = dfeats[(size_t)q * F + i];
  }
  xn_field_const(net, p.feats, p.c0);
  xn_field_const(net, p.xt, p.ct0);
  p.seed = seed[p.n];
  p.st = dseed[q];
}

// ---------------------------------------------------------------------------
// #3 / #4: forward with tangents; STORE also writes the interval start
// states hs [L, N, H] (direction 0) and hts [L, N, d, H].
// ---------------------------------------------------------------------------
template <bool STORE>
__global__ void __launch_bounds__(XN_FWD_THREADS)
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
                     int n_field, int n_sub, int method) {
  extern __shared__ float sw[];
  xn_stage_weights(sw, params, n_params);
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N * d) return;

  const XnNet net = xn_net(sw, H, Hh, F, n_lift, n_field);
  XnPath p;
  xn_load_path(net, q, d, feats, dfeats, seed, dseed, p);
  float h[XN_MAX_WIDTH], ht[XN_MAX_WIDTH];
  xn_lift_tan(net, p.seed, p.st, h, ht);
  const float* wr = sw + net.readout_off;

  for (int l = 0; l < L; ++l) {
    if (STORE) {
      if (p.k == 0)
        for (int j = 0; j < H; ++j) hs[((size_t)l * N + p.n) * H + j] = h[j];
      for (int j = 0; j < H; ++j) hts[((size_t)l * N * d + q) * H + j] = ht[j];
    }
    const size_t nl = (size_t)p.n * L + l;
    const float ta = t0[nl], dl = dt[nl];
    for (int s = 0; s < n_sub; ++s)
      xn_rk_step_tan(net, method, p.c0, p.ct0, ta + (float)s * dl, dl, h, ht);
    if (p.k == 0) u[nl] = xn_readout(net, h);
    float s = 0.f;
    for (int i = 0; i < H; ++i) s = fmaf(wr[i], ht[i], s);
    du[nl * d + p.k] = s;
  }
}

// ---------------------------------------------------------------------------
// #5: backward.
// ---------------------------------------------------------------------------

// VJP of the one-direction joint field at (t, h, ht) for the cotangents
// (obar, otbar) of (out, outt): adds the input cotangents to (hbar, htbar)
// and every weight gradient to the warp's accumulator G.
__device__ void xn_field_vjp(const XnNet& n, const XnPath& p, float t,
                             const float* h, const float* ht,
                             const float* obar, const float* otbar,
                             float* hbar, float* htbar, float* G, int lane) {
  float A[XN_MAX_FIELD_LAYERS - 1][XN_MAX_WIDTH];
  float AT[XN_MAX_FIELD_LAYERS - 1][XN_MAX_WIDTH];
  float r[XN_MAX_WIDTH], rt[XN_MAX_WIDTH], ab[XN_MAX_WIDTH],
      atb[XN_MAX_WIDTH], rb[XN_MAX_WIDTH], rtb[XN_MAX_WIDTH];
  const int H = n.H, Hh = n.Hh, F = n.F, fin = F + 1 + H;
  const int nh = n.n_field - 1;  // hidden pre-activations A[0 .. nh-1]

  // forward recompute, keeping every pre-activation and its tangent
  const int off0 = n.field_off;
  const float* W0 = n.w + off0;
  for (int j = 0; j < Hh; ++j) {
    const float* row = W0 + j * fin + F;
    float s = fmaf(row[0], t, p.c0[j]), st = p.ct0[j];
    for (int i = 0; i < H; ++i) {
      s = fmaf(row[1 + i], h[i], s);
      st = fmaf(row[1 + i], ht[i], st);
    }
    A[0][j] = s + W0[Hh * fin + j];
    AT[0][j] = st;
  }
  int off = off0 + Hh * fin + Hh;
  for (int l = 1; l < nh; ++l) {
    for (int i = 0; i < Hh; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      r[i] = on ? A[l - 1][i] : 0.f;
      rt[i] = on ? AT[l - 1][i] : 0.f;
    }
    xn_dense(n.w + off, Hh, Hh, r, A[l]);
    xn_dense_nb(n.w + off, Hh, Hh, rt, AT[l]);
    off += Hh * Hh + Hh;
  }
  // off is now the output layer W_o [H, Hh], b_o [H]
  const float* Wo = n.w + off;
  for (int i = 0; i < Hh; ++i) {
    const float y = tanhf(A[nh - 1][i]);
    r[i] = y;
    rt[i] = (1.f - y * y) * AT[nh - 1][i];
  }
  for (int j = 0; j < H; ++j) {
    for (int i = 0; i < Hh; ++i)
      xn_gacc(G, off + j * Hh + i, obar[j] * r[i] + otbar[j] * rt[i], lane);
    xn_gacc(G, off + H * Hh + j, obar[j], lane);
  }
  for (int i = 0; i < Hh; ++i) {
    float yb = 0.f, ytb = 0.f;
    for (int j = 0; j < H; ++j) {
      yb = fmaf(Wo[j * Hh + i], obar[j], yb);
      ytb = fmaf(Wo[j * Hh + i], otbar[j], ytb);
    }
    const float y = r[i], s = 1.f - y * y;
    atb[i] = s * ytb;
    ab[i] = s * yb - 2.f * y * s * AT[nh - 1][i] * ytb;
  }
  // hidden layers l = nh-1 .. 1 map relu(A[l-1]) to A[l]
  for (int l = nh - 1; l >= 1; --l) {
    off -= Hh * Hh + Hh;
    const float* W = n.w + off;
    for (int i = 0; i < Hh; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      r[i] = on ? A[l - 1][i] : 0.f;
      rt[i] = on ? AT[l - 1][i] : 0.f;
    }
    for (int j = 0; j < Hh; ++j) {
      for (int i = 0; i < Hh; ++i)
        xn_gacc(G, off + j * Hh + i, ab[j] * r[i] + atb[j] * rt[i], lane);
      xn_gacc(G, off + Hh * Hh + j, ab[j], lane);
    }
    for (int i = 0; i < Hh; ++i) {
      float s = 0.f, st = 0.f;
      for (int j = 0; j < Hh; ++j) {
        s = fmaf(W[j * Hh + i], ab[j], s);
        st = fmaf(W[j * Hh + i], atb[j], st);
      }
      rb[i] = s;
      rtb[i] = st;
    }
    for (int i = 0; i < Hh; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      ab[i] = on ? rb[i] : 0.f;
      atb[i] = on ? rtb[i] : 0.f;
    }
  }
  // layer 0: input [feats, t, h], tangent [xt, 0, ht]
  for (int j = 0; j < Hh; ++j) {
    const int row = off0 + j * fin;
    for (int i = 0; i < F; ++i)
      xn_gacc(G, row + i, ab[j] * p.feats[i] + atb[j] * p.xt[i], lane);
    xn_gacc(G, row + F, ab[j] * t, lane);
    for (int i = 0; i < H; ++i)
      xn_gacc(G, row + F + 1 + i, ab[j] * h[i] + atb[j] * ht[i], lane);
    xn_gacc(G, off0 + Hh * fin + j, ab[j], lane);
  }
  for (int i = 0; i < H; ++i) {
    float s = 0.f, st = 0.f;
    for (int j = 0; j < Hh; ++j) {
      s = fmaf(W0[j * fin + F + 1 + i], ab[j], s);
      st = fmaf(W0[j * fin + F + 1 + i], atb[j], st);
    }
    hbar[i] += s;
    htbar[i] += st;
  }
}

// VJP of one joint substep from (h, ht) at time t: (hbar, htbar) hold the
// cotangents of the substep's output on entry and of its input on exit.
__device__ void xn_step_vjp(const XnNet& n, int method, const XnPath& p,
                            float t, float dt, const float* h,
                            const float* ht, float* hbar, float* htbar,
                            float* G, int lane) {
  float C[4], Ac[4], B[4];
  float Y[4][XN_MAX_WIDTH], YT[4][XN_MAX_WIDTH];
  float k[XN_MAX_WIDTH], kt[XN_MAX_WIDTH], hb0[XN_MAX_WIDTH],
      htb0[XN_MAX_WIDTH], kb[XN_MAX_WIDTH], ktb[XN_MAX_WIDTH],
      yb[XN_MAX_WIDTH], ytb[XN_MAX_WIDTH];
  const int H = n.H;
  const int S = xn_rk_table(method, C, Ac, B);
  for (int j = 0; j < H; ++j) {
    Y[0][j] = h[j];
    YT[0][j] = ht[j];
    hb0[j] = hbar[j];
    htb0[j] = htbar[j];
  }
  for (int s = 1; s < S; ++s) {
    xn_field_tan(n, p.c0, p.ct0, t + C[s - 1] * dt, Y[s - 1], YT[s - 1], k,
                 kt);
    const float a = Ac[s] * dt;
    for (int j = 0; j < H; ++j) {
      Y[s][j] = h[j] + a * k[j];
      YT[s][j] = ht[j] + a * kt[j];
    }
  }
  for (int j = 0; j < H; ++j) {
    kb[j] = dt * B[S - 1] * hb0[j];
    ktb[j] = dt * B[S - 1] * htb0[j];
  }
  for (int s = S - 1; s >= 0; --s) {
    for (int j = 0; j < H; ++j) yb[j] = ytb[j] = 0.f;
    xn_field_vjp(n, p, t + C[s] * dt, Y[s], YT[s], kb, ktb, yb, ytb, G,
                 lane);
    for (int j = 0; j < H; ++j) {
      hbar[j] += yb[j];
      htbar[j] += ytb[j];
    }
    if (s > 0) {
      const float a = Ac[s] * dt, b = dt * B[s - 1];
      for (int j = 0; j < H; ++j) {
        kb[j] = b * hb0[j] + a * yb[j];
        ktb[j] = b * htb0[j] + a * ytb[j];
      }
    }
  }
}

// VJP of the lift on (seed, st) for the cotangents (hbar, htbar) of h0.
__device__ void xn_lift_vjp(const XnNet& n, const XnPath& p,
                            const float* hbar, const float* htbar, float* G,
                            int lane) {
  float A[XN_MAX_FIELD_LAYERS][XN_MAX_WIDTH];
  float AT[XN_MAX_FIELD_LAYERS][XN_MAX_WIDTH];
  float r[XN_MAX_WIDTH], rt[XN_MAX_WIDTH], ab[XN_MAX_WIDTH],
      atb[XN_MAX_WIDTH], rb[XN_MAX_WIDTH], rtb[XN_MAX_WIDTH];
  const int H = n.H, nl = n.n_lift;
  for (int j = 0; j < H; ++j) {
    A[0][j] = n.w[j] * p.seed + n.w[H + j];
    AT[0][j] = n.w[j] * p.st;
  }
  for (int l = 1; l < nl; ++l) {
    const float* W = n.w + 2 * H + (l - 1) * (H * H + H);
    for (int i = 0; i < H; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      r[i] = on ? A[l - 1][i] : 0.f;
      rt[i] = on ? AT[l - 1][i] : 0.f;
    }
    xn_dense(W, H, H, r, A[l]);
    xn_dense_nb(W, H, H, rt, AT[l]);
  }
  for (int j = 0; j < H; ++j) {
    ab[j] = hbar[j];
    atb[j] = htbar[j];
  }
  for (int l = nl - 1; l >= 1; --l) {
    const int off = 2 * H + (l - 1) * (H * H + H);
    const float* W = n.w + off;
    for (int i = 0; i < H; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      r[i] = on ? A[l - 1][i] : 0.f;
      rt[i] = on ? AT[l - 1][i] : 0.f;
    }
    for (int j = 0; j < H; ++j) {
      for (int i = 0; i < H; ++i)
        xn_gacc(G, off + j * H + i, ab[j] * r[i] + atb[j] * rt[i], lane);
      xn_gacc(G, off + H * H + j, ab[j], lane);
    }
    for (int i = 0; i < H; ++i) {
      float s = 0.f, st = 0.f;
      for (int j = 0; j < H; ++j) {
        s = fmaf(W[j * H + i], ab[j], s);
        st = fmaf(W[j * H + i], atb[j], st);
      }
      rb[i] = s;
      rtb[i] = st;
    }
    for (int i = 0; i < H; ++i) {
      const bool on = A[l - 1][i] > 0.f;
      ab[i] = on ? rb[i] : 0.f;
      atb[i] = on ? rtb[i] : 0.f;
    }
  }
  for (int j = 0; j < H; ++j) {
    xn_gacc(G, j, ab[j] * p.seed + atb[j] * p.st, lane);
    xn_gacc(G, H + j, ab[j], lane);
  }
}

// Every lane of every warp runs the whole walk (the warp reductions need
// all 32): a thread past N*d works on path 0 with zero cotangents, which
// adds exactly zero to every gradient.
__global__ void xnode_udu_bwd_kernel(
    const float* __restrict__ params, int n_params,
    const float* __restrict__ t0, const float* __restrict__ dt,
    const float* __restrict__ feats, const float* __restrict__ dfeats,
    const float* __restrict__ seed, const float* __restrict__ dseed,
    const float* __restrict__ hs, const float* __restrict__ hts,
    const float* __restrict__ ub,   // [N, L]
    const float* __restrict__ dub,  // [N, L, d]
    float* __restrict__ partial,    // [gridDim.x, n_params]
    int N, int L, int d, int H, int Hh, int F, int n_lift, int n_field,
    int n_sub, int method) {
  extern __shared__ float smem[];
  float* sw = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* G = smem + (size_t)(1 + warp) * n_params;
  for (int i = threadIdx.x; i < n_params * (1 + n_warps); i += blockDim.x)
    smem[i] = i < n_params ? params[i] : 0.f;
  __syncthreads();

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = tid < N * d;
  const int q = active ? tid : 0;
  const float live = active ? 1.f : 0.f;
  const XnNet net = xn_net(sw, H, Hh, F, n_lift, n_field);
  XnPath p;
  xn_load_path(net, q, d, feats, dfeats, seed, dseed, p);
  const int ro = net.readout_off;
  const float* wr = sw + ro;

  float h[XN_MAX_WIDTH], ht[XN_MAX_WIDTH], he[XN_MAX_WIDTH],
      hte[XN_MAX_WIDTH], hbar[XN_MAX_WIDTH], htbar[XN_MAX_WIDTH];
  for (int j = 0; j < H; ++j) hbar[j] = htbar[j] = 0.f;

  for (int l = L - 1; l >= 0; --l) {
    for (int j = 0; j < H; ++j) {
      h[j] = hs[((size_t)l * N + p.n) * H + j];
      ht[j] = hts[((size_t)l * N * d + q) * H + j];
      he[j] = h[j];
      hte[j] = ht[j];
    }
    const size_t nl = (size_t)p.n * L + l;
    const float ta = t0[nl], dl = dt[nl];
    for (int s = 0; s < n_sub; ++s)
      xn_rk_step_tan(net, method, p.c0, p.ct0, ta + (float)s * dl, dl, he,
                     hte);
    // readout u = wr.h + br (share 0 only), du_k = wr.ht_k
    const float u_b = p.k == 0 ? live * ub[nl] : 0.f;
    const float du_b = live * dub[nl * d + p.k];
    for (int i = 0; i < H; ++i) {
      xn_gacc(G, ro + i, u_b * he[i] + du_b * hte[i], lane);
      hbar[i] += wr[i] * u_b;
      htbar[i] += wr[i] * du_b;
    }
    xn_gacc(G, ro + H, u_b, lane);
    // substeps in reverse, each recomputed from the interval start
    for (int s = n_sub - 1; s >= 0; --s) {
      for (int j = 0; j < H; ++j) {
        he[j] = h[j];
        hte[j] = ht[j];
      }
      for (int r = 0; r < s; ++r)
        xn_rk_step_tan(net, method, p.c0, p.ct0, ta + (float)r * dl, dl, he,
                       hte);
      xn_step_vjp(net, method, p, ta + (float)s * dl, dl, he, hte, hbar,
                  htbar, G, lane);
    }
  }
  xn_lift_vjp(net, p, hbar, htbar, G, lane);

  __syncthreads();
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += smem[(size_t)(1 + w) * n_params + i];
    partial[(size_t)blockIdx.x * n_params + i] = s;
  }
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

static cudaError_t xn_grad_checks(int N, int L, int d, int n_sub,
                                  int n_lift, int n_field) {
  if (N < 0 || L < 0 || d < 1 || n_sub < 1 || n_lift > XN_MAX_FIELD_LAYERS ||
      n_field > XN_MAX_FIELD_LAYERS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool STORE>
static int xn_udu_fwd(int device, void* stream, const float* params,
                      int n_params, const float* t0, const float* dt,
                      const float* feats, const float* dfeats,
                      const float* seed, const float* dseed, float* u,
                      float* du, float* hs, float* hts, int N, int L, int d,
                      int H, int Hh, int F, int n_lift, int n_field,
                      int n_sub, int method) {
  size_t smem = 0;
  cudaError_t e = xn_grad_checks(N, L, d, n_sub, n_lift, n_field);
  if (e != cudaSuccess) return (int)e;
  e = xn_prepare(xnode_udu_fwd_kernel<STORE>, device, H, Hh, F, n_lift,
                 n_field, method, n_params, &smem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0) return 0;
  const int blocks = (N * d + XN_FWD_THREADS - 1) / XN_FWD_THREADS;
  xnode_udu_fwd_kernel<STORE>
      <<<blocks, XN_FWD_THREADS, smem, (cudaStream_t)stream>>>(
          params, n_params, t0, dt, feats, dfeats, seed, dseed, u, du, hs,
          hts, N, L, d, H, Hh, F, n_lift, n_field, n_sub, method);
  return (int)cudaGetLastError();
}

extern "C" int xnode_udu_fwd_launch(int device, void* stream,
                                    const float* params, int n_params,
                                    const float* t0, const float* dt,
                                    const float* feats, const float* dfeats,
                                    const float* seed, const float* dseed,
                                    float* u, float* du, int N, int L, int d,
                                    int H, int Hh, int F, int n_lift,
                                    int n_field, int n_sub, int method) {
  return xn_udu_fwd<false>(device, stream, params, n_params, t0, dt, feats,
                           dfeats, seed, dseed, u, du, nullptr, nullptr, N,
                           L, d, H, Hh, F, n_lift, n_field, n_sub, method);
}

extern "C" int xnode_udu_fwd_store_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed, float* u,
    float* du, float* hs, float* hts, int N, int L, int d, int H, int Hh,
    int F, int n_lift, int n_field, int n_sub, int method) {
  return xn_udu_fwd<true>(device, stream, params, n_params, t0, dt, feats,
                          dfeats, seed, dseed, u, du, hs, hts, N, L, d, H,
                          Hh, F, n_lift, n_field, n_sub, method);
}

// threads: the block size the wrapper chose (a multiple of 32) so that the
// weights and one gradient accumulator per warp fit shared memory;
// partial holds ceil(N*d / threads) rows of n_params.
extern "C" int xnode_udu_bwd_launch(
    int device, void* stream, const float* params, int n_params,
    const float* t0, const float* dt, const float* feats,
    const float* dfeats, const float* seed, const float* dseed,
    const float* hs, const float* hts, const float* ub, const float* dub,
    float* partial, float* grad, int N, int L, int d, int H, int Hh, int F,
    int n_lift, int n_field, int n_sub, int method, int threads) {
  size_t smem = 0;
  cudaError_t e = xn_grad_checks(N, L, d, n_sub, n_lift, n_field);
  if (e != cudaSuccess) return (int)e;
  if (threads < 32 || threads % 32 != 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  e = xn_prepare(xnode_udu_bwd_kernel, device, H, Hh, F, n_lift, n_field,
                 method, n_params, &smem);
  if (e != cudaSuccess) return (int)e;
  smem = sizeof(float) * (size_t)n_params * (1 + threads / 32);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(xnode_udu_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = N * d > 0 ? (N * d + threads - 1) / threads : 0;
  if (blocks > 0 && L > 0) {
    xnode_udu_bwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        params, n_params, t0, dt, feats, dfeats, seed, dseed, hs, hts, ub,
        dub, partial, N, L, d, H, Hh, F, n_lift, n_field, n_sub, method);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    return (int)cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)n_params,
                                (cudaStream_t)stream);
  }
  xnode_udu_reduce_kernel<<<(n_params + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(partial, grad, blocks,
                                                    n_params);
  return (int)cudaGetLastError();
}
