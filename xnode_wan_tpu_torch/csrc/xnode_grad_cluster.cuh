// Kernel #5's cluster variant (xnode_udu_bwd_cluster_launch), for the nets
// whose gradient accumulator does not fit beside a tile in one block's
// shared memory (H = Hh = 64 at d = 5: 185 KB). It replaces, as the shared
// and global variants do, the JAX package's ops/pallas/xnode_train.py ::
// _bwd_kernel at those geometries, and computes what they compute: the
// packed primal weight cotangent of u_du_fused. Included by xnode_grad.cu,
// whose tile rows, RK tables, row loads and network packing it shares.
//
// What held the global variant back (the shared variant's tile design,
// its accumulator in the block's row of `partial`): every weight sum went
// through L2 as a read-modify-write (at 56/56, d = 5, one path a tile, the
// global variant took 39% longer than the shared one at the same tile and
// grid; at the cube's 20/10, 3%); each product's dependent steps waited on
// weights read through the read-only cache, whose L1 the full shared
// memory leaves small; and every RK stage's activations for every field
// layer left room for a few rows a tile.
//
// Design. C blocks (C = 2, 4 or 8) form a thread-block cluster and walk one
// tile of P paths together. Block c owns a slice [lo, lo + n) of the units
// of every layer (lo = w c / C for a width w): it computes those outputs of
// every product and keeps those units of every activation, stage and
// cotangent buffer, so a block holds about 1/C of the tile's state. A
// product needs its whole input: the pass that makes an input writes its
// slice into an exchange buffer of every block of the cluster (distributed
// shared memory), and a cluster barrier separates it from the product,
// which then reads the full input from its own shared memory. Two exchange
// buffers alternate, so a block never writes into one that a peer may
// still read. The VJP's weight sums are owned by input column: block c sums
// the entries W[j][i] of its input units i for every output j, from the
// full output cotangent (in the exchange) and its own slice of the layer's
// input; so the backward exchanges the cotangents only. Biases are owned by
// output unit. Each block keeps the accumulator entries it owns in its own
// shared memory (about 1/C of the net's weights); every entry is summed by
// one lane of the cluster in a fixed order. Each cluster writes one row of
// `partial`, which xnode_udu_reduce_kernel sums in order: two launches
// give bitwise equal gradients.
//
// The VJP's transposed products and weight sums run on the tensor cores:
// each is a small matrix product (at H = Hh = 64, d = 5: 32 units by 24
// rows by 64 inputs a block), cut into 16 x 8 warp tiles of mma.sync
// m16n8k8 in TF32, each operand split into a TF32 value and a rest
// (3xTF32), so the sums keep about FP32 accuracy (the limit is 2e-4 of
// each tensor's largest value). The forward recompute's products stay in
// FP32 FMAs: the relu masks the VJP walks back follow the signs of their
// pre-activations, and paths that pass within rounding of a kink must
// take the branch an FP32 sum takes as often as the other variants do. A
// product's slice of the weights is copied into shared memory with
// cp.async while the previous product runs (two buffers), and the block's
// biases, time column and readout weights are staged once. FP32 FMAs alone
// (the CUDA cores, the same data flow) were slower, bound by the
// instructions a warp issues for each float4 of input it reads.
#include "cluster_mma.cuh"

// ---------------------------------------------------------------------------
// Layout
// ---------------------------------------------------------------------------

// Floats of one buffer of a product's staged weights (XcWSlice): the
// largest slice either way, m units by the widest layer Wx.
__host__ __device__ inline int xc_wbuf(int Wx, int m) {
  const int rows = m * xc_ld(Wx, 4), cols = Wx * xc_ld(m, 4);
  return rows > cols ? rows : cols;
}



// Float offsets of one block's accumulator, each layer's owned entries:
// lift 0 W [mH] b [mH]; lift l >= 1 W [H][mH] b [mH]; field 0 W [Hh][cw0]
// (its feature, time and state columns) b [mHh]; hidden W [Hh][mHh] b
// [mHh]; output W [H][mHh] b [mH]; readout W [mH] b [1]. Widths are the
// largest slice's (m*), so every block has the same layout.
struct XcAcc {
  int mH, mHh, mF, cw0;
  int lift1, field0, hid1, out, readout, total;
};

__host__ __device__ inline XcAcc xc_acc(int H, int Hh, int F, int n_lift,
                                        int n_field, int C) {
  XcAcc a;
  a.mH = xc_max(H, C);
  a.mHh = xc_max(Hh, C);
  a.mF = xc_max(F, C);
  a.cw0 = a.mF + 1 + a.mH;
  int o = 2 * a.mH;
  a.lift1 = o;   o += (n_lift - 1) * (H * a.mH + a.mH);
  a.field0 = o;  o += Hh * a.cw0 + a.mHh;
  a.hid1 = o;    o += (n_field - 2) * (Hh * a.mHh + a.mHh);
  a.out = o;     o += H * a.mHh + a.mH;
  a.readout = o; o += a.mH + 1;
  a.total = xg_round4(o);
  return a;
}

// Float offsets of one block's shared buffers (the same in every block of
// the cluster; ops/kernels/xnode_train.py :: tile_smem_bytes restates the
// total). Exchange buffers [Wx][S] (Wx = max(H, Hh)) hold whole layers;
// every other buffer holds the block's slice, [m][S], but the features,
// seeds and readout cotangents, which every block loads whole.
struct XcLayout {
  int S, R, Wx, sst;
  XcAcc a;
  int ex0, ex1, acc, ws, fe, cf, sd, ub, t0, dt;
  // the block's units' vectors: each lift layer's bias, the lift's first
  // weight column, field layer 0's bias and time column, each hidden
  // bias, the field output's bias and the readout weights
  int u_lift_b, u_lift_w0, u_f0_b, u_f0_t, u_hid_b, u_out_b, u_wr;
  int hs, hb, hb0, yb;          // [mH][S]
  int ys, k, accu, he, hcur;    // the walk's (ys: ns - 1 of them)
  int fld;                      // (ns (n_field - 1) + 2) [mHh][S]
  int stage;                    // cp.async staging: [R][sst], ub [R], t0, dt
  int total;
};

__host__ __device__ inline XcLayout xc_layout(int P, int d, int H, int Hh,
                                              int F, int n_lift, int n_field,
                                              int method, int C) {
  XcLayout y;
  y.R = P * (1 + d);
  const int S = y.S = xg_stride(y.R), ns = xg_stages(method);
  y.a = xc_acc(H, Hh, F, n_lift, n_field, C);
  const int mH = y.a.mH, mHh = y.a.mHh;
  y.Wx = H > Hh ? H : Hh;
  int o = 0;
  y.ex0 = o;  o += y.Wx * S;
  y.ex1 = o;  o += y.Wx * S;
  y.acc = o;  o += y.a.total;
  y.ws = o;   o += 2 * xc_wbuf(y.Wx, mH > mHh ? mH : mHh);
  y.u_lift_b = o;  o += n_lift * mH;
  y.u_lift_w0 = o; o += mH;
  y.u_f0_b = o;    o += mHh;
  y.u_f0_t = o;    o += mHh;
  y.u_hid_b = o;   o += (n_field - 2) * mHh;
  y.u_out_b = o;   o += mH;
  y.u_wr = o;      o += mH;
  o = xg_round4(o);
  y.fe = o;   o += F * S;
  y.cf = o;   o += mHh * S;
  y.sd = o;   o += S;
  y.ub = o;   o += S;
  y.t0 = o;   o += xg_round4(P);
  y.dt = o;   o += xg_round4(P);
  y.hs = o;   o += mH * S;
  y.hb = o;   o += mH * S;
  y.hb0 = o;  o += mH * S;
  y.yb = o;   o += mH * S;
  // the walk's buffers; after the walk the lift's reuse them
  const int main0 = o;
  y.ys = o;   o += (ns - 1) * mH * S;
  y.k = o;    o += mH * S;
  y.accu = o; o += mH * S;
  y.he = o;   o += mH * S;
  y.hcur = o; o += mH * S;
  // per stage R_1..R_{nh-1}, AL; then YT, AS
  y.fld = o;  o += (ns * (n_field - 1) + 2) * mHh * S;
  const int lift = main0 + n_lift * mH * S;
  if (lift > o) o = lift;
  y.sst = xg_round4(mH);
  y.stage = o; o += y.R * y.sst + y.R + 2 * P;
  y.total = o;
  return y;
}

__host__ inline size_t xc_smem_bytes(const XcLayout& y) {
  return sizeof(float) * (size_t)y.total + sizeof(int) * (size_t)y.R;
}

// The block's place in the cluster: its rank, its slices and the exchange
// buffers (rd(): the one the current phase reads; pushes go to wr()).
struct XcCtx {
  int c, C;
  int loH, nH, loHh, nHh, loF, nF;
  float *rdp, *wrp;
  __device__ __forceinline__ float* rd() const { return rdp; }
  __device__ __forceinline__ float* wr() const { return wrp; }
  // the cluster barrier between a phase that pushes and one that reads
  __device__ __forceinline__ void swap() {
    xc_sync();
    float* t = rdp;
    rdp = wrp;
    wrp = t;
  }
};

// v into row r of unit u of the write exchange of every block.
__device__ __forceinline__ void xc_push(const XcCtx& x, int u, int r, int S,
                                        float v) {
  float* p = x.wr() + u * S + r;
  for (int q = 0; q < x.C; ++q) *xc_peer(p, q) = v;
}

// A product's weights: rows [r0, r0 + nr) by columns [c0, c0 + nc) of W
// (row stride ldw), staged in shared memory as [nr][ld]. A product over
// the block's output units takes their rows, a transposed product the
// block's columns of every row (xc_wslice, either way). ld, a multiple of 4
// (for 16-byte copies) that is 4 mod 32, spreads a warp's reads of a
// tensor-core fragment over the banks: lanes read rows g and columns t of
// the slice (g < 8, t < 4), 32 banks, for the rows; columns g and rows t,
// two lanes a bank, for the columns.
struct XcWSlice {
  const float* W;
  int ldw, r0, nr, c0, nc, ld;
};

__device__ __forceinline__ XcWSlice xc_wslice(const float* W, int ldw,
                                              int r0, int nr, int c0,
                                              int nc) {
  return XcWSlice{W, ldw, r0, nr, c0, nc, xc_ld(nc, 4)};
}

// Two staging buffers: a product reads cur (ld floats a row) while the
// next product's slice is copied into nxt with cp.async, every copy of the
// block in flight at once (16 bytes where the slice's rows allow it).
// issue() may follow ready() at once: nxt was last read by the product
// before the current one, which the barrier in ready() has seen finish.
struct XcWPipe {
  float *cur, *nxt;
  int ld, ld_nxt;
  __device__ __forceinline__ void issue(const XcWSlice& w) {
    const float* src0 = w.W + (size_t)w.r0 * w.ldw + w.c0;
    const bool vec = w.ldw % 4 == 0 && w.nc % 4 == 0 && w.ld % 4 == 0 &&
                     reinterpret_cast<size_t>(src0) % 16 == 0;
    float* dst = nxt;
    if (vec) {
      xg_each(w.nr, w.nc / 4, [&](int r, int q) {
        __pipeline_memcpy_async(dst + r * w.ld + 4 * q,
                                src0 + (size_t)r * w.ldw + 4 * q, 16);
      });
    } else {
      xg_each(w.nr, w.nc, [&](int r, int c) {
        __pipeline_memcpy_async(dst + r * w.ld + c,
                                src0 + (size_t)r * w.ldw + c, 4);
      });
    }
    __pipeline_commit();
    ld_nxt = w.ld;
  }
  // every thread's copies are in and seen by the block; nxt becomes cur
  __device__ __forceinline__ void ready() {
    __pipeline_wait_prior(0);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    ld = ld_nxt;
  }
};


// For j < n_out and the tile's rows r: epi(j, r, sum_{i < n_in} w(j, i)
// x[i][r]), x [n_in][S]. The block's warps take the 16 x 8 tiles of the
// (output, row) plane in turn; a tile inside the edges (and n_in a
// multiple of 8) reads without bounds checks.
template <class Wt, class Epi>
__device__ __forceinline__ void xc_prod(int n_out, int n_in, const float* x,
                                        const XgTile& g, Wt w, Epi epi) {
  const int NT = (g.R + 7) / 8, tiles = (n_out + 15) / 16 * NT;
  const int lane = threadIdx.x & 31, S = g.S, R = g.R;
  for (int t = threadIdx.x >> 5; t < tiles; t += blockDim.x >> 5) {
    const int j0 = t / NT * 16, r0 = (t - t / NT * NT) * 8;
    const float* xr = x + r0;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (j0 + 16 <= n_out && r0 + 8 <= R && n_in % 8 == 0)
      xc_tile(d, n_in, [&](int m, int k) { return w(j0 + m, k); },
              [&](int k, int c) { return xr[k * S + c]; });
    else
      xc_tile(d, n_in,
              [&](int m, int k) {
                return j0 + m < n_out && k < n_in ? w(j0 + m, k) : 0.f;
              },
              [&](int k, int c) {
                return k < n_in && r0 + c < R ? xr[k * S + c] : 0.f;
              });
    const int j = j0 + (lane >> 2), r = r0 + 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jq = j + (q >> 1) * 8, rq = r + (q & 1);
      if (jq < n_out && rq < R) epi(jq, rq, d[q]);
    }
  }
}

// The same product in FP32 FMAs on the CUDA cores, for the forward
// recompute: the relu masks the VJP walks back follow the signs of its
// pre-activations, and a 3xTF32 sum, a little further from the FP32 one,
// flips more of the paths that pass within rounding of a kink. A thread
// takes U outputs, JG apart, by four consecutive rows (one float4 of x a
// step); consecutive threads take consecutive row chunks of one output.
template <int U, class Wt, class Epi>
__device__ __forceinline__ void xc_prod_fma_u(int n_out, int n_in,
                                              const float* x,
                                              const XgTile& g, Wt w,
                                              Epi epi) {
  const int RC = (g.R + XG_RPT - 1) / XG_RPT, S4 = g.S / 4;
  const int JG = (n_out + U - 1) / U;
  xg_each(JG, RC, [&](int jg, int c) {
    const float4* xc = reinterpret_cast<const float4*>(x) + c;
    float4 s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_in; ++i) {
      const float4 v = xc[i * S4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = jg + u * JG;
        const float wu = j < n_out ? w(j, i) : 0.f;
        s[u].x = fmaf(wu, v.x, s[u].x);
        s[u].y = fmaf(wu, v.y, s[u].y);
        s[u].z = fmaf(wu, v.z, s[u].z);
        s[u].w = fmaf(wu, v.w, s[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jg + u * JG;
      if (j < n_out) {
        const float sv[XG_RPT] = {s[u].x, s[u].y, s[u].z, s[u].w};
#pragma unroll
        for (int m = 0; m < XG_RPT; ++m) {
          const int r = c * XG_RPT + m;
          if (r < g.R) epi(j, r, sv[m]);
        }
      }
    }
  });
}

// U = 2 where its items still fill the block, else 1.
template <class Wt, class Epi>
__device__ __forceinline__ void xc_prod_fma(int n_out, int n_in,
                                            const float* x, const XgTile& g,
                                            Wt w, Epi epi) {
  const int RC = (g.R + XG_RPT - 1) / XG_RPT;
  if (RC * ((n_out + 1) / 2) >= (int)blockDim.x)
    xc_prod_fma_u<2>(n_out, n_in, x, g, w, epi);
  else
    xc_prod_fma_u<1>(n_out, n_in, x, g, w, epi);
}

// ---------------------------------------------------------------------------
// The network on the cluster's tile
// ---------------------------------------------------------------------------

// relu of the block's pre-activations A [nHh][S] into its slice Rl and into
// every block's write exchange (units lo ..): a tangent row keeps its value
// where its path's primal pre-activation is positive.
__device__ __forceinline__ void xc_relu_push(const XcCtx& x, float* Rl,
                                             const float* A, int lo, int n,
                                             const XgTile& g) {
  xg_each(n, g.R, [&](int i, int r) {
    const float v = A[i * g.S + g.prim[r]] > 0.f ? A[i * g.S + r] : 0.f;
    if (Rl) Rl[i * g.S + r] = v;
    xc_push(x, lo + i, r, g.S, v);
  });
}

// The field's buffers of the block's Hh units, each [mHh][S]: per RK stage
// the relu outputs R_1..R_{nh-1} and the tanh layer's pre-activation AL,
// kstride apart; YT the tanh output, which the VJP recomputes from AL; AS a
// pre-activation (forward) or the output layer's input cotangent (VJP). CF
// holds W0[:, :F] applied to each row's features, FE the features.
struct XcField {
  float *R, *AL, *YT, *AS;
  const float *CF, *FE;
  const float *b0, *t0, *hb, *ob;  // field 0's bias and time column, each
                                   // hidden bias ([n_field - 2][mHh]), the
                                   // output's bias: the block's units
  int mHh;
  int rstride, kstride;
  __device__ __forceinline__ XcField stage(int s) const {
    XcField f = *this;
    f.R += (size_t)s * kstride;
    f.AL += (size_t)s * kstride;
    return f;
  }
};

// The field at the rows of ex.rd() (the stage input X, whole): keeps the
// block's slice of every activation in f and writes its units of the field
// into K [nH][S]. Leaves the exchanges swapped as often as it pushed.
__device__ __forceinline__ void xc_field_fwd(const XgNet& n, const XcField& f,
                                             XcCtx& x, XgTime tm, float* K,
                                             XcWPipe& wp, const XgTile& g) {
  const int nh = n.n_field - 1, Hh = n.Hh, H = n.H, S = g.S;
  const float* W0 = n.w + n.field_off;
  const float* b0 = W0 + Hh * n.fin;
  const float* Wo = n.w + n.out_off;
  // the weights of layer l's product over the block's output units
  auto rows = [&](int l) {
    if (l == 0) return xc_wslice(W0, n.fin, x.loHh, x.nHh, n.F + 1, H);
    if (l == nh) return xc_wslice(Wo, Hh, x.loH, x.nH, 0, Hh);
    return xc_wslice(n.w + n.hid_off + (l - 1) * (Hh * Hh + Hh), Hh, x.loHh,
                     x.nHh, 0, Hh);
  };
  wp.issue(rows(0));
  wp.ready();
  wp.issue(rows(1));
  {
    float* out = nh == 1 ? f.AL : f.AS;
    const int ld = wp.ld;
    const float* Ws = wp.cur;
    const float* CF = f.CF;
    xc_prod_fma(x.nHh, H, x.rd(), g,
                [&](int j, int i) { return Ws[j * ld + i]; },
                [&](int j, int r, float v) {
                  v += CF[j * S + r];
                  if (r < g.P) {
                    v = fmaf(f.t0[j], tm.at(r), v);
                    v += f.b0[j];
                  }
                  out[j * S + r] = v;
                });
    __syncthreads();
  }
  for (int l = 1; l < nh; ++l) {
    float* Rl = f.R + (size_t)(l - 1) * f.rstride;
    xc_relu_push(x, Rl, f.AS, x.loHh, x.nHh, g);
    x.swap();
    wp.ready();
    wp.issue(rows(l + 1));
    const float* hb = f.hb + (l - 1) * f.mHh;
    float* out = l == nh - 1 ? f.AL : f.AS;
    const int ld = wp.ld;
    const float* Ws = wp.cur;
    xc_prod_fma(x.nHh, Hh, x.rd(), g,
                [&](int j, int i) { return Ws[j * ld + i]; },
                [&](int j, int r, float v) {
                  if (r < g.P) v += hb[j];
                  out[j * S + r] = v;
                });
    __syncthreads();
  }
  // tanh: y on a primal row, (1 - y^2) at on its tangent rows
  xg_each(x.nHh, g.P, [&](int i, int p) {
    const float* ai = f.AL + i * S;
    const float yv = tanhf(ai[p]), s = 1.f - yv * yv;
    xc_push(x, x.loHh + i, p, S, yv);
    for (int k = 0, r = g.P + p * g.d; k < g.d; ++k, ++r)
      xc_push(x, x.loHh + i, r, S, s * ai[r]);
  });
  x.swap();
  wp.ready();
  const int ld = wp.ld;
  const float* Ws = wp.cur;
  xc_prod_fma(x.nH, Hh, x.rd(), g,
              [&](int j, int i) { return Ws[j * ld + i]; },
              [&](int j, int r, float v) {
                if (r < g.P) v += f.ob[j];
                K[j * S + r] = v;
              });
  __syncthreads();
}

// The walk's buffers of the block's H units, each [mH][S] but ys (ns - 1 of
// them, ystride apart).
struct XcWalk {
  float *HS, *HB, *HB0, *YB, *ys, *K, *ACC, *HE, *HCUR;
  XcWPipe* wp;  // the products' staged weights
  int ystride;
};

// One RK substep from X0 (the block's slice; ex.rd() holds it whole): the
// stage inputs go to w.ys (and, whole, to the exchange the next stage
// reads), each stage's activations to f.stage(s), the end X0 + dt sum_s B_s
// k_s to out (which may be X0); pushed whole too if push_out.
__device__ __forceinline__ void xc_step(const XgNet& n, const XcField& f,
                                        XcCtx& x, int method, const float* X0,
                                        const XcWalk& w, float* out,
                                        bool push_out, XgTime tm,
                                        const XgTile& g) {
  const int ns = XG_STAGES[method], S = g.S;
  for (int s = 0; s < ns; ++s) {
    tm.c = XG_C[method][s];
    xc_field_fwd(n, f.stage(s), x, tm, w.K, *w.wp, g);
    const float b = XG_B[method][s];
    const float a = s + 1 < ns ? XG_A[method][s + 1] : 0.f;
    float* yn = s + 1 < ns ? w.ys + (size_t)s * w.ystride : nullptr;
    xg_each(x.nH, g.R, [&](int i, int r) {
      const int e = i * S + r;
      const float dt = tm.dt[g.prim[r]], kv = w.K[e];
      w.ACC[e] = s == 0 ? b * kv : fmaf(b, kv, w.ACC[e]);
      if (yn) {
        const float v = X0[e] + (a * dt) * kv;
        yn[e] = v;
        xc_push(x, x.loH + i, r, S, v);
      }
    });
    if (yn)
      x.swap();
    else
      __syncthreads();
  }
  xg_each(x.nH, g.R, [&](int i, int r) {
    const int e = i * S + r;
    const float v = X0[e] + tm.dt[g.prim[r]] * w.ACC[e];
    out[e] = v;
    if (push_out) xc_push(x, x.loH + i, r, S, v);
  });
  if (push_out)
    x.swap();
  else
    __syncthreads();
}

// VJP of the field at the stage input Xs (the block's slice), whose
// activations xc_field_fwd kept in f, for the output cotangent in ex.rd()
// (whole): adds the block's weight sums to acc and writes its units of the
// input cotangent into XB.
__device__ __forceinline__ void xc_field_vjp(const XgNet& n, const XcField& f,
                                             XcCtx& x, const XcAcc& a,
                                             float* acc, const float* Xs,
                                             XgTime tm, float* XB,
                                             XcWPipe& wp, const XgTile& g) {
  const int H = n.H, Hh = n.Hh, nh = n.n_field - 1, R = g.R, S = g.S;
  const int o0 = n.field_off, fin = n.fin;
  const float* Wo = n.w + n.out_off;
  // the weights of layer l's transposed product: the block's input columns
  auto cols = [&](int l) {
    if (l == 0) return xc_wslice(n.w + o0, fin, 0, Hh, n.F + 1 + x.loH, x.nH);
    if (l == nh) return xc_wslice(Wo, Hh, 0, H, x.loHh, x.nHh);
    return xc_wslice(n.w + n.hid_off + (l - 1) * (Hh * Hh + Hh), Hh, 0, Hh,
                     x.loHh, x.nHh);
  };
  // the tanh output again, as xc_field_fwd made it
  xg_each(x.nHh, g.P, [&](int i, int p) {
    const float* ai = f.AL + i * S;
    float* oi = f.YT + i * S;
    const float yv = tanhf(ai[p]), s = 1.f - yv * yv;
    oi[p] = yv;
    for (int k = 0, r = g.P + p * g.d; k < g.d; ++k, ++r) oi[r] = s * ai[r];
  });
  wp.issue(cols(nh));
  wp.ready();  // its barrier also orders YT
  wp.issue(cols(nh - 1));
  {
    // output layer Wo [H][Hh]: columns of the block's Hh units
    const float* E = x.rd();
    xc_outer(acc + a.out, a.mHh, E, H, f.YT, x.nHh, R, S);
    xg_rowsum(acc + a.out + H * a.mHh, E + x.loH * S, x.nH, g);
    const int ld = wp.ld;
    const float* Ws = wp.cur;
    float* AB = f.AS;
    xc_prod(x.nHh, H, E, g, [&](int i, int j) { return Ws[j * ld + i]; },
            [&](int i, int r, float v) { AB[i * S + r] = v; });
    __syncthreads();
  }
  // tanh's VJP: s ytb on a tangent row, s yb - 2 y s sum_k at_k ytb_k on
  // the primal (s = 1 - y^2)
  xg_each(x.nHh, g.P, [&](int i, int p) {
    const float* ai = f.AL + i * S;
    const float* bi = f.AS + i * S;
    const float yv = tanhf(ai[p]), s = 1.f - yv * yv;
    float c = 0.f;
    for (int k = 0, r = g.P + p * g.d; k < g.d; ++k, ++r) {
      c = fmaf(ai[r], bi[r], c);
      xc_push(x, x.loHh + i, r, S, s * bi[r]);
    }
    xc_push(x, x.loHh + i, p, S, s * bi[p] - 2.f * yv * s * c);
  });
  x.swap();
  for (int l = nh - 1; l >= 1; --l) {
    wp.ready();
    wp.issue(cols(l - 1));
    const float* E = x.rd();
    const int ao = a.hid1 + (l - 1) * (Hh * a.mHh + a.mHh);
    const float* Rl = f.R + (size_t)(l - 1) * f.rstride;
    xc_outer(acc + ao, a.mHh, E, Hh, Rl, x.nHh, R, S);
    xg_rowsum(acc + ao + Hh * a.mHh, E + x.loHh * S, x.nHh, g);
    const int lo = x.loHh, ld = wp.ld;
    const float* Ws = wp.cur;
    xc_prod(x.nHh, Hh, E, g, [&](int i, int j) { return Ws[j * ld + i]; },
            [&](int i, int r, float v) {
              xc_push(x, lo + i, r, S, Rl[i * S + g.prim[r]] > 0.f ? v : 0.f);
            });
    x.swap();
  }
  // layer 0: input [feats, t, h], tangent [xt, 0, ht]
  wp.ready();
  const float* E = x.rd();
  float* A0 = acc + a.field0;
  xc_outer(A0, a.cw0, E, Hh, f.FE + x.loF * S, x.nF, R, S);
  if (x.c == 0) xg_time(A0 + a.mF, a.cw0, E, Hh, tm, g);
  xc_outer(A0 + a.mF + 1, a.cw0, E, Hh, Xs, x.nH, R, S);
  xg_rowsum(A0 + Hh * a.cw0, E + x.loHh * S, x.nHh, g);
  const int ld = wp.ld;
  const float* Ws = wp.cur;
  xc_prod(x.nH, Hh, E, g, [&](int i, int j) { return Ws[j * ld + i]; },
          [&](int i, int r, float v) { XB[i * S + r] = v; });
  __syncthreads();
}

// VJP of one substep from X0 (the block's slice) whose stage inputs are in
// w.ys and stage activations in f: w.HB holds the block's units of the
// cotangent of the substep's output on entry and of X0 on exit.
__device__ __forceinline__ void xc_step_vjp(const XgNet& n, const XcField& f,
                                            XcCtx& x, const XcAcc& a,
                                            int method, float* acc,
                                            const float* X0, const XcWalk& w,
                                            XgTime tm, const XgTile& g) {
  const int ns = XG_STAGES[method], S = g.S;
  const float bl = XG_B[method][ns - 1];
  xg_each(x.nH, g.R, [&](int i, int r) {
    const int e = i * S + r;
    const float hb = w.HB[e];
    w.HB0[e] = hb;
    xc_push(x, x.loH + i, r, S, (tm.dt[g.prim[r]] * bl) * hb);
  });
  x.swap();
  for (int s = ns - 1; s >= 0; --s) {
    tm.c = XG_C[method][s];
    xc_field_vjp(n, f.stage(s), x, a, acc,
                 s == 0 ? X0 : w.ys + (size_t)(s - 1) * w.ystride, tm, w.YB,
                 *w.wp, g);
    const float b = s > 0 ? XG_B[method][s - 1] : 0.f;
    const float av = XG_A[method][s];
    xg_each(x.nH, g.R, [&](int i, int r) {
      const int e = i * S + r;
      const float yb = w.YB[e];
      w.HB[e] += yb;
      if (s > 0) {
        const float dt = tm.dt[g.prim[r]];
        xc_push(x, x.loH + i, r, S, (dt * b) * w.HB0[e] + (av * dt) * yb);
      }
    });
    if (s > 0)
      x.swap();
    else
      __syncthreads();
  }
}

// Start the copies of the block's units of interval l's start states, and
// of its readout cotangents and times, into the staging buffer st: rows
// [R][sst], then ub [R], t0 [P], dt [P]. Rows of paths past N get zeros.
__device__ __forceinline__ void xc_prefetch(
    float* st, int sst, const float* __restrict__ hs,
    const float* __restrict__ hts, const float* __restrict__ ub,
    const float* __restrict__ dub, const float* __restrict__ t0,
    const float* __restrict__ dt, int l, int N, int L, int H, int n0,
    int live, int lo, int nu, bool vec, const XgTile& g) {
  const int P = g.P, d = g.d, R = g.R, w = vec ? 4 : 1;
  const int nq = (nu + w - 1) / w;
  for (int idx = threadIdx.x; idx < R * nq; idx += blockDim.x) {
    const int r = idx / nq, q = (idx - r * nq) * w;
    const int p = r < P ? r : (r - P) / d;
    float* dst = st + r * sst + q;
    if (p >= live) {
      for (int m = 0; m < w; ++m) dst[m] = 0.f;
      continue;
    }
    const float* src =
        r < P ? hs + ((size_t)l * N + n0 + r) * H + lo + q
              : hts + (((size_t)l * N + n0) * d + (r - P)) * H + lo + q;
    __pipeline_memcpy_async(dst, src, 4 * w);
  }
  float* sub = st + R * sst;
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

// The block's accumulator entries into the cluster's row of partial, at
// their places in the packed gradient.
__device__ __forceinline__ void xc_write_row(float* row, const float* acc,
                                             const XcAcc& a, const XgNet& n,
                                             const XcCtx& x) {
  const int H = n.H, Hh = n.Hh, F = n.F, fin = n.fin, T = blockDim.x;
  const int t = threadIdx.x;
  for (int j = t; j < x.nH; j += T) {  // lift 0, W [H][1] and b, by unit
    row[x.loH + j] = acc[j];
    row[H + x.loH + j] = acc[a.mH + j];
  }
  for (int l = 1; l < n.n_lift; ++l) {
    const int go = 2 * H + (l - 1) * (H * H + H);
    const int lo = a.lift1 + (l - 1) * (H * a.mH + a.mH);
    for (int e = t; e < H * x.nH; e += T) {
      const int j = e / x.nH, i = e - j * x.nH;
      row[go + j * H + x.loH + i] = acc[lo + j * a.mH + i];
    }
    for (int j = t; j < x.nH; j += T)
      row[go + H * H + x.loH + j] = acc[lo + H * a.mH + j];
  }
  {
    const int go = n.field_off, lo = a.field0;
    const int nc = x.nF + 1 + x.nH;
    for (int e = t; e < Hh * nc; e += T) {
      const int j = e / nc, k = e - j * nc;
      if (k < x.nF)
        row[go + j * fin + x.loF + k] = acc[lo + j * a.cw0 + k];
      else if (k == x.nF) {
        if (x.c == 0) row[go + j * fin + F] = acc[lo + j * a.cw0 + a.mF];
      } else {
        const int i = k - x.nF - 1;
        row[go + j * fin + F + 1 + x.loH + i] =
            acc[lo + j * a.cw0 + a.mF + 1 + i];
      }
    }
    for (int j = t; j < x.nHh; j += T)
      row[go + Hh * fin + x.loHh + j] = acc[lo + Hh * a.cw0 + j];
  }
  for (int l = 1; l < n.n_field - 1; ++l) {
    const int go = n.hid_off + (l - 1) * (Hh * Hh + Hh);
    const int lo = a.hid1 + (l - 1) * (Hh * a.mHh + a.mHh);
    for (int e = t; e < Hh * x.nHh; e += T) {
      const int j = e / x.nHh, i = e - j * x.nHh;
      row[go + j * Hh + x.loHh + i] = acc[lo + j * a.mHh + i];
    }
    for (int j = t; j < x.nHh; j += T)
      row[go + Hh * Hh + x.loHh + j] = acc[lo + Hh * a.mHh + j];
  }
  for (int e = t; e < H * x.nHh; e += T) {
    const int j = e / x.nHh, i = e - j * x.nHh;
    row[n.out_off + j * Hh + x.loHh + i] = acc[a.out + j * a.mHh + i];
  }
  for (int j = t; j < x.nH; j += T) {
    row[n.out_off + H * Hh + x.loH + j] = acc[a.out + H * a.mHh + j];
    row[n.readout_off + x.loH + j] = acc[a.readout + j];
  }
  if (x.c == 0 && t == 0) row[n.readout_off + H] = acc[a.readout + a.mH];
}

// #5 on clusters of C blocks: cluster k walks tiles k, k + G, ... (G =
// gridDim.x / C clusters), from interval L-1 down to 0, as
// xnode_udu_bwd_kernel does, each block computing its units; partial holds
// one row a cluster.
__global__ void __launch_bounds__(XG_MAX_THREADS, 1)
xnode_udu_bwd_cluster_kernel(const float* __restrict__ params, int n_params,
                             const float* __restrict__ t0,
                             const float* __restrict__ dt,
                             const float* __restrict__ feats,
                             const float* __restrict__ dfeats,
                             const float* __restrict__ seed,
                             const float* __restrict__ dseed,
                             const float* __restrict__ hs,
                             const float* __restrict__ hts,
                             const float* __restrict__ ub,
                             const float* __restrict__ dub,
                             float* __restrict__ partial,
                             int N, int L, int d, int H, int Hh, int F,
                             int n_lift, int n_field, int n_sub, int method,
                             int P, int vec, int C) {
  extern __shared__ __align__(16) float smem[];
  const XgNet n = xg_net(params, H, Hh, F, n_lift, n_field);
  const XcLayout y =
      xc_layout(P, d, H, Hh, F, n_lift, n_field, method, C);
  const XcAcc& a = y.a;
  XgTile g;
  g.P = P;
  g.d = d;
  g.R = y.R;
  g.S = y.S;
  int* prim = reinterpret_cast<int*>(smem + y.total);
  g.prim = prim;
  const int S = g.S, R = g.R, ns = XG_STAGES[method];
  XcCtx x;
  x.c = xc_rank();
  x.C = C;
  x.loH = xc_lo(H, x.c, C);
  x.nH = xc_lo(H, x.c + 1, C) - x.loH;
  x.loHh = xc_lo(Hh, x.c, C);
  x.nHh = xc_lo(Hh, x.c + 1, C) - x.loHh;
  x.loF = xc_lo(F, x.c, C);
  x.nF = xc_lo(F, x.c + 1, C) - x.loF;
  x.rdp = smem + y.ex0;
  x.wrp = smem + y.ex1;
  float* acc = smem + y.acc;
  float *FE = smem + y.fe, *CF = smem + y.cf, *SD = smem + y.sd,
        *UB = smem + y.ub, *T0 = smem + y.t0, *DT = smem + y.dt,
        *ST = smem + y.stage;
  const int sst = y.sst, HS_ = a.mH * S;
  XcWalk w;
  w.HS = smem + y.hs;
  w.HB = smem + y.hb;
  w.HB0 = smem + y.hb0;
  w.YB = smem + y.yb;
  w.ys = smem + y.ys;
  w.ystride = HS_;
  w.K = smem + y.k;
  w.ACC = smem + y.accu;
  w.HE = smem + y.he;
  w.HCUR = smem + y.hcur;
  XcWPipe wp;
  wp.cur = smem + y.ws;
  wp.nxt = wp.cur + xc_wbuf(y.Wx, a.mH > a.mHh ? a.mH : a.mHh);
  wp.ld = wp.ld_nxt = 0;
  w.wp = &wp;
  const int HhS = a.mHh * S;
  XcField f;
  f.R = smem + y.fld;
  f.rstride = HhS;
  f.kstride = (n_field - 1) * HhS;
  f.AL = f.R + (n_field - 2) * HhS;
  f.YT = f.R + (size_t)ns * f.kstride;
  f.AS = f.YT + HhS;
  f.CF = CF;
  f.FE = FE;
  f.b0 = smem + y.u_f0_b;
  f.t0 = smem + y.u_f0_t;
  f.hb = smem + y.u_hid_b;
  f.ob = smem + y.u_out_b;
  f.mHh = a.mHh;
  const float* wr = smem + y.u_wr;

  for (int i = threadIdx.x; i < a.total; i += blockDim.x) acc[i] = 0.f;
  {
    float* u = smem + y.u_lift_b;
    for (int l = 0; l < n_lift; ++l) {
      const float* b = l == 0 ? n.w + H : n.w + 2 * H + (l - 1) * (H * H + H)
                                              + H * H;
      for (int j = threadIdx.x; j < x.nH; j += blockDim.x)
        u[l * a.mH + j] = b[x.loH + j];
    }
    const float* W0 = n.w + n.field_off;
    for (int j = threadIdx.x; j < x.nH; j += blockDim.x) {
      smem[y.u_lift_w0 + j] = n.w[x.loH + j];
      smem[y.u_out_b + j] = n.w[n.out_off + H * Hh + x.loH + j];
      smem[y.u_wr + j] = n.w[n.readout_off + x.loH + j];
    }
    for (int j = threadIdx.x; j < x.nHh; j += blockDim.x) {
      smem[y.u_f0_b + j] = W0[Hh * n.fin + x.loHh + j];
      smem[y.u_f0_t + j] = W0[(size_t)(x.loHh + j) * n.fin + F];
      for (int l = 1; l < n_field - 1; ++l)
        smem[y.u_hid_b + (l - 1) * a.mHh + j] =
            n.w[n.hid_off + (l - 1) * (Hh * Hh + Hh) + Hh * Hh + x.loHh + j];
    }
  }
  xc_sync();  // every block of the cluster runs before the first push
  const int cluster = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int n_tiles = (N + P - 1) / P;
  for (int tile = cluster; tile < n_tiles; tile += n_clusters) {
    const int n0 = tile * P, live = min(P, N - n0);
    __syncthreads();  // the previous tile's last reads are done
    xg_load_rows(prim, FE, SD, feats, dfeats, seed, dseed, n0, live, F, g);
    for (int idx = threadIdx.x; idx < x.nH * S; idx += blockDim.x)
      w.HB[idx] = 0.f;
    xc_prefetch(ST, sst, hs, hts, ub, dub, t0, dt, L - 1, N, L, H, n0, live,
                x.loH, x.nH, vec, g);
    __syncthreads();
    xg_dense<false>(CF, n.w + n.field_off + (size_t)x.loHh * n.fin, n.fin,
                    x.nHh, F, FE, g);

    for (int l = L - 1; l >= 0; --l) {
      __pipeline_wait_prior(0);
      __syncthreads();  // the staged interval and CF are in
      xg_each(R, x.nH, [&](int r, int j) {
        const float v = ST[r * sst + j];
        w.HS[j * S + r] = v;
        xc_push(x, x.loH + j, r, S, v);
      });
      for (int r = threadIdx.x; r < R; r += blockDim.x) UB[r] = ST[R * sst + r];
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        T0[p] = ST[R * sst + R + p];
        DT[p] = ST[R * sst + R + P + p];
      }
      x.swap();  // ex.rd(): the interval's start state, whole
      if (l > 0)
        xc_prefetch(ST, sst, hs, hts, ub, dub, t0, dt, l - 1, N, L, H, n0,
                    live, x.loH, x.nH, vec, g);
      for (int sub = n_sub - 1; sub >= 0; --sub) {
        XgTime tm{T0, DT, 0.f, 0.f};
        if (sub < n_sub - 1) {  // a later substep's walk used the exchange
          xg_each(x.nH, R, [&](int i, int r) {
            xc_push(x, x.loH + i, r, S, w.HS[i * S + r]);
          });
          x.swap();
        }
        // substeps 0 .. sub-1 recompute this one's start into HCUR (and,
        // whole, into the exchange); substep sub keeps its stage inputs
        // and activations, which the VJP walks back, and ends in HE
        const float* X0 = w.HS;
        for (int s = 0; s <= sub; ++s) {
          tm.sub = (float)s;
          xc_step(n, f, x, method, X0, w, s < sub ? w.HCUR : w.HE, s < sub,
                  tm, g);
          if (s < sub) X0 = w.HCUR;
        }
        const bool last = sub == n_sub - 1;
        if (last) {  // readout u = wr.h + br, du_k = wr.ht_k
          xc_outer(acc + a.readout, 1, w.HE, x.nH, UB, 1, R, S);
          if (x.c == 0) xg_rowsum(acc + a.readout + a.mH, UB, 1, g);
          xg_each(x.nH, R, [&](int i, int r) {
            w.HB[i * S + r] += wr[i] * UB[r];
          });
          __syncthreads();
        }
        xc_step_vjp(n, f, x, a, method, acc, X0, w, tm, g);
      }
    }
    // the lift on the rows' seeds, then its VJP; its buffers reuse the
    // walk's: LR_1 .. LR_{n_lift-1} (the relu outputs, the block's units),
    // LS the pre-activations
    float* LR = w.ys;
    float* LS = LR + (size_t)(n_lift - 1) * HS_;
    {
      const float* w0 = smem + y.u_lift_w0;
      const float* b0 = smem + y.u_lift_b;
      xc_prod_fma(x.nH, 1, SD, g, [&](int j, int) { return w0[j]; },
              [&](int j, int r, float v) {
                if (r < g.P) v += b0[j];
                LS[j * S + r] = v;
              });
      __syncthreads();
    }
    for (int l = 1; l < n_lift; ++l) {
      float* Rl = LR + (size_t)(l - 1) * HS_;
      if (l == n_lift - 1) {  // the last layer's input: kept, not pushed
        xg_each(x.nH, R, [&](int i, int r) {
          Rl[i * S + r] = LS[i * S + prim[r]] > 0.f ? LS[i * S + r] : 0.f;
        });
        __syncthreads();
        break;
      }
      xc_relu_push(x, Rl, LS, x.loH, x.nH, g);
      x.swap();
      const float* W = n.w + 2 * H + (l - 1) * (H * H + H);
      const float* lb = smem + y.u_lift_b + l * a.mH;
      wp.issue(xc_wslice(W, H, x.loH, x.nH, 0, H));
      wp.ready();
      const int ld = wp.ld;
      const float* Ws = wp.cur;
      xc_prod_fma(x.nH, H, x.rd(), g,
                  [&](int j, int i) { return Ws[j * ld + i]; },
                  [&](int j, int r, float v) {
                    if (r < g.P) v += lb[j];
                    LS[j * S + r] = v;
                  });
      __syncthreads();
    }
    xg_each(x.nH, R, [&](int i, int r) {
      xc_push(x, x.loH + i, r, S, w.HB[i * S + r]);
    });
    x.swap();
    for (int l = n_lift - 1; l >= 1; --l) {
      const float* E = x.rd();
      const int ao = a.lift1 + (l - 1) * (H * a.mH + a.mH);
      const float* Rl = LR + (size_t)(l - 1) * HS_;
      xc_outer(acc + ao, a.mH, E, H, Rl, x.nH, R, S);
      xg_rowsum(acc + ao + H * a.mH, E + x.loH * S, x.nH, g);
      const float* W = n.w + 2 * H + (l - 1) * (H * H + H);
      const int lo = x.loH;
      wp.issue(xc_wslice(W, H, 0, H, lo, x.nH));
      wp.ready();
      const int ld = wp.ld;
      const float* Ws = wp.cur;
      xc_prod(x.nH, H, E, g, [&](int i, int j) { return Ws[j * ld + i]; },
              [&](int i, int r, float v) {
                xc_push(x, lo + i, r, S, Rl[i * S + prim[r]] > 0.f ? v : 0.f);
              });
      x.swap();
    }
    xc_outer(acc, 1, x.rd() + x.loH * S, x.nH, SD, 1, R, S);
    xg_rowsum(acc + a.mH, x.rd() + x.loH * S, x.nH, g);
  }
  xc_sync();  // no block leaves while a peer may still push into it
  xc_write_row(partial + (size_t)cluster * n_params, acc, a, n, x);
}
