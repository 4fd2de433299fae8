// Kernel #7's cluster variant (disc_bwd_cluster_launch), for the
// adversaries whose gradient accumulator does not fit beside a tile in one
// block's shared memory (2v's 256-wide tied net: 67,841 weights, 265 KB).
// It replaces, as the shared and global variants do, the JAX package's
// ops/pallas/disc_train.py :: _v_bwd_kernel at those geometries, and
// computes what they compute: the gradient of sum(v vb) + sum(gin gb) in
// the packed weights, second-order terms included, summed over the points.
// Included by disc_train.cu, whose network packing, row stride and stages
// it shares.
//
// What held the global variant back (its accumulator in the block's row of
// `partial`): every weight sum of a tile of 4-8 points went through L2 as a
// read-modify-write (18 H x H outer products a tile at 2v), and every
// product re-read its weights through the read-only cache, whose L1 the
// full shared memory leaves small; all in FP32 FMAs.
//
// Bound on an H100 SXM at 2v (F = 6, H = 256, L = 9, 80,000 points): the
// FP32 forward recompute 94.7 GFLOP (1.41 ms at 67 TFLOP/s) and the rest,
// in 3xTF32, 472.9 GFLOP (2.87 ms at 495 / 3 TFLOP/s), against 4.7 MB:
// bound by operations.
//
// Design (xnode_grad_cluster.cuh, #5's cluster variant, is the template).
// C blocks (C = 2, 4 or 8) form a thread-block cluster and walk one tile of
// P points together. Block c owns a slice [lo, lo + n) of the H units of
// every layer (lo = H c / C): it computes those outputs of every product and
// keeps those units of A_0..A_L, G_0..G_L and the two cotangent buffers.
// A product needs its whole input: the pass that makes an input writes its
// slice into an exchange buffer of every block of the cluster (distributed
// shared memory), and a cluster barrier separates it from the product. Two
// exchange buffers alternate, so a block never writes into one that a peer
// may still read; the forward's reverse reads two whole vectors a step
// (abar and relu(a_i)), so there the buffers are refilled after a second
// barrier. The features, gb and vb are loaded whole by every block.
//
// Each block owns the weight cotangents of its units' rows, W[j][:] for j
// in its slice, of every layer (and the biases and w_o of those units; b_o
// is block 0's): the sweep's reverse sums g_{i+1}[j] tbar_i[k] from its own
// g and the whole tbar_i in the exchange, the forward's reverse abar[j]
// relu(a_i)[k] from its own abar and the whole relu(a_i). The entries stay
// in the block's shared memory for the whole launch (about n_params / C
// floats), each summed by one lane of the cluster in a fixed order; each
// cluster writes one row of `partial` at the end, which disc_reduce_kernel
// sums in order: two launches give bitwise equal gradients.
//
// Arithmetic. The forward recompute (stage 1) sums in FP32 FMAs in the
// shared variant's order (inputs in index order, the bias last), because
// the relu masks the reverses walk follow its signs: a point within
// rounding of a kink takes the branch the other variants take. The sweep,
// both reverses and every weight sum run on the tensor cores
// (mma.sync.m16n8k8 in TF32, each operand split into a TF32 value and a
// rest: 3xTF32, about FP32 accuracy), cut along the inputs over the block's
// warps where a product has fewer 16 x 8 tiles than warps. The net is
// tied, and the block's rows and columns of its hidden layer stay in
// shared memory for the whole launch, so no hidden weight is read from
// device memory after the first tile. (With the weights staged into shared
// memory for each product instead, untied nets and the 558-wide one ran
// slower than the global variant: ops/kernels/disc_train.py ::
// cluster_choice takes this variant only where the weights stay.)
#include "cluster_mma.cuh"

// Threads of a block of the cluster variant
// (ops/kernels/disc_train.py :: CLUSTER_THREADS): 16 warps, so that a
// scheduler has four to hide each one's chains of dependent steps (faster
// than 256 or 384 threads at the 256-wide net on an H100)
#define XK_THREADS 512

// Tiles of 8 points a product's warp tile covers: one, two or four (a tile
// of P points needs ceil(P / 8); 3 is taken as 4).
__host__ __device__ constexpr int xk_nb(int P) {
  return P <= 8 ? 1 : P <= 16 ? 2 : 4;
}

// Float offsets of one block's shared buffers (the same in every block of
// the cluster; ops/kernels/disc_train.py :: cluster_smem_bytes restates
// the total): two exchange buffers [H][S]; the block's units of A_0..A_L,
// G_0..G_L and two cotangent buffers, each [mH][S]; the features and gb
// [F][S] and vb [S]; the accumulator; the split products' partial tiles;
// and the block's rows of the hidden layer [mH][ldw] and its columns,
// transposed, [mH][ldw].
struct XkLayout {
  int S, mH, ldw, ldh;
  int ex0, ex1, A, G, T0, T1, Z, GB, VB;
  int acc, acc_n, a_w0, a_b0, a_hid, a_wo;  // a_*: within acc
  int scr, wr, wt, total;
};

// The accumulator's layout, at the widest slice mH so every block has the
// same: the hidden layer's rows [mH][ldh] and b [mH], W0's rows [mH][F] (on
// 16 bytes), b0 [mH], w_o [mH], b_o. ldh, H rounded up to 8 mod 32: the 8
// row groups of a tensor-core tile fall on distinct banks, and pairs of
// entries on 8 bytes.
__host__ __device__ inline XkLayout xk_layout(int F, int H, int L, int C,
                                              int P) {
  XkLayout y;
  const int S = y.S = xd_bwd_stride(P);
  const int mH = y.mH = xc_max(H, C);
  y.ldh = xc_ld(H, 8);
  int o = 0;
  y.ex0 = o; o += H * S;
  y.ex1 = o; o += H * S;
  y.A = o;   o += (L + 1) * mH * S;
  y.G = o;   o += (L + 1) * mH * S;
  y.T0 = o;  o += mH * S;
  y.T1 = o;  o += mH * S;
  y.Z = o;   o += F * S;
  y.GB = o;  o += F * S;
  y.VB = o;  o += S;
  y.a_hid = 0;
  int a = (mH * y.ldh + mH + 3) / 4 * 4;
  y.a_w0 = a;      a += mH * F;
  y.a_b0 = a;      a += mH;
  y.a_wo = a;      a += mH + 1;
  y.acc = o;
  y.acc_n = (a + 3) / 4 * 4;
  o += y.acc_n;
  y.scr = o; o += XK_THREADS / 32 * 128 * xk_nb(P);
  y.ldw = xc_ld(H, 4);
  y.wr = o;  o += mH * y.ldw;
  y.wt = o;  o += mH * y.ldw;
  y.total = o;
  return y;
}

__host__ inline size_t xk_smem_bytes(const XkLayout& y) {
  return sizeof(float) * (size_t)y.total;
}

// Weight (o, k) of a product over the block's units, p[o rs + k cs]: in
// shared memory (SMEM) or through the read-only cache.
template <bool SMEM>
struct XkW {
  const float* p;
  int rs, cs;
  __device__ __forceinline__ float operator()(int o, int k) const {
    const float* q = p + o * rs + k * cs;
    return SMEM ? *q : __ldg(q);
  }
};

// The block's n units of src [mH][S] into rows lo.. of ex of every block,
// four points a store; consecutive threads take consecutive stores to one
// block.
__device__ __forceinline__ void xk_push_rows(float* ex, const float* src,
                                             int n, int P, int S, int lo,
                                             int C) {
  const int np = P / 4, items = n * np;
  for (int t = threadIdx.x; t < items * C; t += blockDim.x) {
    const int q = t / items, i = t - q * items;
    const int o = i / np, p0 = (i - o * np) * 4;
    *reinterpret_cast<float4*>(xc_peer(ex + (lo + o) * S + p0, q)) =
        *reinterpret_cast<const float4*>(src + o * S + p0);
  }
}

// The forward recompute: out[o][p] = sum_{k < K} w(o, k) X[k][p] + b[o]
// (relu'd where RELU) for the block's units o < n and the tile's points,
// X [K][S]: each output sums its inputs in index order and adds its bias
// last, as xd_dense does. A thread takes one unit by two points.
template <bool RELU, class Wt>
__device__ __forceinline__ void xk_dense(float* out, Wt w,
                                         const float* __restrict__ b,
                                         const float* X, int n, int K, int P,
                                         int S) {
  const int np = P / 2;
  for (int t = threadIdx.x; t < n * np; t += blockDim.x) {
    const int o = t / np, p0 = (t - o * np) * 2;
    float2 s = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(X + k * S + p0);
      const float wk = w(o, k);
      s.x = fmaf(wk, v.x, s.x);
      s.y = fmaf(wk, v.y, s.y);
    }
    const float bo = __ldg(b + o);
    s.x += bo;
    s.y += bo;
    if (RELU) {
      s.x = fmaxf(s.x, 0.f);
      s.y = fmaxf(s.y, 0.f);
    }
    *reinterpret_cast<float2*>(out + o * S + p0) = s;
  }
}

// One k-step (k0 .. k0 + 7) of a warp's NB tiles of 16 x 8, A(m, k) B(nb,
// k, c): a lane loads A at rows g, g + 8 and columns t, t + 4 and B at rows
// t, t + 4 and column g (g = lane / 4, t = lane % 4); A's split serves the
// NB tiles. The big parts' products go to e, the cross terms to x.
template <int NB, class Af, class Bf>
__device__ __forceinline__ void xk_kstep(int k0, Af& A, Bf& B,
                                         float (&x)[NB][4],
                                         float (&e)[NB][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned ab[4], as[4];
  xc_split(A(g, k0 + t), ab[0], as[0]);
  xc_split(A(g + 8, k0 + t), ab[1], as[1]);
  xc_split(A(g, k0 + t + 4), ab[2], as[2]);
  xc_split(A(g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    unsigned bb[2], bs[2];
    xc_split(B(nb, k0 + t, g), bb[0], bs[0]);
    xc_split(B(nb, k0 + t + 4, g), bb[1], bs[1]);
    xc_mma(x[nb], as, bb);
    xc_mma(x[nb], ab, bs);
    xc_mma(e[nb], ab, bb);
  }
}

// d[nb] += sum_{k < K} A(m, k) B(nb, k, c) for a warp's NB tiles on the
// tensor cores in 3xTF32 (xk_kstep); with one tile, even and odd k-steps
// go to separate sums too, so the warp has four chains of products in
// flight. The sums are added in a fixed order at the end.
template <int NB, class Af, class Bf>
__device__ __forceinline__ void xk_tiles(float (&d)[NB][4], int K, Af A,
                                         Bf B) {
  float x[NB][4] = {}, e[NB][4] = {};
  if constexpr (NB == 1) {
    float x1[1][4] = {}, e1[1][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      xk_kstep<1>(k0, A, B, x, e);
      if (k0 + 8 < K) xk_kstep<1>(k0 + 8, A, B, x1, e1);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[0][q] += x1[0][q];
      e[0][q] += e1[0][q];
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) xk_kstep<NB>(k0, A, B, x, e);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[nb][q] += x[nb][q] + e[nb][q];
}

// For o < n and the tile's points p < P: epi(o, p, sum_{k < K} w(o, k)
// X[k][p]), X [K][S], on the tensor cores in 3xTF32. A warp takes 16 units
// by all of the tile's points (NB tiles of 8); where there are fewer such
// blocks than warps, each is cut into ks parts along k (each at least 16
// inputs), one a warp, whose sums go through scr and are added in part
// order. The caller orders epi's writes before their readers.
template <int NB, class Wt, class Epi>
__device__ __forceinline__ void xk_prod(int n, int K, const float* X, int P,
                                        int S, Wt w, float* scr, Epi epi) {
  const int nj = (n + 15) / 16;
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  int ks = 1;
  while (2 * ks * nj <= nw && 2 * ks * 16 <= K) ks *= 2;
  const int kc = ((K + ks - 1) / ks + 7) / 8 * 8;
  for (int it = threadIdx.x >> 5; it < nj * ks; it += nw) {
    const int jb = it / ks, part = it - jb * ks, j0 = jb * 16;
    const int k0 = min(K, part * kc), nk = min(K, k0 + kc) - k0;
    const float* xr = X + k0 * S;
    float d[NB][4] = {};
    if (j0 + 16 <= n && 8 * NB == P && nk % 8 == 0)
      xk_tiles<NB>(d, nk, [&](int m, int k) { return w(j0 + m, k0 + k); },
                   [&](int nb, int k, int c) {
                     return xr[k * S + 8 * nb + c];
                   });
    else
      xk_tiles<NB>(d, nk,
                   [&](int m, int k) {
                     return j0 + m < n && k < nk ? w(j0 + m, k0 + k) : 0.f;
                   },
                   [&](int nb, int k, int c) {
                     return k < nk && 8 * nb + c < P ? xr[k * S + 8 * nb + c]
                                                     : 0.f;
                   });
    const int j = j0 + (lane >> 2), p = 2 * (lane & 3);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (ks > 1) {
          scr[((it * NB + nb) * 4 + q) * 32 + lane] = d[nb][q];
          continue;
        }
        const int jq = j + (q >> 1) * 8, pq = 8 * nb + p + (q & 1);
        if (jq < n && pq < P) epi(jq, pq, d[nb][q]);
      }
  }
  if (ks == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < nj * NB * 128; e += blockDim.x) {
    const int jb = e / (NB * 128), r = e - jb * NB * 128;
    const int nb = r >> 7, q = (r >> 5) & 3, ln = r & 31;
    float v = 0.f;
    for (int part = 0; part < ks; ++part)
      v += scr[(((jb * ks + part) * NB + nb) * 4 + q) * 32 + ln];
    const int j = jb * 16 + (ln >> 2) + (q >> 1) * 8;
    const int p = 8 * nb + 2 * (ln & 3) + (q & 1);
    if (j < n && p < P) epi(j, p, v);
  }
}

// acc[j lda + i] += sum_{p < P} X[j][p] Y[i][p] for j < nx, i < ny (X, Y
// with row stride S), each entry's sum in one lane, in a fixed order, on
// the tensor cores in 3xTF32 (KB = ceil(P / 8) k-steps). A warp keeps a
// 16-row block of X split in registers and walks its share of Y's 8-row
// tiles two at a time; the lanes add pairs of entries (lda even) or single
// ones into the accumulator.
template <int KB>
__device__ __forceinline__ void xk_outer(float* acc, int lda, const float* X,
                                         int nx, const float* Y, int ny,
                                         int P, int S) {
  const int nj = (nx + 15) / 16, ni = (ny + 7) / 8;
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, G = max(1, nw / nj);
  for (int it = threadIdx.x >> 5; it < nj * G; it += nw) {
    const int j0 = it % nj * 16, ig = it / nj;
    auto xa = [&](int m, int p) {
      return j0 + m < nx && p < P ? X[(j0 + m) * S + p] : 0.f;
    };
    unsigned ab[KB][4], as[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      xc_split(xa(g, 8 * kb + t), ab[kb][0], as[kb][0]);
      xc_split(xa(g + 8, 8 * kb + t), ab[kb][1], as[kb][1]);
      xc_split(xa(g, 8 * kb + t + 4), ab[kb][2], as[kb][2]);
      xc_split(xa(g + 8, 8 * kb + t + 4), ab[kb][3], as[kb][3]);
    }
    auto tile = [&](int i0, float (&x)[4], float (&e)[4]) {
      const int i = i0 + g;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int p = 8 * kb + t;
        unsigned bb[2], bs[2];
        xc_split(i < ny && p < P ? Y[i * S + p] : 0.f, bb[0], bs[0]);
        xc_split(i < ny && p + 4 < P ? Y[i * S + p + 4] : 0.f, bb[1], bs[1]);
        xc_mma(x, as[kb], bb);
        xc_mma(x, ab[kb], bs);
        xc_mma(e, ab[kb], bb);
      }
    };
    auto add = [&](int i0, const float (&x)[4], const float (&e)[4]) {
      const int i = i0 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + g + 8 * h;
        if (j >= nx || i >= ny) continue;
        float* a = acc + j * lda + i;
        const float v0 = x[2 * h] + e[2 * h], v1 = x[2 * h + 1] + e[2 * h + 1];
        if (i + 1 < ny && lda % 2 == 0) {
          float2 c = *reinterpret_cast<float2*>(a);
          c.x += v0;
          c.y += v1;
          *reinterpret_cast<float2*>(a) = c;
        } else {
          a[0] += v0;
          if (i + 1 < ny) a[1] += v1;
        }
      }
    };
    for (int ib = ig; ib < ni; ib += 2 * G) {
      float x0[4] = {}, e0[4] = {}, x1[4] = {}, e1[4] = {};
      const bool two = ib + G < ni;
      tile(ib * 8, x0, e0);
      if (two) tile((ib + G) * 8, x1, e1);
      add(ib * 8, x0, e0);
      if (two) add((ib + G) * 8, x1, e1);
    }
  }
}

// accb[j] += sum_{p < P} X[j][p], the points in order, for j < n.
__device__ __forceinline__ void xk_rowsum(float* accb, const float* X, int n,
                                          int P, int S) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += X[j * S + p];
    accb[j] += s;
  }
}

// The block's accumulator entries into the cluster's row of partial, at
// their places in the packed gradient.
__device__ __forceinline__ void xk_write_row(float* row, const float* acc,
                                             const XkLayout& y, int F, int H,
                                             int L, int c, int lo, int n) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int e = t; e < n * F; e += T) row[lo * F + e] = acc[y.a_w0 + e];
  for (int j = t; j < n; j += T) row[H * F + lo + j] = acc[y.a_b0 + j];
  const int off = xd_hidden_off(F, H, 0, 1);
  const float* a = acc + y.a_hid;
  for (int e = t; e < n * H; e += T) {
    const int j = e / H, k = e - j * H;
    row[off + (lo + j) * H + k] = a[j * y.ldh + k];
  }
  for (int j = t; j < n; j += T)
    row[off + H * H + lo + j] = a[y.mH * y.ldh + j];
  const int oo = xd_out_off(F, H, L, 1);
  for (int j = t; j < n; j += T) row[oo + lo + j] = acc[y.a_wo + j];
  if (c == 0 && t == 0) row[oo + H] = acc[y.a_wo + y.mH];
}

// #7 on clusters of C blocks: cluster k walks tiles k, k + G, ... (G =
// gridDim.x / C clusters) through the stages of disc_bwd_kernel, each
// block computing its units; partial holds one row a cluster. The net is
// tied. NB: xk_nb(P).
template <int NB>
__global__ void __launch_bounds__(XK_THREADS, 1)
disc_bwd_cluster_kernel(const float* __restrict__ params, int n_params,
                        const float* __restrict__ feats,  // [M, F]
                        const float* __restrict__ vb,     // [M]
                        const float* __restrict__ gb,     // [M, F]
                        float* __restrict__ partial,      // [clusters, n_params]
                        int M, int F, int H, int L, int P, int C) {
  extern __shared__ __align__(16) float smem[];
  const XkLayout y = xk_layout(F, H, L, C, P);
  const int S = y.S, mHS = y.mH * S;
  const int c = xc_rank(), lo = xc_lo(H, c, C);
  const int n = xc_lo(H, c + 1, C) - lo;
  float* rd = smem + y.ex0;  // the exchange a product reads
  float* wr = smem + y.ex1;  // the exchange its outputs are pushed into
  float* const A = smem + y.A;   // the block's units of A_0..A_L
  float* const G = smem + y.G;   // and of G_0..G_L
  float* cur = smem + y.T0;
  float* nxt = smem + y.T1;
  float* const Z = smem + y.Z;
  float* const GB = smem + y.GB;
  float* const VB = smem + y.VB;
  float* const acc = smem + y.acc;
  float* const scr = smem + y.scr;
  const float* W0 = params;
  const float* wo = params + xd_out_off(F, H, L, 1);
  for (int i = threadIdx.x; i < y.acc_n; i += blockDim.x) acc[i] = 0.f;
  {  // the block's rows and columns of the hidden layer, for the launch
    const float* W = params + xd_hidden_off(F, H, 0, 1);
    for (int e = threadIdx.x; e < n * H; e += blockDim.x) {
      const int o = e / H, k = e - o * H;
      smem[y.wr + o * y.ldw + k] = W[(lo + o) * H + k];
    }
    for (int e = threadIdx.x; e < n * H; e += blockDim.x) {
      const int k = e / n, o = e - k * n;
      smem[y.wt + o * y.ldw + k] = W[k * H + lo + o];
    }
  }
  // the products over the hidden layer's rows (W(o, k) = W_h[lo + o][k])
  // and columns (W(o, j) = W_h[j][lo + o]) of the block's units
  const XkW<true> rows{smem + y.wr, y.ldw, 1}, cols{smem + y.wt, y.ldw, 1};
  const float* const hb = params + xd_hidden_off(F, H, 0, 1) + H * H + lo;
  const XkW<false> w0r{W0 + lo * F, F, 1};
  float* const ah = acc + y.a_hid;  // the hidden layer's rows, its biases
  auto swap = [&]() {  // the barrier between a phase that pushes and one
    xc_sync();         // that reads
    float* t = rd;
    rd = wr;
    wr = t;
  };

  const int cluster = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int n_tiles = (M + P - 1) / P;
  for (int tile = cluster; tile < n_tiles; tile += n_clusters) {
    const int m0 = tile * P, live = min(P, M - m0);
    xc_sync();  // the previous tile's reads, here and of the exchange, are
                // done (and, at the first, every block of the cluster runs)
    for (int idx = threadIdx.x; idx < F * P; idx += blockDim.x) {
      const int p = idx / F, f = idx - p * F;  // consecutive threads: a row
      const bool in = p < live;
      Z[f * S + p] = in ? feats[(size_t)(m0 + p) * F + f] : 0.f;
      GB[f * S + p] = in ? gb[(size_t)(m0 + p) * F + f] : 0.f;
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      VB[p] = p < live ? vb[m0 + p] : 0.f;
    __syncthreads();

    // 1. forward: A_i = relu(a_i) for i < L, A_L = a_L
    xk_dense<true>(A, w0r, W0 + H * F + lo, Z, n, F, P, S);
    __syncthreads();
    xk_push_rows(wr, A, n, P, S, lo, C);
    swap();
    for (int i = 0; i < L; ++i) {
      float* out = A + (i + 1) * mHS;
      if (i + 1 < L)
        xk_dense<true>(out, rows, hb, rd, n, H, P, S);
      else
        xk_dense<false>(out, rows, hb, rd, n, H, P, S);
      __syncthreads();
      if (i + 1 < L) {
        xk_push_rows(wr, out, n, P, S, lo, C);
        swap();
      }
    }
    // 2. sweep: y = tanh(a_L) in place of a_L, G_L = w_o (1 - y^2),
    // G_i = [a_i > 0] (W_h^T G_{i+1})
    float* const Y = A + L * mHS;
    for (int idx = threadIdx.x; idx < n * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float yv = tanhf(Y[j * S + p]);
      Y[j * S + p] = yv;
      G[L * mHS + j * S + p] = __ldg(wo + lo + j) * (1.f - yv * yv);
    }
    __syncthreads();
    xk_push_rows(wr, G + L * mHS, n, P, S, lo, C);
    swap();
    for (int i = L - 1; i >= 0; --i) {
      const float* Ai = A + i * mHS;
      float* Gi = G + i * mHS;
      xk_prod<NB>(n, H, rd, P, S, cols, scr, [&](int o, int p, float v) {
        Gi[o * S + p] = Ai[o * S + p] > 0.f ? v : 0.f;
      });
      __syncthreads();
      if (i > 0) {
        xk_push_rows(wr, Gi, n, P, S, lo, C);
        swap();
      }
    }
    // 3. the sweep's reverse: tbar_0 = [a_0 > 0] (W0 gb), dW0 += g_0 gb^T;
    // then per layer dW_h += g_{i+1} tbar_i^T and tbar_{i+1} = [a_{i+1} >
    // 0] (W_h tbar_i), unmasked at the last layer: gbar_L
    xk_prod<NB>(n, F, GB, P, S, w0r, scr, [&](int o, int p, float v) {
      cur[o * S + p] = A[o * S + p] > 0.f ? v : 0.f;
    });
    xk_outer<NB>(acc + y.a_w0, F, G, n, GB, F, P, S);
    __syncthreads();
    xk_push_rows(wr, cur, n, P, S, lo, C);
    swap();
    for (int i = 0; i < L; ++i) {
      const bool last = i + 1 == L;
      const float* An = A + (i + 1) * mHS;
      float* const out = nxt;
      xk_prod<NB>(n, H, rd, P, S, rows, scr, [&](int o, int p, float v) {
        out[o * S + p] = last || An[o * S + p] > 0.f ? v : 0.f;
      });
      __syncthreads();
      // the pushes first: their stores travel while the weight sum runs
      if (!last) xk_push_rows(wr, out, n, P, S, lo, C);
      xk_outer<NB>(ah, y.ldh, G + (i + 1) * mHS, n, rd, H, P, S);
      if (!last)
        swap();
      else
        __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // output layer: dw_o += gbar_L (1 - y^2) + vb y, db_o += vb,
    // abar_L = (vb w_o - 2 y w_o gbar_L)(1 - y^2)
    for (int idx = threadIdx.x; idx < n * P; idx += blockDim.x) {
      const int j = idx / P, p = idx - j * P;
      const float yv = Y[j * S + p], s = 1.f - yv * yv;
      const float w = __ldg(wo + lo + j);
      nxt[j * S + p] = (VB[p] * w - 2.f * yv * w * cur[j * S + p]) * s;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) {
        const float yv = Y[j * S + p];
        s = fmaf(cur[j * S + p], 1.f - yv * yv, s);
        s = fmaf(VB[p], yv, s);
      }
      acc[y.a_wo + j] += s;
    }
    if (c == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += VB[p];
      acc[y.a_wo + y.mH] += s;
    }
    { float* t = cur; cur = nxt; nxt = t; }
    // 4. the forward's reverse: dW_h += abar relu(a_i)^T, db_h += abar,
    // abar = [a_i > 0] (W_h^T abar); a step reads abar and relu(a_i) whole,
    // one exchange buffer each, refilled once every block has read them
    float* const EA = smem + y.ex0;
    float* const EB = smem + y.ex1;
    xc_sync();  // abar_L is in; the sweep's reverse's reads are done
    for (int i = L - 1; i >= 0; --i) {
      const float* Ai = A + i * mHS;
      xk_push_rows(EA, cur, n, P, S, lo, C);
      xk_push_rows(EB, Ai, n, P, S, lo, C);
      xc_sync();
      float* const out = nxt;
      xk_outer<NB>(ah, y.ldh, cur, n, EB, H, P, S);
      xk_rowsum(ah + y.mH * y.ldh, cur, n, P, S);
      xk_prod<NB>(n, H, EA, P, S, cols, scr, [&](int o, int p, float v) {
        out[o * S + p] = Ai[o * S + p] > 0.f ? v : 0.f;
      });
      float* t = cur; cur = nxt; nxt = t;
      if (i > 0)
        xc_sync();  // every block has read the exchange before its refill
      else
        __syncthreads();
    }
    xk_outer<NB>(acc + y.a_w0, F, cur, n, Z, F, P, S);
    xk_rowsum(acc + y.a_b0, cur, n, P, S);
  }
  xc_sync();  // every block's last weight sums are in, and no peer pushes
  xk_write_row(partial + (size_t)cluster * n_params, acc, y, F, H, L, c, lo,
               n);
}
