// Kernel #6's tile variant (disc_tile_fwd_launch): v [M] and gin [M, F]
// of the adversary for every net that the register kernel (disc_fwd.cu)
// does not take: wider than 64, or whose staged weights do not fit a
// block. It replaces, at those geometries, the JAX package's
// ops/pallas/disc_train.py :: _v_fwd_kernel. Included by disc_train.cu,
// whose network packing (disc_net.cuh) it reads; F, H, L and `tied` are
// runtime values.
//
// Bound on an H100 SXM at 2v (F = 6, H = 256, L = 9, tied, 80,000
// points): the forward in FP32, 94.66 GFLOP (1.41 ms at 67 TFLOP/s), and
// the sweep with gin in 3xTF32, 94.6 GFLOP x 3 (0.57 ms at 495 TFLOP/s),
// against 4.1 MB: bound by operations, by the FP32 forward.
//
// Design (against a tile kernel that kept every relu(a_i) as a float, 16
// points a tile at 2v, and re-read every weight through the read-only
// cache for each tile, from micro-tiles paced by their loads):
//
//   - A persistent grid (one block an SM where the shared memory allows
//     one) walks tiles of P points (128, 64, 32, 16 or 8: the largest that
//     fits, ops/kernels/disc_train.py :: disc_route) in a fixed order.
//   - Two activation buffers [H][S] alternate (A_i of the forward, G_i of
//     the sweep, at A_i's place); the relu signs of a_0 .. a_{L-1} are kept
//     as bits, ceil(P / 32) words a unit and layer, set in the forward's
//     epilogue (shared-memory atomicOr) and read in the sweep's. G_L is
//     formed right after v, in place of y.
//   - Every product walks its outputs in passes of OB and its inputs in
//     slices, KF inputs for the forward's products and KB for the sweep's:
//     the slice of the weights, W(o, k) for the pass's outputs and the
//     slice's inputs, is copied into shared memory by cp.async (16 bytes a
//     copy, bypassing L1, where the slice's rows sit on 16 bytes; else 4),
//     double-buffered: the copy of the next slice (of this product, the
//     next one, or the next tile's first) runs while this one computes,
//     and one barrier a slice orders both. Each staged weight then serves
//     all P points of the tile. On an H100 at 2v the copies cost about a
//     fifth of the time, in issuing them, not in waiting for them: the
//     forward's slices are unpadded rows of KF = 32 floats, one 128-byte
//     line each (24-float rows, and bulk copies of the copy engine, one a
//     row, measured slower; so did a third buffer).
//   - The forward sums in FP32 FMAs from register micro-tiles of 8 outputs
//     x 8 points (eight float4 of the slice for four inputs, two float4 of
//     the tile an input), each output over its inputs in index order
//     across the slices, the bias added last, as the other variants and
//     the plain version's order of terms (the relu masks follow these
//     signs).
//   - The sweep G_i = [a_i > 0] (W_h^T G_{i+1}) and gin = W0^T G_0 run on
//     the tensor cores (mma.sync.m16n8k8, each operand split into a TF32
//     value and a rest: 3xTF32, cluster_mma.cuh), a warp taking 16 outputs
//     by all P points of a pass's row blocks; the masks apply in the
//     epilogue. Each slice sums into registers of its own, added to the
//     product's sums in FP32 after it: the tensor cores truncate as they
//     accumulate, and one accumulator over a 256-input product left gin
//     1.4e-5 of its largest value from f64 at 2v's shape (1.3e-6 so).
//   - v = w_o . y + b_o as a fixed-order reduction: R = threads / P ranges
//     of units, each summed in index order by one thread a point, the
//     partial sums added in range order. Nothing depends on scheduling:
//     two launches are bitwise equal.
//
// Rows of the activation buffers and of the sweep's slices are odd
// multiples of 8 floats (S = P + 8, or 8 at P = 8; OB + 8): the eight row
// groups of a tensor-core fragment's lanes (rows t, t + 4 by columns g) fall
// on distinct banks. The forward's weight reads are broadcasts within a
// quarter-warp (its eight lanes share their outputs from P = 64 up), so its
// slice's rows go unpadded. Every row starts on 16 bytes.
#include <cuda_pipeline.h>

#include "cluster_mma.cuh"

// Threads of a block (ops/kernels/disc_train.py :: FWD_TILE_THREADS)
#define XF_THREADS 256
// Outputs a pass covers at most: a slice of 8 inputs of the widest net
// the JAX package takes (H = 2047 at L = 1) fits beside its activations
#define XF_OB_MAX 512

// Row stride of the tile's buffers: the smallest odd multiple of 8 at
// least P.
__host__ __device__ constexpr int xf_stride(int P) {
  return P % 16 == 8 ? P : P + 8;
}

// Float offsets of a block's shared buffers (ops/kernels/disc_train.py ::
// fwd_tile_smem_bytes restates the total): two activation buffers [H][S];
// the relu bits [L][H][MW] (rounded up to four words); two weight slices,
// each [KB][OBp] for the sweep's products (input-major, KB inputs) or
// [OB][KF] for the forward's (output-major, KF inputs), whichever is
// larger; the v reduction's partial sums [XF_THREADS]. KB: the most
// multiple of 8 inputs (at least 8) whose sweep slice is no larger than
// the forward's.
struct XfLayout {
  int S, MW, OB, OBp, KF, KB;
  int act1, mask, w0, slice, scr, total;
};

__host__ __device__ inline XfLayout xf_layout(int F, int H, int L, int P,
                                              int KF) {
  XfLayout y;
  y.S = xf_stride(P);
  y.MW = (P + 31) / 32;
  // a pass: at most the block's 8 x 8 micro-tiles and XF_OB_MAX; the
  // widest product's outputs (rounded up to 16, a tensor-core row block)
  // in as few passes of equal width (a multiple of 16) as that allows
  const int widest = ((H > F ? H : F) + 15) / 16 * 16;
  int ob = XF_THREADS * 64 / P;
  if (ob > XF_OB_MAX) ob = XF_OB_MAX;
  const int passes = (widest + ob - 1) / ob;
  y.OB = ((widest + passes - 1) / passes + 15) / 16 * 16;
  y.OBp = y.OB + 8;
  y.KF = KF;
  y.KB = KF * y.OB / (8 * y.OBp) * 8;
  if (y.KB < 8) y.KB = 8;
  y.slice = y.KB * y.OBp > y.OB * KF ? y.KB * y.OBp : y.OB * KF;
  int o = H * y.S;
  y.act1 = o; o += H * y.S;
  y.mask = o; o += (L * H * y.MW + 3) / 4 * 4;
  y.w0 = o;   o += 2 * y.slice;
  y.scr = o;  o += XF_THREADS;
  y.total = o;
  return y;
}

// Inputs a forward slice, largest first (a multiple of 8)
constexpr int XF_SLICES[] = {32, 24, 16, 8};

// The largest forward slice whose block fits at P points; 0 where none
// does.
__host__ inline int xf_slice(int F, int H, int L, int P) {
  for (int ks : XF_SLICES)
    if (sizeof(float) * (size_t)xf_layout(F, H, L, P, ks).total <=
        XD_MAX_SMEM)
      return ks;
  return 0;
}

// One product of the tile: weights W(o, k) at W[o K + k] (rows: W0, W_h)
// or W[k O + o] (cols: W_h^T, W0^T), O outputs, K inputs.
struct XfProd {
  const float* W;
  int cols, O, K;
};

// The products of a tile in order: q = 0 the input layer, 1..L the hidden
// layers, L + 1 .. 2L the sweep (layer 2L - q), 2L + 1 gin.
__device__ __forceinline__ XfProd xf_prod(const float* params, int F, int H,
                                          int L, int tied, int q) {
  if (q == 0) return {params, 0, H, F};
  if (q <= L) return {params + xd_hidden_off(F, H, q - 1, tied), 0, H, H};
  if (q <= 2 * L)
    return {params + xd_hidden_off(F, H, 2 * L - q, tied), 1, H, H};
  return {params, 1, F, H};
}

// dst[0 .. 4) = src[0 .. 4), both on 16 bytes, by cp.async in the
// thread's current <cuda_pipeline.h> group, not cached in L1 (the L1
// beside 227 KB of shared memory cannot keep the weights anyway).
__device__ __forceinline__ void xf_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// cp.async of every thread, N floats a copy (4: 16 bytes, xf_cp16): dst[r
// dld + c N ..] = src[r sld + c N ..] for r < rows, c < cols; consecutive
// threads take consecutive copies of a row, then the next row's (faster on
// an H100 than a power of two of threads a row, whose idle lanes add
// instructions: issuing the copies, not waiting for them, is what a slice
// costs).
template <int N>
__device__ __forceinline__ void xf_copy(float* dst, int dld,
                                        const float* src, size_t sld,
                                        int rows, int cols) {
  if (rows <= 0 || cols <= 0) return;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;
  while (r < rows) {
    if (N == 4)
      xf_cp16(dst + r * dld + c * N, src + r * sld + c * N);
    else
      __pipeline_memcpy_async(dst + r * dld + c * N, src + r * sld + c * N,
                              4 * N);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Issue the copy of the slice of w for outputs ob0 .. and inputs k0 ..:
// dst[kk OBp + o] (cols) or dst[o KF + kk] (rows) = W(ob0 + o, k0 + kk)
// for o < on, kk < kn, in one commit group: 16-byte copies where every
// row of the slice (kn inputs of a rows product, on outputs of a cols one)
// sits on 16 bytes, else 4-byte ones. Nothing past the product's edges is
// written: its readers never use it (the tensor-core reads past kn are
// masked, the forward's outputs past on are not stored).
__device__ __forceinline__ void xf_issue(float* dst, const XfProd& w,
                                         int ob0, int k0,
                                         const XfLayout& y) {
  const int on = min(y.OB, w.O - ob0);
  const int kn = min(w.cols ? y.KB : y.KF, w.K - k0);
  const float* src;
  size_t sld;
  int dld, rows, len;  // rows of len floats
  if (w.cols) {
    src = w.W + (size_t)k0 * w.O + ob0;
    sld = w.O; dld = y.OBp; rows = kn; len = on;
  } else {
    src = w.W + (size_t)ob0 * w.K + k0;
    sld = w.K; dld = y.KF; rows = on; len = kn;
  }
  if (sld % 4 == 0 && len % 4 == 0 &&
      reinterpret_cast<size_t>(src) % 16 == 0)
    xf_copy<4>(dst, dld, src, sld, rows, len / 4);
  else
    xf_copy<1>(dst, dld, src, sld, rows, len);
  __pipeline_commit();
}

// The forward of one slice: s[r][c] += sum_{kk < kn} W(o_r, k0 + kk)
// x(k0 + kk, p_c), in input order, for the thread's outputs o_r = og 8 + r
// (of the pass; the slice wsl output-major, rows of KF) and points p_c =
// p0 + c, p1 + c - 4 (c >= 4). The inputs from the tile buffer X [K][S],
// or (GLOBAL) the features [n, F] of the tile's points, zero past n.
template <bool GLOBAL>
__device__ __forceinline__ void xf_fwd_slice(float (&s)[8][8],
                                             const float* wsl, int KF,
                                             const float* X, int S,
                                             const float* __restrict__ z,
                                             int F, int n, int k0, int kn,
                                             int og, int p0, int p1) {
  const float* wr = wsl + og * 8 * KF;
  auto fma_in = [&](int k, const float (&w)[8]) {
    float x[8];
    if (GLOBAL) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = c < 4 ? p0 + c : p1 + c - 4;
        x[c] = p < n ? __ldg(z + (size_t)p * F + k) : 0.f;
      }
    } else {
      const float* xr = X + k * S;
      const float4 xa = *reinterpret_cast<const float4*>(xr + p0);
      const float4 xb = *reinterpret_cast<const float4*>(xr + p1);
      x[0] = xa.x; x[1] = xa.y; x[2] = xa.z; x[3] = xa.w;
      x[4] = xb.x; x[5] = xb.y; x[6] = xb.z; x[7] = xb.w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = fmaf(w[r], x[c], s[r][c]);
  };
  int kk = 0;
#pragma unroll 1
  for (; kk + 4 <= kn; kk += 4) {
    float4 w4[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w4[r] = *reinterpret_cast<const float4*>(wr + r * KF + kk);
    float w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = w4[r].x;
    fma_in(k0 + kk, w);
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = w4[r].y;
    fma_in(k0 + kk + 1, w);
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = w4[r].z;
    fma_in(k0 + kk + 2, w);
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = w4[r].w;
    fma_in(k0 + kk + 3, w);
  }
#pragma unroll 1
  for (; kk < kn; ++kk) {
    float w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = wr[r * KF + kk];
    fma_in(k0 + kk, w);
  }
}

// The sweep (or gin) of one slice on the tensor cores, 3xTF32: d[u][nb] +=
// the warp's 16 x 8 tile of row block rb = warp + 8 u (outputs rb 16 ..,
// of the pass) and points nb 8 .., over the slice's kn inputs; X [K][S]
// the tile buffer of the input vector, k0 the slice's first input. Row
// blocks past the pass's on outputs are skipped.
template <int U, int NB>
__device__ __forceinline__ void xf_mma_slice(float (&d)[U][NB][4],
                                             const float* wsl, int OBp,
                                             const float* X, int S, int k0,
                                             int kn, int on) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float ds[U][NB][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[u][nb][e] = 0.f;
  for (int kk0 = 0; kk0 < kn; kk0 += 8) {
    // past the product's K (the last slice) both operands read as zero
    const bool ka = kk0 + t < kn, kb = kk0 + t + 4 < kn;
    const float* xa = X + (k0 + kk0 + t) * S + g;
    const float* xb = xa + 4 * S;
    unsigned bb[NB][2], bs[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      xc_split(ka ? xa[8 * nb] : 0.f, bb[nb][0], bs[nb][0]);
      xc_split(kb ? xb[8 * nb] : 0.f, bb[nb][1], bs[nb][1]);
    }
    const float* wa = wsl + (kk0 + t) * OBp + g;
    const float* wb = wa + 4 * OBp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r0 = (warp + 8 * u) * 16;
      if (r0 >= on) continue;
      unsigned ab[4], as[4];
      xc_split(ka ? wa[r0] : 0.f, ab[0], as[0]);
      xc_split(ka ? wa[r0 + 8] : 0.f, ab[1], as[1]);
      xc_split(kb ? wb[r0] : 0.f, ab[2], as[2]);
      xc_split(kb ? wb[r0 + 8] : 0.f, ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        xc_mma(ds[u][nb], as, bb[nb]);
        xc_mma(ds[u][nb], ab, bs[nb]);
        xc_mma(ds[u][nb], ab, bb[nb]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[u][nb][e] += ds[u][nb][e];
}

// Kernel #6 on tiles of P points: block b walks tiles b, b + gridDim.x,
// ..., each through the forward (products 0..L), v, the sweep and gin.
// KF: inputs a forward slice (xf_slice).
template <int P>
__global__ void __launch_bounds__(XF_THREADS, 1)
disc_tile_fwd_kernel(const float* __restrict__ params,
                     const float* __restrict__ feats,  // [M, F]
                     float* __restrict__ v,            // [M]
                     float* __restrict__ gin,          // [M, F]
                     int M, int F, int H, int L, int tied, int KF) {
  constexpr int NPG = P / 8;          // point groups of the micro-tiles
  constexpr int NB = P / 8;           // 8-point tiles of a warp's row block
  constexpr int U = 128 / P;          // row blocks a warp (XF_THREADS * 64
                                      // / P outputs, 16 a block, 8 warps)
  constexpr int R = XF_THREADS / P;   // unit ranges of the v reduction
  static_assert(XF_THREADS == 256 && P >= 8 && P <= 128, "the tile's maps");
  extern __shared__ __align__(16) float xf_smem[];
  const XfLayout y = xf_layout(F, H, L, P, KF);
  const int S = y.S, OB = y.OB, MW = y.MW, KB = y.KB;
  float* const act0 = xf_smem;
  float* const act1 = xf_smem + y.act1;
  unsigned* const mask = reinterpret_cast<unsigned*>(xf_smem + y.mask);
  float* const wbuf = xf_smem + y.w0;  // two slices
  float* const scr = xf_smem + y.scr;
  const float* const wo = params + xd_out_off(F, H, L, tied);
  const int n_tiles = (M + P - 1) / P, n_prods = 2 * L + 2;
  const int tid = threadIdx.x;
  const int og = tid / NPG, pg = tid - og * NPG;
  const int p0 = pg * 4, p1 = P / 2 + pg * 4;

  // The stream of weight slices: every product's passes and slices in
  // order, tile after tile. nt/nq/npass/nslice name the next slice to
  // copy, c the slices acquired so far (slice c sits in buffer c & 1).
  int c = 0, nt = blockIdx.x, nq = 0, npass = 0, nslice = 0;
  // slices of the forward's inputs (F, then H) and of the sweep's (H),
  // passes of an output width (H, or F for gin)
  const int slices_F = (F + KF - 1) / KF, slices_H = (H + KF - 1) / KF;
  const int slices_B = (H + KB - 1) / KB;
  const int passes_F = (F + OB - 1) / OB, passes_H = (H + OB - 1) / OB;
  auto issue = [&](int b) {
    if (nt >= n_tiles) return;
    const XfProd w = xf_prod(params, F, H, L, tied, nq);
    xf_issue(wbuf + b * y.slice, w, npass * OB,
             nslice * (w.cols ? KB : KF), y);
    if (++nslice == (w.cols ? slices_B : w.K == H ? slices_H : slices_F)) {
      nslice = 0;
      if (++npass == (w.O == H ? passes_H : passes_F)) {
        npass = 0;
        if (++nq == n_prods) {
          nq = 0;
          nt += gridDim.x;
        }
      }
    }
  };
  // The next slice: its copies done and seen by every thread, the slice
  // before it no longer read, so the one after it is issued into its
  // buffer. The barrier also orders each product's epilogue writes
  // before the next product's reads.
  auto acquire = [&]() -> const float* {
    const int b = c++ & 1;
    __pipeline_wait_prior(0);
    __syncthreads();
    issue(b ^ 1);
    return wbuf + b * y.slice;
  };
  issue(0);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * P, n = min(P, M - m0);
    const float* const z = feats + (size_t)m0 * F;
    // the relu bits of the previous tile were last read by its sweep,
    // whose epilogues a barrier since has ordered
    for (int i = tid; i < L * H * MW; i += XF_THREADS) mask[i] = 0u;

    // 1. the forward: product q writes a_q (relu'd for q < L, with its
    // signs in mask layer q; y = tanh(a_L) at q = L) into act0 for even q,
    // act1 for odd
    for (int q = 0; q <= L; ++q) {
      const XfProd w = xf_prod(params, F, H, L, tied, q);
      const float* const bias = w.W + (size_t)H * w.K;
      const float* const X = q & 1 ? act0 : act1;
      float* const out = q & 1 ? act1 : act0;
      for (int ob0 = 0; ob0 < H; ob0 += OB) {
        const int on = min(OB, H - ob0);
        const bool mine = og * 8 < on;
        float s[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[r][e] = 0.f;
        for (int k0 = 0; k0 < w.K; k0 += KF) {
          const float* wsl = acquire();
          if (!mine) continue;
          const int kn = min(KF, w.K - k0);
          if (q == 0)
            xf_fwd_slice<true>(s, wsl, KF, nullptr, S, z, F, n, k0, kn, og,
                               p0, p1);
          else
            xf_fwd_slice<false>(s, wsl, KF, X, S, nullptr, F, n, k0, kn, og,
                                p0, p1);
        }
        if (!mine) continue;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int o = ob0 + og * 8 + r;
          if (o >= H) break;
          const float b = __ldg(bias + o);
          float a[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = s[r][e] + b;
          if (q == L) {
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = tanhf(a[e]);
          } else {
            unsigned nib0 = 0u, nib1 = 0u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              nib0 |= (a[e] > 0.f ? 1u : 0u) << e;
              nib1 |= (a[e + 4] > 0.f ? 1u : 0u) << e;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = fmaxf(a[e], 0.f);
            unsigned* const mo = mask + (size_t)(q * H + o) * MW;
            if (nib0) atomicOr(mo + (p0 >> 5), nib0 << (p0 & 31));
            if (nib1) atomicOr(mo + (p1 >> 5), nib1 << (p1 & 31));
          }
          *reinterpret_cast<float4*>(out + o * S + p0) =
              make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<float4*>(out + o * S + p1) =
              make_float4(a[4], a[5], a[6], a[7]);
        }
      }
    }

    // 2. v = w_o . y + b_o: thread (r, p) sums the units of range r in
    // order, then each point adds the ranges in order and its bias; then
    // y becomes G_L = w_o (1 - y^2) in place
    float* const Y = L & 1 ? act1 : act0;
    __syncthreads();
    {
      const int r = tid / P, p = tid - r * P;
      const int lo = H * r / R, hi = H * (r + 1) / R;
      float sum = 0.f;
      for (int j = lo; j < hi; ++j)
        sum = fmaf(__ldg(wo + j), Y[j * S + p], sum);
      scr[tid] = sum;
    }
    __syncthreads();
    if (tid < n) {
      float sum = scr[tid];
#pragma unroll
      for (int r = 1; r < R; ++r) sum += scr[r * P + tid];
      v[m0 + tid] = sum + __ldg(wo + H);
    }
    for (int idx = tid; idx < H * P; idx += XF_THREADS) {
      const int j = idx / P, p = idx - j * P;
      const float yv = Y[j * S + p];
      Y[j * S + p] = __ldg(wo + j) * (1.f - yv * yv);
    }

    // 3. the sweep, G_i = [a_i > 0] (W_h^T G_{i+1}) into a_i's buffer, and
    // gin = W0^T G_0 (q = 2L + 1), on the tensor cores
    const int lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
    const int warp = tid >> 5;
    for (int q = L + 1; q <= 2 * L + 1; ++q) {
      const XfProd w = xf_prod(params, F, H, L, tied, q);
      const int i = 2 * L - q;  // the sweep's layer; -1: gin
      const float* const X = i & 1 ? act0 : act1;  // G_{i+1}
      float* const out = i & 1 ? act1 : act0;
      for (int ob0 = 0; ob0 < w.O; ob0 += OB) {
        const int on = min(OB, w.O - ob0);
        float d[U][NB][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[u][nb][e] = 0.f;
        for (int k0 = 0; k0 < w.K; k0 += KB) {
          const float* wsl = acquire();
          xf_mma_slice<U, NB>(d, wsl, y.OBp, X, S, k0, min(KB, w.K - k0),
                              on);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = ob0 + (warp + 8 * u) * 16 + g + 8 * h;
            if (o >= ob0 + on) continue;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int p = 8 * nb + t2;
              const float e0 = d[u][nb][2 * h], e1 = d[u][nb][2 * h + 1];
              if (i >= 0) {
                const unsigned bits =
                    mask[(size_t)(i * H + o) * MW + (p >> 5)] >> (p & 31);
                *reinterpret_cast<float2*>(out + o * S + p) =
                    make_float2(bits & 1u ? e0 : 0.f, bits & 2u ? e1 : 0.f);
              } else {
                if (p < n) gin[(size_t)(m0 + p) * F + o] = e0;
                if (p + 1 < n) gin[(size_t)(m0 + p + 1) * F + o] = e1;
              }
            }
          }
        }
      }
    }
  }
}
