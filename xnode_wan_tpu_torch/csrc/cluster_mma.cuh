// Thread-block cluster primitives and the 3xTF32 tensor-core tile, shared
// by the cluster variants of #5 (xnode_grad_cluster.cuh) and of #7
// (disc_train_cluster.cuh).
#pragma once

#include <cooperative_groups.h>

#define XC_MAX_CLUSTER 8

// ---------------------------------------------------------------------------
// Cluster primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ int xc_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

// Every thread of every block of the cluster; orders the shared-memory
// writes before it (to any block) before the reads after it.
__device__ __forceinline__ void xc_sync() {
  cooperative_groups::this_cluster().sync();
}

// The address of p (in this block's shared memory) in block q's.
__device__ __forceinline__ float* xc_peer(float* p, int q) {
  return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)q);
}

// ---------------------------------------------------------------------------
// Unit slices
// ---------------------------------------------------------------------------

// Block c's units of a width w: [xc_lo(w, c), xc_lo(w, c + 1)).
__host__ __device__ inline int xc_lo(int w, int c, int C) { return w * c / C; }
__host__ __device__ inline int xc_max(int w, int C) { return (w + C - 1) / C; }

// The smallest multiple of 4 at least n whose remainder mod 32 is res.
__host__ __device__ inline int xc_ld(int n, int res) {
  int ld = (n + 3) / 4 * 4;
  while (ld % 32 != res) ld += 4;
  return ld;
}

// ---------------------------------------------------------------------------
// Products and weight sums on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// v as big + small: big v rounded to its nearest TF32 value (the values
// here are finite, far from the float range's end), small the rest as a
// float, whose low 13 bits the tensor core ignores; big_a big_b + big_a
// small_b + small_a big_b carries the float product to about 2^-20 of it.
__device__ __forceinline__ void xc_split(float v, unsigned& big,
                                         unsigned& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a b on one warp: the m16n8k8 TF32 product, FP32 sums.
__device__ __forceinline__ void xc_mma(float* d, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The TF32 parts of one k-step's fragments (k0 .. k0 + 7) of a warp's
// tile: a lane loads A at rows g, g + 8 and columns t, t + 4, B at rows t,
// t + 4 and column g (g = lane / 4, t = lane % 4).
template <class Af, class Bf>
__device__ __forceinline__ void xc_frag(int k0, int gq, int tq, Af& A, Bf& B,
                                        unsigned* ab, unsigned* as,
                                        unsigned* bb, unsigned* bs) {
  xc_split(A(gq, k0 + tq), ab[0], as[0]);
  xc_split(A(gq + 8, k0 + tq), ab[1], as[1]);
  xc_split(A(gq, k0 + tq + 4), ab[2], as[2]);
  xc_split(A(gq + 8, k0 + tq + 4), ab[3], as[3]);
  xc_split(B(k0 + tq, gq), bb[0], bs[0]);
  xc_split(B(k0 + tq + 4, gq), bb[1], bs[1]);
}

// One warp's 16 x 8 tile d of A B over k < K, the elements A(m, k) and
// B(k, n) in tile coordinates (zero past the edges). A lane holds d at
// rows g, g + 8 and columns 2t, 2t + 1. The big parts' products and the
// cross terms go to separate sums, and even and odd k-steps too, so the
// warp has four chains of products in flight; they are added in a fixed
// order at the end.
template <class Af, class Bf>
__device__ __forceinline__ void xc_tile(float* d, int K, Af A, Bf B) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float e0[4] = {0.f, 0.f, 0.f, 0.f}, e1[4] = {0.f, 0.f, 0.f, 0.f};
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned ab[4], as[4], bb[2], bs[2];
    unsigned ab1[4], as1[4], bb1[2], bs1[2];
    xc_frag(k0, gq, tq, A, B, ab, as, bb, bs);
    const bool two = k0 + 8 < K;
    if (two) xc_frag(k0 + 8, gq, tq, A, B, ab1, as1, bb1, bs1);
    xc_mma(c0, as, bb);
    xc_mma(e0, ab, bb);
    if (two) {
      xc_mma(c1, as1, bb1);
      xc_mma(e1, ab1, bb1);
    }
    xc_mma(c0, ab, bs);
    if (two) xc_mma(c1, ab1, bs1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += (c0[q] + c1[q]) + (e0[q] + e1[q]);
}

// acc[j lda + i] += sum_{r < nr} X[j][r] Y[i][r] for j < nx, i < ny
// (X, Y with row stride S): each entry's sum in one lane, in a fixed order.
__device__ __forceinline__ void xc_outer(float* acc, int lda, const float* X,
                                         int nx, const float* Y, int ny,
                                         int nr, int S) {
  const int NT = (ny + 7) / 8, tiles = (nx + 15) / 16 * NT;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < tiles; t += blockDim.x >> 5) {
    const int j0 = t / NT * 16, i0 = (t - t / NT * NT) * 8;
    const float* Xj = X + j0 * S;
    const float* Yi = Y + i0 * S;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (j0 + 16 <= nx && i0 + 8 <= ny && nr % 8 == 0)
      xc_tile(d, nr, [&](int m, int k) { return Xj[m * S + k]; },
              [&](int k, int c) { return Yi[c * S + k]; });
    else
      xc_tile(d, nr,
              [&](int m, int k) {
                return j0 + m < nx && k < nr ? Xj[m * S + k] : 0.f;
              },
              [&](int k, int c) {
                return i0 + c < ny && k < nr ? Yi[c * S + k] : 0.f;
              });
    const int j = j0 + (lane >> 2), i = i0 + 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jq = j + (q >> 1) * 8, iq = i + (q & 1);
      if (jq < nx && iq < ny) acc[jq * lda + iq] += d[q];
    }
  }
}
