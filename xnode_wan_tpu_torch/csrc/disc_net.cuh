// The adversary network's packing, shared by disc_fwd.cu (#6 in registers)
// and disc_train.cu (#6 on a tile of points, #7). Network (ops/kernels/disc_train.py, per point with
// features z [F]):
//   a0 = W0 z + b0;  a_{i+1} = W_h relu(a_i) + b_h  (i < L);  y = tanh(a_L);
//   v = w_o . y + b_o;  reverse sweep g_L = w_o (1 - y^2),
//   g_i = [a_i > 0] (W_h^T g_{i+1}),  gin = W0^T g_0.
// Packed weights: W0 [H, F], b0 [H], then (W_h [H, H], b_h [H]) once when
// tied or L times, then w_o [H], b_o; each W row-major [out, in].
#pragma once

#include <cuda_runtime.h>

#define XD_MAX_SMEM 232448

__host__ __device__ inline int xd_n_params(int F, int H, int L, int tied) {
  return F * H + H + (tied ? 1 : L) * (H * H + H) + H + 1;
}

// Offset of hidden layer i's W_h (b_h follows it).
__host__ __device__ inline int xd_hidden_off(int F, int H, int i, int tied) {
  return F * H + H + (tied ? 0 : i) * (H * H + H);
}

__host__ __device__ inline int xd_out_off(int F, int H, int L, int tied) {
  return F * H + H + (tied ? 1 : L) * (H * H + H);
}

// The packing check: positive widths, and a buffer of the net's size. Which
// geometries a kernel takes is decided by ops/kernels/disc_train.py ::
// disc_route, and each launcher refuses a block past XD_MAX_SMEM.
__host__ inline bool xd_caps_ok(int F, int H, int L, int tied,
                                int n_params) {
  return F >= 1 && H >= 1 && L >= 1 && (tied == 0 || tied == 1) &&
         n_params == xd_n_params(F, H, L, tied);
}

static cudaError_t xd_allow_smem(const void* kernel, size_t smem) {
  if (smem > XD_MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
