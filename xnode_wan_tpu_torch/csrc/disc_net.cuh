// The adversary network's packing and caps, shared by disc_fwd.cu (#6) and
// disc_train.cu (#7). Network (ops/kernels/disc_train.py, per point with
// features z [F]):
//   a0 = W0 z + b0;  a_{i+1} = W_h relu(a_i) + b_h  (i < L);  y = tanh(a_L);
//   v = w_o . y + b_o;  reverse sweep g_L = w_o (1 - y^2),
//   g_i = [a_i > 0] (W_h^T g_{i+1}),  gin = W0^T g_0.
// Packed weights: W0 [H, F], b0 [H], then (W_h [H, H], b_h [H]) once when
// tied or L times, then w_o [H], b_o; each W row-major [out, in].
#pragma once

#include <cuda_runtime.h>

#define XD_MAX_WIDTH 64   // cap on H (v_hidden_dim)
#define XD_MAX_FEATS 128  // cap on F (feature width)
#define XD_MAX_LAYERS 32  // cap on L (v_layers)
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

__host__ inline bool xd_caps_ok(int F, int H, int L, int tied,
                                int n_params) {
  return F >= 1 && F <= XD_MAX_FEATS && H >= 1 && H <= XD_MAX_WIDTH &&
         L >= 1 && L <= XD_MAX_LAYERS && (tied == 0 || tied == 1) &&
         n_params == xd_n_params(F, H, L, tied);
}

static cudaError_t xd_allow_smem(const void* kernel, size_t smem) {
  if (smem > XD_MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
