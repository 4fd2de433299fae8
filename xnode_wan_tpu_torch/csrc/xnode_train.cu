// Tangentless path-forward kernel: u at every sample of N paths
// (seed -> lift -> L intervals x n_sub fixed RK substeps -> readout after
// each interval). Masked samples arrive with dt = 0, so their interval is
// the identity. Replaces the JAX package's
// ops/pallas/xnode_train.py::_fwd_only_kernel; the Python wrapper is
// ops/kernels/xnode_train.py::u_forward_fused.
#include "steppers.cuh"

// The metric batch has only N = 4,000 paths: one warp per block spreads
// them over 125 of the 132 SMs instead of stacking four warps on 32.
#define XN_THREADS 32

__global__ void __launch_bounds__(XN_THREADS)
xnode_path_fwd_kernel(const float* __restrict__ params, int n_params,
                      const float* __restrict__ t0,     // [N, L]
                      const float* __restrict__ dt,     // [N, L] substep
                      const float* __restrict__ feats,  // [N, F]
                      const float* __restrict__ seed,   // [N]
                      float* __restrict__ u,            // [N, L]
                      int N, int L, int H, int Hh, int F, int n_lift,
                      int n_field, int n_sub, int method) {
  extern __shared__ float sw[];
  xn_stage_weights(sw, params, n_params);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  const XnNet net = xn_net(sw, H, Hh, F, n_lift, n_field);
  float h[XN_MAX_WIDTH], c0[XN_MAX_WIDTH];
  xn_lift(net, seed[n], h);
  xn_field_const(net, feats + (size_t)n * F, c0);

  const size_t row = (size_t)n * L;
  for (int l = 0; l < L; ++l) {
    const float ta = t0[row + l], d = dt[row + l];
    for (int k = 0; k < n_sub; ++k)
      xn_rk_step(net, method, c0, ta + (float)k * d, d, h);
    u[row + l] = xn_readout(net, h);
  }
}

extern "C" int xnode_path_fwd_launch(int device, void* stream,
                                     const float* params, int n_params,
                                     const float* t0, const float* dt,
                                     const float* feats, const float* seed,
                                     float* u, int N, int L, int H, int Hh,
                                     int F, int n_lift, int n_field,
                                     int n_sub, int method) {
  size_t smem = 0;
  if (N < 0 || L < 0 || n_sub < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = xn_prepare(xnode_path_fwd_kernel, device, H, Hh, F,
                             n_lift, n_field, method, n_params, &smem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0) return 0;
  const int blocks = (N + XN_THREADS - 1) / XN_THREADS;
  xnode_path_fwd_kernel<<<blocks, XN_THREADS, smem, (cudaStream_t)stream>>>(
      params, n_params, t0, dt, feats, seed, u, N, L, H, Hh, F, n_lift,
      n_field, n_sub, method);
  return (int)cudaGetLastError();
}
