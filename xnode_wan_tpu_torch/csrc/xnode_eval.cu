// Serving kernel: u at M arbitrary space-time points, one fresh ODE path
// per point (seed -> lift -> k_steps fixed RK steps from t_start to t ->
// readout). Replaces the JAX package's ops/pallas/xnode_eval.py::_kernel;
// the Python wrapper is ops/kernels/xnode_eval.py.
#include "steppers.cuh"

// 65,536 points at serving size: 512 blocks, about four per SM.
#define XN_THREADS 128

__global__ void __launch_bounds__(XN_THREADS)
xnode_eval_kernel(const float* __restrict__ params, int n_params,
                  const float* __restrict__ feats,    // [M, F]
                  const float* __restrict__ t,        // [M] target times
                  const float* __restrict__ t_start,  // [M] path origins
                  const float* __restrict__ seed,     // [M]
                  float* __restrict__ out,            // [M]
                  int M, int H, int Hh, int F, int n_lift, int n_field,
                  int k_steps, int method) {
  extern __shared__ float sw[];
  xn_stage_weights(sw, params, n_params);
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;

  const XnNet net = xn_net(sw, H, Hh, F, n_lift, n_field);
  float h[XN_MAX_WIDTH], c0[XN_MAX_WIDTH];
  xn_lift(net, seed[m], h);
  xn_field_const(net, feats + (size_t)m * F, c0);

  const float ts = t_start[m];
  const float dt = (t[m] - ts) / (float)k_steps;
  for (int k = 0; k < k_steps; ++k)
    xn_rk_step(net, method, c0, ts + (float)k * dt, dt, h);
  out[m] = xn_readout(net, h);
}

extern "C" int xnode_eval_launch(int device, void* stream,
                                 const float* params, int n_params,
                                 const float* feats, const float* t,
                                 const float* t_start, const float* seed,
                                 float* out, int M, int H, int Hh, int F,
                                 int n_lift, int n_field, int k_steps,
                                 int method) {
  size_t smem = 0;
  if (M < 0 || k_steps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = xn_prepare(xnode_eval_kernel, device, H, Hh, F, n_lift,
                             n_field, method, n_params, &smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return 0;
  const int blocks = (M + XN_THREADS - 1) / XN_THREADS;
  xnode_eval_kernel<<<blocks, XN_THREADS, smem, (cudaStream_t)stream>>>(
      params, n_params, feats, t, t_start, seed, out, M, H, Hh, F, n_lift,
      n_field, k_steps, method);
  return (int)cudaGetLastError();
}
