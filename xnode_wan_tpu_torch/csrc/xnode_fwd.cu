// Tangentless XNODE path forward, one kernel body with two launchers:
//
// - xnode_eval_launch (serving, #1): u at M arbitrary space-time points,
//   one fresh path per point (seed -> lift -> k_steps fixed RK steps of
//   dt = (t - t_start) / k_steps -> readout). Replaces the JAX package's
//   ops/pallas/xnode_eval.py::_kernel; wrapper ops/kernels/xnode_eval.py.
// - xnode_path_fwd_launch (the trainer's metric, #2): u at every sample of
//   N paths (seed -> lift -> L intervals x n_sub fixed RK substeps ->
//   readout after each interval). Masked samples arrive with dt = 0, so
//   their interval is the identity. Replaces
//   ops/pallas/xnode_train.py::_fwd_only_kernel; wrapper
//   ops/kernels/xnode_train.py::u_forward_fused.
//
// Built once per width pair: nvcc -DXN_H=<H> -DXN_HH=<Hh> (ops/kernels/
// _build.py), so the per-thread state, RK stages and activations of
// steppers.cuh live in registers. One thread integrates one path over the
// block's staged copy of the weights in shared memory. The feature width F
// is a run-time value without a cap: field layer 0's feature columns are
// applied once a path (steppers.cuh :: xn_field_const, the block's feature
// rows read coalesced through shared memory before the weights are staged
// there), and no array or staged byte depends on F. Nets with H or Hh above
// 64, or a staged copy above one block's shared memory, take the path-tile
// kernel (xnode_path_tile.cu).
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
// both are FP32-compute-bound in principle (#1 at the d=5 width: 5.9 GFLOP
// against 2.4 MB), and both stay issue- or latency-bound in practice: the
// 10-26 wide layers give each FMA one 16-byte broadcast load per four
// weights, and #2's 4,000 paths are one warp per SM walking a serial chain
// of 40 field evaluations. Plain FP32 FMAs, no tensor cores: the layers do
// not fill a tile, and TF32 would break the kernels' f32 tolerance.
#include "steppers.cuh"

#ifndef XN_H
#error "build with -DXN_H=<hidden width> -DXN_HH=<field width>"
#endif

// #1: 65,536 points at serving size, 512 blocks, about four per SM.
#define XN_SERVE_THREADS 128
// #2: the metric batch has only N = 4,000 paths: one warp per block
// spreads them over 125 of the 132 SMs instead of stacking four on 32.
#define XN_PATH_THREADS 32

// kServe: ta = t [M], tb = t_start [M], n_steps = k_steps, L = 1.
// Otherwise: ta = t0 [N, L], tb = dt [N, L] (the substep), n_steps = n_sub.
// A minimum of one block lets ptxas use up to 255 registers; without it
// ptxas holds both kernels at 168 and the (24, 32) build spills.
template <bool kServe>
__global__ void __launch_bounds__(kServe ? XN_SERVE_THREADS : XN_PATH_THREADS,
                                  1)
xnode_fwd_kernel(const float* __restrict__ params,
                 const float* __restrict__ feats,  // [N, F]
                 const float* __restrict__ ta, const float* __restrict__ tb,
                 const float* __restrict__ seed,   // [N]
                 float* __restrict__ out,          // [N, L]
                 int N, int L, int F, int n_lift, int n_field, int n_steps,
                 int method) {
  constexpr int H = XN_H, Hh = XN_HH;
  constexpr int T = kServe ? XN_SERVE_THREADS : XN_PATH_THREADS;
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  float h[H], c0[Hh];
  xn_field_const<H, Hh, T>(sw, params + (H + H) + (n_lift - 1) * (H * H + H),
                           F, feats, blockIdx.x * T, N, c0);
  xn_stage<H, Hh>(sw, params, F, n_lift, n_field);
  const int n = blockIdx.x * T + threadIdx.x;
  if (n >= N) return;

  const int n_hidden = n_field - 2;
  const float* fw = sw + xn_staged_layer(H, 1) +
                    (n_lift - 1) * xn_staged_layer(H, H);
  const float* rw = fw + xn_staged_layer(Hh, 1 + H) +
                    n_hidden * xn_staged_layer(Hh, Hh) +
                    xn_staged_layer(H, Hh);
  xn_lift<H>(sw, n_lift, seed[n], h);

  const size_t row = (size_t)n * L;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float t0, d;
    if (kServe) {
      t0 = tb[n];
      d = (ta[n] - t0) / (float)n_steps;
    } else {
      t0 = ta[row + l];
      d = tb[row + l];
    }
#pragma unroll 1
    for (int k = 0; k < n_steps; ++k)
      xn_rk_step<H, Hh>(fw, n_hidden, method, c0, t0 + (float)k * d, d, h);
    out[row + l] = xn_readout<H>(rw, h);
  }
}

// Checks shared by both launchers: the widths this library was built for,
// the caps, the method and the packed count; selects the caller's device
// and allows the dynamic shared memory of the staged weights (or of the
// feature pass's scratch, where that is larger, for T threads a block).
template <typename Kernel>
static cudaError_t xn_prepare(Kernel kernel, int T, int device, int n_params,
                              int H, int Hh, int F, int n_lift, int n_field,
                              int method, size_t* smem) {
  if (H != XN_H || Hh != XN_HH || !xn_caps_ok(H, Hh, F, n_lift, n_field) ||
      method < XN_EULER || method > XN_RK4 ||
      n_params != xn_n_params(H, Hh, F, n_lift, n_field))
    return cudaErrorInvalidValue;
  const int staged = xn_staged_floats(H, Hh, n_lift, n_field);
  const int scratch = xn_feat_floats(T, F, Hh);
  *smem = sizeof(float) * (size_t)(staged > scratch ? staged : scratch);
  if (*smem > XN_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (*smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  return e;
}

// Floats of the staged copy at these widths and depths (steppers.py's
// staged_floats is its twin; chip_smoke.py holds the two together).
extern "C" int xnode_fwd_staged_floats(int H, int Hh, int n_lift,
                                       int n_field) {
  return xn_staged_floats(H, Hh, n_lift, n_field);
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
  cudaError_t e = xn_prepare(xnode_fwd_kernel<true>, XN_SERVE_THREADS, device,
                             n_params, H, Hh, F, n_lift, n_field, method,
                             &smem);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return 0;
  const int blocks = (M + XN_SERVE_THREADS - 1) / XN_SERVE_THREADS;
  xnode_fwd_kernel<true>
      <<<blocks, XN_SERVE_THREADS, smem, (cudaStream_t)stream>>>(
          params, feats, t, t_start, seed, out, M, 1, F, n_lift, n_field,
          k_steps, method);
  return (int)cudaGetLastError();
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
  cudaError_t e = xn_prepare(xnode_fwd_kernel<false>, XN_PATH_THREADS, device,
                             n_params, H, Hh, F, n_lift, n_field, method,
                             &smem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || L == 0) return 0;
  const int blocks = (N + XN_PATH_THREADS - 1) / XN_PATH_THREADS;
  xnode_fwd_kernel<false>
      <<<blocks, XN_PATH_THREADS, smem, (cudaStream_t)stream>>>(
          params, feats, t0, dt, seed, u, N, L, F, n_lift, n_field, n_sub,
          method);
  return (int)cudaGetLastError();
}
