// Device-side XNODE network and fixed-step RK stepper, shared by the
// serving kernel (xnode_eval.cu) and the path-forward kernel
// (xnode_train.cu). Device twin of ops/kernels/steppers.py and of the
// JAX package's ops/pallas/steppers.py::rk_step.
//
// One thread integrates one path. The hidden state, the RK stages and the
// MLP activations live in per-thread arrays sized by the compile-time caps
// below; the widths themselves are runtime arguments. The weights sit in
// shared memory, packed by the wrapper as, for every layer in the order
// lift..., field..., readout:  W [out, in] row-major, then b [out].
// Every thread of a warp reads the same weight at the same time, so each
// shared-memory read is a broadcast.
#pragma once

#include <cuda_runtime.h>

#define XN_MAX_WIDTH 64      // cap on H (hidden state) and Hh (field width)
#define XN_MAX_FIELD_IN 128  // cap on F + 1 + H (field input width)

// Order matches FUSED_KERNEL_METHODS in ops/kernels/steppers.py.
enum XnMethod { XN_EULER = 0, XN_MIDPOINT = 1, XN_HEUN = 2, XN_RK4 = 3 };

struct XnNet {
  const float* w;   // packed weights (shared memory)
  int H, Hh, F, n_lift, n_field;
  int field_off;    // offset of field layer 0
  int readout_off;  // offset of the readout layer
};

__host__ __device__ inline int xn_n_params(int H, int Hh, int F, int n_lift,
                                           int n_field) {
  const int fin = F + 1 + H;
  return (H + H) + (n_lift - 1) * (H * H + H)              // lift
         + (fin * Hh + Hh) + (n_field - 2) * (Hh * Hh + Hh)  // field
         + (Hh * H + H)                                      // field out
         + (H + 1);                                          // readout
}

__host__ inline bool xn_caps_ok(int H, int Hh, int F, int n_lift,
                                int n_field) {
  return H >= 1 && Hh >= 1 && F >= 0 && n_lift >= 1 && n_field >= 2 &&
         H <= XN_MAX_WIDTH && Hh <= XN_MAX_WIDTH &&
         F + 1 + H <= XN_MAX_FIELD_IN;
}

__device__ inline XnNet xn_net(const float* w, int H, int Hh, int F,
                               int n_lift, int n_field) {
  XnNet n;
  n.w = w;
  n.H = H;
  n.Hh = Hh;
  n.F = F;
  n.n_lift = n_lift;
  n.n_field = n_field;
  n.field_off = (H + H) + (n_lift - 1) * (H * H + H);
  n.readout_off = xn_n_params(H, Hh, F, n_lift, n_field) - (H + 1);
  return n;
}

// Copy the packed weights into shared memory (whole block).
__device__ inline void xn_stage_weights(float* sw, const float* params,
                                        int n_params) {
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) sw[i] = params[i];
  __syncthreads();
}

// y[j] = sum_i W[j, i] x[i] + b[j], W [out, in] row-major, b after W.
__device__ inline void xn_dense(const float* W, int out, int in,
                                const float* x, float* y) {
  const float* b = W + out * in;
  for (int j = 0; j < out; ++j) {
    const float* row = W + j * in;
    float s = 0.f;
    for (int i = 0; i < in; ++i) s = fmaf(row[i], x[i], s);
    y[j] = s + b[j];
  }
}

// Lift MLP: seed -> h [H]: linear, then [relu, linear] * (n_lift - 1).
__device__ inline void xn_lift(const XnNet& n, float seed, float* h) {
  float a[XN_MAX_WIDTH];
  const int H = n.H;
  const float* p = n.w;
  for (int j = 0; j < H; ++j) h[j] = p[j] * seed + p[H + j];
  p += 2 * H;
  for (int l = 1; l < n.n_lift; ++l) {
    for (int i = 0; i < H; ++i) a[i] = fmaxf(h[i], 0.f);
    xn_dense(p, H, H, a, h);
    p += H * H + H;
  }
}

// Field layer 0 splits its input [feats, t, h]: the feats part is fixed
// along a path, so each thread computes c0 = W0[:, :F] feats once.
__device__ inline void xn_field_const(const XnNet& n, const float* feats,
                                      float* c0) {
  const int fin = n.F + 1 + n.H;
  const float* W = n.w + n.field_off;
  for (int j = 0; j < n.Hh; ++j) {
    float s = 0.f;
    for (int i = 0; i < n.F; ++i) s = fmaf(W[j * fin + i], feats[i], s);
    c0[j] = s;
  }
}

// ODE field F(x, t, h) -> dh/dt [H]:
// linear, [relu, linear] * (n_field - 2), tanh, linear.
__device__ inline void xn_field(const XnNet& n, const float* c0, float t,
                                const float* h, float* out) {
  float a[XN_MAX_WIDTH], b[XN_MAX_WIDTH];
  const int H = n.H, Hh = n.Hh, fin = n.F + 1 + H;
  const float* W = n.w + n.field_off;
  const float* bias = W + Hh * fin;
  for (int j = 0; j < Hh; ++j) {
    const float* row = W + j * fin + n.F;
    float s = fmaf(row[0], t, c0[j]);
    for (int i = 0; i < H; ++i) s = fmaf(row[1 + i], h[i], s);
    a[j] = s + bias[j];
  }
  const float* p = bias + Hh;
  for (int l = 0; l < n.n_field - 2; ++l) {
    for (int i = 0; i < Hh; ++i) b[i] = fmaxf(a[i], 0.f);
    xn_dense(p, Hh, Hh, b, a);
    p += Hh * Hh + Hh;
  }
  for (int i = 0; i < Hh; ++i) b[i] = tanhf(a[i]);
  xn_dense(p, H, Hh, b, out);
}

__device__ inline float xn_readout(const XnNet& n, const float* h) {
  const float* W = n.w + n.readout_off;
  float s = 0.f;
  for (int i = 0; i < n.H; ++i) s = fmaf(W[i], h[i], s);
  return s + W[n.H];
}

// One fixed step of `method` from state h at time t, in place. Same
// arithmetic order as rk_step in ops/kernels/steppers.py.
__device__ inline void xn_rk_step(const XnNet& n, int method,
                                  const float* c0, float t, float dt,
                                  float* h) {
  float k[XN_MAX_WIDTH], y[XN_MAX_WIDTH], acc[XN_MAX_WIDTH];
  const int H = n.H;
  const float hdt = 0.5f * dt;
  switch (method) {
    case XN_EULER:
      xn_field(n, c0, t, h, k);
      for (int j = 0; j < H; ++j) h[j] = h[j] + dt * k[j];
      break;
    case XN_MIDPOINT:
      xn_field(n, c0, t, h, k);
      for (int j = 0; j < H; ++j) y[j] = h[j] + hdt * k[j];
      xn_field(n, c0, t + hdt, y, k);
      for (int j = 0; j < H; ++j) h[j] = h[j] + dt * k[j];
      break;
    case XN_HEUN:
      xn_field(n, c0, t, h, acc);
      for (int j = 0; j < H; ++j) y[j] = h[j] + dt * acc[j];
      xn_field(n, c0, t + dt, y, k);
      for (int j = 0; j < H; ++j) h[j] = h[j] + hdt * (acc[j] + k[j]);
      break;
    default:  // XN_RK4; the launchers reject other values
      xn_field(n, c0, t, h, acc);
      for (int j = 0; j < H; ++j) y[j] = h[j] + hdt * acc[j];
      xn_field(n, c0, t + hdt, y, k);
      for (int j = 0; j < H; ++j) {
        acc[j] = acc[j] + 2.f * k[j];
        y[j] = h[j] + hdt * k[j];
      }
      xn_field(n, c0, t + hdt, y, k);
      for (int j = 0; j < H; ++j) {
        acc[j] = acc[j] + 2.f * k[j];
        y[j] = h[j] + dt * k[j];
      }
      xn_field(n, c0, t + dt, y, k);
      for (int j = 0; j < H; ++j) h[j] = h[j] + dt * (acc[j] + k[j]) / 6.f;
      break;
  }
}

// Launch set-up shared by both kernels: select the caller's device, check
// the caps and allow the dynamic shared memory the weights need.
template <typename Kernel>
__host__ inline cudaError_t xn_prepare(Kernel kernel, int device, int H,
                                       int Hh, int F, int n_lift,
                                       int n_field, int method, int n_params,
                                       size_t* smem) {
  if (!xn_caps_ok(H, Hh, F, n_lift, n_field) || method < XN_EULER ||
      method > XN_RK4 ||
      n_params != xn_n_params(H, Hh, F, n_lift, n_field))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  *smem = sizeof(float) * (size_t)n_params;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

extern "C" const char* xn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
