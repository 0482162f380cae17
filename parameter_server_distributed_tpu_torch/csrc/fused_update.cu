// Fused optimizer updates for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ops/fused_update.py).
//
// Replaces the three Pallas TPU kernels that fused_update.py's _run
// launches (parameter_server_distributed_tpu/ops/pallas/fused_update.py:89):
//  - _sgd_kernel (:42)      p' = p - lr*g;
//  - _momentum_kernel (:46) v' = mu*v + g; p' = p - lr*v';
//  - _adam_kernel (:53)     m' = b1*m + (1-b1)*g; v' = b2*v + (1-b2)*g*g;
//                           p' = p - lr*(m'/bc1)/(sqrt(v'/bc2) + eps).
// Arithmetic in f32 in the JAX order, each operation rounded on its own
// (the _rn intrinsics keep nvcc from contracting a*b+c into one fused
// multiply-add), as the plain PyTorch version rounds them, so the two
// agree to the last bit where PyTorch divides exactly.  Adam's bias
// corrections bc1, bc2 change every step and arrive as runtime arguments
// (the TPU kernel's SMEM scalars), so stepping never rebuilds anything.
// Params are written to a
// fresh output (a served snapshot may alias the input); the slots (the
// velocity, m and v) are updated in place, which is the JAX buffer
// donation.
//
// What bounds it on this card: bytes.  Each element does a handful of
// flops against 12 (SGD), 20 (momentum) or 28 (Adam) bytes moved, far
// below the card's ~295 flops per byte, so the bound is the memory rate.
// The design: one launch per tensor over its flat n elements (the TPU's
// (rows, 128) padding was that chip's tile rule and has no counterpart),
// a grid-stride loop of 16-byte float4 accesses when every pointer is
// 16-byte aligned, and plain f32 accesses otherwise and for the tail.  Both
// paths apply the same per-element rule, so they agree bit for bit.  One
// launch over a list of tensors is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 32;   // grid-stride beyond this

struct Sgd {
  static constexpr int SLOTS = 0;
  float lr;
  __device__ __forceinline__ float operator()(float p, float g,
                                              float*) const {
    return __fsub_rn(p, __fmul_rn(lr, g));
  }
};

struct Momentum {
  static constexpr int SLOTS = 1;   // velocity
  float lr, mu;
  __device__ __forceinline__ float operator()(float p, float g,
                                              float* s) const {
    s[0] = __fadd_rn(__fmul_rn(mu, s[0]), g);
    return __fsub_rn(p, __fmul_rn(lr, s[0]));
  }
};

struct Adam {
  static constexpr int SLOTS = 2;   // m, v
  float lr, b1, b2, eps, one_minus_b1, one_minus_b2, bc1, bc2;
  __device__ __forceinline__ float operator()(float p, float g,
                                              float* s) const {
    s[0] = __fadd_rn(__fmul_rn(b1, s[0]), __fmul_rn(one_minus_b1, g));
    s[1] = __fadd_rn(__fmul_rn(b2, s[1]),
                     __fmul_rn(__fmul_rn(one_minus_b2, g), g));
    const float step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(s[0], bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(s[1], bc2)),
                                           eps));
    return __fsub_rn(p, step);
  }
};

template <typename Rule>
__global__ void __launch_bounds__(THREADS)
update_kernel(const float* __restrict__ p, const float* __restrict__ g,
              float* __restrict__ out, float* __restrict__ s0,
              float* __restrict__ s1, long long n, int vec, Rule rule) {
  constexpr int NS = Rule::SLOTS;
  float* slots[2] = {s0, s1};
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long start = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 pv = reinterpret_cast<const float4*>(p)[i];
      float4 gv = reinterpret_cast<const float4*>(g)[i];
      float4 sv[NS > 0 ? NS : 1];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        sv[k] = reinterpret_cast<const float4*>(slots[k])[i];
      float4 ov;
      const float* pe = reinterpret_cast<const float*>(&pv);
      const float* ge = reinterpret_cast<const float*>(&gv);
      float* oe = reinterpret_cast<float*>(&ov);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s[2];
#pragma unroll
        for (int k = 0; k < NS; ++k) s[k] = reinterpret_cast<float*>(&sv[k])[c];
        oe[c] = rule(pe[c], ge[c], s);
#pragma unroll
        for (int k = 0; k < NS; ++k) reinterpret_cast<float*>(&sv[k])[c] = s[k];
      }
#pragma unroll
      for (int k = 0; k < NS; ++k)
        reinterpret_cast<float4*>(slots[k])[i] = sv[k];
      reinterpret_cast<float4*>(out)[i] = ov;
    }
    start = n4 * 4;
  }
  for (long long i = start + tid; i < n; i += stride) {
    float s[2];
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = slots[k][i];
    out[i] = rule(p[i], g[i], s);
#pragma unroll
    for (int k = 0; k < NS; ++k) slots[k][i] = s[k];
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

template <typename Rule>
int launch(const float* p, const float* g, float* out, float* s0, float* s1,
           long long n, Rule rule, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int vec = aligned16(p) && aligned16(g) && aligned16(out) &&
                  (Rule::SLOTS < 1 || aligned16(s0)) &&
                  (Rule::SLOTS < 2 || aligned16(s1));
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  update_kernel<Rule><<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, g, out, s0, s1, n, vec, rule);
  return cudaGetLastError();
}

}  // namespace

// Every array is n contiguous float32 on one device; out must not alias
// any input.  Each returns the launch's cudaError_t (0 on success).
extern "C" int psdt_fused_sgd(const float* p, const float* g, float* out,
                              long long n, float lr, void* stream) {
  return launch(p, g, out, nullptr, nullptr, n, Sgd{lr}, stream);
}

// vel is updated in place.
extern "C" int psdt_fused_momentum(const float* p, const float* g,
                                   float* vel, float* out, long long n,
                                   float lr, float mu, void* stream) {
  return launch(p, g, out, vel, nullptr, n, Momentum{lr, mu}, stream);
}

// m and v are updated in place; bc1/bc2 are the step's bias corrections,
// one_minus_b1/b2 are 1-b1 and 1-b2 as the caller rounds them to f32.
extern "C" int psdt_fused_adam(const float* p, const float* g, float* m,
                               float* v, float* out, long long n, float lr,
                               float b1, float b2, float eps, float bc1,
                               float bc2, float one_minus_b1,
                               float one_minus_b2, void* stream) {
  return launch(p, g, out, m, v, n,
                Adam{lr, b1, b2, eps, one_minus_b1, one_minus_b2, bc1, bc2},
                stream);
}
