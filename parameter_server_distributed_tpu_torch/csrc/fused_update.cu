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
// Params are written to a fresh output (a served snapshot may alias the
// input); the slots (the velocity, m and v) are updated in place, which
// is the JAX buffer donation.
//
// What bounds it on this card: bytes.  Each element does a handful of
// flops against 12 (SGD), 20 (momentum) or 28 (Adam) bytes moved, far
// below the card's ~295 flops per byte, so the bound is the memory rate.
// A store is hundreds of tensors (219 for llama_350m, from 1,024 to 32.8M
// elements), and one launch a tensor would leave the apply bound by the
// host's launch gaps, not by the card.  So one launch covers a list of
// tensors:
//  - the host plans it (ops/fused_update.py ``plan``): every tensor is cut
//    into chunks of CHUNK elements and each block takes one chunk, so a
//    32.8M-element embedding and a 1,024-element norm spread over the
//    card alike and the block scheduler balances the rest;
//  - the launch's table (each tensor's operand pointers, length, float4
//    flag and the block of its chunk 0, and each block's tensor) is the
//    kernel's by-value parameter, 29,952 bytes (CUDA 12.1+ takes up to
//    32,764 bytes of parameters on sm_70+), so a launch costs no copy and
//    no allocation; a store beyond MAX_TENSORS tensors or MAX_CHUNKS
//    chunks takes one launch per table (the TPU's (rows, 128) padding was
//    that chip's tile rule and has no counterpart);
//  - inside a chunk, 16-byte float4 accesses when every operand of the
//    tensor is 16-byte aligned, plain f32 accesses otherwise and for the
//    tail.  Both apply the same per-element rule, so they agree bit for
//    bit.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1 << 16;        // elements a block takes
constexpr int MAX_TENSORS = 256;      // tensors in one launch's table
constexpr int MAX_CHUNKS = 16384;     // chunks (blocks) in one launch
constexpr int OPERANDS = 5;           // p, g, out, s0, s1

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

// One launch's table, the kernel's by-value parameter.
struct Table {
  float* ops[OPERANDS][MAX_TENSORS];   // p, g, out, s0 (velocity; m), s1 (v)
  long long n[MAX_TENSORS];            // elements of each tensor
  int first[MAX_TENSORS];    // block of the tensor's chunk 0 (negative
                             // when earlier chunks went to an earlier launch)
  unsigned char vec[MAX_TENSORS];      // 1: every operand 16-byte aligned
  unsigned char tensor[MAX_CHUNKS];    // each block's tensor
};
static_assert(sizeof(Table) == 29952, "ops/fused_update.py packs this size");
static_assert(sizeof(Table) + 8 * sizeof(float) <= 32764,
              "the table must fit the kernel parameter space");

template <typename Rule>
__global__ void __launch_bounds__(THREADS)
update_kernel(const __grid_constant__ Table t, Rule rule) {
  constexpr int NS = Rule::SLOTS;
  const int i = t.tensor[blockIdx.x];
  const long long start = (long long)((int)blockIdx.x - t.first[i]) * CHUNK;
  const int n = (int)min((long long)CHUNK, t.n[i] - start);
  const float* __restrict__ p = t.ops[0][i] + start;
  const float* __restrict__ g = t.ops[1][i] + start;
  float* __restrict__ out = t.ops[2][i] + start;
  float* slots[2] = {NS > 0 ? t.ops[3][i] + start : nullptr,
                     NS > 1 ? t.ops[4][i] + start : nullptr};
  int tail = 0;
  if (t.vec[i]) {
    const int n4 = n / 4;
    for (int j = threadIdx.x; j < n4; j += THREADS) {
      float4 pv = reinterpret_cast<const float4*>(p)[j];
      float4 gv = reinterpret_cast<const float4*>(g)[j];
      float4 sv[NS > 0 ? NS : 1];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        sv[k] = reinterpret_cast<const float4*>(slots[k])[j];
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
        reinterpret_cast<float4*>(slots[k])[j] = sv[k];
      reinterpret_cast<float4*>(out)[j] = ov;
    }
    tail = n4 * 4;
  }
  for (int j = tail + threadIdx.x; j < n; j += THREADS) {
    float s[2];
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = slots[k][j];
    out[j] = rule(p[j], g[j], s);
#pragma unroll
    for (int k = 0; k < NS; ++k) slots[k][j] = s[k];
  }
}

template <typename Rule>
int launch(const long long* ops, const long long* n, const int* first,
           const unsigned char* vec, int tensors,
           const unsigned char* tensor, int blocks, Rule rule,
           void* stream) {
  if (tensors < 0 || tensors > MAX_TENSORS || blocks < 0 ||
      blocks > MAX_CHUNKS)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  Table t;
  std::memset(&t, 0, sizeof(t));
  for (int i = 0; i < tensors; ++i) {
    for (int k = 0; k < OPERANDS; ++k)
      t.ops[k][i] = reinterpret_cast<float*>(ops[i * OPERANDS + k]);
    t.n[i] = n[i];
    t.first[i] = first[i];
    t.vec[i] = vec[i];
  }
  std::memcpy(t.tensor, tensor, blocks);
  update_kernel<Rule><<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, rule);
  return cudaGetLastError();
}

}  // namespace

// The table's limits as this build has them: CHUNK, MAX_TENSORS,
// MAX_CHUNKS (ops/fused_update.py checks them against its own).
extern "C" void psdt_fused_limits(int* out) {
  out[0] = CHUNK;
  out[1] = MAX_TENSORS;
  out[2] = MAX_CHUNKS;
}

// One launch over a planned table (ops/fused_update.py): ops [tensors][5]
// operand addresses (p, g, out, s0, s1; 0 for a slot the rule lacks), n
// each tensor's elements, first the block of its chunk 0, vec 1 where all
// its operands are 16-byte aligned, tensor [blocks] each block's tensor.
// Every operand is float32 on one device; out must not alias any input;
// the slots are updated in place.  Each returns the launch's cudaError_t
// (0 on success).
extern "C" int psdt_fused_sgd(const long long* ops, const long long* n,
                              const int* first, const unsigned char* vec,
                              int tensors, const unsigned char* tensor,
                              int blocks, float lr, void* stream) {
  return launch(ops, n, first, vec, tensors, tensor, blocks, Sgd{lr},
                stream);
}

extern "C" int psdt_fused_momentum(const long long* ops, const long long* n,
                                   const int* first,
                                   const unsigned char* vec, int tensors,
                                   const unsigned char* tensor, int blocks,
                                   float lr, float mu, void* stream) {
  return launch(ops, n, first, vec, tensors, tensor, blocks,
                Momentum{lr, mu}, stream);
}

// bc1/bc2 are the step's bias corrections, one_minus_b1/b2 are 1-b1 and
// 1-b2 as the caller rounds them to f32.
extern "C" int psdt_fused_adam(const long long* ops, const long long* n,
                               const int* first, const unsigned char* vec,
                               int tensors, const unsigned char* tensor,
                               int blocks, float lr, float b1, float b2,
                               float eps, float bc1, float bc2,
                               float one_minus_b1, float one_minus_b2,
                               void* stream) {
  return launch(ops, n, first, vec, tensors, tensor, blocks,
                Adam{lr, b1, b2, eps, one_minus_b1, one_minus_b2, bc1, bc2},
                stream);
}
