// Causal flash-attention forward for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (parameter_server_distributed_tpu/ops/pallas/flash_attention.py:86,
// driven by _flash_fwd :126).  Same function: q is scaled by 1/sqrt(D)
// before Q K^T; scores, the running max m, the running sum l and the
// output accumulator are f32; masked scores are -1e30; O is written once
// in the input type and the per-row logsumexp lse = m + log(max(l, 1e-30))
// in f32.  Under the GQA fold q is [BH, G*S, D] against k/v [BH, S, D]:
// the q-rows axis holds G segments of S rows that share one K/V sequence,
// and a row's causal position is its position inside its segment.
//
// What bounds it on this card.  Causal prefill does 2*BH*G*S^2*D
// multiply-adds against 2*BH*S*(G+2)*D input elements, so at the serving
// shapes (S >= 256) it is bound by operations, not bytes: the bound is the
// tensor-core rate.  This first design does not reach for that bound.  It
// is the simple, correct form:
//  - one thread block owns one (bh, segment, 64-row q tile) and loops
//    over 64-row k/v tiles up to its own causal frontier, so blocks past
//    the diagonal are never loaded or computed and nothing carries between
//    blocks (the TPU's sequential grid, bps arithmetic and clamped index
//    maps have no counterpart);
//  - q, k and v tiles are staged in shared memory as f32 (row stride padded
//    by one word, so column walks hit distinct banks); the products run on
//    the CUDA cores in f32, which keeps f32 inputs within the f32 tolerance;
//  - q tiles are issued longest-frontier first, so the long causal rows
//    do not trail at the end of the grid.
// Tensor cores (mma.sync / wgmma), TMA staging and a pipelined k/v ring
// are the later work that moves it toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // k/v rows per tile
constexpr int THREADS = 256;   // 16 x 16 thread grid over a 64 x 64 tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1], m/l/alpha [BQ]
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int groups, int seg, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * D;
  float* m_s = ps + BQ * SP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest frontier first
  const int g = blockIdx.z;
  const int q0 = tile * BQ;   // segment-relative position of the tile's row 0
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long rows = (long long)groups * seg;
  const T* qb = q + ((long long)bh * rows + (long long)g * seg) * D;
  const T* kb = k + (long long)bh * seg * D;
  const T* vb = v + (long long)bh * seg * D;
  T* ob = o + ((long long)bh * rows + (long long)g * seg) * D;
  float* lb = lse + (long long)bh * rows + (long long)g * seg;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] =
        q0 + r < seg ? load_f32(qb + (long long)(q0 + r) * D + c) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, seg) - 1;
  const int n_k = q_last / BK + 1;   // k tiles up to the causal frontier
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's p/v reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < seg;
      const long long at = (long long)(k0 + r) * D + c;
      ks[r * DP + c] = in ? load_f32(kb + at) : 0.f;
      vs[r * D + c] = in ? load_f32(vb + at) : 0.f;
    }
    __syncthreads();

    // scores: this thread owns rows ty + 16i and columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool live = k0 + c <= q0 + r && k0 + c < seg;
        ps[r * SP + c] = live ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax: four threads per row, reduced with warp shuffles
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ps + r * SP;
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const bool live = k0 + c <= q0 + r && k0 + c < seg;
        const float p = live ? expf(row[c] - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: this thread owns rows ty + 16i and output
    // columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= seg) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store_f32(ob + (long long)(q0 + r) * D + tx + 16 * j, acc[i][j] / l);
    if (tx == 0) lb[q0 + r] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int groups, int seg, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seg + BQ - 1) / BQ, groups);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), groups, seg, scale);
  return cudaGetLastError();
}

}  // namespace

// q [bh, groups*seg, d], k/v [bh, seg, d], o like q, lse [bh, 1, groups*seg]
// f32; all contiguous on one device.  is_bf16: 1 for bf16, 0 for f32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int psdt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int groups, int seg,
                              int d, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, groups,
                                               seg, scale, s)
                   : launch<float, 64>(q, k, v, o, lse, bh, groups, seg,
                                       scale, s);
  if (d == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, groups,
                                                seg, scale, s)
                   : launch<float, 128>(q, k, v, o, lse, bh, groups, seg,
                                        scale, s);
  return cudaErrorInvalidValue;
}
