// Causal flash-attention backward for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ops/flash_attention.py).
//
// Replaces the two Pallas TPU kernels of _flash_bwd
// (parameter_server_distributed_tpu/ops/pallas/flash_attention.py:244):
//  - _flash_bwd_dq_kernel (:162)  -> flash_bwd_dq_kernel below;
//  - _flash_bwd_dkv_kernel (:202) -> flash_bwd_dkv_kernel below.
// Same function: the forward saved only O and the per-row logsumexp, so
// both kernels recompute P = exp(s*scale - lse) (masked to 0) tile by tile,
// with delta = rowsum(dO * O) computed in the kernel, dS = P * (dP - delta)
// and dP = dO V^T; then dQ = scale * dS K, dV = P^T dO and
// dK = scale * dS^T Q.  All arithmetic is f32; each output is written once
// in the input type.  Under the GQA fold q/o/dO are [BH, G*S, D] against
// k/v [BH, S, D]: the q-rows axis holds G segments of S rows that share
// one K/V sequence, a row's causal position is its position inside its
// segment, and dK/dV sum the G segments' contributions.
//
// What bounds it on this card.  dQ does three causal-half products
// (QK^T, dO V^T, dS K) and dK/dV four (QK^T, dO V^T, P^T dO, dS^T Q), each
// BH*G*S^2*D multiply-adds, against O(S*D) bytes per row: at the training
// shapes (S = 1024) both are bound by operations, so the bound is the
// tensor-core rate.  This first design does not reach for it.  It is the
// simple, correct form, the design of flash_fwd.cu:
//  - dQ: one thread block owns one (bh, segment, 64-row q tile); it
//    computes delta for its rows once, then loops over 64-row k/v tiles up
//    to its own causal frontier and accumulates dQ in registers;
//  - dK/dV: one thread block owns one (bh, 64-row k tile) and walks every
//    segment's q tiles from the k tile's frontier to the segment's end,
//    accumulating dK and dV in registers.  One block owns the k tile across
//    all G segments, so the GQA group sum needs no atomics and nothing
//    carries between blocks (the TPU kernel's segment-restarting q stream,
//    _q_frontier_spec :67, has no other counterpart);
//  - tiles are staged in shared memory as f32 (row stride padded by one
//    word, so column walks hit distinct banks) and the products run on the
//    CUDA cores in f32, which keeps f32 inputs within the f32 tolerance;
//  - the blocks with the longest causal walks start first.
// Tensor cores (mma.sync / wgmma), TMA staging and pipelined tile rings are
// the later work that moves it toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // k/v rows per tile
constexpr int THREADS = 256;   // 16 x 16 thread grid over a 64 x 64 tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [r0, r0 + 64) of a [rows_total, D] operand into a padded f32
// tile; rows at or past `limit` read as zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int limit) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] =
        r0 + r < limit ? load_f32(src + (long long)(r0 + r) * D + c) : 0.f;
  }
}

// delta[r] = sum_d dO[r][d] * O[r][d] for the tile's 64 rows, four threads
// per row reduced with warp shuffles; dO comes from the staged tile, O
// straight from device memory.  lse is staged beside it.
template <typename T, int D>
__device__ __forceinline__ void row_terms(float* delta_s, float* lse_s,
                                          const float* dos, const T* ob,
                                          const float* lb, int q0, int seg) {
  constexpr int DP = D + 1;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float sum = 0.f;
  if (q0 + r < seg)
    for (int c = part; c < D; c += 4)
      sum += dos[r * DP + c] * load_f32(ob + (long long)(q0 + r) * D + c);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0) {
    delta_s[r] = sum;
    lse_s[r] = q0 + r < seg ? lb[q0 + r] : 0.f;
  }
}

// For the 4 x 4 (q row, k row) entries this thread owns — q rows
// ty + 16i, k rows tx + 16j of the tile pair — compute s = q.k and
// dp = dO.v over D, then P = exp(s*scale - lse) (0 outside the causal
// triangle and the segment) and dS = P * (dp - delta).
template <int D>
__device__ __forceinline__ void tile_p_ds(float (&p)[4][4], float (&ds)[4][4],
                                          const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* delta_s, int q0,
                                          int k0, int seg, float scale) {
  constexpr int DP = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * DP + d];
      gv[i] = dos[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * DP + d];
      vv[j] = vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool live = k0 + c <= q0 + r && q0 + r < seg && k0 + c < seg;
      p[i][j] = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta_s[r]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  // q, dO, k, v [64][D+1]; dS [BQ][BK+1]; lse, delta [BQ]
  return 4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // k, v, q, dO [64][D+1]; P, dS [BQ][BK+1]; lse, delta [BQ]
  return 4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, int groups, int seg, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + 64 * DP;
  float* ks = dos + 64 * DP;
  float* vs = ks + 64 * DP;
  float* dss = vs + 64 * DP;
  float* lse_s = dss + BQ * SP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest frontier first
  const int seg_i = blockIdx.z;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long rows = (long long)groups * seg;
  const long long qoff = ((long long)bh * rows + (long long)seg_i * seg) * D;
  const T* kb = k + (long long)bh * seg * D;
  const T* vb = v + (long long)bh * seg * D;
  const float* lb = lse + (long long)bh * rows + (long long)seg_i * seg;

  stage<T, D>(qs, q + qoff, q0, seg);
  stage<T, D>(dos, g + qoff, q0, seg);
  __syncthreads();
  row_terms<T, D>(delta_s, lse_s, dos, o + qoff, lb, q0, seg);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, seg) - 1;
  const int n_k = q_last / BK + 1;   // k tiles up to the causal frontier
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's dS/k reads are done
    stage<T, D>(ks, kb, k0, seg);
    stage<T, D>(vs, vb, k0, seg);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<D>(p, ds, qs, dos, ks, vs, lse_s, delta_s, q0, k0, seg, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty + 16 * i) * SP + tx + 16 * j] =
          ds[i][j];
    __syncthreads();
    // acc += dS K: this thread owns q rows ty + 16i, columns tx + 16j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* out = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= seg) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store_f32(out + (long long)(q0 + r) * D + tx + 16 * j,
                acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     T* __restrict__ dk, T* __restrict__ dv, int groups,
                     int seg, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + 64 * DP;
  float* qs = vs + 64 * DP;
  float* dos = qs + 64 * DP;
  float* ps = dos + 64 * DP;
  float* dss = ps + BQ * SP;
  float* lse_s = dss + BQ * SP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;   // k tile 0 walks the most q tiles: first
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long rows = (long long)groups * seg;
  const long long kvoff = (long long)bh * seg * D;

  stage<T, D>(ks, k + kvoff, k0, seg);
  stage<T, D>(vs, v + kvoff, k0, seg);

  // dK, dV accumulators: this thread owns k rows ty + 16i, columns
  // tx + 16j
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (seg + BQ - 1) / BQ;
  for (int seg_i = 0; seg_i < groups; ++seg_i) {
    const long long qoff =
        ((long long)bh * rows + (long long)seg_i * seg) * D;
    const float* lb = lse + (long long)bh * rows + (long long)seg_i * seg;
    // q tiles before k0 / BQ end before this k tile starts: no row there
    // attends to it
    for (int qt = k0 / BQ; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's reads are done
      stage<T, D>(qs, q + qoff, q0, seg);
      stage<T, D>(dos, g + qoff, q0, seg);
      __syncthreads();
      row_terms<T, D>(delta_s, lse_s, dos, o + qoff, lb, q0, seg);
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<D>(p, ds, qs, dos, ks, vs, lse_s, delta_s, q0, k0, seg,
                   scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty + 16 * i) * SP + tx + 16 * j;
          ps[at] = p[i][j];
          dss[at] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's q rows r
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[4], sv[4], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * SP + ty + 16 * i];
          sv[i] = dss[r * SP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = dos[r * DP + tx + 16 * j];
          qv[j] = qs[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (k0 + r >= seg) continue;
    const long long at = kvoff + (long long)(k0 + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store_f32(dk + at + tx + 16 * j, dk_acc[i][j] * scale);
      store_f32(dv + at + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* g, const void* lse, void* dq,
                      int bh, int groups, int seg, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seg + BQ - 1) / BQ, groups);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), groups, seg, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* g, const void* lse,
                       void* dk, void* dv, int bh, int groups, int seg,
                       float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seg + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), groups, seg, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, g (= dO) and dq [bh, groups*seg, d]; k, v [bh, seg, d];
// lse [bh, 1, groups*seg] f32; all contiguous on one device.  is_bf16: 1
// for bf16, 0 for f32.  Returns the launch's cudaError_t (0 on success).
extern "C" int psdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* g,
                                 const void* lse, void* dq, int bh,
                                 int groups, int seg, int d, int is_bf16,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, o, g, lse, dq, bh,
                                                  groups, seg, scale, s)
                   : launch_dq<float, 64>(q, k, v, o, g, lse, dq, bh, groups,
                                          seg, scale, s);
  if (d == 128)
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(q, k, v, o, g, lse, dq,
                                                   bh, groups, seg, scale, s)
                   : launch_dq<float, 128>(q, k, v, o, g, lse, dq, bh, groups,
                                           seg, scale, s);
  return cudaErrorInvalidValue;
}

// As psdt_flash_bwd_dq; dk and dv are [bh, seg, d] like k and v.
extern "C" int psdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* o, const void* g,
                                  const void* lse, void* dk, void* dv, int bh,
                                  int groups, int seg, int d, int is_bf16,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, o, g, lse, dk, dv,
                                                   bh, groups, seg, scale, s)
                   : launch_dkv<float, 64>(q, k, v, o, g, lse, dk, dv, bh,
                                           groups, seg, scale, s);
  if (d == 128)
    return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(q, k, v, o, g, lse, dk,
                                                    dv, bh, groups, seg, scale,
                                                    s)
                   : launch_dkv<float, 128>(q, k, v, o, g, lse, dk, dv, bh,
                                            groups, seg, scale, s);
  return cudaErrorInvalidValue;
}
