// Causal flash-attention backward for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ops/flash_attention.py).
//
// Replaces the two Pallas TPU kernels of _flash_bwd
// (parameter_server_distributed_tpu/ops/pallas/flash_attention.py:244):
//  - _flash_bwd_dq_kernel (:162)  -> flash_bwd_dq_mma_kernel (bf16) and
//    flash_bwd_dq_kernel (f32) below;
//  - _flash_bwd_dkv_kernel (:202) -> flash_bwd_dkv_mma_kernel (bf16) and
//    flash_bwd_dkv_kernel (f32) below.
// Same function: the forward saved only O and the per-row logsumexp, so
// the kernels recompute P = exp(s*scale - lse) (masked to 0) tile by tile,
// with delta = rowsum(dO * O) computed in the kernel, dS = P * (dP - delta)
// and dP = dO V^T; then dQ = scale * dS K, dV = P^T dO and
// dK = scale * dS^T Q.  Sums are f32; each output is written once in the
// input type.  Under the GQA fold q/o/dO are [BH, G*S, D] against k/v
// [BH, S, D]: the q-rows axis holds G segments of S rows that share one
// K/V sequence, a row's causal position is its position inside its
// segment, and dK/dV sum the G segments' contributions.
//
// What bounds it on this card.  dQ does three causal-half products
// (QK^T, dO V^T, dS K) and dK/dV four (QK^T, dO V^T, P^T dO, dS^T Q), each
// BH*G*S^2*D multiply-adds, against O(S*D) bytes per row: at the training
// shapes (S = 1024) both are bound by operations, so the bound is the
// tensor-core rate.
//
// dK/dV in bf16 (flash_bwd_dkv_mma_kernel, the main path): one block, a
// warpgroup of four warps, owns one (bh, 64-row k tile), each warp 16 k
// rows, and walks every segment's 64-row q tiles from the k tile's
// frontier to the segment's end, accumulating dK and dV in registers: the
// GQA group sum needs no atomics and nothing carries between blocks (the
// TPU kernel's segment-restarting q stream, _q_frontier_spec :67, has no
// other counterpart).  In the transposed form every product runs on the
// tensor cores as a warpgroup MMA (wgmma m64n64k16, flash_mma.cuh) with k
// rows as M:
//  - S^T = K Q^T and dP^T = V dO^T with both operands in 128B-swizzled
//    shared tiles, taking the bf16 inputs as they are (exact products,
//    f32 sums);
//  - P^T = exp(S^T*scale - lse) and dS^T = P^T (dP^T - delta) in f32
//    registers, masked only on tiles that cross the diagonal or the
//    segment's end;
//  - dV += P^T dO and dK += dS^T Q each as two bf16 products on
//    hi = bf16(x) and lo = bf16(x - hi) of P^T and dS^T (register A
//    operands; the same swizzled dO and Q tiles read MN-major): one bf16
//    rounding of P and dS puts ~0.2% of dk/dv entries outside the bf16
//    tolerance (rtol 1e-2, atol 1e-3) at the training shape; the split
//    keeps P and dS to ~2^-17 and costs 6 products a tile where 4 would
//    do;
//  - q, dO and O tiles and the tile's lse stream through a two-stage
//    cp.async ring; delta = rowsum(dO * O) is taken from the staged tiles
//    while S^T and dP^T run;
//  - k tile 0, which walks the most q tiles, starts first.
//
// dQ in bf16 (flash_bwd_dq_mma_kernel, the main path) is the dK/dV
// design with the roles of q and k swapped: one block, a warpgroup, owns
// one (bh, segment, 64-row q tile), each warp 16 q rows, and walks the
// 64-row k tiles from 0 up to its causal frontier with dQ in registers
// (q tiles are issued longest frontier first, so the long rows do not
// trail at the end of the grid).  Per k tile it runs four products where
// the bound counts three:
//  - S = Q K^T and dP = dO V^T with both operands in 128B-swizzled shared
//    tiles (K-major); Q, dO and O are copied once per block, K and V
//    stream through a two-stage cp.async ring that zero-fills rows past
//    the segment's end;
//  - P = exp(S*scale - lse) and dS = P (dP - delta) in f32 registers,
//    masked only on the diagonal tile and the segment's last q tile;
//    each thread needs lse and delta of just its two rows, and delta =
//    rowsum(dO * O) is taken from the staged tiles while the first
//    tile's S and dP run;
//  - dQ += dS K as two products on hi = bf16(dS) and lo = bf16(dS - hi)
//    (register A operands; the swizzled K tile read MN-major), for the
//    same reason as dK/dV: one bf16 rounding of dS leaves dq outside the
//    bf16 tolerance; the scale is applied once at the end.
// One warpgroup a block keeps every product's accumulator, dQ's 64
// (D=128) among them, in registers with no spills; blocks of other
// segments and tiles hide one another's latency on the SM.
//
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the products run on
// the CUDA cores in f32 (f32 inputs must stay within the f32 tolerance,
// which bf16 or TF32 products would miss).  dQ: one thread block owns one
// (bh, segment, 64-row q tile); it computes delta for its rows once, then
// loops over 64-row k/v tiles up to its own causal frontier and
// accumulates dQ in registers.  dK/dV: the block and walk of the bf16
// kernel.  Tiles are staged in shared memory as f32 (row stride padded by
// one word).  The C entry points pick the kernel by type, so one call is
// one launch in either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // k/v rows per tile
constexpr int THREADS = 256;   // 16 x 16 thread grid over a 64 x 64 tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

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

// ---- dK/dV in bf16: tensor cores (wgmma)

constexpr int DKV_THREADS = 128;   // one warpgroup, 16 k rows a warp
constexpr int DKV_BK = 64;         // k rows per block
constexpr int DKV_BQ = 64;         // q rows per tile

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles; k, v [BK][D]; q, dO,
  // O [2 stages][BQ][D], all bf16; then lse [2 stages][BQ] and delta [BQ]
  // f32
  return 1024 + (size_t)(2 * DKV_BK + 6 * DKV_BQ) * D * sizeof(__nv_bfloat16) +
         3 * DKV_BQ * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int groups, int seg,
                         float scale) {
  using namespace flash_mma;
  constexpr int BQ = DKV_BQ, BK = DKV_BK;
  constexpr int KS = D / 16;          // k steps of K Q^T and V dO^T
  constexpr int SLABS = D / 64;       // 64-column slabs of a row
  constexpr int QT = BQ * D;          // elements of one q, dO or O tile
  constexpr int TPR = DKV_THREADS / BQ;   // threads per row for delta
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = align1024(smem_raw);
  bf16* vs = ks + BK * D;
  bf16* stages = vs + BK * D;         // [2][q, dO, O]
  float* lse_st = reinterpret_cast<float*>(stages + 6 * QT);   // [2][BQ]
  float* delta_s = lse_st + 2 * BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;     // k tile 0 walks the most: first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long rows = (long long)groups * seg;
  const long long kvoff = (long long)bh * seg * D;

  // q tiles before k0 / BQ end before this k tile starts: no row there
  // attends to it.  The walk: segment by segment, q tile by q tile; tile
  // t's q, dO, O and lse go to stage t & 1.
  const int qt0 = k0 / BQ;
  const int per = (seg + BQ - 1) / BQ - qt0;
  const int total = groups * per;
  auto prefetch = [&](int t) {
    const int seg_i = t / per;
    const int q0 = (qt0 + t % per) * BQ;
    const long long off = ((long long)bh * rows + (long long)seg_i * seg) * D;
    bf16* st = stages + (t & 1) * 3 * QT;
    load_tile_sw128<BQ, D, DKV_THREADS>(st, q + off, q0, seg, tid);
    load_tile_sw128<BQ, D, DKV_THREADS>(st + QT, g + off, q0, seg, tid);
    load_tile_sw128<BQ, D, DKV_THREADS>(st + 2 * QT, o + off, q0, seg, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < seg;
      cp_async_4(lse_st + (t & 1) * BQ + tid,
                 lse + (long long)bh * rows + (long long)seg_i * seg +
                     (in ? q0 + tid : 0),
                 in);
    }
  };
  load_tile_sw128<BK, D, DKV_THREADS>(ks, k + kvoff, k0, seg, tid);
  load_tile_sw128<BK, D, DKV_THREADS>(vs, v + kvoff, k0, seg, tid);
  prefetch(0);
  cp_async_commit();

  // this thread's k rows: kr_lo (c0, c1) and kr_lo + 8
  const int kr_lo = k0 + warp * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float dk_acc[SLABS][32], dv_acc[SLABS][32];
#pragma unroll
  for (int h = 0; h < SLABS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      prefetch(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int q0 = (qt0 + t % per) * BQ;
    const bf16* qst = stages + (t & 1) * 3 * QT;
    const bf16* dost = qst + QT;
    const bf16* ost = qst + 2 * QT;

    // S^T = K Q^T and dP^T = V dO^T: 64 k rows x 64 q columns, st[4j + e]
    // and dpt[4j + e] for q column tile j
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int at = (kk / 4) * 64 * 64 + (kk % 4) * 16;   // BK = BQ = 64
      wgmma_ss_m64n64k16(st, sw128_desc(ks + at), sw128_desc(qst + at));
      wgmma_ss_m64n64k16(dpt, sw128_desc(vs + at), sw128_desc(dost + at));
    }
    wgmma_commit();

    // delta = rowsum(dO * O) for the tile's rows while the products run
    {
      const int r = tid / TPR, part = tid % TPR;
      float sum = 0.f;
#pragma unroll
      for (int c = part * (D / 8 / TPR); c < (part + 1) * (D / 8 / TPR); ++c) {
        const int at = (c / 8) * BQ * 64 + sw128(r, c % 8);
        const uint4 a = *reinterpret_cast<const uint4*>(dost + at);
        const uint4 b = *reinterpret_cast<const uint4*>(ost + at);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(b2[e]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) delta_s[r] = sum;
    }

    __syncthreads();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in place; a tile that crosses the diagonal or either
    // segment end is masked (k row > q row, or q row past the segment)
    const bool edge = q0 < k0 + BK || q0 + BQ > seg || k0 + BK > seg;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      float p = exp2f(fmaf(st[i], sl2, -lse_st[(t & 1) * BQ + c] * LOG2E));
      if (edge && (kr_lo + ((i >> 1) & 1) * 8 > q0 + c || q0 + c >= seg))
        p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta_s[c]);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's q rows, each on the hi
    // and lo bf16 parts of its A operand; k step kk is q rows 16kk..
    uint32_t fr[BQ / 16][4][4];   // k step, (P hi, P lo, dS hi, dS lo)
#pragma unroll
    for (int h = 0; h < SLABS; ++h) {
      fence_regs(dk_acc[h]);
      fence_regs(dv_acc[h]);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1], fr[kk][0][i],
              fr[kk][1][i]);
        split(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1], fr[kk][2][i],
              fr[kk][3][i]);
      }
      wgmma_fence();   // fr[kk] was written since the last fence
#pragma unroll
      for (int h = 0; h < SLABS; ++h) {
        const int at = h * BQ * 64 + kk * 16 * 64;
        wgmma_m64n64k16<1>(dv_acc[h], fr[kk][0], sw128_desc(dost + at));
        wgmma_m64n64k16<1>(dv_acc[h], fr[kk][1], sw128_desc(dost + at));
        wgmma_m64n64k16<1>(dk_acc[h], fr[kk][2], sw128_desc(qst + at));
        wgmma_m64n64k16<1>(dk_acc[h], fr[kk][3], sw128_desc(qst + at));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < SLABS; ++h) {
      fence_regs(dk_acc[h]);
      fence_regs(dv_acc[h]);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(fr[kk][j]);
    __syncthreads();   // this stage and delta are free for tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr_lo + r * 8;
    if (row >= seg) continue;
    const long long at = kvoff + (long long)row * D + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < SLABS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store_pair(dk + at + h * 64 + j * 8, dk_acc[h][4 * j + 2 * r] * scale,
                   dk_acc[h][4 * j + 2 * r + 1] * scale);
        store_pair(dv + at + h * 64 + j * 8, dv_acc[h][4 * j + 2 * r],
                   dv_acc[h][4 * j + 2 * r + 1]);
      }
  }
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* o, const void* g, const void* lse,
                           void* dk, void* dv, int bh, int groups, int seg,
                           float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seg + DKV_BK - 1) / DKV_BK);
  flash_bwd_dkv_mma_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), groups, seg, scale);
  return cudaGetLastError();
}

// ---- dQ in bf16: tensor cores (wgmma)

constexpr int DQ_THREADS = 128;   // one warpgroup, 16 q rows a warp
constexpr int DQ_BQ = 64;         // q rows per block
constexpr int DQ_BK = 64;         // k/v rows per tile

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles; q, dO, O [BQ][D];
  // k, v [2 stages][BK][D], all bf16; then delta [BQ] f32
  return 1024 + (size_t)(3 * DQ_BQ + 4 * DQ_BK) * D * sizeof(__nv_bfloat16) +
         DQ_BQ * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, int groups, int seg,
                        float scale) {
  using namespace flash_mma;
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  constexpr int KS = D / 16;          // k steps of Q K^T and dO V^T
  constexpr int SLABS = D / 64;       // 64-column slabs of a row
  constexpr int KT = BK * D;          // elements of one k or v tile
  constexpr int TPR = DQ_THREADS / BQ;   // threads per row for delta
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024(smem_raw);
  bf16* dos = qs + BQ * D;
  bf16* os = dos + BQ * D;
  bf16* kvs = os + BQ * D;            // [2 stages][k, v]
  float* delta_s = reinterpret_cast<float*>(kvs + 4 * KT);

  const int bh = blockIdx.x / groups;
  const int seg_i = blockIdx.x % groups;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long rows = (long long)groups * seg;
  const long long qoff = ((long long)bh * rows + (long long)seg_i * seg) * D;
  const bf16* kb = k + (long long)bh * seg * D;
  const bf16* vb = v + (long long)bh * seg * D;

  // k/v tile kt into stage kt & 1; rows past the segment zero-filled
  auto load_kv = [&](int kt) {
    bf16* st = kvs + (kt & 1) * 2 * KT;
    load_tile_sw128<BK, D, DQ_THREADS>(st, kb, kt * BK, seg, tid);
    load_tile_sw128<BK, D, DQ_THREADS>(st + KT, vb, kt * BK, seg, tid);
  };
  load_tile_sw128<BQ, D, DQ_THREADS>(qs, q + qoff, q0, seg, tid);
  load_tile_sw128<BQ, D, DQ_THREADS>(dos, g + qoff, q0, seg, tid);
  load_tile_sw128<BQ, D, DQ_THREADS>(os, o + qoff, q0, seg, tid);
  load_kv(0);
  cp_async_commit();

  // this thread's q rows (segment-relative): r_lo (c0, c1) and r_lo + 8,
  // with their lse in log2 units
  const int r_lo = q0 + warp * 16 + lane / 4;
  const float* lb = lse + (long long)bh * rows + (long long)seg_i * seg;
  float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = r_lo + 8 * r < seg ? lb[r_lo + 8 * r] * LOG2E : 0.f;
  const float sl2 = scale * LOG2E;
  float acc[SLABS][32];
#pragma unroll
  for (int h = 0; h < SLABS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  const int n_k = (min(q0 + BQ, seg) - 1) / BK + 1;   // up to the frontier
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_kv(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int k0 = kt * BK;
    const bf16* kst = kvs + (kt & 1) * 2 * KT;
    const bf16* vst = kst + KT;

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 k columns, s[4j + e] and
    // dp[4j + e] for k column tile j
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int at = (kk / 4) * 64 * 64 + (kk % 4) * 16;   // BQ = BK = 64
      wgmma_ss_m64n64k16(s, sw128_desc(qs + at), sw128_desc(kst + at));
      wgmma_ss_m64n64k16(dp, sw128_desc(dos + at), sw128_desc(vst + at));
    }
    wgmma_commit();

    if (kt == 0) {
      // delta = rowsum(dO * O) for the tile's rows while the products run
      const int r = tid / TPR, part = tid % TPR;
      float sum = 0.f;
#pragma unroll
      for (int c = part * (D / 8 / TPR); c < (part + 1) * (D / 8 / TPR); ++c) {
        const int at = (c / 8) * BQ * 64 + sw128(r, c % 8);
        const uint4 a = *reinterpret_cast<const uint4*>(dos + at);
        const uint4 b = *reinterpret_cast<const uint4*>(os + at);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(b2[e]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) delta_s[r] = sum;
      __syncthreads();
      delta[0] = delta_s[r_lo - q0];
      delta[1] = delta_s[r_lo - q0 + 8];
    }

    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P and dS (in dp); the diagonal tile and the segment's last q tile
    // are masked (k column > q row, or q row past the segment)
    const bool edge = kt == n_k - 1 || q0 + BQ > seg;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      const int row = r_lo + 8 * hr;
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -lse2[hr]));
      if (edge && (col > row || row >= seg)) p = 0.f;
      dp[i] = p * (dp[i] - delta[hr]);
    }

    // dQ += dS K on the hi and lo bf16 parts of dS; k step kk is k rows
    // 16kk.. of the tile
    uint32_t fr[BK / 16][2][4];   // k step, (dS hi, dS lo)
#pragma unroll
    for (int h = 0; h < SLABS; ++h) fence_regs(acc[h]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1], fr[kk][0][i],
              fr[kk][1][i]);
      wgmma_fence();   // fr[kk] was written since the last fence
#pragma unroll
      for (int h = 0; h < SLABS; ++h) {
        const int at = h * BK * 64 + kk * 16 * 64;
        wgmma_m64n64k16<1>(acc[h], fr[kk][0], sw128_desc(kst + at));
        wgmma_m64n64k16<1>(acc[h], fr[kk][1], sw128_desc(kst + at));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < SLABS; ++h) fence_regs(acc[h]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) fence_regs(fr[kk][j]);
    __syncthreads();   // this stage is free for tile kt + 2
  }

  bf16* out = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + r * 8;
    if (row >= seg) continue;
    const long long at = (long long)row * D + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < SLABS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(out + at + h * 64 + j * 8, acc[h][4 * j + 2 * r] * scale,
                   acc[h][4 * j + 2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* o, const void* g, const void* lse,
                          void* dq, int bh, int groups, int seg, float scale,
                          cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dq_mma_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh * groups, (seg + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_mma_kernel<D><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), groups, seg, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, g (= dO) and dq [bh, groups*seg, d]; k, v [bh, seg, d];
// lse [bh, 1, groups*seg] f32; all contiguous on one device.  is_bf16: 1
// for bf16, 0 for f32; bf16 takes the tensor-core kernel, which needs
// every pointer 16-byte aligned.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int psdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* g,
                                 const void* lse, void* dq, int bh,
                                 int groups, int seg, int d, int is_bf16,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dq_mma<64>(q, k, v, o, g, lse, dq, bh, groups,
                                       seg, scale, s)
                   : launch_dq<float, 64>(q, k, v, o, g, lse, dq, bh, groups,
                                          seg, scale, s);
  if (d == 128)
    return is_bf16 ? launch_dq_mma<128>(q, k, v, o, g, lse, dq, bh, groups,
                                        seg, scale, s)
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
    return is_bf16 ? launch_dkv_mma<64>(q, k, v, o, g, lse, dk, dv, bh,
                                        groups, seg, scale, s)
                   : launch_dkv<float, 64>(q, k, v, o, g, lse, dk, dv, bh,
                                           groups, seg, scale, s);
  if (d == 128)
    return is_bf16 ? launch_dkv_mma<128>(q, k, v, o, g, lse, dk, dv, bh,
                                         groups, seg, scale, s)
                   : launch_dkv<float, 128>(q, k, v, o, g, lse, dk, dv, bh,
                                            groups, seg, scale, s);
  return cudaErrorInvalidValue;
}
