// Causal flash-attention forward for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (parameter_server_distributed_tpu/ops/pallas/flash_attention.py:86,
// driven by _flash_fwd :126).  Same function: scores s = q.k / sqrt(D),
// the running max m, the running sum l and the output accumulator are
// f32; masked scores are -1e30; O is written once in the input type and
// the per-row logsumexp lse = m + log(max(l, 1e-30)) in f32.  Under the
// GQA fold q is [BH, G*S, D] against k/v [BH, S, D]: the q-rows axis holds
// G segments of S rows that share one K/V sequence, and a row's causal
// position is its position inside its segment.
//
// What bounds it on this card.  Causal prefill does 2*BH*G*S^2*D
// multiply-adds against 2*BH*S*(G+2)*D input elements, so at the serving
// and training shapes (S >= 256) it is bound by operations: the bound is
// the tensor-core rate.  Two kernels, picked by the input type:
//
// bf16 (flash_fwd_mma_kernel, the main path):
//  - a block of two warpgroups owns one 64-row q tile position in two
//    segments of one kv head (warpgroup 0 segment 2p, warpgroup 1 segment
//    2p + 1; with G odd the last pair's second warpgroup idles), so both
//    share every K/V tile and stop at the same causal frontier;
//  - Q K^T and P V run on the tensor cores as warpgroup MMAs (wgmma
//    m64n64k16, bf16 inputs, f32 accumulator; flash_mma.cuh): Q as
//    register fragments, K and V through descriptors on 128B-swizzled
//    tiles (K K-major, V MN-major).  The scores are exact products summed
//    in f32, the 1/sqrt(D) scale is applied to them in f32, and the
//    online softmax stays in registers; P is rounded to bf16 as the
//    register A operand of P V (l sums the f32 P), which moves o by less
//    than its own bf16 rounding;
//  - K/V tiles (64 rows) stream through a two-stage cp.async ring, zero
//    filling rows past the segment, the next tile's copy in flight during
//    the current tile's products (TMA and a producer warp are the next
//    step);
//  - only the diagonal tile is masked; q tiles are issued longest
//    frontier first, so the long causal rows do not trail at the end of
//    the grid.
//
// f32 (flash_fwd_kernel, the small f32 models): products on the CUDA
// cores in f32, which keeps f32 inputs within the f32 tolerance (bf16 or
// TF32 products would not).  One thread block owns one (bh, segment,
// 64-row q tile), stages q, k and v tiles in shared memory as f32 (row
// stride padded by one word) and loops over 64-row k/v tiles up to its
// own causal frontier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // k/v rows per tile
constexpr int THREADS = 256;   // 16 x 16 thread grid over a 64 x 64 tile
using flash_mma::NEG_INF;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

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

// ---- bf16: tensor cores (wgmma)

constexpr int MMA_THREADS = 256;   // two warpgroups, one segment each
constexpr int MQ = 64;             // q rows per segment per block
constexpr int MK = 64;             // k/v rows per tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // 1024 bytes of slack to align the swizzled k/v tiles; k and v
  // [2 stages][MK][D] swizzled; q [2*MQ][D+8] padded; all bf16
  return 1024 + (size_t)4 * MK * D * sizeof(__nv_bfloat16) +
         (size_t)2 * MQ * flash_mma::row_stride<D>() * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int groups, int seg, float scale) {
  using namespace flash_mma;
  constexpr int DP = row_stride<D>();
  constexpr int KS = D / 16;      // k steps of Q K^T
  constexpr int SLABS = D / 64;   // 64-column slabs of a k/v row (and of O)
  constexpr int TILE = MK * D;    // elements of one k or v tile
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = align1024(smem_raw);
  bf16* vs = ks + 2 * TILE;
  bf16* qs = vs + 2 * TILE;

  const int pairs = (groups + 1) / 2;
  const int bh = blockIdx.x / pairs;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest frontier first
  const int q0 = tile * MQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / 4;                     // this warpgroup
  const int g = 2 * (blockIdx.x % pairs) + half;
  const bool active = g < groups;
  const long long rows = (long long)groups * seg;
  const long long qoff =
      (long long)bh * rows + (long long)(active ? g : 0) * seg;
  const bf16* kb = k + (long long)bh * seg * D;
  const bf16* vb = v + (long long)bh * seg * D;

  // k/v tile kt into stage st, swizzled; rows past the segment zero-filled
  auto load_kv = [&](int kt, int st) {
    load_tile_sw128<MK, D, MMA_THREADS>(ks + st * TILE, kb, kt * MK, seg,
                                        threadIdx.x);
    load_tile_sw128<MK, D, MMA_THREADS>(vs + st * TILE, vb, kt * MK, seg,
                                        threadIdx.x);
  };
  // each warpgroup copies its own segment's q rows (none when idle), then
  // all threads copy k/v tile 0: one group
  load_tile<MQ, D, 128>(qs + half * MQ * DP, q + qoff * D, q0,
                        active ? seg : 0, threadIdx.x % 128);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows (segment-relative): r_lo (c0, c1) and r_lo + 8
  const int r_lo = q0 + (warp % 4) * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[SLABS][32];
#pragma unroll
  for (int h = 0; h < SLABS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  const int n_k = (min(q0 + MQ, seg) - 1) / MK + 1;   // up to the frontier
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_kv(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    if (active) {
      const bf16* kst = ks + (kt & 1) * TILE;
      const bf16* vst = vs + (kt & 1) * TILE;
      // Q fragments are read again for every tile: a register A operand
      // carried from one tile's wgmma to the next was found corrupted
      uint32_t qa[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a<D>(qa[kk], qs + half * MQ * DP, (warp % 4) * 16, kk * 16,
                  lane);

      // S = Q K^T: 64 rows x 64 keys for the warpgroup, 16 rows a warp;
      // s[4j + e] is n tile j in the m16n8 C layout
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_m64n64k16<0>(
            s, qa[kk], sw128_desc(kst + (kk / 4) * MK * 64 + (kk % 4) * 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) fence_regs(qa[kk]);

      // the diagonal tile (the last) masks keys past the row; keys past
      // the segment lie past every live row there too
      if (kt == n_k - 1) {
        const int k0 = kt * MK;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1) >
              r_lo + ((i >> 1) & 1) * 8)
            s[i] = NEG_INF;
      }

      // online softmax over the tile; the four lanes of a row reduce the
      // max by shuffles and keep partial sums of l
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i] * scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2], ml2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
        ml2[r] = mx[r] * LOG2E;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(fmaf(s[i], sl2, -ml2[(i >> 1) & 1]));
        s[i] = p;
        l[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int h = 0; h < SLABS; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];

      // O += P V: P rounded to bf16 as the register A operand (n tiles
      // 2kk and 2kk + 1 of S are k step kk), V MN-major by slab
      uint32_t pa[MK / 16][4];
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
      for (int h = 0; h < SLABS; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < SLABS; ++h)
          wgmma_m64n64k16<1>(acc[h], pa[kk],
                             sw128_desc(vst + h * MK * 64 + kk * 16 * 64));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < SLABS; ++h) fence_regs(acc[h]);
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk) fence_regs(pa[kk]);
    }
    __syncthreads();   // this stage is free for tile kt + 2
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* ob = o + qoff * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + r * 8;
    if (row >= seg) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int h = 0; h < SLABS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(ob + (long long)row * D + h * 64 + j * 8 + (lane % 4) * 2,
                   acc[h][4 * j + 2 * r] * inv,
                   acc[h][4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0) lse[qoff + row] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int groups, int seg, float scale,
                       cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh * ((groups + 1) / 2), (seg + MQ - 1) / MQ);
  using bf16 = __nv_bfloat16;
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), groups, seg, scale);
  return cudaGetLastError();
}

}  // namespace

// q [bh, groups*seg, d], k/v [bh, seg, d], o like q, lse [bh, 1, groups*seg]
// f32; all contiguous on one device, 16-byte aligned.  is_bf16: 1 for bf16
// (the tensor-core kernel), 0 for f32.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int psdt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int groups, int seg,
                              int d, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_mma<64>(q, k, v, o, lse, bh, groups, seg, scale, s)
                   : launch<float, 64>(q, k, v, o, lse, bh, groups, seg,
                                       scale, s);
  if (d == 128)
    return is_bf16
               ? launch_mma<128>(q, k, v, o, lse, bh, groups, seg, scale, s)
               : launch<float, 128>(q, k, v, o, lse, bh, groups, seg, scale,
                                    s);
  return cudaErrorInvalidValue;
}
