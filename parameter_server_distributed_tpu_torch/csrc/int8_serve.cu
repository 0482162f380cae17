// int8 serving on Hopper (sm_90a): the weight-only int8 product, the
// attention of a decode step against the int8 KV cache, and the KV
// quantizer that writes it.  CUDA C++ with a plain C interface (loaded
// with ctypes by ops/int8_serve.py).
//
// Replaces device programs of the JAX package that are not Pallas: XLA
// fuses each into one program on the TPU, so that only int8 bytes leave
// device memory; a plain PyTorch port would write and read a widened
// copy of every weight or cache layer on every call instead.
//  - int8_wdot (K5): models/quant.py wdot (:106-115), the int8->dtype
//    convert fused into the dot, then the per-channel scale.
//    y[M,N] (f32) = (sum_k x[m,k] * q[k,n]) * scale[n], x f32 or bf16.
//  - decode_attention_int8 (K6): the int8 einsums of
//    models/generation.py decode_block (:224-246).
//  - kv_quantize (K7): models/generation.py _kv_quantize (:79-86) and the
//    cache writes of decode_block (:198-222) and prefill (:140-147).
//
// What bounds them on this card, and what the designs do about it:
//  - K5 in a decode round (M = slots, 8) is bound by the weight bytes
//    (one byte a weight, read once), at a prefill (M = the bucket, up to
//    2048) by f32 operations on the CUDA cores (2MKN; f32 x must not run
//    in TF32).  Every output's sum runs in one fixed order whatever M and
//    whichever of the two shapes computes it (runs of KSEG k, each an
//    fmaf chain; RUN_GROUPS groups of runs; see runs_a_group), so a
//    row's product is the same bits in a prefill, an extension and a
//    decode round.  The skinny shape (M <= SKINNY_M) gives a block 32
//    columns and a warp each run group, so the weight is read by
//    N / 32 blocks of 8 warps with no second pass; the tiled shape (M >
//    SKINNY_M) is a 64 x 64 x 32 shared-memory SGEMM tile, 4 x 4
//    outputs a thread, that closes a run every KSEG and a group every
//    runs_a_group runs.  bf16 x at M > SKINNY_M (a bf16 model's
//    prefill) runs instead on the tensor cores (wdot_mma_kernel), in
//    their own summation order: the fixed order binds f32 rows, which the
//    f32 serving check compares token for token.
//  - K6 is bound by the cache bytes up to each row's limit (K and V int8,
//    their f32 scales).  Probabilities are rounded to the model dtype
//    after normalisation, as in the reference, so an online softmax
//    cannot give its rounding: a block (one row, one query head, one
//    query) keeps the scores over the visible positions in shared memory
//    (8 KB at max_len 2048), takes max, sum and the normalised, rounded
//    weights, then the V pass (4 neighbouring d a thread, one 4-byte load
//    a position), split over position groups and added in a fixed order.
//    The G query heads of a KV head read its rows alike, the repeats
//    from L2; B x H blocks (128 in a decode round) spread over the card.  Positions past the limit are
//    never read.
//  - K7 is bound by bytes.  One warp a (row, position, head, K or V): the
//    absmax over D by shuffles, an IEEE divide (not a reciprocal), rint
//    half to even, the clip; writes at positions past max_len are
//    dropped, not clamped.  It must be byte-equal to its plain version,
//    so the library builds with --fmad=false, -prec-div=true,
//    -prec-sqrt=true and -ftz=false (ops/build.py EXTRA_FLAGS); K5 and K6
//    call fmaf explicitly where they want a fused multiply-add.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KSEG = 64;         // k run of one fmaf chain (K5)
constexpr int RUN_GROUPS = 8;    // K5's runs fall into this many groups
constexpr int SKINNY_M = 16;     // K5 rows up to which the skinny shape runs
constexpr int SKINNY_THREADS = 32 * RUN_GROUPS;   // a warp a run group
constexpr int SKINNY_TILE = 32;  // columns of a skinny block, one a lane
constexpr int BM = 64, BN = 64, BK = 32;  // tiled K5
constexpr int TILED_THREADS = 256;
constexpr int ATTN_THREADS = 256;
constexpr int MAXD = 256;        // head dim (K6, K7)

static_assert(KSEG % BK == 0, "a run is whole tiles of the tiled shape");

template <bool BF16>
__device__ __forceinline__ float load_f(const void* x, long long i) {
  if constexpr (BF16) {
    // bf16 -> f32 is exact: the 16 bits become the f32's high half
    return __uint_as_float(
        static_cast<unsigned>(static_cast<const unsigned short*>(x)[i]) << 16);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

__device__ __forceinline__ unsigned short f32_to_bf16_bits(float v) {
  // round to nearest even (NaN kept quiet), as __float2bfloat16_rn
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<unsigned short>(
      (u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<unsigned short>(u >> 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(static_cast<unsigned>(f32_to_bf16_bits(v)) << 16);
}

template <bool BF16>
__device__ __forceinline__ void store_f(void* out, long long i, float v) {
  if constexpr (BF16) {
    static_cast<unsigned short*>(out)[i] = f32_to_bf16_bits(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// ----------------------------------------------------------------- K5
// The order of a K5 sum, the same in both shapes: k falls into runs of
// KSEG, each an fmaf chain from +0; the runs into RUN_GROUPS groups of
// ceil(runs / RUN_GROUPS) consecutive runs, each group's runs added in
// order from +0; the groups added in order from +0; then one multiply by
// the scale.
__device__ __forceinline__ int runs_a_group(int K) {
  return ((K + KSEG - 1) / KSEG + RUN_GROUPS - 1) / RUN_GROUPS;
}

// Skinny: a block takes SKINNY_TILE columns (one a lane) and every row;
// warp w takes run group w (each run's x staged in shared memory, its
// weight bytes loaded into registers at once, one byte of q a lane a k),
// then the block adds the groups in order.
template <bool BF16, int MT>
__global__ void __launch_bounds__(SKINNY_THREADS)
wdot_skinny_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int M, int K, int N) {
  __shared__ __align__(16) float xs[RUN_GROUPS][KSEG][MT];
  __shared__ float gpart[RUN_GROUPS][MT][SKINNY_TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int runs = (K + KSEG - 1) / KSEG;
  const int g = runs_a_group(K);
  const int n = blockIdx.x * SKINNY_TILE + lane;
  float grp[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) grp[m] = 0.f;
  const int r_end = min(runs, (warp + 1) * g);
  for (int r = warp * g; r < r_end; ++r) {
    const int k0 = r * KSEG;
    const int kn = min(KSEG, K - k0);
    // the run's KSEG weight bytes of this lane's column, all loads issued
    // before any is used (one memory latency a run, not one a k)
    const int8_t* qk = q + static_cast<long long>(k0) * N + n;
    int8_t b[KSEG];
#pragma unroll
    for (int kk = 0; kk < KSEG; ++kk)
      b[kk] = (kk < kn && n < N) ? __ldg(qk + static_cast<long long>(kk) * N)
                                 : 0;
    for (int e = lane; e < MT * KSEG; e += 32) {
      const int m = e / KSEG, kk = e % KSEG;
      xs[warp][kk][m] =
          (m < M && kk < kn)
              ? load_f<BF16>(x, static_cast<long long>(m) * K + k0 + kk)
              : 0.f;
    }
    __syncwarp();
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSEG; ++kk) {
      if (kk >= kn) break;
      const float w = static_cast<float>(b[kk]);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = fmaf(xs[warp][kk][m], w, acc[m]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) grp[m] = __fadd_rn(grp[m], acc[m]);
    __syncwarp();    // the warp's x runs are read before the next staging
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) gpart[warp][m][lane] = grp[m];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * SKINNY_TILE; e += SKINNY_THREADS) {
    const int m = e / SKINNY_TILE, c = e % SKINNY_TILE;
    const int nn = blockIdx.x * SKINNY_TILE + c;
    if (m >= M || nn >= N) continue;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < RUN_GROUPS; ++w)
      total = __fadd_rn(total, gpart[w][m][c]);
    y[static_cast<long long>(m) * N + nn] = __fmul_rn(total, scale[nn]);
  }
}

// Tiled: block (column tile, row tile) of BM x BN outputs, 4 x 4 a thread.
template <bool BF16>
__global__ void __launch_bounds__(TILED_THREADS)
wdot_tiled_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int M, int K, int N) {
  __shared__ __align__(16) float as[BK][BM + 4];   // x, transposed
  __shared__ __align__(16) float bs[BK][BN + 4];   // q as f32
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int g = runs_a_group(K);
  // the run's fmaf chain, its group's sum and the total (see the order
  // above runs_a_group)
  float part[4][4], grp[4][4], total[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = grp[i][j] = total[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / TILED_THREADS; ++r) {
      const int e = tid + r * TILED_THREADS;
      const int m = e / BK, kk = e % BK;
      as[kk][m] = (m0 + m < M && k0 + kk < K)
                      ? load_f<BF16>(x, static_cast<long long>(m0 + m) * K +
                                            k0 + kk)
                      : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / TILED_THREADS; ++r) {
      const int e = tid + r * TILED_THREADS;
      const int kk = e / BN, n = e % BN;
      bs[kk][n] = (k0 + kk < K && n0 + n < N)
                      ? static_cast<float>(__ldg(
                            q + static_cast<long long>(k0 + kk) * N + n0 + n))
                      : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    const bool last_tile = k0 + BK >= K;
    if ((k0 + BK) % KSEG == 0 || last_tile) {
      // run k0 / KSEG ends here; its group ends every g runs
      const bool group_end = (k0 / KSEG + 1) % g == 0 || last_tile;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          grp[i][j] = __fadd_rn(grp[i][j], part[i][j]);
          part[i][j] = 0.f;
          if (group_end) {
            total[i][j] = __fadd_rn(total[i][j], grp[i][j]);
            grp[i][j] = 0.f;
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        y[static_cast<long long>(m) * N + n] = __fmul_rn(total[i][j], scale[n]);
    }
  }
}

// bf16 x at M > SKINNY_M: a 128 x 128 block tile on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  x's rows load as 16-byte
// chunks; q's int8 rows load as 16-byte chunks and widen to bf16 (exact:
// |q| <= 127) as they are stored transposed, [n][k], so both operands'
// fragments are 32-bit shared-memory loads of k pairs.  8 warps, 2 x 4,
// each 64 x 32 outputs (4 x 4 mma tiles).  The sum is the tensor cores'
// order, not the fixed one above: only bf16 rows take this shape.
constexpr int MMA_BM = 128, MMA_BN = 128, MMA_BK = 32;
constexpr int MMA_THREADS = 256;
constexpr int MMA_LD = MMA_BK + 8;   // padded row of k (bank spread)

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MMA_THREADS)
wdot_mma_kernel(const unsigned short* __restrict__ x,
                const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) unsigned short as[MMA_BM][MMA_LD];
  __shared__ __align__(16) unsigned short bs[MMA_BN][MMA_LD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * MMA_BM, n0 = blockIdx.x * MMA_BN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
    // x: 128 rows of 32 k, 4 chunks of 8 a row, 2 chunks a thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * MMA_THREADS;
      const int row = c / 4, kc = (c % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < M && k0 + kc < K)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<long long>(m0 + row) * K + k0 + kc));
      *reinterpret_cast<uint4*>(&as[row][kc]) = v;
    }
    // q: 32 k rows of 128 n, 8 chunks of 16 a row, 1 chunk a thread
    {
      const int krow = tid / 8, nc = (tid % 8) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + krow < K && n0 + nc < N)
        v = __ldg(reinterpret_cast<const uint4*>(
            q + static_cast<long long>(k0 + krow) * N + n0 + nc));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float f = static_cast<float>(
            static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
        bs[nc + i][krow] =
            static_cast<unsigned short>(__float_as_uint(f) >> 16);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MMA_BK; ks += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const unsigned*>(&as[r][ks + 2 * t]);
        a[i][1] = *reinterpret_cast<const unsigned*>(&as[r + 8][ks + 2 * t]);
        a[i][2] = *reinterpret_cast<const unsigned*>(&as[r][ks + 2 * t + 8]);
        a[i][3] =
            *reinterpret_cast<const unsigned*>(&as[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const unsigned*>(&bs[n][ks + 2 * t]);
        b[j][1] = *reinterpret_cast<const unsigned*>(&bs[n][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 64 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (r & 1);
        if (m < M && n < N)
          y[static_cast<long long>(m) * N + n] =
              __fmul_rn(acc[i][j][r], scale[n]);
      }
}

template <bool BF16, int MT>
int launch_skinny(const void* x, const int8_t* q, const float* scale, float* y,
                  int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + SKINNY_TILE - 1) / SKINNY_TILE);
  wdot_skinny_kernel<BF16, MT><<<grid, SKINNY_THREADS, 0, stream>>>(
      x, q, scale, y, M, K, N);
  return cudaGetLastError();
}

template <bool BF16>
int launch_wdot(const void* x, const int8_t* q, const float* scale, float* y,
                int M, int K, int N, cudaStream_t stream) {
  if (M <= 1) return launch_skinny<BF16, 1>(x, q, scale, y, M, K, N, stream);
  if (M <= 2) return launch_skinny<BF16, 2>(x, q, scale, y, M, K, N, stream);
  if (M <= 4) return launch_skinny<BF16, 4>(x, q, scale, y, M, K, N, stream);
  if (M <= 8) return launch_skinny<BF16, 8>(x, q, scale, y, M, K, N, stream);
  if (M <= SKINNY_M)
    return launch_skinny<BF16, SKINNY_M>(x, q, scale, y, M, K, N, stream);
  // the tensor cores take bf16 rows whose 16-byte chunks are aligned
  if (BF16 && K % 8 == 0 && N % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
    wdot_mma_kernel<<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const unsigned short*>(x), q, scale, y, M, K, N);
    return cudaGetLastError();
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wdot_tiled_kernel<BF16><<<grid, TILED_THREADS, 0, stream>>>(x, q, scale, y,
                                                             M, K, N);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- K6
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// grid (T, H, B), ATTN_THREADS threads: one block a (row, query head,
// query); the G query heads of a KV head read its K/V rows alike (the
// repeat reads come from L2).  q, out: [B, T, H, D] (dtype); k8, v8:
// [B, max_len, KV, D] int8; ks, vs: [B, max_len, KV] f32.  Query j of
// row b sees positions 0..limit, limit = (lengths ? lengths[b] : base) +
// j, clipped to the cache.  Shared memory: the scores [max_len], the
// query [D], the V pass's partials [groups][D] and the reduction slots.
template <bool BF16>
__global__ void __launch_bounds__(ATTN_THREADS)
decode_attn_kernel(const void* __restrict__ q, const int8_t* __restrict__ k8,
                   const int8_t* __restrict__ v8,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const long long* __restrict__ lengths, long long base,
                   void* __restrict__ out, int T, int H, int KV, int D,
                   int max_len, float sqrt_d) {
  extern __shared__ float smem[];
  const int j = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / (H / KV);                   // its KV head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int WARPS = ATTN_THREADS / 32;
  const int quads = D / 4;
  const int groups = ATTN_THREADS / quads;       // V-pass position groups
  float* scores = smem;                          // [max_len]
  float* qs = scores + max_len;                  // [D]
  float* vpart = qs + D;                         // [groups][D]
  float* red = vpart + groups * D;               // [WARPS]
  const long long limit = (lengths ? lengths[b] : base) + j;
  const int nvis = static_cast<int>(
      limit + 1 < max_len ? limit + 1 : static_cast<long long>(max_len));
  const long long qrow = (static_cast<long long>(b) * T + j) * H + hq;
  for (int e = tid; e < D; e += ATTN_THREADS)
    qs[e] = load_f<BF16>(q, qrow * D + e);
  __syncthreads();
  // scores: f32 product, x k_scale, / sqrt(D)
  const long long row0 = static_cast<long long>(b) * max_len;
  float mx = -INFINITY;
  for (int p = tid; p < nvis; p += ATTN_THREADS) {
    const long long at = (row0 + p) * KV + h;
    const char4* kr = reinterpret_cast<const char4*>(k8 + at * D);
    float acc = 0.f;
    // unrolled so that a row's loads (16 at D = 64) issue together
#pragma unroll 16
    for (int d4 = 0; d4 < quads; ++d4) {
      const char4 c = __ldg(kr + d4);
      acc = fmaf(qs[d4 * 4], static_cast<float>(c.x), acc);
      acc = fmaf(qs[d4 * 4 + 1], static_cast<float>(c.y), acc);
      acc = fmaf(qs[d4 * 4 + 2], static_cast<float>(c.z), acc);
      acc = fmaf(qs[d4 * 4 + 3], static_cast<float>(c.w), acc);
    }
    const float sc = __fdiv_rn(__fmul_rn(acc, ks[at]), sqrt_d);
    scores[p] = sc;
    mx = fmaxf(mx, sc);
  }
  // softmax over the visible positions
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int i = 1; i < WARPS; ++i) mx = fmaxf(mx, red[i]);
  __syncthreads();
  float sm = 0.f;
  for (int p = tid; p < nvis; p += ATTN_THREADS) {
    const float e = expf(__fsub_rn(scores[p], mx));
    scores[p] = e;
    sm = __fadd_rn(sm, e);
  }
  sm = warp_sum(sm);
  if (lane == 0) red[warp] = sm;
  __syncthreads();
  sm = 0.f;
  for (int i = 0; i < WARPS; ++i) sm = __fadd_rn(sm, red[i]);
  // probs rounded to the dtype, times v_scale rounded to the dtype (a
  // product in the dtype)
  for (int p = tid; p < nvis; p += ATTN_THREADS) {
    const float pr = __fdiv_rn(scores[p], sm);
    const float vscale = vs[(row0 + p) * KV + h];
    scores[p] = BF16 ? round_bf16(__fmul_rn(round_bf16(pr),
                                            round_bf16(vscale)))
                     : __fmul_rn(pr, vscale);
  }
  __syncthreads();
  // V pass: thread (group, quad) adds positions group, group + groups, ...
  // for 4 neighbouring d (one 4-byte load a position); the groups'
  // partials are added in group order
  if (tid < groups * quads) {
    const int grp = tid / quads, d0 = (tid % quads) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int p = grp; p < nvis; p += groups) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(
          v8 + ((row0 + p) * KV + h) * D + d0));
      const float w = scores[p];
      acc[0] = fmaf(w, static_cast<float>(c.x), acc[0]);
      acc[1] = fmaf(w, static_cast<float>(c.y), acc[1]);
      acc[2] = fmaf(w, static_cast<float>(c.z), acc[2]);
      acc[3] = fmaf(w, static_cast<float>(c.w), acc[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) vpart[grp * D + d0 + i] = acc[i];
  }
  __syncthreads();
  for (int e = tid; e < D; e += ATTN_THREADS) {
    float o = 0.f;
    for (int grp = 0; grp < groups; ++grp)
      o = __fadd_rn(o, vpart[grp * D + e]);
    store_f<BF16>(out, qrow * D + e, o);
  }
}

// ----------------------------------------------------------------- K7
// One warp a (b, t, head, K or V) row of D elements of x [B, T, KV, D];
// writes q [B, max_len, KV, D] int8 and scale [B, max_len, KV] f32 at
// position (lengths ? lengths[b] : base) + t, dropped past max_len.
template <bool BF16>
__global__ void kv_quantize_kernel(const void* __restrict__ xk,
                                   const void* __restrict__ xv,
                                   int8_t* __restrict__ qk,
                                   int8_t* __restrict__ qv,
                                   float* __restrict__ sk,
                                   float* __restrict__ sv,
                                   const long long* __restrict__ lengths,
                                   long long base, int B, int T, int KV, int D,
                                   int max_len) {
  const long long rows = static_cast<long long>(B) * T * KV;
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2 * rows) return;
  const bool is_v = w >= rows;
  const long long r = is_v ? w - rows : w;
  const int h = static_cast<int>(r % KV);
  const long long bt = r / KV;
  const int t = static_cast<int>(bt % T);
  const int b = static_cast<int>(bt / T);
  const long long pos = (lengths ? lengths[b] : base) + t;
  if (pos < 0 || pos >= max_len) return;   // mode="drop"
  const void* x = is_v ? xv : xk;
  float vals[MAXD / 32];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAXD / 32; ++i) {
    const int d = lane + 32 * i;
    vals[i] = d < D ? load_f<BF16>(x, r * D + d) : 0.f;
    amax = fmaxf(amax, fabsf(vals[i]));
  }
  amax = warp_max(amax);
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  const long long at = (static_cast<long long>(b) * max_len + pos) * KV + h;
  int8_t* dst = (is_v ? qv : qk) + at * D;
#pragma unroll
  for (int i = 0; i < MAXD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      const float c = fminf(fmaxf(rintf(__fdiv_rn(vals[i], scale)), -127.f),
                            127.f);
      dst[d] = static_cast<int8_t>(static_cast<int>(c));
    }
  }
  if (lane == 0) (is_v ? sv : sk)[at] = scale;
}

}  // namespace

// The limits the wrappers check against (ops/int8_serve.py).
extern "C" void psdt_int8_serve_limits(int* out) {
  out[0] = KSEG;
  out[1] = RUN_GROUPS;
  out[2] = SKINNY_M;
  out[3] = MAXD;
  out[4] = ATTN_THREADS;
}

// K5.  x [M, K] (bf16 when x_bf16, else f32), q [K, N] int8, scale [N]
// f32, y [M, N] f32.  Returns the cudaError_t of the launch.
extern "C" int psdt_int8_wdot(const void* x, int x_bf16, const int8_t* q,
                              const float* scale, float* y, int M, int K,
                              int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_wdot<true>(x, q, scale, y, M, K, N, s)
                : launch_wdot<false>(x, q, scale, y, M, K, N, s);
}

// K6.  See decode_attn_kernel; lengths is null in the contiguous mode
// (every row's first query at `base`).
extern "C" int psdt_decode_attention_int8(
    const void* q, int q_bf16, const int8_t* k8, const int8_t* v8,
    const float* ks, const float* vs, const long long* lengths,
    long long base, void* out, int B, int T, int H, int KV, int D,
    int max_len, float sqrt_d, void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H % KV || D < 4 ||
      D % 4 || D > MAXD || max_len < 1)
    return cudaErrorInvalidValue;
  const int groups = ATTN_THREADS / (D / 4);
  const size_t bytes = sizeof(float) *
      (static_cast<size_t>(max_len) + D + groups * D + ATTN_THREADS / 32);
  auto kernel = q_bf16 ? decode_attn_kernel<true> : decode_attn_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(T, H, B);
  kernel<<<grid, ATTN_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k8, v8, ks, vs, lengths, base, out, T, H, KV, D, max_len, sqrt_d);
  return cudaGetLastError();
}

// K7.  xk, xv [B, T, KV, D] (bf16 when x_bf16, else f32) into qk, qv
// [B, max_len, KV, D] int8 and sk, sv [B, max_len, KV] f32 at positions
// (lengths ? lengths[b] : base) + t; past max_len dropped.
extern "C" int psdt_kv_quantize(const void* xk, const void* xv, int x_bf16,
                                int8_t* qk, int8_t* qv, float* sk, float* sv,
                                const long long* lengths, long long base,
                                int B, int T, int KV, int D, int max_len,
                                void* stream) {
  if (B < 1 || T < 1 || KV < 1 || D < 1 || D > MAXD || max_len < 1)
    return cudaErrorInvalidValue;
  const long long threads = 2LL * B * T * KV * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    kv_quantize_kernel<true><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xk, xv, qk, qv, sk, sv, lengths, base, B, T, KV, D, max_len);
  else
    kv_quantize_kernel<false><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xk, xv, qk, qv, sk, sv, lengths, base, B, T, KV, D, max_len);
  return cudaGetLastError();
}
