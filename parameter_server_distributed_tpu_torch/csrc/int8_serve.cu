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
//    2048) by operations (2MKN): bf16 ones on the tensor cores for bf16
//    x, f32 ones on the CUDA cores for f32 x (which must not run in
//    TF32).  Every f32 output, and every bf16 one up to SKINNY_M rows,
//    sums in one fixed order whatever M and whichever SIMT shape
//    computes it (runs of KSEG k, each an fmaf chain; RUN_GROUPS groups
//    of runs; see runs_a_group), so a row's product is the same bits in
//    a prefill, an extension and a decode round.  The skinny shape (M <=
//    SKINNY_M, wdot_skinny_kernel) spreads the weight's bytes over a
//    thread-block cluster a 64- or 128-column tile, a block a run group and
//    SKINNY_ROWS rows of a run a warp, the codes copied into shared
//    memory by cp.async, so enough bytes are in flight to stream q and a
//    warp's fmaf chains stay short; the cluster adds its groups' sums in
//    order through distributed shared memory.
//    The tiled shape (f32 rows above SKINNY_M, wdot_tiled_kernel) is a
//    64 x 64 x 32 shared-memory SGEMM tile, 4 x 4 outputs a thread, that
//    closes a run every KSEG and a group every runs_a_group runs.  bf16
//    x above SKINNY_M (a bf16 model's prefill, wdot_wgmma_kernel) runs on
//    the tensor cores as wgmma, x and q copied by TMA and q widened in
//    shared memory, in their own summation order: the fixed order binds
//    f32 rows, which the f32 serving check compares token for token.
//    Only int8 bytes of a weight leave device memory in every shape: no
//    widened copy is made.
//  - K6 is bound by the cache bytes up to each row's limit (K and V int8,
//    their f32 scales), and at a decode round's size (4.8 MB) by latency:
//    the launch, one DRAM round trip and the chain of reductions.
//    Probabilities are rounded to the model dtype after normalisation, as
//    in the reference, so an online softmax cannot give its rounding:
//    the scores stay in shared memory until the max and the sum are known.
//    A row's visible positions fall into chunks of attn::P, spread over a
//    thread-block cluster (decode_attn_plan.h), so a decode round's 8 rows of
//    2048 positions fill the card's SMs; a block reads each K and V row of
//    its chunk once (16-byte copies into shared memory, all issued on
//    entry) for every query head of the KV head and every query of its
//    tile, and the cluster finishes the softmax and the V sums through
//    distributed shared memory, a round (a chunk a block) at a time.
//    Where a tile's rounds do not fit in shared memory, it scores each
//    chunk again in the sum and V passes instead of holding the scores,
//    so shared memory does not grow with max_len.  Every sum across
//    chunks runs in chunk order, so a row's result does not depend on the
//    cluster, the rounds held, the batch or max_len.  Positions past the
//    limit are never read.
//  - K7 is bound by bytes: a row of D elements is D / 8 lanes, 8 elements
//    a lane, one 16-byte load (bf16) and one 8-byte store of the codes;
//    the absmax by shuffles among the row's lanes, an IEEE divide (not a
//    reciprocal), rint half to even, the clip; writes at positions past
//    max_len are dropped, not clamped.  It must be byte-equal to its plain
//    version, so the library builds with --fmad=false, -prec-div=true,
//    -prec-sqrt=true and -ftz=false (ops/build.py EXTRA_FLAGS); K5 and K6
//    call fmaf explicitly where they want a fused multiply-add.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "decode_attn_plan.h"
#include "flash_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using flash_mma::align1024;
using flash_mma::bf16;
using flash_mma::cp_async_16;
using flash_mma::cp_async_4;
using flash_mma::cp_async_commit;
using flash_mma::cp_async_wait;
using flash_mma::fence_proxy_async;
using flash_mma::fence_regs;
using flash_mma::sw128;
using flash_mma::sw128_desc;
using flash_mma::wgmma_commit;
using flash_mma::wgmma_fence;
using flash_mma::wgmma_wait;

constexpr int KSEG = 64;         // k run of one fmaf chain (K5)
constexpr int RUN_GROUPS = 8;    // K5's runs fall into this many groups
constexpr int SKINNY_M = 16;     // K5 rows up to which the skinny shape runs
constexpr int SKINNY_WARPS = 8;  // most runs a skinny block takes at once
constexpr int SKINNY_ROWS = 2;   // most rows a skinny warp takes
constexpr int SKINNY_THREADS = 1024;   // most threads of a skinny block
constexpr int BM = 64, BN = 64, BK = 32;  // tiled K5
constexpr int TILED_THREADS = 256;
constexpr int MAXD = 256;        // most head dim (K6, K7)

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
// The order of a K5 sum, the same in the skinny and the tiled shape: k
// falls into runs of KSEG, each an fmaf chain from +0; the runs into
// RUN_GROUPS groups of ceil(runs / RUN_GROUPS) consecutive runs, each
// group's runs added in order from +0; the groups added in order from +0;
// then one multiply by the scale.
__host__ __device__ __forceinline__ int runs_a_group(int K) {
  return ((K + KSEG - 1) / KSEG + RUN_GROUPS - 1) / RUN_GROUPS;
}

// rows of an MT-row skinny tile that one warp takes (the rest of the
// run's rows go to other warps)
__host__ __device__ constexpr int skinny_rows_a_warp(int mt) {
  return mt < SKINNY_ROWS ? mt : SKINNY_ROWS;
}

// runs a skinny block takes at once: its group's, at most SKINNY_WARPS
// and at most SKINNY_THREADS threads' worth
__host__ __device__ inline int skinny_runs(int K, int mt) {
  const int most = SKINNY_THREADS / 32 / (mt / skinny_rows_a_warp(mt));
  const int g = runs_a_group(K);
  return g < SKINNY_WARPS ? (g < most ? g : most)
                          : (SKINNY_WARPS < most ? SKINNY_WARPS : most);
}

// shared memory of a skinny block taking `runs` runs at once over a tile
// of `tile` columns: their q rows, their partials, the staged x and the
// inbox of group sums
__host__ __device__ constexpr int skinny_q_bytes(int runs, int tile) {
  return runs * KSEG * tile;
}
__host__ __device__ constexpr int skinny_smem(int runs, int mt, int tile) {
  return skinny_q_bytes(runs, tile) +
         static_cast<int>(sizeof(float)) * mt *
             (runs * tile + runs * KSEG + tile);
}

// Four int8 codes (one 32-bit word, the lowest byte first) as exact
// floats: 2^23 + (b + 128) is a float whose low byte is b + 128, less
// 2^23 + 128 (two ALU operations a code instead of a quarter-rate I2F).
__device__ __forceinline__ void widen4(unsigned w, float (&f)[4]) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)),
                     8388736.f);
}

// xs[kk][m] = x[m][k0 + kk] as f32 for kk < width, zero past kn and M;
// 16-byte loads when `vectors` (x 16-byte aligned and K a whole number
// of 16-byte chunks, so every chunk lies within its row).
template <bool BF16, int MT>
__device__ __forceinline__ void stage_x(const void* __restrict__ x,
                                        float* xs, int M, int K, int k0,
                                        int kn, int width, int vectors) {
  if (vectors) {
    constexpr int V = BF16 ? 8 : 4;   // elements of a 16-byte chunk
    const int chunks = width / V;
    for (int e = threadIdx.x; e < MT * chunks; e += blockDim.x) {
      const int m = e / chunks, kk = (e % chunks) * V;
      float v[V];
      if (m < M && kk < kn) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const char*>(x) +
            (static_cast<long long>(m) * K + k0 + kk) * (BF16 ? 2 : 4)));
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (BF16) {
            v[2 * i] = __uint_as_float(w[i] << 16);
            v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
          } else {
            v[i] = __uint_as_float(w[i]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) xs[(kk + i) * MT + m] = v[i];
    }
  } else {
    for (int e = threadIdx.x; e < MT * width; e += blockDim.x) {
      const int m = e / width, kk = e % width;
      xs[kk * MT + m] =
          (m < M && kk < kn)
              ? load_f<BF16>(x, static_cast<long long>(m) * K + k0 + kk)
              : 0.f;
    }
  }
}

// Rows [k0, k0 + kn) of q's TILE columns from n0 into qs ([kk][TILE]
// bytes), zero past N: 16-byte cp.async chunks (q_mode 2: N % 16 == 0 and
// q 16-byte aligned), 4-byte ones (1: N % 4 == 0, q 4-byte aligned) or
// bytes (0); the caller waits.
template <int TILE>
__device__ __forceinline__ void copy_q(const int8_t* __restrict__ q,
                                       unsigned char* qs, int k0, int kn,
                                       int n0, int N, int q_mode) {
  if (q_mode == 2) {
    constexpr int C = TILE / 16;
    for (int i = threadIdx.x; i < kn * C; i += blockDim.x) {
      const int kk = i / C, c = (i % C) * 16;
      const bool in = n0 + c < N;
      cp_async_16(qs + kk * TILE + c,
                  q + static_cast<long long>(k0 + kk) * N + (in ? n0 + c : 0),
                  in);
    }
  } else if (q_mode == 1) {
    constexpr int C = TILE / 4;
    for (int i = threadIdx.x; i < kn * C; i += blockDim.x) {
      const int kk = i / C, c = (i % C) * 4;
      const bool in = n0 + c < N;
      cp_async_4(qs + kk * TILE + c,
                 q + static_cast<long long>(k0 + kk) * N + (in ? n0 + c : 0),
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < kn * TILE; i += blockDim.x) {
      const int kk = i / TILE, c = i % TILE;
      qs[i] = n0 + c < N ? static_cast<unsigned char>(
                               q[static_cast<long long>(k0 + kk) * N + n0 + c])
                         : 0;
    }
  }
  cp_async_commit();
}

// The cluster barrier in two halves: every thread of the cluster arrives
// (relaxed: it orders no memory) and later waits for all of them, so a
// block may touch another's shared memory only once that block is known
// to have started, while the work between the halves hides the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Skinny (M <= SKINNY_M: every decode round).  Bound by the weight bytes
// (one a weight), which stream at the memory's rate only with many loads
// in flight, and at the small shapes by the latency of a block's chain
// (copy, products, sums): a column tile of TILE = 32 * COLS columns is
// one thread-block cluster of RUN_GROUPS blocks (grid (column tiles,
// RUN_GROUPS)), and the block of cluster rank g sums run group g of the
// tile, a chunk of up to SKINNY_WARPS of its runs at a time.  The block
// copies the chunk's q rows into shared memory with cp.async (whole
// 16-byte chunks, no registers held) while it stages the chunk's x once.
// Each run is RQ warps, one for each SKINNY_ROWS rows (all MT rows below
// that), each lane COLS adjacent columns: one shared load of their codes
// and one fmaf a row and column a k, so a warp's chains are SKINNY_ROWS
// rows' work, not MT's.  COLS is 4 (a 32-bit load, 128-column tiles)
// where the tiles already fill the card, 2 where halving the tiles'
// width puts more of it to work (launch_skinny).  The block adds the
// chunk's runs in order, through shared memory, into its group's sums
// (registers), and stores each column's sum into the inbox of the
// cluster block that ends that column (distributed shared memory: the
// cluster barrier arrived at on entry is waited on first, so every block
// of the cluster has started); after a second cluster barrier each block
// adds the RUN_GROUPS sums of an eighth of
// the tile's columns in group order from its own inbox, scales (scales
// loaded at the start) and stores.  One launch; no global scratch, no
// atomics.
template <bool BF16, int MT, int COLS>
__global__ void __cluster_dims__(1, RUN_GROUPS, 1)
__launch_bounds__(SKINNY_THREADS)
wdot_skinny_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int M, int K, int N, int q_mode, int x_vectors) {
  constexpr int TILE = 32 * COLS;
  constexpr int RW = skinny_rows_a_warp(MT);   // rows a warp takes
  constexpr int RQ = MT / RW;                  // warps a run
  constexpr int PER = TILE / RUN_GROUPS;       // columns a block ends
  constexpr int HELD = COLS * RW;   // group sums a thread holds: MT * TILE
                                    // over the block's >= 32 * RQ threads
  using Codes = typename std::conditional<COLS == 4, unsigned,
                                          unsigned short>::type;
  static_assert(COLS == 2 || COLS == 4, "a lane's codes are one load");
  extern __shared__ __align__(16) unsigned char sk_smem[];
  const int warps = blockDim.x / 32 / RQ;   // runs a chunk
  unsigned char* qs = sk_smem;              // [warps][KSEG][TILE] bytes
  float* part =
      reinterpret_cast<float*>(sk_smem + skinny_q_bytes(warps, TILE));
  float* xs = part + warps * MT * TILE;     // [warps * KSEG][MT]
  float* inbox = xs + warps * KSEG * MT;    // [RUN_GROUPS][MT][PER]
  cg::cluster_group cluster = cg::this_cluster();
  const int group = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / RQ, band = warp % RQ;   // run of the chunk, rows
  const int c = COLS * lane;                      // the lane's columns
  const int n0 = blockIdx.x * TILE;
  const int runs = (K + KSEG - 1) / KSEG, g = runs_a_group(K);
  const int r_end = min(runs, (group + 1) * g);
  // the column this thread ends (blockDim.x % PER == 0), its scale now
  const int end_n = n0 + group * PER + threadIdx.x % PER;
  const float sc = end_n < N ? __ldg(scale + end_n) : 0.f;
  cluster_arrive_relaxed();   // waited on before the inbox stores
  float held[HELD];   // group sums of elements threadIdx.x + i * blockDim.x
#pragma unroll
  for (int i = 0; i < HELD; ++i) held[i] = 0.f;
  for (int r0 = group * g; r0 < r_end; r0 += warps) {
    // the chunk's runs, none past the group's last
    const int nr = min(warps, r_end - r0);
    const int ck0 = r0 * KSEG, ckn = min(nr * KSEG, K - ck0);
    copy_q<TILE>(q, qs, ck0, ckn, n0, N, q_mode);
    stage_x<BF16, MT>(x, xs, M, K, ck0, ckn, nr * KSEG, x_vectors);
    cp_async_wait<0>();
    __syncthreads();
    const int r = r0 + slot;
    const int kn = r < r_end ? min(KSEG, K - r * KSEG) : 0;
    float acc[RW][COLS];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;
    const Codes* qw =
        reinterpret_cast<const Codes*>(qs + slot * KSEG * TILE) + lane;
    const float* xr = xs + slot * KSEG * MT + band * RW;
#pragma unroll
    for (int kk = 0; kk < KSEG; ++kk) {
      if (kk >= kn) break;
      float w[4];
      widen4(qw[kk * 32], w);
      float xv[RW];
      if constexpr (RW == 2) {
        const float2 v = *reinterpret_cast<const float2*>(xr + kk * MT);
        xv[0] = v.x;
        xv[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < RW; ++i) xv[i] = xr[kk * MT + i];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          acc[i][j] = fmaf(xv[i], w[j], acc[i][j]);
    }
    if (kn > 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float* dst = part + (slot * MT + band * RW + i) * TILE + c;
        if constexpr (COLS == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i][0], acc[i][1]);
      }
    }
    __syncthreads();
    // the group's sums take the chunk's runs in run order
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e < MT * TILE)
        for (int w = 0; w < nr; ++w)
          held[i] = __fadd_rn(held[i], part[w * MT * TILE + e]);
    }
    if (r0 + warps < r_end) __syncthreads();   // qs, part, xs reused
  }
  // each group sum into the inbox of the block that ends its column
  cluster_wait();
#pragma unroll
  for (int i = 0; i < HELD; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < MT * TILE) {
      const int m = e / TILE, cc = e % TILE;
      cluster.map_shared_rank(inbox, cc / PER)[(group * MT + m) * PER +
                                               cc % PER] = held[i];
    }
  }
  cluster.sync();   // every inbox holds its columns' RUN_GROUPS sums
  for (int e = threadIdx.x; e < MT * PER; e += blockDim.x) {
    const int m = e / PER;
    if (m >= M || end_n >= N) continue;
    float total = 0.f;
#pragma unroll
    for (int h = 0; h < RUN_GROUPS; ++h)
      total = __fadd_rn(total, inbox[(h * MT + m) * PER + e % PER]);
    y[static_cast<long long>(m) * N + end_n] = __fmul_rn(total, sc);
  }
}

// Tiled: block (column tile, row tile) of BM x BN outputs, 4 x 4 a thread.
template <bool BF16>
__global__ void __launch_bounds__(TILED_THREADS, 1)
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

// bf16 x at M > SKINNY_M (a bf16 model's prefill): bound by bf16
// operations (2MKN), so it runs on the tensor cores as warpgroup MMAs,
// the only instruction that reaches Hopper's full rate.  A block takes a
// TC_BM x TC_BN output tile, two warpgroups of 64 rows each running
// wgmma m64n128k16 (bf16 in, f32 accumulators) with both operands read
// from 128-byte-swizzled shared memory through descriptors
// (flash_mma.cuh).  One thread copies each TC_BK-deep tile of x (K-major,
// swizzled by the copy) and of q's int8 rows (as stored, [k][n]) with two
// TMA tensor copies into a TC_STAGES ring, completing on an mbarrier: a
// tile's copies are two instructions, where per-thread 16-byte copies
// cost the block more issue time than the products.  While tile kt's
// products run, the block widens tile kt + 1's int8 codes into a bf16 B
// tile kept in [k][n] order, the N-major form that wgmma takes for 16-bit
// types with its transpose-B bit, 16 bytes a store (exact: |q| <= 127);
// the B tile is double buffered, with two block barriers a tile, and two
// blocks fit an SM.  On the card a tile's products and the widening of
// its codes take about as long as each other, and the shared memory's
// bandwidth, which the products' operand reads mostly use, holds a tile
// above the products' own time.  The epilogue scales the
// f32 accumulators by scale[n] and stores f32.  The sum runs in the
// tensor cores' order, not the fixed one: only bf16 rows take this shape,
// and only where every 16-byte chunk is aligned (wdot_shape).
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 3;
constexpr int TC_THREADS = 256;                     // two warpgroups
constexpr int TC_X_TILE = TC_BM * TC_BK;            // bf16 elements
constexpr int TC_B_TILE = TC_BK * TC_BN;            // bf16 elements
constexpr int TC_B_SLAB = TC_BK * 64;               // a 64-column slab
constexpr int TC_Q_TILE = TC_BK * TC_BN;            // int8 bytes
constexpr int TC_SMEM = 1024 + TC_STAGES * (2 * TC_X_TILE + TC_Q_TILE) +
                        2 * 2 * TC_B_TILE + TC_STAGES * 8;

// The descriptor of an N-major B tile at p: sw128_desc's, with the leading
// byte offset (bits 16-29, 16-byte units) the step from one 64-column
// slab to the next.
__device__ __forceinline__ uint64_t sw128_desc_n(const bf16* p) {
  constexpr uint64_t lbo = 2 * TC_B_SLAB / 16;
  return (sw128_desc(p) & ~(0x3FFFull << 16)) | (lbo << 16);
}

static_assert(TC_BN % 64 == 0 && TC_BK % 16 == 0, "whole slabs and k steps");
static_assert(TC_STAGES >= 2, "a tile in use while the next lands");

// d[64 x 128] += a[64 x 16] b[16 x 128], a K-major and b N-major (b[k][n]
// at row k of slab n / 64), both through descriptors.
__device__ __forceinline__ void wgmma_m64n128k16_tb(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// 16 int8 codes as 16 bf16 (exact), the lowest first: lo holds codes
// 0-7, hi codes 8-15.
__device__ __forceinline__ void widen16(const uint4 v, uint4& lo, uint4& hi) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned p[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4(w[i], f);
    // the high halves of two floats are their bf16 (exact here)
    p[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                           0x7632);
    p[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]),
                               0x7632);
  }
  lo = make_uint4(p[0], p[1], p[2], p[3]);
  hi = make_uint4(p[4], p[5], p[6], p[7]);
}

// mbarriers in shared memory: where the TMA copies land
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   flash_mma::smem_u32(bar)),
               "r"(count)
               : "memory");
}
// arrive, and expect `bytes` more from copies that complete on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(flash_mma::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// TMA: the box of a 2-D tensor map at (c0 inner, c1 outer) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          flash_mma::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(flash_mma::smem_u32(bar))
      : "memory");
}
// Wait for the phase of the given parity to complete.  Bounded: a
// pipeline fault traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(flash_mma::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}

__global__ void __launch_bounds__(TC_THREADS, 2)
wdot_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap q_map,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int M, int K, int N) {
  extern __shared__ unsigned char tc_smem[];
  bf16* xs = align1024(tc_smem);             // [stage][TC_BM][TC_BK], sw128
  bf16* bs = xs + TC_STAGES * TC_X_TILE;     // [2][slab][TC_BK][64], sw128
  int8_t* qs = reinterpret_cast<int8_t*>(bs + 2 * TC_B_TILE);   // [stage]
  uint64_t* loaded = reinterpret_cast<uint64_t*>(qs + TC_STAGES * TC_Q_TILE);
  const int tid = threadIdx.x, wg = tid / 128;
  // row tiles run fastest, so the blocks in flight share q's column
  // tiles and x (a few MB) stays in L2
  const int m0 = blockIdx.x * TC_BM, n0 = blockIdx.y * TC_BN;
  const int tiles = (K + TC_BK - 1) / TC_BK;
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) mbar_init(&loaded[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile j's x and q into stage j % TC_STAGES (thread 0); the maps
  // zero-fill past M, N and K
  auto load = [&](int j) {
    const int s = j % TC_STAGES;
    mbar_expect(&loaded[s], 2 * TC_X_TILE + TC_Q_TILE);
    tma_load_2d(xs + s * TC_X_TILE, &x_map, j * TC_BK, m0, &loaded[s]);
    tma_load_2d(qs + s * TC_Q_TILE, &q_map, n0, j * TC_BK, &loaded[s]);
  };
  // tile j's int8 q, once landed, widened into B tile j % 2
  auto widen = [&](int j) {
    const int s = j % TC_STAGES;
    mbar_wait(&loaded[s], (j / TC_STAGES) & 1);
    const int8_t* qt = qs + s * TC_Q_TILE;
    bf16* bt = bs + (j & 1) * TC_B_TILE;
#pragma unroll
    for (int i = 0; i < TC_Q_TILE / 16 / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int r = e / (TC_BN / 16), c = e % (TC_BN / 16);
      uint4 lo, hi;
      widen16(*reinterpret_cast<const uint4*>(qt + r * TC_BN + c * 16), lo,
              hi);
      bf16* slab = bt + (c / 4) * TC_B_SLAB;   // 4 chunks of 16 a slab
      *reinterpret_cast<uint4*>(slab + sw128(r, (c % 4) * 2)) = lo;
      *reinterpret_cast<uint4*>(slab + sw128(r, (c % 4) * 2 + 1)) = hi;
    }
  };

  float acc[TC_BN / 2];
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i) acc[i] = 0.f;
  if (tid == 0)
    for (int j = 0; j < TC_STAGES - 1 && j < tiles; ++j) load(j);
  widen(0);
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < tiles; ++kt) {
    const bf16* xa = xs + (kt % TC_STAGES) * TC_X_TILE + wg * 64 * TC_BK;
    const bf16* bt = bs + (kt & 1) * TC_B_TILE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
      wgmma_m64n128k16_tb(acc, sw128_desc(xa + ks * 16),
                          sw128_desc_n(bt + ks * 16 * 64));
    wgmma_commit();
    wgmma_wait<1>();    // this warpgroup's products of tile kt - 1 are done
    fence_regs(acc);
    __syncthreads();    // and the other's: its stage and B tile are free
    if (tid == 0 && kt + TC_STAGES - 1 < tiles) load(kt + TC_STAGES - 1);
    if (kt + 1 < tiles) widen(kt + 1);
    fence_proxy_async();   // the widened tile, for wgmma (and the q codes
    __syncthreads();       // read from a stage before a copy overwrites it)
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int t = tid % 128;
  // accumulator i of the m64n128 tile: n tile i / 4 (8 columns each), row
  // lane / 4 (+8 for i % 4 >= 2), columns 2 * (lane % 4) + {0, 1}
  const int warp = t / 32, lane = t % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= N) continue;   // N is even: n + 1 < N as well
    const float s0 = __ldg(scale + n), s1 = __ldg(scale + n + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m < M)
        *reinterpret_cast<float2*>(y + static_cast<long long>(m) * N + n) =
            make_float2(__fmul_rn(acc[4 * j + 2 * h], s0),
                        __fmul_rn(acc[4 * j + 2 * h + 1], s1));
    }
  }
}

enum WdotShape { WDOT_SKINNY = 0, WDOT_TENSOR_CORES = 1, WDOT_TILED = 2 };

// Which K5 kernel takes a call: the skinny one up to SKINNY_M rows; above
// it the tensor cores for bf16 rows whose 16-byte chunks are aligned (x
// and q 16-byte aligned, K % 8 == 0, N % 16 == 0), the tiled SIMT kernel
// otherwise.
int wdot_shape(int M, int K, int N, bool bf16, const void* x, const void* q) {
  if (M <= SKINNY_M) return WDOT_SKINNY;
  if (bf16 && K % 8 == 0 && N % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(q) & 15) == 0)
    return WDOT_TENSOR_CORES;
  return WDOT_TILED;
}

constexpr int MAX_DEVICES = 64;

// Raise a kernel's dynamic shared memory limit to `bytes`, once a device
// (`done`: the launcher's flags, one a device).
cudaError_t allow_smem(const void* kernel, int bytes,
                       bool (&done)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// A 2-D TMA map of a row-major [outer][inner] tensor (`pitch` bytes a
// row) with boxes of box_inner x box_outer elements, zero past its edges.
// cuTensorMapEncodeTiled is a host function of the driver, found through
// the runtime (nothing links libcuda).
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, long long inner, long long outer,
                          long long pitch, int box_inner, int box_outer,
                          CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool BF16, int MT, int COLS>
int launch_skinny_cols(const void* x, const int8_t* q, const float* scale,
                       float* y, int M, int K, int N, cudaStream_t stream) {
  constexpr int TILE = 32 * COLS;
  static bool smem_set[MAX_DEVICES];
  const auto kernel = wdot_skinny_kernel<BF16, MT, COLS>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel),
                 skinny_smem(SKINNY_WARPS, MT, TILE), smem_set);
  if (err != cudaSuccess) return err;
  const int warps_a_run = MT / skinny_rows_a_warp(MT);
  const int runs = skinny_runs(K, MT);
  const dim3 grid((N + TILE - 1) / TILE, RUN_GROUPS);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const int q_mode = (N % 16 == 0 && (qa & 15) == 0) ? 2
                     : (N % 4 == 0 && (qa & 3) == 0) ? 1 : 0;
  const int x_vectors = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                        K % (BF16 ? 8 : 4) == 0;
  kernel<<<grid, 32 * warps_a_run * runs, skinny_smem(runs, MT, TILE),
           stream>>>(x, q, scale, y, M, K, N, q_mode, x_vectors);
  return cudaGetLastError();
}

// 64-column tiles (2 columns a lane) where 128-column ones give fewer
// than two blocks an SM and a block has at most 8 warps: twice the
// blocks, each with half the products, where the card would sit idle;
// 128-column tiles otherwise (on the card, halving a block of more warps
// or a grid that fills it costs more in shared loads and widening than
// it gains)
template <bool BF16, int MT>
int launch_skinny(const void* x, const int8_t* q, const float* scale, float* y,
                  int M, int K, int N, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int warps = skinny_runs(K, MT) * (MT / skinny_rows_a_warp(MT));
  if ((N + 127) / 128 * RUN_GROUPS >= 2 * sms || warps > 8)
    return launch_skinny_cols<BF16, MT, 4>(x, q, scale, y, M, K, N, stream);
  return launch_skinny_cols<BF16, MT, 2>(x, q, scale, y, M, K, N, stream);
}

template <bool BF16>
int launch_wdot(const void* x, const int8_t* q, const float* scale, float* y,
                int M, int K, int N, cudaStream_t stream) {
  const int shape = wdot_shape(M, K, N, BF16, x, q);
  if (shape == WDOT_SKINNY) {
    if (M <= 1) return launch_skinny<BF16, 1>(x, q, scale, y, M, K, N, stream);
    if (M <= 2) return launch_skinny<BF16, 2>(x, q, scale, y, M, K, N, stream);
    if (M <= 4) return launch_skinny<BF16, 4>(x, q, scale, y, M, K, N, stream);
    if (M <= 8) return launch_skinny<BF16, 8>(x, q, scale, y, M, K, N, stream);
    return launch_skinny<BF16, SKINNY_M>(x, q, scale, y, M, K, N, stream);
  }
  if (shape == WDOT_TENSOR_CORES) {
    static bool smem_set[MAX_DEVICES];
    cudaError_t err = allow_smem(
        reinterpret_cast<const void*>(wdot_wgmma_kernel), TC_SMEM, smem_set);
    if (err != cudaSuccess) return err;
    CUtensorMap x_map, q_map;
    err = tensor_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                        2LL * K, TC_BK, TC_BM,
                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = tensor_map_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N,
                        TC_BN, TC_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN);
    wdot_wgmma_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
        x_map, q_map, scale, y, M, K, N);
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

// four int8 codes (one word, the lowest byte first) as two bf16 pairs:
// lo the first two, hi the last two (exact)
__device__ __forceinline__ void codes4_bf16(unsigned w, uint32_t& lo,
                                            uint32_t& hi) {
  float f[4];
  widen4(w, f);
  lo = flash_mma::pack(f[0], f[1]);
  hi = flash_mma::pack(f[2], f[3]);
}

// d += a b, one m16n8k16 tensor-core product (bf16 in, f32 sums); the
// fragments in the mma.sync layouts (flash_mma.cuh)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct AttnArgs {
  const void* q;
  const int8_t* k8;
  const int8_t* v8;
  const float* ks;
  const float* vs;
  const long long* lengths;
  long long base;
  void* out;
  int T, H, KV, D, max_len, tile, rounds, hold;   // the plan's
  float sqrt_d, inv_sqrt_d;   // inv_sqrt_d: 1 / sqrt_d where that is exact
                              // (a power of two), else 0
};

// score / sqrt(D): the IEEE divide, or the product with the exact
// reciprocal where sqrt(D) is a power of two (the same bits; the divide
// costs a decode round's scores ~4 %)
__device__ __forceinline__ float over_sqrt_d(const AttnArgs& a, float x) {
  return a.inv_sqrt_d != 0.f ? __fmul_rn(x, a.inv_sqrt_d)
                             : __fdiv_rn(x, a.sqrt_d);
}

// acc[rr] = the f32 product of the int8 key row `krow` with query row rr
// of q ([QS][D], f32), an fmaf chain over d in order; W-byte reads of the
// codes (16 when D % 16 == 0 and the rows are so aligned, else 4).
template <int W>
__device__ __forceinline__ void dot_rows(const unsigned char* krow,
                                         const float* q, int D,
                                         float (&acc)[attn::QS]) {
  for (int d0 = 0; d0 < D; d0 += W) {
    float kf[W / 4][4];
    if constexpr (W == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + d0);
      widen4(u.x, kf[0]);
      widen4(u.y, kf[1]);
      widen4(u.z, kf[2]);
      widen4(u.w, kf[3]);
    } else {
      widen4(*reinterpret_cast<const unsigned*>(krow + d0), kf[0]);
    }
#pragma unroll
    for (int rr = 0; rr < attn::QS; ++rr) {
#pragma unroll
      for (int e = 0; e < W / 4; ++e) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q + rr * D + d0 + 4 * e);
        acc[rr] = fmaf(qv.x, kf[e][0], acc[rr]);
        acc[rr] = fmaf(qv.y, kf[e][1], acc[rr]);
        acc[rr] = fmaf(qv.z, kf[e][2], acc[rr]);
        acc[rr] = fmaf(qv.w, kf[e][3], acc[rr]);
      }
    }
  }
}

// One thread-block cluster a (query tile, KV head, row), grid
// (cluster * tiles, KV, B), attn::THREADS threads a block
// (decode_attn_plan.h: the plan, the layout and every index).  q, out:
// [B, T, H, D] (dtype); k8, v8: [B, max_len, KV, D] int8; ks, vs: [B,
// max_len, KV] f32.  Query j of row b sees positions 0..limit, limit =
// (lengths ? lengths[b] : base) + j, clipped to the cache.  The block of
// rank k holds chunks k, k + cluster, ... of the tile's positions, one a
// round.  On entry it puts its first chunk's K rows and scales in flight
// (cp.async, 16 bytes a copy where the rows allow; the V rows follow once
// the K rows land, so the scores wait on K alone), then
//  1. scores: each position against every query row of the tile (the G
//     query heads of the KV head and the tile's queries: each K byte is
//     read once for all of them), x k_scale, / sqrt(D).  bf16 queries
//     with 16-byte rows (MMA) run m16n8k16 tensor-core products, K's
//     codes widened to bf16 (exact) in the A fragments; f32 queries an
//     fmaf chain a position a thread, QS query rows a step.  A warp a
//     query row takes the block's max, which goes into every block's
//     inbox; the cluster's max is exact in any order;
//  2. a round at a time, exp(s - max) and each chunk's sum in a fixed
//     order within the chunk, stored into every block's inbox; each row's
//     sum so far takes the round's chunks in chunk order;
//  3. a round at a time, the probabilities normalised, rounded to the
//     dtype and multiplied by the dtype-rounded V scale (bf16 weights for
//     the tensor cores), then the V pass: tensor-core products of the
//     weights and V's codes (MMA), or thread (group, quad) adding
//     positions group, group + groups, ... of the chunk for 4
//     neighbouring d and the groups' partials in group order; each element
//     of the chunk's partial stored into the inbox of the block that ends
//     it, which adds the round's chunks in chunk order onto its sum so far
//     and, after the last round, stores it.
// A tile of more rounds than the plan holds scores again in passes 2 and
// 3 (the same bits), so shared memory does not grow with max_len.  Every
// exchange is a store into another block's shared memory (no remote load
// waits), then a cluster barrier; the first store waits on a barrier
// arrived at on entry (a block's shared memory may be written only once
// the block has started).  No global scratch, no atomics; positions past
// a row's last query's limit are never read.  At a decode round the
// kernel is latency-bound: a launch, a DRAM round trip for the K rows,
// then short dependent chains split by the three exchanges.  HELD: every
// tile of the call holds its rounds (the plan's hold is its rounds).
// Without the streamed passes' code the kernel fits 80 registers, three
// blocks an SM (at 86-96 registers, two blocks an SM, a decode round took
// 0.020-0.021 ms against 0.015).  The streamed passes need 121-145
// registers (they spill at 80).
template <bool BF16, bool VEC, bool HELD>
__global__ void __launch_bounds__(attn::THREADS, HELD ? 3 : 1)
decode_attn_kernel(const AttnArgs a) {
  using attn::P;
  using attn::QS;
  using attn::THREADS;
  using attn::WARPS;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();   // waited on before the first remote store
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, D = a.D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = static_cast<int>(blockIdx.x) / C * a.tile;
  const int nq = G * min(a.tile, a.T - j0);   // the tile's query rows
  const int rows = attn::layout_rows(G, a.tile);   // the layout's
  const attn::Layout L = attn::layout(rows, D, a.hold, C, a.rounds);
  unsigned char* kbuf = attn_smem;
  float* vred = reinterpret_cast<float*>(attn_smem);
  unsigned char* vbuf = attn_smem + L.vbuf;
  float* qs = reinterpret_cast<float*>(attn_smem + L.qs);
  float* sc = reinterpret_cast<float*>(attn_smem + L.sc);
  float* ksm = reinterpret_cast<float*>(attn_smem + L.ks);
  float* vsm = reinterpret_cast<float*>(attn_smem + L.vs);
  int* nvr = reinterpret_cast<int*>(attn_smem + L.nv);
  float* mxr = reinterpret_cast<float*>(attn_smem + L.mx);
  float* tot = reinterpret_cast<float*>(attn_smem + L.tot);
  // bf16 queries with 16-byte rows take the tensor cores: the queries as
  // bf16 [rows][D + 16] (over qs; 8-byte reads of 8 rows fall on distinct
  // banks), the weights as bf16 [hold][wb_rows][WBS]
  constexpr bool MMA = BF16 && VEC;
  const int qbs = D + 16, wrows = attn::wb_rows(rows);
  unsigned short* qb = reinterpret_cast<unsigned short*>(qs);
  bf16* wb = reinterpret_cast<bf16*>(attn_smem + L.wb);
  const int g8 = lane / 4, t4 = lane % 4;   // the mma.sync fragment's
  float* mxin = reinterpret_cast<float*>(attn_smem + L.mxin);
  float* psin = reinterpret_cast<float*>(attn_smem + L.psin);
  float* oin = reinterpret_cast<float*>(attn_smem + L.oin);
  float* oacc = reinterpret_cast<float*>(attn_smem + L.oacc);
  // the tile's queries, four loads in flight a thread, the first four
  // before anything waits on the lengths: f32 [rows][D], or bf16 [rows]
  // [qbs] for the tensor cores (bf16 -> f32 -> bf16 keeps the bits)
  float qv[4];
  auto load_q = [&](int e0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * THREADS, r = e / D;
      qv[k] = e < nq * D ? load_f<BF16>(a.q, ((static_cast<long long>(b) *
                                                   a.T + j0 + r / G) * a.H +
                                               h * G + r % G) * D + e % D)
                         : 0.f;
    }
  };
  auto stage_q = [&](int e0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * THREADS;
      if (e >= nq * D) break;
      if constexpr (MMA)
        qb[e / D * qbs + e % D] =
            static_cast<unsigned short>(__float_as_uint(qv[k]) >> 16);
      else
        qs[e] = qv[k];
    }
  };
  load_q(tid);
  const long long first = (a.lengths ? a.lengths[b] : a.base) + j0;
  const int nv_max = attn::visible(first + (nq - 1) / G, a.max_len);
  const int nch = attn::chunks(nv_max);
  const int mine = attn::slots_of(rank, nch, C);
  // the tile's rounds (every block of the cluster takes part in each);
  // held: every round's scores stay in their slot
  const int rounds = max(1, attn::slots_of(0, nch, C));
  const bool held = HELD || rounds <= a.hold;
  const long long row0 = static_cast<long long>(b) * a.max_len;
  const int kst = attn::kstride(D), vst = attn::vstride(D);
  const int per = attn::share(nq * D, C);   // outputs a block ends

  // head h's codes at chunk c's positions [c * P, c * P + n) into buf
  // (thread t copies piece t % pieces of rows t / pieces + k * step)
  constexpr int W = VEC ? 16 : 4;
  const int pieces = D / W, step = THREADS / pieces;
  const int row_of = tid / pieces, piece = (tid % pieces) * W;
  auto copy_rows = [&](const int8_t* src, unsigned char* buf, int st, int c) {
    if (row_of >= step) return;
    const int n = min(P, nv_max - c * P);
    const int8_t* from =
        src + ((row0 + c * P + row_of) * a.KV + h) * D + piece;
    for (int p = row_of; p < n;
         p += step, from += static_cast<long long>(step) * a.KV * D) {
      if constexpr (VEC)
        cp_async_16(buf + p * st + piece, from, true);
      else
        cp_async_4(buf + p * st + piece, from, true);
    }
  };
  // and their scales into sbuf
  auto copy_scales = [&](const float* scale, float* sbuf, int c) {
    if (tid < min(P, nv_max - c * P))
      cp_async_4(sbuf + tid, scale + (row0 + c * P + tid) * a.KV + h, true);
  };
  // chunk c's K rows and scales, and its V scales into vdst
  auto load_k = [&](int c, float* vdst) {
    copy_rows(a.k8, kbuf, kst, c);
    copy_scales(a.ks, ksm, c);
    copy_scales(a.vs, vdst, c);
    cp_async_commit();
  };

  // the first chunk's K rows and both scales in flight before anything
  // waits (its V rows once the K rows have landed: the scores wait on K
  // alone, the V pass comes two exchanges later)
  if (mine > 0) load_k(rank, vsm);
  // each query row's visible positions; the rest of the tile's queries
  for (int r = tid; r < nq; r += THREADS)
    nvr[r] = attn::visible(first + r / G, a.max_len);
  stage_q(tid);
  for (int e0 = tid + 4 * THREADS; e0 < nq * D; e0 += 4 * THREADS) {
    load_q(e0);
    stage_q(e0);
  }

  // the scores of chunk c, from its K rows in kbuf, into s [rows][P]
  const int p = tid;
  auto score = [&](int c, float* s) {
    if constexpr (MMA) {
      // a warp MT m tiles of 16 positions by an n tile of 8 query rows,
      // the K rows as the A fragments, the bf16 queries as B; the m tiles'
      // products interleaved.  A k step's 16 d fall to the fragments'
      // k slots permuted, the same way in A and B (a dot product in
      // another fixed order): lane t4's k 2 t4, 2 t4 + 1 take d k0 + 4 t4,
      // + 1 and its k 2 t4 + 8, + 9 take d k0 + 4 t4 + 2, + 3, so one word
      // of each K row and one 8-byte read of each query row feed a step
      constexpr int MT = P / (16 * WARPS);
      for (int n0 = 0; n0 < nq; n0 += 8) {
        float acc[MT][4] = {};
        const unsigned short* q_row = qb + (n0 + g8) * qbs + 4 * t4;
#pragma unroll 4
        for (int k0 = 0; k0 < D; k0 += 16) {
          const uint2 bq = *reinterpret_cast<const uint2*>(q_row + k0);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const unsigned char* k_lo =
                kbuf + ((warp + mt * WARPS) * 16 + g8) * kst + 4 * t4 + k0;
            uint32_t af[4];
            codes4_bf16(*reinterpret_cast<const unsigned*>(k_lo), af[0],
                        af[2]);
            codes4_bf16(*reinterpret_cast<const unsigned*>(k_lo + 8 * kst),
                        af[1], af[3]);
            mma_16816(acc[mt], af, bq.x, bq.y);
          }
        }
        // acc[mt]: positions m0 + g8 (+ 8), query rows n0 + 2 t4 (+ 1)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pp = (warp + mt * WARPS) * 16 + g8 + (e / 2) * 8;
            const int r = n0 + 2 * t4 + e % 2;
            if (r < nq)
              s[r * P + pp] =
                  c * P + pp < nvr[r]
                      ? over_sqrt_d(a, __fmul_rn(acc[mt][e], ksm[pp]))
                      : -INFINITY;
          }
      }
    } else {
      const int n = min(P, nv_max - c * P), pos = c * P + p;
      const float ksc = p < n ? ksm[p] : 0.f;
      for (int r0 = 0; r0 < nq; r0 += QS) {
        float acc[QS];
#pragma unroll
        for (int rr = 0; rr < QS; ++rr) acc[rr] = 0.f;
        if (p < n) dot_rows<W>(kbuf + p * kst, qs + r0 * D, D, acc);
#pragma unroll
        for (int rr = 0; rr < QS; ++rr) {
          const int r = r0 + rr;
          if (r < nq)
            s[r * P + p] = pos < nvr[r]
                               ? over_sqrt_d(a, __fmul_rn(acc[rr], ksc))
                               : -INFINITY;
        }
      }
    }
  };
  // chunk i's scores into its slot (slot 0 when streamed), its K rows in
  // flight unless this is the first chunk (whose V rows then follow); the
  // block's threads meet before the scores (not after them)
  auto scores_of = [&](int i, bool first_chunk) {
    const int c = attn::chunk_of(rank, i, C), slot = held ? i : 0;
    if (!first_chunk) {
      __syncthreads();   // the last chunk's codes are read
      load_k(c, vsm + slot * P);
    }
    cp_async_wait<0>();
    if (first_chunk) {
      copy_rows(a.v8, vbuf, vst, c);
      cp_async_commit();
    }
    __syncthreads();
    float* s = sc + slot * rows * P;
    score(c, s);
    return s;
  };
  // exp(s - m) over row r of chunk c's scores s, in place; the chunk's
  // sum in a fixed order (on every lane)
  auto exp_row = [&](float* s, int c, int r, float m) {
    const int nv = nvr[r];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < P / 32; ++k) {
      const int pp = lane + 32 * k;
      const float e = c * P + pp < nv ? expf(__fsub_rn(s[r * P + pp], m)) : 0.f;
      s[r * P + pp] = e;
      part = __fadd_rn(part, e);
    }
    return warp_sum(part);
  };
  // the cluster's max of row r (every lane)
  auto row_max = [&](int r) {
    return warp_max(lane < C ? mxin[lane * rows + r] : -INFINITY);
  };

  // row r's max over the scores of slots [0, n)
  auto slots_max = [&](int r, int n) {
    float m = -INFINITY;
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int k = 0; k < P / 32; ++k)
        m = fmaxf(m, sc[(i * rows + r) * P + lane + 32 * k]);
    return warp_max(m);
  };

  // 1. the scores of the block's chunks (streamed: each slot's max
  // folded in before the next chunk's scores take the slot)
  for (int i = 0; i < mine; ++i) {
    scores_of(i, i == 0);
    if (held) continue;
    __syncthreads();
    for (int r = warp; r < nq; r += WARPS) {
      const float m = slots_max(r, 1);
      if (lane == 0) mxr[r] = i == 0 ? m : fmaxf(mxr[r], m);
    }
  }
  __syncthreads();
  // the block's max into every block's inbox
  cluster_wait();   // every block of the cluster has started
  for (int r = warp; r < nq; r += WARPS) {
    const float m = held ? slots_max(r, mine) : mine > 0 ? mxr[r] : -INFINITY;
    if (lane < C) cluster.map_shared_rank(mxin, lane)[rank * rows + r] = m;
  }
  cluster.sync();

  // 2. a round at a time: exp(s - max) and the chunk's sum into every
  // block's inbox, then each row's sum over the round's chunks in chunk
  // order
  for (int i = 0; i < rounds; ++i) {
    float* in = psin + i % 2 * C * rows;
    if (i < mine) {
      const int c = attn::chunk_of(rank, i, C);
      float* s = sc + i * rows * P;
      if (!held) {   // the scores again: the same bits
        s = scores_of(i, false);
        __syncthreads();
      }
      for (int r = warp; r < nq; r += WARPS) {
        const float part = exp_row(s, c, r, row_max(r));
        if (lane < C) cluster.map_shared_rank(in, lane)[rank * rows + r] = part;
      }
    }
    cluster.sync();
    // row r's sum so far, kept by its warp (the same rows a warp in the
    // weights below)
    for (int r = warp; r < nq; r += WARPS) {
      const int kn = min(C, attn::chunks(nvr[r]) - i * C);
      float total = i > 0 ? tot[r] : 0.f;
#pragma unroll 8
      for (int k = 0; k < kn; ++k) total = __fadd_rn(total, in[k * rows + r]);
      __syncwarp();
      if (lane == 0) tot[r] = total;
      __syncwarp();
    }
  }

  // 3. a round at a time: the weights and the V pass of the block's chunk,
  // each element of its partial into the inbox of the block that ends it,
  // which adds the round's chunks in chunk order onto its sum so far
  const int quads = D / 4, groups = THREADS / quads;
  const int grp = tid / quads, d0 = (tid % quads) * 4;
  const int e_end = min(nq * D, (rank + 1) * per);
  for (int i = 0; i < rounds; ++i) {
    float* in = oin + i % attn::obufs(a.rounds) * C * per;
    if (i < mine) {
      const int c = attn::chunk_of(rank, i, C), slot = held ? i : 0;
      const int n = min(P, nv_max - c * P);
      if (i > 0) {   // the last round's V rows are read
        copy_rows(a.v8, vbuf, vst, c);
        cp_async_commit();
      }
      float* s = sc + slot * rows * P;
      if (!held) {   // the scores and their exps again: the same bits
        s = scores_of(i, false);
        __syncthreads();
        for (int r = warp; r < nq; r += WARPS) exp_row(s, c, r, row_max(r));
      }
      // the probabilities rounded to the dtype, times v_scale rounded to
      // the dtype (a product in the dtype)
      for (int r = warp; r < nq; r += WARPS) {
        const int nv = nvr[r];
        const float total = tot[r];
#pragma unroll
        for (int k = 0; k < P / 32; ++k) {
          const int pp = lane + 32 * k;
          if (!MMA && c * P + pp >= nv) break;
          float w = 0.f;
          if (c * P + pp < nv) {
            const float pr = __fdiv_rn(s[r * P + pp], total);
            const float vscale = vsm[slot * P + pp];
            w = BF16 ? round_bf16(__fmul_rn(round_bf16(pr), round_bf16(vscale)))
                     : __fmul_rn(pr, vscale);
          }
          if constexpr (MMA)   // bf16 already: exact
            wb[(slot * wrows + r) * attn::WBS + pp] = __float2bfloat16_rn(w);
          else
            s[r * P + pp] = w;
        }
      }
      cp_async_wait<0>();   // the V rows
      __syncthreads();
      if constexpr (MMA) {
        // a warp an m tile of 16 query rows by an n tile of 8 d, k the
        // positions: the weights by ldmatrix (A), V's codes down a column
        // (B)
        const int mts = (nq + 15) / 16, nts = D / 8;
        const bf16* wt = wb + slot * wrows * attn::WBS;
        for (int job = warp; job < mts * nts; job += WARPS) {
          const int m0 = job / nts * 16, col = job % nts * 8 + g8;
          // even and odd k steps into two sums (two products in flight),
          // added at the end
          float acc[4] = {0.f, 0.f, 0.f, 0.f}, odd[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* w_at = wt + (m0 + lane % 8 + (lane / 8) % 2 * 8) *
                                      attn::WBS + lane / 16 * 8;
          const unsigned char* v_at = vbuf + 2 * t4 * vst + col;
          auto step = [&](float (&sum)[4], int k0) {
            uint32_t af[4], b0, b1;
            flash_mma::ldsm_x4(af, w_at + k0);
            const unsigned char* v0 = v_at + k0 * vst;
            codes4_bf16(v0[0] | v0[vst] << 8 | v0[8 * vst] << 16 |
                            static_cast<unsigned>(v0[9 * vst]) << 24,
                        b0, b1);
            mma_16816(sum, af, b0, b1);
          };
          for (int k0 = 0; k0 < n; k0 += 32) {
            step(acc, k0);
            if (k0 + 16 < n) step(odd, k0 + 16);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], odd[e]);
          // acc: query rows m0 + g8 (+ 8), d job % nts * 8 + 2 t4 (+ 1)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m0 + g8 + (e / 2) * 8;
            if (r >= nq) continue;
            const int el = r * D + job % nts * 8 + 2 * t4 + e % 2;
            const int owner = el / per;
            cluster.map_shared_rank(in, owner)[rank * per + el - owner * per] =
                acc[e];
          }
        }
      } else {
        for (int r0 = 0; r0 < nq; r0 += QS) {
          const int nr = min(QS, nq - r0);
          if (grp < groups) {
            float acc[QS][4];
#pragma unroll
            for (int rr = 0; rr < QS; ++rr)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[rr][k] = 0.f;
#pragma unroll 4
            for (int pp = grp; pp < n; pp += groups) {
              float vf[4];
              widen4(*reinterpret_cast<const unsigned*>(vbuf + pp * vst + d0),
                     vf);
#pragma unroll
              for (int rr = 0; rr < QS; ++rr) {
                const float wt = s[(r0 + rr) * P + pp];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  acc[rr][k] = fmaf(wt, vf[k], acc[rr][k]);
              }
            }
#pragma unroll
            for (int rr = 0; rr < QS; ++rr)
              if (rr < nr)
                *reinterpret_cast<float4*>(vred + (grp * QS + rr) * D + d0) =
                    make_float4(acc[rr][0], acc[rr][1], acc[rr][2],
                                acc[rr][3]);
          }
          __syncthreads();
          for (int e = tid; e < nr * D; e += THREADS) {
            const int rr = e / D, d = e % D;
            float o = 0.f;
#pragma unroll 8
            for (int g2 = 0; g2 < groups; ++g2)
              o = __fadd_rn(o, vred[(g2 * QS + rr) * D + d]);
            const int el = (r0 + rr) * D + d, owner = el / per;
            cluster.map_shared_rank(in, owner)[rank * per + el - owner * per] =
                o;
          }
          __syncthreads();
        }
      }
    }
    cluster.sync();
    // this block's share of the outputs: the round's chunks in order
    for (int e = rank * per + tid; e < e_end; e += THREADS) {
      const int r = e / D, d = e % D, at = e - rank * per;
      const int kn = min(C, attn::chunks(nvr[r]) - i * C);
      float o = i > 0 ? oacc[at] : 0.f;
#pragma unroll 8
      for (int k = 0; k < kn; ++k) o = __fadd_rn(o, in[k * per + at]);
      if (i + 1 < rounds) {
        oacc[at] = o;
        continue;
      }
      const int jj = r / G, g = r % G;
      store_f<BF16>(a.out,
                    ((static_cast<long long>(b) * a.T + j0 + jj) * a.H +
                     h * G + g) * D + d,
                    o);
    }
  }
}

// ----------------------------------------------------------------- K7
constexpr int KVQ_THREADS = 256;
constexpr int KVQ_ELEMS = 8;    // elements a lane

struct KvqArgs {
  const void* xk;
  const void* xv;
  int8_t* qk;
  int8_t* qv;
  float* sk;
  float* sv;
  const long long* lengths;
  long long base;
  int per_b, KV, D, max_len, shift;   // per_b: T * KV; 2^shift lanes a row
  int flat;   // x's rows are the cache's (no lengths, base 0, T = max_len:
              // the rows entry, whose cells need no position; 7 % faster at
              // a prefill stack, 0.0302-0.0313 ms against 0.0326-0.0345)
};

// Grid (lanes of a batch row's rows / KVQ_THREADS, B, 2: K then V): no
// index division, and 32-bit lane indices (a batch row of 2^32 lanes would
// be a K and a V past the card's memory).
// 2^shift lanes a (b, t, head) row of D elements of x [B, T, KV, D],
// KVQ_ELEMS elements a lane: one
// 16-byte load (bf16) or two (f32) and one 8-byte store of the codes
// where D % 8 == 0 and the tensors are so aligned (VEC), element by
// element otherwise.  The absmax by shuffles within the row's lanes, an
// IEEE divide (not a reciprocal), rounding half to even (the conversion's
// .rni, as rintf), the clip; lane 0 writes the scale.  q [B, max_len, KV,
// D] int8 and scale [B, max_len, KV] f32 at position (lengths ?
// lengths[b] : base) + t, dropped past max_len.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(KVQ_THREADS)
kv_quantize_kernel(const KvqArgs a) {
  const int b = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  const unsigned t = blockIdx.x * KVQ_THREADS + threadIdx.x;
  const unsigned j = t >> a.shift;   // the row within batch row b
  const int d0 = static_cast<int>(t & ((1u << a.shift) - 1)) * KVQ_ELEMS;
  const bool live = j < static_cast<unsigned>(a.per_b) && d0 < a.D;
  const long long at = (static_cast<long long>(b) * a.per_b + j) * a.D + d0;
  const void* x = is_v ? a.xv : a.xk;
  float v[KVQ_ELEMS];
#pragma unroll
  for (int i = 0; i < KVQ_ELEMS; ++i) v[i] = 0.f;
  if (live) {
    if constexpr (VEC && BF16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const unsigned short*>(x) + at));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else if constexpr (VEC) {
      const float4* src =
          reinterpret_cast<const float4*>(static_cast<const float*>(x) + at);
      const float4 lo = __ldg(src), hi = __ldg(src + 1);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < KVQ_ELEMS; ++i)
        if (d0 + i < a.D) v[i] = load_f<BF16>(x, at + i);
    }
  }
  // the cache row written (its position * KV + head within row b), -1
  // for none: past max_len the row is read, not written
  long long cell = -1;
  if (live && a.flat) {
    cell = static_cast<long long>(b) * a.per_b + j;
  } else if (live) {
    const long long slot = (a.lengths ? a.lengths[b] : a.base) * a.KV + j;
    if (slot >= 0 && slot < static_cast<long long>(a.max_len) * a.KV)
      cell = (static_cast<long long>(b) * a.max_len) * a.KV + slot;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < KVQ_ELEMS; ++i) amax = fmaxf(amax, fabsf(v[i]));
  // every lane of the warp takes part: a row's lanes are aligned
  for (int o = (1 << a.shift) >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(~0u, amax, o));
  if (cell < 0) return;
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  int8_t* dst = (is_v ? a.qv : a.qk) + cell * a.D + d0;
  unsigned codes[KVQ_ELEMS];
#pragma unroll
  for (int i = 0; i < KVQ_ELEMS; ++i)
    codes[i] = static_cast<unsigned>(min(max(
                   __float2int_rn(__fdiv_rn(v[i], scale)), -127), 127)) &
               0xffu;
  if constexpr (VEC) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        codes[0] | codes[1] << 8 | codes[2] << 16 | codes[3] << 24,
        codes[4] | codes[5] << 8 | codes[6] << 16 | codes[7] << 24);
  } else {
#pragma unroll
    for (int i = 0; i < KVQ_ELEMS; ++i)
      if (d0 + i < a.D) dst[i] = static_cast<int8_t>(codes[i]);
  }
  if (d0 == 0) (is_v ? a.sv : a.sk)[cell] = scale;
}

template <bool BF16, bool VEC, bool HELD>
int launch_attn(const AttnArgs& a, const attn::Plan& p, int B,
                cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES];
  const auto kernel = decode_attn_kernel<BF16, VEC, HELD>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel),
                               attn::SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster * p.tiles, a.KV, B);
  cfg.blockDim = dim3(attn::THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BF16, bool VEC>
int launch_kvq(const KvqArgs& a, int B, cudaStream_t stream) {
  const long long lanes = static_cast<long long>(a.per_b) << a.shift;
  const dim3 grid(
      static_cast<unsigned>((lanes + KVQ_THREADS - 1) / KVQ_THREADS), B, 2);
  if (static_cast<long long>(grid.x) * KVQ_THREADS > 0xffffffffLL)
    return cudaErrorInvalidValue;   // a batch row's lanes in 32 bits
  kv_quantize_kernel<BF16, VEC><<<grid, KVQ_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The limits the wrappers check against (ops/int8_serve.py).
extern "C" void psdt_int8_serve_limits(int* out) {
  out[0] = KSEG;
  out[1] = RUN_GROUPS;
  out[2] = SKINNY_M;
  out[3] = MAXD;
  out[4] = attn::THREADS;
  out[5] = attn::P;
  out[6] = attn::CLUSTER;
}

// Which K5 kernel psdt_int8_wdot launches for these operands: 0 the
// skinny one, 1 the tensor cores, 2 the tiled SIMT kernel.
extern "C" int psdt_int8_wdot_shape(int M, int K, int N, int x_bf16,
                                    const void* x, const void* q) {
  return wdot_shape(M, K, N, x_bf16 != 0, x, q);
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
  if (B < 1 || T < 1 || KV < 1 || H % KV || D < 4 || D % 4 || D > MAXD ||
      max_len < 1 || B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  // the most positions a query of the call sees (the lengths lie on the
  // card: a ragged call plans for the whole cache)
  const int vis = lengths ? max_len : attn::visible(base + T - 1, max_len);
  const attn::Plan p = attn::plan(T, H / KV, D, vis);
  if (p.smem == 0) return cudaErrorInvalidValue;
  int e2 = 0;
  const float inv = std::frexp(sqrt_d, &e2) == 0.5f ? 1.f / sqrt_d : 0.f;
  const AttnArgs a{q,      k8,     v8,       ks,     vs,     lengths,
                   base,   out,    T,        H,      KV,     D,
                   max_len, p.tile, p.rounds, p.hold, sqrt_d, inv};
  const bool vec = D % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k8) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v8) & 15) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool held = p.hold >= p.rounds;
  if (q_bf16) {
    if (vec)
      return held ? launch_attn<true, true, true>(a, p, B, s)
                  : launch_attn<true, true, false>(a, p, B, s);
    return held ? launch_attn<true, false, true>(a, p, B, s)
                : launch_attn<true, false, false>(a, p, B, s);
  }
  if (vec)
    return held ? launch_attn<false, true, true>(a, p, B, s)
                : launch_attn<false, true, false>(a, p, B, s);
  return held ? launch_attn<false, false, true>(a, p, B, s)
              : launch_attn<false, false, false>(a, p, B, s);
}

// K7.  xk, xv [B, T, KV, D] (bf16 when x_bf16, else f32) into qk, qv
// [B, max_len, KV, D] int8 and sk, sv [B, max_len, KV] f32 at positions
// (lengths ? lengths[b] : base) + t; past max_len dropped.
extern "C" int psdt_kv_quantize(const void* xk, const void* xv, int x_bf16,
                                int8_t* qk, int8_t* qv, float* sk, float* sv,
                                const long long* lengths, long long base,
                                int B, int T, int KV, int D, int max_len,
                                void* stream) {
  if (B < 1 || B > 65535 || T < 1 || KV < 1 || D < 1 || D > MAXD ||
      max_len < 1 || static_cast<long long>(T) * KV > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int shift = 0;   // 2^shift lanes a row: D / KVQ_ELEMS rounded up
  while ((KVQ_ELEMS << shift) < D) ++shift;
  const KvqArgs a{xk,   xv,     qk, qv, sk, sv,      lengths,
                  base, T * KV, KV, D,  max_len, shift,
                  !lengths && base == 0 && T == max_len};
  const bool vec = D % KVQ_ELEMS == 0 &&
                   (reinterpret_cast<uintptr_t>(xk) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(xv) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(qk) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(qv) & 7) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vec ? launch_kvq<true, true>(a, B, s)
               : launch_kvq<true, false>(a, B, s);
  return vec ? launch_kvq<false, true>(a, B, s)
             : launch_kvq<false, false>(a, B, s);
}
