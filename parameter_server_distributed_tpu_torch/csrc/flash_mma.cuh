// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), for Hopper (sm_90a).
//
// The products run as warpgroup MMAs (wgmma.mma_async m64n64k16, bf16
// inputs, f32 accumulator): four warps together multiply a 64-row tile,
// each warp owning 16 of its rows.  B, and A where it sits in shared
// memory, are read through matrix descriptors on 128-byte-swizzled tiles;
// an A operand computed in registers (P, dS) is handed over as register
// fragments.  Tiles reach shared memory through cp.async, zero-filling
// rows past the end of a segment, so the next tile's copy overlaps the
// current tile's products.
//
// Register layouts (lane = threadIdx.x % 32; each warp's 16 rows):
//  - accumulator of an m64nN product: for n tile j (columns 8j..8j+7),
//    d[4j], d[4j+1] at (row lane/4, cols 8j + 2*(lane%4) + {0,1}) and
//    d[4j+2], d[4j+3] at row + 8: the mma.sync m16n8 C layout, tile by
//    tile;
//  - register A fragment of a 64 x 16 operand: a0..a3 hold the bf16 pairs
//    at (row lane/4, cols 2*(lane%4) + {0,1}), row + 8, col + 8, and both:
//    the mma.sync m16n8k16 A layout.
// So the accumulators of n tiles 2j and 2j+1, packed to bf16, are the A
// fragment of k step j of the next product over that dimension (a0 =
// d[8j..8j+1], a1 = d[8j+2..8j+3], a2 = d[8j+4..8j+5], a3 = d[8j+6..8j+7]):
// P and dS never leave the registers.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// elements between rows of a padded (unswizzled) tile
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (swizzled tiles start there)
__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>(p + ((1024 - (smem_u32(p) & 1023)) & 1023));
}

// 16-byte global -> shared copy; when !valid the destination is
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy, zero-filling when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + ROWS) of a row-major [*, D] bf16 operand into a
// padded tile, NT threads sharing the work (t = this thread's index
// among them); rows at or past `limit` are zero-filled.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int limit, int t) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "tile does not split evenly");
#pragma unroll
  for (int i = t; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < limit;
    cp_async_16(dst + r * row_stride<D>() + c * 8,
                src + (long long)(in ? r0 + r : 0) * D + c * 8, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The register A fragment of the 16 x 16 block at (row0, col0) of a
// padded row-major tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int col0, int lane) {
  ldsm_x4(a, tile + (row0 + (lane % 8) + ((lane / 8) % 2) * 8) *
                        row_stride<D>() +
                 col0 + (lane / 16) * 8);
}

// two f32 values as one bf16 pair, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x ~ hi + lo with hi = bf16(x) and lo = bf16(x - hi): two bf16 MMAs on
// hi and lo carry x to ~2^-17 of itself, where one would carry 2^-9
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- 128-byte-swizzled tiles and wgmma
//
// A swizzled slab holds rows of 64 bf16 (128 bytes): row r's 16-byte
// chunk c sits at chunk c ^ (r % 8), and the slab starts 1024-byte
// aligned, so the swizzle phase follows the row.  A tile with wider rows
// is stored as 64-column slabs one after the other.  wgmma reads a slab
// through a matrix descriptor: start address, leading byte offset (unused
// here: every instruction reads within one slab), stride byte offset 1024
// (eight rows of 128 bytes), layout type 1 (128B swizzle).  A K-major
// operand (k along the row) steps k by moving the start 32 bytes along
// the row; an MN-major one (k down the rows) by moving it 16 rows down.

// element offset of (row r, 16-byte chunk c) in a swizzled slab
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// As load_tile, into a swizzled tile of ROWS-row slabs.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_sw128(bf16* dst, const bf16* src,
                                                int r0, int limit, int t) {
  constexpr int CPR = D / 8;
  static_assert((ROWS * CPR) % NT == 0, "tile does not split evenly");
#pragma unroll
  for (int i = t; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < limit;
    cp_async_16(dst + (c / 8) * ROWS * 64 + sw128(r, c % 8),
                src + (long long)(in ? r0 + r : 0) * D + c * 8, in);
  }
}

__device__ __forceinline__ uint64_t sw128_desc(const bf16* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 64] += a[64 x 16] b[16 x 64] for the warpgroup: a as register
// fragments, b through a descriptor, K-major (TRANS_B 0: b[k][n] at row
// n, column k of the slab) or MN-major (TRANS_B 1: at row k, column n).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

// As wgmma_m64n64k16, with a through a descriptor too: a[m][k] at row m,
// column k of a K-major slab, b K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

}  // namespace flash_mma
