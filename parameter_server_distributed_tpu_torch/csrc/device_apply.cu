// The parameter server's barrier close on Hopper (sm_90a): the fold, the
// contributor-mean scale, the sharded optimizer update and the top-k
// decode, CUDA C++ with a plain C interface (loaded with ctypes by
// ops/device_apply.py).
//
// Replaces the jit programs of the JAX package's core/device_apply.py
// (XLA programs, not Pallas kernels):
//  - fold_segments: slab_update (:400), slab_assemble (:480), fold_add
//    (:614), owned_copy, device_unpack's raw/bf16/int8 lanes (:514-537),
//    cast_f32, dequant_int8 and add_d0.  Each segment of a by-value table
//    is dst[0:n] = src (a bit copy) or dst[0:n] += src, where src is f32,
//    bf16 (its exact upcast) or int8 (q * scale, one rounding);
//  - scale_mean: mul_d0, x *= inv in place, one row a tensor or slab;
//  - sharded_update<Rule>: every b_* and a_* stage of _build_kernel
//    (:212-387) as ONE kernel a rule.  The reference split each rule into
//    2-4 programs only because XLA:CPU contracts a product feeding an add
//    into an FMA; here every operation is rounded on its own (the _rn
//    intrinsics, and the library builds with --fmad=false, IEEE divide
//    and sqrt, no flush to zero), so one kernel computes what the chain
//    computes, in the port's host numpy optimizers' order
//    (core/optimizer.py);
//  - topk_scatter: _topk_scatter (:498) and device_unpack's top-k lane.
//
// What bounds them on this card: bytes.  Each element does at most ~15
// flops against 8 (scale) to 28 (Adam) bytes moved, far below the
// card's ~295 flops per byte.  The designs are simple sweeps that keep
// every block busy whatever the row sizes (speed is later work): the fold
// and the scale lay their table's rows end to end and hand out chunks of
// ROW_CHUNK elements (a row of 32.8M elements and one of 1,024 spread
// over the card alike); the update reuses fused_update.cu's chunked table
// (ops/fused_update.py plan), with float4 accesses where every operand is
// 16-byte aligned; the top-k decode gives each block whole chunks of the
// output, zeroed and then scattered into after a block barrier, so it
// needs no separate fill.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEGMENTS = 1024;  // rows of a fold or scale table
constexpr int CHUNK = 1 << 16;      // elements an update block takes
constexpr int MAX_TENSORS = 256;    // tensors in one update table
constexpr int MAX_CHUNKS = 16384;   // blocks in one update launch
constexpr int OPERANDS = 5;         // p, g, out, s0, s1

// ------------------------------------------------------------- the fold
// A table's rows are laid end to end: row r holds elements [start[r],
// start[r+1]) of that virtual sequence.  Block b takes chunks b, b +
// gridDim.x, ... of ROW_CHUNK elements of it, so a 32.8M-element row and
// a 1,024-element one spread over the card alike; a chunk inside one row
// (the usual case) runs a plain unrolled sweep, a chunk across rows finds
// each element's row as it goes.
constexpr int ROW_CHUNK = 4096;

struct Segments {
  long long dst[MAX_SEGMENTS];   // float* of each row's first element
  long long src[MAX_SEGMENTS];   // its source's first element
  long long start[MAX_SEGMENTS + 1];  // prefix sums of the rows' lengths
  float scale[MAX_SEGMENTS];     // int8 rows: the dequantize scale
};
static_assert(sizeof(Segments) <= 32764, "fits the parameter space");

enum SrcKind { SRC_F32 = 0, SRC_BF16 = 1, SRC_INT8 = 2 };

template <int KIND>
__device__ __forceinline__ float source(const void* src, long long j,
                                        float scale) {
  if constexpr (KIND == SRC_F32) {
    return static_cast<const float*>(src)[j];
  } else if constexpr (KIND == SRC_BF16) {
    // bf16 -> f32 is exact: the 16 bits become the f32's high half
    return __uint_as_float(
        static_cast<unsigned>(static_cast<const unsigned short*>(src)[j])
        << 16);
  } else {
    // q.astype(f32) * scale: the conversion is exact, one rounding
    return __fmul_rn(static_cast<float>(static_cast<const signed char*>(
                         src)[j]),
                     scale);
  }
}

template <int KIND, bool ADD>
__device__ __forceinline__ void fold_one(float* dst, const void* src,
                                         long long k, float scale) {
  if constexpr (ADD) {
    dst[k] = __fadd_rn(dst[k], source<KIND>(src, k, scale));
  } else if constexpr (KIND == SRC_F32) {
    // the set lane of an f32 source is a bit copy (np.array(g))
    reinterpret_cast<unsigned*>(dst)[k] =
        static_cast<const unsigned*>(src)[k];
  } else {
    dst[k] = source<KIND>(src, k, scale);
  }
}

// The row holding element lo of the virtual sequence: the last r with
// start[r] <= lo (uniform over the block).
__device__ __forceinline__ int row_of(const long long* start, int rows,
                                      long long lo) {
  int a = 0, b = rows - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (start[mid] <= lo) a = mid;
    else b = mid - 1;
  }
  return a;
}

template <int KIND, bool ADD>
__global__ void __launch_bounds__(THREADS)
fold_segments_kernel(const __grid_constant__ Segments t, int rows) {
  const long long total = t.start[rows];
  const long long chunks = (total + ROW_CHUNK - 1) / ROW_CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long lo = c * ROW_CHUNK;
    const long long hi = min(lo + ROW_CHUNK, total);
    int r = row_of(t.start, rows, lo);
    if (t.start[r + 1] >= hi) {
      float* dst = reinterpret_cast<float*>(t.dst[r]);
      const void* src = reinterpret_cast<const void*>(t.src[r]);
      const long long base = t.start[r];
      const float scale = t.scale[r];
#pragma unroll 4
      for (long long j = lo + threadIdx.x; j < hi; j += THREADS)
        fold_one<KIND, ADD>(dst, src, j - base, scale);
      continue;
    }
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) {
      while (j >= t.start[r + 1]) ++r;
      fold_one<KIND, ADD>(reinterpret_cast<float*>(t.dst[r]),
                          reinterpret_cast<const void*>(t.src[r]),
                          j - t.start[r], t.scale[r]);
    }
  }
}

template <int KIND, bool ADD>
int launch_fold(const long long* dst, const long long* src,
                const long long* n, const float* scale, int rows,
                int grid, void* stream) {
  if (rows < 0 || rows > MAX_SEGMENTS || grid < 1)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  Segments t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.dst, dst, rows * sizeof(long long));
  std::memcpy(t.src, src, rows * sizeof(long long));
  std::memcpy(t.scale, scale, rows * sizeof(float));
  for (int r = 0; r < rows; ++r) t.start[r + 1] = t.start[r] + n[r];
  fold_segments_kernel<KIND, ADD>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t, rows);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the scale
struct Scales {
  long long ptr[MAX_SEGMENTS];   // float* of each row
  long long start[MAX_SEGMENTS + 1];
  float inv[MAX_SEGMENTS];       // np.float32(1.0 / count), host-rounded
};
static_assert(sizeof(Scales) <= 32764, "fits the parameter space");

__global__ void __launch_bounds__(THREADS)
scale_mean_kernel(const __grid_constant__ Scales t, int rows) {
  const long long total = t.start[rows];
  const long long chunks = (total + ROW_CHUNK - 1) / ROW_CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long lo = c * ROW_CHUNK;
    const long long hi = min(lo + ROW_CHUNK, total);
    int r = row_of(t.start, rows, lo);
    if (t.start[r + 1] >= hi) {
      float* x = reinterpret_cast<float*>(t.ptr[r]);
      const long long base = t.start[r];
      const float inv = t.inv[r];
#pragma unroll 4
      for (long long j = lo + threadIdx.x; j < hi; j += THREADS)
        x[j - base] = __fmul_rn(x[j - base], inv);
      continue;
    }
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) {
      while (j >= t.start[r + 1]) ++r;
      float* x = reinterpret_cast<float*>(t.ptr[r]);
      const long long k = j - t.start[r];
      x[k] = __fmul_rn(x[k], t.inv[r]);
    }
  }
}

// ----------------------------------------------------------- the update
enum Rule { SGD = 0, MOMENTUM = 1, ADAM = 2, ADAMW = 3, LION = 4 };

// The rule's f32 scalars, each rounded once on the host as the numpy
// optimizers round them (omb = 1 - b as an f32 subtraction; bc1, bc2 the
// step's bias corrections, Python-float powers rounded once).
struct Scalars {
  float lr, mu, b1, omb1, b2, omb2, bc1, bc2, eps, wd;
};

struct UpdateTable {
  long long ops[OPERANDS][MAX_TENSORS];  // p, g, out, s0, s1 addresses
  long long n[MAX_TENSORS];              // elements of each tensor
  long long decay[MAX_TENSORS];  // elements [0, decay) take the decay lane
  int first[MAX_TENSORS];        // block of the tensor's chunk 0
  unsigned char vec[MAX_TENSORS];   // 1: every operand 16-byte aligned
  unsigned char seed[MAX_TENSORS];  // momentum: v = g (first touch)
  unsigned char tensor[MAX_CHUNKS];  // each block's tensor
};
static_assert(sizeof(UpdateTable) == 32256,
              "ops/device_apply.py packs this size");
static_assert(sizeof(UpdateTable) + sizeof(Scalars) <= 32764,
              "the table must fit the kernel parameter space");

template <int RULE>
struct SlotCount {
  static constexpr int value =
      RULE == SGD ? 0 : (RULE == MOMENTUM || RULE == LION ? 1 : 2);
};

// One element of the update: returns the fresh param, updates the slots.
template <int RULE>
__device__ __forceinline__ float update_one(const Scalars& c, float p,
                                            float g, float* s,
                                            bool decayed, bool seed) {
  if constexpr (RULE == SGD) {
    // np.subtract(p, np.multiply(g, lr))
    return __fsub_rn(p, __fmul_rn(g, c.lr));
  } else if constexpr (RULE == MOMENTUM) {
    // v = np.array(g) on first touch (a bit copy: mu*0 + g would turn
    // -0.0 into +0.0), else v = v*mu; v = v + g; p - v*lr
    s[0] = seed ? g : __fadd_rn(__fmul_rn(s[0], c.mu), g);
    return __fsub_rn(p, __fmul_rn(s[0], c.lr));
  } else if constexpr (RULE == ADAM || RULE == ADAMW) {
    // m = m*b1 + g*(1-b1); v = v*b2 + (g*g)*(1-b2) (core/optimizer.py
    // Adam._moments: g*g first, then times 1-b2)
    s[0] = __fadd_rn(__fmul_rn(s[0], c.b1), __fmul_rn(g, c.omb1));
    s[1] = __fadd_rn(__fmul_rn(s[1], c.b2),
                     __fmul_rn(__fmul_rn(g, g), c.omb2));
    const float den =
        __fadd_rn(__fsqrt_rn(__fdiv_rn(s[1], c.bc2)), c.eps);
    if constexpr (RULE == ADAM) {
      // p - ((m/bc1)*lr) / den: lr multiplies before the divide
      return __fsub_rn(
          p, __fdiv_rn(__fmul_rn(__fdiv_rn(s[0], c.bc1), c.lr), den));
    } else {
      // AdamW: (m/bc1)/den, + p*wd on the decay lane, times lr last
      float step = __fdiv_rn(__fdiv_rn(s[0], c.bc1), den);
      if (decayed) step = __fadd_rn(step, __fmul_rn(p, c.wd));
      return __fsub_rn(p, __fmul_rn(step, c.lr));
    }
  } else {
    // Lion: sign(m*b1 + g*(1-b1)) with numpy's sign (NaN kept, +-0 ->
    // +0), from the old m; then m = m*b2 + g*(1-b2); + p*wd on the decay
    // lane; times lr
    const float t = __fadd_rn(__fmul_rn(s[0], c.b1), __fmul_rn(g, c.omb1));
    float step = isnan(t) ? t : (t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f));
    s[0] = __fadd_rn(__fmul_rn(s[0], c.b2), __fmul_rn(g, c.omb2));
    if (decayed) step = __fadd_rn(step, __fmul_rn(p, c.wd));
    return __fsub_rn(p, __fmul_rn(step, c.lr));
  }
}

template <int RULE>
__global__ void __launch_bounds__(THREADS)
sharded_update_kernel(const __grid_constant__ UpdateTable t,
                      const Scalars c) {
  constexpr int NS = SlotCount<RULE>::value;
  const int i = t.tensor[blockIdx.x];
  const long long start =
      static_cast<long long>(static_cast<int>(blockIdx.x) - t.first[i]) *
      CHUNK;
  const int n = static_cast<int>(min(static_cast<long long>(CHUNK),
                                     t.n[i] - start));
  // elements of this chunk before `decay` take the decay lane
  const long long decay = t.decay[i] - start;
  const bool seed = t.seed[i] != 0;
  const float* __restrict__ p =
      reinterpret_cast<const float*>(t.ops[0][i]) + start;
  const float* __restrict__ g =
      reinterpret_cast<const float*>(t.ops[1][i]) + start;
  float* __restrict__ out = reinterpret_cast<float*>(t.ops[2][i]) + start;
  float* slots[2] = {
      NS > 0 ? reinterpret_cast<float*>(t.ops[3][i]) + start : nullptr,
      NS > 1 ? reinterpret_cast<float*>(t.ops[4][i]) + start : nullptr};
  int tail = 0;
  if (t.vec[i]) {
    const int n4 = n / 4;
    for (int q = threadIdx.x; q < n4; q += THREADS) {
      const float4 pv = reinterpret_cast<const float4*>(p)[q];
      const float4 gv = reinterpret_cast<const float4*>(g)[q];
      float4 sv[NS > 0 ? NS : 1];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        sv[k] = reinterpret_cast<const float4*>(slots[k])[q];
      float4 ov;
      const float* pe = reinterpret_cast<const float*>(&pv);
      const float* ge = reinterpret_cast<const float*>(&gv);
      float* oe = reinterpret_cast<float*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s[2] = {0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < NS; ++k)
          s[k] = reinterpret_cast<const float*>(&sv[k])[e];
        oe[e] = update_one<RULE>(c, pe[e], ge[e], s, 4 * q + e < decay,
                                 seed);
#pragma unroll
        for (int k = 0; k < NS; ++k)
          reinterpret_cast<float*>(&sv[k])[e] = s[k];
      }
#pragma unroll
      for (int k = 0; k < NS; ++k)
        reinterpret_cast<float4*>(slots[k])[q] = sv[k];
      reinterpret_cast<float4*>(out)[q] = ov;
    }
    tail = n4 * 4;
  }
  for (int j = tail + threadIdx.x; j < n; j += THREADS) {
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = slots[k][j];
    out[j] = update_one<RULE>(c, p[j], g[j], s, j < decay, seed);
#pragma unroll
    for (int k = 0; k < NS; ++k) slots[k][j] = s[k];
  }
}

template <int RULE>
int launch_update(const long long* ops, const long long* n,
                  const long long* decay, const int* first,
                  const unsigned char* vec, const unsigned char* seed,
                  int tensors, const unsigned char* tensor, int blocks,
                  const Scalars& c, void* stream) {
  if (tensors < 0 || tensors > MAX_TENSORS || blocks < 0 ||
      blocks > MAX_CHUNKS)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  UpdateTable t;
  std::memset(&t, 0, sizeof(t));
  for (int i = 0; i < tensors; ++i) {
    for (int k = 0; k < OPERANDS; ++k) t.ops[k][i] = ops[i * OPERANDS + k];
    t.n[i] = n[i];
    t.decay[i] = decay[i];
    t.first[i] = first[i];
    t.vec[i] = vec[i];
    t.seed[i] = seed[i];
  }
  std::memcpy(t.tensor, tensor, blocks);
  sharded_update_kernel<RULE><<<blocks, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(t, c);
  return cudaGetLastError();
}

// ----------------------------------------------------------- the top-k
// out = +0.0 everywhere, the bf16 value kept at each index.  idx holds k
// strictly ascending indices below total (the wrapper checks them).  A
// block owns chunks of ROW_CHUNK output elements: it zeroes one, finds
// the indices that fall in it (two binary searches), syncs, and writes
// them, so each element is written by one block in order and no launch
// or fill precedes the scatter.
__global__ void __launch_bounds__(THREADS)
topk_scatter_kernel(float* __restrict__ out, long long total,
                    const unsigned* __restrict__ idx,
                    const unsigned short* __restrict__ vals, long long k) {
  __shared__ long long span[2];
  const long long chunks = (total + ROW_CHUNK - 1) / ROW_CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long lo = c * ROW_CHUNK;
    const long long hi = min(lo + ROW_CHUNK, total);
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) out[j] = 0.0f;
    if (threadIdx.x < 2) {
      // the first position whose index is >= lo (thread 0), >= hi (1)
      const long long bound = threadIdx.x ? hi : lo;
      long long a = 0, b = k;
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (static_cast<long long>(idx[mid]) < bound) a = mid + 1;
        else b = mid;
      }
      span[threadIdx.x] = a;
    }
    __syncthreads();
    for (long long i = span[0] + threadIdx.x; i < span[1]; i += THREADS)
      out[idx[i]] = __uint_as_float(static_cast<unsigned>(vals[i]) << 16);
    __syncthreads();
  }
}

}  // namespace

// The limits this build has: MAX_SEGMENTS, CHUNK, MAX_TENSORS, MAX_CHUNKS,
// ROW_CHUNK (ops/device_apply.py checks them against its own).
extern "C" void psdt_device_apply_limits(int* out) {
  out[0] = MAX_SEGMENTS;
  out[1] = CHUNK;
  out[2] = MAX_TENSORS;
  out[3] = MAX_CHUNKS;
  out[4] = ROW_CHUNK;
}

// One fold launch over `rows` rows: dst/src addresses, n elements each,
// scale (int8 rows); kind 0 f32, 1 bf16, 2 int8; add 0 = set, 1 = add.
// `grid` blocks take the rows' ROW_CHUNK-element chunks in turn.  Returns
// the cudaError_t.
extern "C" int psdt_fold_segments(const long long* dst, const long long* src,
                                  const long long* n, const float* scale,
                                  int rows, int kind, int add, int grid,
                                  void* stream) {
  if (kind == SRC_F32)
    return add ? launch_fold<SRC_F32, true>(dst, src, n, scale, rows,
                                            grid, stream)
               : launch_fold<SRC_F32, false>(dst, src, n, scale, rows,
                                             grid, stream);
  if (kind == SRC_BF16)
    return add ? launch_fold<SRC_BF16, true>(dst, src, n, scale, rows,
                                             grid, stream)
               : launch_fold<SRC_BF16, false>(dst, src, n, scale, rows,
                                              grid, stream);
  if (kind == SRC_INT8)
    return add ? launch_fold<SRC_INT8, true>(dst, src, n, scale, rows,
                                             grid, stream)
               : launch_fold<SRC_INT8, false>(dst, src, n, scale, rows,
                                              grid, stream);
  return cudaErrorInvalidValue;
}

// One in-place scale launch: x[0:n] *= inv for each row.
extern "C" int psdt_scale_mean(const long long* ptr, const long long* n,
                               const float* inv, int rows, int grid,
                               void* stream) {
  if (rows < 0 || rows > MAX_SEGMENTS || grid < 1)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  Scales t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.ptr, ptr, rows * sizeof(long long));
  std::memcpy(t.inv, inv, rows * sizeof(float));
  for (int r = 0; r < rows; ++r) t.start[r + 1] = t.start[r] + n[r];
  scale_mean_kernel<<<grid, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, rows);
  return cudaGetLastError();
}

// One update launch over a planned table (ops/fused_update.py plan):
// ops [tensors][5] operand addresses (p, g, out, s0, s1; 0 for a slot the
// rule lacks), n, decay, first, vec, seed per tensor, tensor [blocks];
// scalars [10] in Scalars' order.  out must alias no input; the slots
// update in place.
extern "C" int psdt_sharded_update(int rule, const long long* ops,
                                   const long long* n,
                                   const long long* decay, const int* first,
                                   const unsigned char* vec,
                                   const unsigned char* seed, int tensors,
                                   const unsigned char* tensor, int blocks,
                                   const float* scalars, void* stream) {
  Scalars c;
  std::memcpy(&c, scalars, sizeof(c));
  switch (rule) {
    case SGD:
      return launch_update<SGD>(ops, n, decay, first, vec, seed, tensors,
                                tensor, blocks, c, stream);
    case MOMENTUM:
      return launch_update<MOMENTUM>(ops, n, decay, first, vec, seed,
                                     tensors, tensor, blocks, c, stream);
    case ADAM:
      return launch_update<ADAM>(ops, n, decay, first, vec, seed, tensors,
                                 tensor, blocks, c, stream);
    case ADAMW:
      return launch_update<ADAMW>(ops, n, decay, first, vec, seed, tensors,
                                  tensor, blocks, c, stream);
    case LION:
      return launch_update<LION>(ops, n, decay, first, vec, seed, tensors,
                                 tensor, blocks, c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// One top-k decode launch into a fresh `out` of `total` f32 elements.
extern "C" int psdt_topk_scatter(float* out, long long total,
                                 const unsigned* idx,
                                 const unsigned short* vals, long long k,
                                 int grid, void* stream) {
  if (total < 0 || k < 0 || grid < 1) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  topk_scatter_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(out, total, idx,
                                                             vals, k);
  return cudaGetLastError();
}
