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
// flops against 5 (an int8 set) to 28 (Adam) bytes moved, far below the
// card's ~295 flops per byte, so each kernel is as fast as its stream of
// bytes.  The fold and the scale share one sweep built for that (see
// "the fold and scale" below): 16-byte accesses of dst, the source read
// in whole vectors, every load of a thread's step in flight before its
// first store, a block a span of one row (no search per element, 32-bit
// indices inside the span) and alignment planned per row on the host, so
// the llama_350m store's 219 rows all run the vector path.  The update
// reuses fused_update.cu's chunked table (ops/fused_update.py plan), with
// float4 accesses where every operand is 16-byte aligned; the top-k
// decode gives each block whole chunks of the output, zeroed and then
// scattered into after a block barrier, so it needs no separate fill.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEGMENTS = 1024;  // rows of a fold or scale table
constexpr int CHUNK = 1 << 16;      // elements an update block takes
constexpr int MAX_TENSORS = 256;    // tensors in one update table
constexpr int MAX_CHUNKS = 16384;   // blocks in one update launch
constexpr int OPERANDS = 5;         // p, g, out, s0, s1

// ---------------------------------------------------- the fold and scale
// One streaming sweep serves both.  Each row of a table is cut into spans
// of SPAN elements and each span is one block's work: a 1,024-element row
// is one block, the 32.8M-element embedding 4,000, and a block finds its
// span's row once (row_of over the rows' first spans).  Inside a row the
// sweep runs vectors of 4 elements: the row's first `head` elements (0-3)
// bring dst to a 16-byte boundary, then vector i is elements head + 4i ..
// head + 4i + 3, one 16-byte access of dst and one 16-byte (f32), 8-byte
// (bf16) or 4-byte (int8) load of its source.  A span is one step of its
// block: each thread takes UNROLL vectors THREADS apart, so a warp's every
// access is 512 consecutive bytes of dst, and issues all of its loads
// before its first store (the pointers are __restrict__).  One step a
// block, 32 KB of dst (PERF.md section 6): 16K or 64K spans in steps of
// 4 vectors ran every lane 2-6 % slower; 16K spans in one step of 16 ran
// the f32 add 0.3 % faster but spill registers in the f32 set; 4K spans
// ran the scale 0.3 % faster and the int8 set 35 % slower (a step of 4
// bytes a thread).  The head goes to the row's first span, the 0-3
// elements past the last vector to its last span.  A row whose source is
// not aligned for its vector load once dst is (a "scalar row") runs
// element by element.  Every element is computed alone, by the same
// arithmetic on every path.  The host plans the table (plan_rows);
// psdt_fold_plan hands the plan out.  The table travels by value, and a
// launch's host time grows with its parameter bytes, so a call of at most
// SMALL_TABLE rows (the per-tensor close's) launches with a table of that
// many rows.
constexpr int SPAN = 8192;    // elements of a row one block takes
constexpr int UNROLL = 8;     // vectors a thread has in flight a step
constexpr int SMALL_TABLE = 16;
static_assert(SPAN == 4 * UNROLL * THREADS, "a span is one step");
static_assert(SPAN - 1 <= 0xffff, "a span's length fits `last`");

template <int R>
struct Table {
  long long dst[R];        // float* of each row's first element
  long long src[R];        // its source's first element (fold)
  int first[R + 1];        // each row's first span; [rows]: all of them
  unsigned short last[R];  // elements in the row's last span, less one
  unsigned char plan[R];   // head (bits 0-1), vector row (bit 2)
  float scale[R];          // int8: the dequantize scale; the scale: inv
};
static_assert(sizeof(Table<MAX_SEGMENTS>) + sizeof(int) <= 32764,
              "fits the parameter space");

// SRC_NONE: the scale's rows, which have no source
enum SrcKind { SRC_F32 = 0, SRC_BF16 = 1, SRC_INT8 = 2, SRC_NONE = 3 };
enum Op { SET = 0, ADD = 1, SCALE = 2 };
constexpr int PLAN_VECTOR = 4;

// Bytes of one source element, and of the 4 that one vector loads.
__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == SRC_F32 ? 4 : kind == SRC_BF16 ? 2 : 1;
}

template <int KIND> struct Vec4 { using T = float4; };  // f32 (and none)
template <> struct Vec4<SRC_BF16> { using T = uint2; };
template <> struct Vec4<SRC_INT8> { using T = unsigned; };

// The source is read once and dst read and written once: plain accesses
// (the evict-first hints measured no faster, PERF.md section 6).
template <class T>
__device__ __forceinline__ T load_once(const T* p) { return *p; }
__device__ __forceinline__ void store_out(float4* p, float4 v) { *p = v; }

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

// One element of a scalar path.
template <int KIND, int OP>
__device__ __forceinline__ void sweep_one(float* __restrict__ dst,
                                          const void* __restrict__ src,
                                          long long k, float scale) {
  if constexpr (OP == SCALE) {
    dst[k] = __fmul_rn(dst[k], scale);
  } else if constexpr (OP == ADD) {
    dst[k] = __fadd_rn(dst[k], source<KIND>(src, k, scale));
  } else if constexpr (KIND == SRC_F32) {
    // the set lane of an f32 source is a bit copy (np.array(g))
    reinterpret_cast<unsigned*>(dst)[k] =
        static_cast<const unsigned*>(src)[k];
  } else {
    dst[k] = source<KIND>(src, k, scale);
  }
}

// Four source elements as f32, each as source() gives it.
template <int KIND>
__device__ __forceinline__ float4 widen(typename Vec4<KIND>::T v,
                                        float scale) {
  if constexpr (KIND == SRC_BF16) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  } else if constexpr (KIND == SRC_INT8) {
    // each byte sign-extended (little-endian: element 0 is the low byte)
    const int w = static_cast<int>(v);
    return make_float4(__fmul_rn(__int2float_rn((w << 24) >> 24), scale),
                       __fmul_rn(__int2float_rn((w << 16) >> 24), scale),
                       __fmul_rn(__int2float_rn((w << 8) >> 24), scale),
                       __fmul_rn(__int2float_rn(w >> 24), scale));
  } else {
    return v;
  }
}

// One vector of dst from its old value d and its source s.  A set moves
// the f32 source's bits untouched.
template <int KIND, int OP>
__device__ __forceinline__ float4 combine(float4 d,
                                          typename Vec4<KIND>::T s,
                                          float scale) {
  if constexpr (OP == SCALE) {
    return make_float4(__fmul_rn(d.x, scale), __fmul_rn(d.y, scale),
                       __fmul_rn(d.z, scale), __fmul_rn(d.w, scale));
  } else {
    const float4 v = widen<KIND>(s, scale);
    if constexpr (OP == ADD)
      return make_float4(__fadd_rn(d.x, v.x), __fadd_rn(d.y, v.y),
                         __fadd_rn(d.z, v.z), __fadd_rn(d.w, v.w));
    else
      return v;
  }
}

// The row holding span s: the last r with first[r] <= s (uniform over the
// block; a row of no elements has no span and is never chosen).
__device__ __forceinline__ int row_of(const int* first, int rows, int s) {
  int a = 0, b = rows - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (first[mid] <= s) a = mid;
    else b = mid - 1;
  }
  return a;
}

template <int KIND, int OP, int R>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const __grid_constant__ Table<R> t, int rows) {
  using V = typename Vec4<KIND>::T;
  constexpr int ELEM = elem_bytes(KIND);
  // The grid has a block a span, so both loops below run once.  Written
  // as loops, the f32 add compiles to 88 registers (2 blocks an SM);
  // written straight, to 80 (3 blocks), and the f32 add ran 2.0-2.3 %
  // slower, the other lanes within 0.5 % (PERF.md section 6).
  const int spans = t.first[rows];
  for (int s = blockIdx.x; s < spans; s += gridDim.x) {
    const int r = row_of(t.first, rows, s);
    const int k = s - t.first[r];
    const bool last_span = s + 1 == t.first[r + 1];
    const long long n =
        static_cast<long long>(t.first[r + 1] - t.first[r] - 1) * SPAN +
        t.last[r] + 1;
    const long long lo = static_cast<long long>(k) * SPAN;
    float* __restrict__ dst = reinterpret_cast<float*>(t.dst[r]);
    const char* __restrict__ src = reinterpret_cast<const char*>(t.src[r]);
    const float scale = t.scale[r];
    const int plan = t.plan[r];
    if (!(plan & PLAN_VECTOR)) {
      const int len = last_span ? t.last[r] + 1 : SPAN;
#pragma unroll 4
      for (int j = threadIdx.x; j < len; j += THREADS)
        sweep_one<KIND, OP>(dst, src, lo + j, scale);
      continue;
    }
    const int head = plan & 3;
    const long long nv = (n - head) >> 2;   // whole vectors of the row
    const long long v0 = lo >> 2;           // the span's first vector
    const int cnt = static_cast<int>(
        min(static_cast<long long>(SPAN / 4), nv - v0));
    float4* __restrict__ d4 = reinterpret_cast<float4*>(dst + head) + v0;
    const V* __restrict__ s4 =
        OP == SCALE ? nullptr
                    : reinterpret_cast<const V*>(src + head * ELEM) + v0;
    // one step: SPAN / 4 == UNROLL * THREADS
    for (int i = threadIdx.x; i < cnt; i += UNROLL * THREADS) {
      V sv[UNROLL];
      float4 dv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = i + u * THREADS;
        if (j < cnt) {
          if constexpr (OP != SCALE) sv[u] = load_once(s4 + j);
          if constexpr (OP != SET) dv[u] = load_once(d4 + j);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = i + u * THREADS;
        if (j < cnt) store_out(d4 + j, combine<KIND, OP>(dv[u], sv[u],
                                                         scale));
      }
    }
    if (k == 0 && static_cast<int>(threadIdx.x) < head)
      sweep_one<KIND, OP>(dst, src, threadIdx.x, scale);
    const long long tail = head + 4 * nv;
    if (last_span && threadIdx.x < n - tail)
      sweep_one<KIND, OP>(dst, src, tail + threadIdx.x, scale);
  }
}

// Plans rows into t: each row's spans, the length of its last, its head
// (the elements before dst's first 16-byte boundary, at most n) and
// whether it is a vector row (its source, past the head, aligned for the
// 4-element load; the scale's rows always are).  Returns cudaSuccess, or
// cudaErrorInvalidValue for a negative length, a dst not 4-byte aligned
// or more spans than an int counts.
template <int R>
int plan_rows(Table<R>& t, const long long* dst, const long long* src,
              const long long* n, int rows, int kind) {
  long long spans = 0;
  for (int r = 0; r < rows; ++r) {
    if (n[r] < 0 || dst[r] % 4) return cudaErrorInvalidValue;
    t.first[r] = static_cast<int>(spans);
    const long long cnt = (n[r] + SPAN - 1) / SPAN;
    if (cnt) t.last[r] = static_cast<unsigned short>(n[r] - (cnt - 1) * SPAN
                                                     - 1);
    spans += cnt;
    if (spans > 0x7fffffff) return cudaErrorInvalidValue;
    const long long head = n[r] < ((-dst[r]) & 15) / 4 ? n[r]
                                                        : ((-dst[r]) & 15) / 4;
    const bool vec = kind == SRC_NONE ||
                     (src[r] + head * elem_bytes(kind)) %
                             (4 * elem_bytes(kind)) == 0;
    t.plan[r] = static_cast<unsigned char>(head | (vec ? PLAN_VECTOR : 0));
  }
  t.first[rows] = static_cast<int>(spans);
  return cudaSuccess;
}

// Plans and launches one sweep over `rows` rows (src unread by the
// scale) in a table of R rows: a block a span.
template <int KIND, int OP, int R>
int launch_table(const long long* dst, const long long* src,
                 const long long* n, const float* scale, int rows,
                 void* stream) {
  Table<R> t;
  std::memset(&t, 0, sizeof(t));
  const int err = plan_rows(t, dst, src, n, rows, KIND);
  if (err) return err;
  std::memcpy(t.dst, dst, rows * sizeof(long long));
  if (OP != SCALE) std::memcpy(t.src, src, rows * sizeof(long long));
  std::memcpy(t.scale, scale, rows * sizeof(float));
  const int spans = t.first[rows];
  if (spans == 0) return cudaSuccess;
  sweep_kernel<KIND, OP, R><<<spans, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(t, rows);
  return cudaGetLastError();
}

template <int KIND, int OP>
int launch_sweep(const long long* dst, const long long* src,
                 const long long* n, const float* scale, int rows,
                 void* stream) {
  if (rows < 0 || rows > MAX_SEGMENTS) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  return rows <= SMALL_TABLE
             ? launch_table<KIND, OP, SMALL_TABLE>(dst, src, n, scale, rows,
                                                   stream)
             : launch_table<KIND, OP, MAX_SEGMENTS>(dst, src, n, scale,
                                                    rows, stream);
}

template <int KIND>
int launch_fold(const long long* dst, const long long* src,
                const long long* n, const float* scale, int rows, bool add,
                void* stream) {
  return add ? launch_sweep<KIND, ADD>(dst, src, n, scale, rows, stream)
             : launch_sweep<KIND, SET>(dst, src, n, scale, rows, stream);
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
constexpr int ROW_CHUNK = 4096;   // output elements a top-k block takes

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
// ROW_CHUNK, SPAN (ops/device_apply.py checks them against its own).
extern "C" void psdt_device_apply_limits(int* out) {
  out[0] = MAX_SEGMENTS;
  out[1] = CHUNK;
  out[2] = MAX_TENSORS;
  out[3] = MAX_CHUNKS;
  out[4] = ROW_CHUNK;
  out[5] = SPAN;
}

// The plan of a fold (kind 0 f32, 1 bf16, 2 int8) over `rows` rows, as
// its launch makes it: first[rows + 1] (each row's first span, then the
// count) and plan[rows] (head | 4 for a vector row).  Returns the
// cudaError_t.
extern "C" int psdt_fold_plan(const long long* dst, const long long* src,
                              const long long* n, int rows, int kind,
                              int* first, unsigned char* plan) {
  if (rows < 0 || rows > MAX_SEGMENTS || kind < SRC_F32 || kind > SRC_INT8)
    return cudaErrorInvalidValue;
  Table<MAX_SEGMENTS> t;
  std::memset(&t, 0, sizeof(t));
  const int err = plan_rows(t, dst, src, n, rows, kind);
  if (err) return err;
  std::memcpy(first, t.first, (rows + 1) * sizeof(int));
  std::memcpy(plan, t.plan, rows);
  return cudaSuccess;
}

// One fold launch over `rows` rows: dst/src addresses, n elements each,
// scale (int8 rows); kind 0 f32, 1 bf16, 2 int8; add 0 = set, 1 = add.
// Returns the cudaError_t.
extern "C" int psdt_fold_segments(const long long* dst, const long long* src,
                                  const long long* n, const float* scale,
                                  int rows, int kind, int add,
                                  void* stream) {
  if (kind == SRC_F32)
    return launch_fold<SRC_F32>(dst, src, n, scale, rows, add, stream);
  if (kind == SRC_BF16)
    return launch_fold<SRC_BF16>(dst, src, n, scale, rows, add, stream);
  if (kind == SRC_INT8)
    return launch_fold<SRC_INT8>(dst, src, n, scale, rows, add, stream);
  return cudaErrorInvalidValue;
}

// One in-place scale launch: x[0:n] *= inv for each row.
extern "C" int psdt_scale_mean(const long long* ptr, const long long* n,
                               const float* inv, int rows, void* stream) {
  return launch_sweep<SRC_NONE, SCALE>(ptr, ptr, n, inv, rows, stream);
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
