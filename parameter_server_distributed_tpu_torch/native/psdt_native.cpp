// Host C++ library of the parameter server and the wire codec: the
// port's own copy of parameter_server_distributed_tpu/native/psdt_native.cpp,
// function for function and operation for operation, so both packages'
// libraries give the same bits.
//
// These are CPU loops, not GPU kernels: the barrier mean, the host
// optimizers' fused passes (core/optimizer.py, core/ps_core.py), the bulk
// copy of the shared-memory rings (rpc/shm_transport.py) and the packed
// wire encodings (rpc/codec.py NativeCodec).  Callers reach them through
// ctypes, which releases the GIL around each call, so stripe-parallel
// encodes and a colocated producer/consumer pair overlap on several cores.
//
// Build: native/__init__.py runs g++ -O3 -ffp-contract=off (never
// -ffast-math) into build/native/ beside the package, under a name that
// hashes this file and the flags.  -ffp-contract=off keeps every multiply
// and add rounded on its own, as numpy rounds them.  PSDT_NATIVE=0 selects
// the numpy paths instead.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

// ---------------------------------------------------------------------------
// Wire-codec helpers.  The packed tensor payloads of the data plane
// (rpc/codec.py) are byte layouts pinned by the Python codec; every kernel
// below reproduces it bit for bit (tests/test_torch_codec.py) — the native
// path is a speed substitution, never a semantic one.
//
// Destination buffers are raw uint8_t* because protobuf payloads start at
// arbitrary (varint-sized) offsets inside the outgoing message buffer;
// all multi-byte stores go through memcpy, which g++ folds into plain
// unaligned moves.

namespace {

inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void store32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline uint16_t load16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

// f32 -> bf16, round-to-nearest-even with NaN quietization — exactly the
// Eigen/ml_dtypes conversion numpy's astype(bfloat16) performs (verified
// against specials: inf, -0.0, denormals, NaN payloads).  Branchless so
// the pack loop vectorizes (the NaN case becomes a blend, not a branch).
inline uint16_t f32_to_bf16(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    const uint32_t lsb = (u >> 16) & 1u;
    const uint16_t rne = static_cast<uint16_t>((u + 0x7fffu + lsb) >> 16);
    const uint16_t nan = static_cast<uint16_t>((u >> 16) | 0x0040u);
    return (u & 0x7fffffffu) > 0x7f800000u ? nan : rne;
}

inline float bf16_to_f32(uint16_t h) {
    const uint32_t u = static_cast<uint32_t>(h) << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

inline uint32_t abs_bits(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    return u & 0x7fffffffu;
}

// Exact r-th smallest (0-based) |src| value via a two-round radix select
// over the bit patterns (monotone for non-negative floats).  Round 1 bins
// the TOP 16 bits in one pass (64k bins — sign is zero, so exponent
// clustering in real gradients still splits on high mantissa bits);
// round 2 resolves the low 16 bits over the (tiny) surviving candidate
// set.  Four interleaved partial histograms break the store-forwarding
// dependency chain of the classic single-array histogram loop.
float radix_kth_abs(const float* src, const int64_t n, int64_t r) {
    std::vector<int64_t> hist(4 * 65536, 0);
    int64_t* h0 = hist.data();
    int64_t* h1 = h0 + 65536;
    int64_t* h2 = h1 + 65536;
    int64_t* h3 = h2 + 65536;
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        ++h0[abs_bits(src[i]) >> 16];
        ++h1[abs_bits(src[i + 1]) >> 16];
        ++h2[abs_bits(src[i + 2]) >> 16];
        ++h3[abs_bits(src[i + 3]) >> 16];
    }
    for (; i < n; ++i) ++h0[abs_bits(src[i]) >> 16];
    uint32_t hi = 0;
    int64_t acc = 0;
    for (;; ++hi) {
        const int64_t c = h0[hi] + h1[hi] + h2[hi] + h3[hi];
        if (acc + c > r) break;
        acc += c;
    }
    r -= acc;
    // round 2: low 16 bits of the elements whose top half == hi
    std::vector<uint32_t> low(65536, 0);
    for (int64_t j = 0; j < n; ++j) {
        const uint32_t u = abs_bits(src[j]);
        low[u & 0xffffu] += (u >> 16) == hi;
    }
    uint32_t lo = 0;
    for (acc = 0;; ++lo) {
        if (acc + low[lo] > r) break;
        acc += low[lo];
    }
    const uint32_t bits = (hi << 16) | lo;
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

}  // namespace

extern "C" {

// out[i] = sum_w srcs[w][i] / count   (the barrier mean,
// mean-over-actual-contributors semantics)
void psdt_mean(const float** srcs, int32_t count, const int64_t n,
               float* out) {
    if (count <= 0) return;
    const float inv = 1.0f / static_cast<float>(count);
    // first source initializes, remaining accumulate, single store pass
    for (int64_t i = 0; i < n; ++i) {
        float acc = srcs[0][i];
        for (int32_t w = 1; w < count; ++w) acc += srcs[w][i];
        out[i] = acc * inv;
    }
}

// param -= lr * grad
void psdt_sgd(float* param, const float* grad, const int64_t n,
              const float lr) {
    for (int64_t i = 0; i < n; ++i) param[i] -= lr * grad[i];
}

// velocity = mu * velocity + grad; param -= lr * velocity  (one pass)
void psdt_momentum(float* param, const float* grad, float* velocity,
                   const int64_t n, const float lr, const float mu) {
    for (int64_t i = 0; i < n; ++i) {
        const float v = mu * velocity[i] + grad[i];
        velocity[i] = v;
        param[i] -= lr * v;
    }
}

// Adam fused pass.  bc1/bc2 are the bias-correction denominators.
void psdt_adam(float* param, const float* grad, float* m, float* v,
               const int64_t n, const float lr, const float b1,
               const float b2, const float eps, const float bc1,
               const float bc2) {
    for (int64_t i = 0; i < n; ++i) {
        const float g = grad[i];
        const float m_new = b1 * m[i] + (1.0f - b1) * g;
        const float v_new = b2 * v[i] + (1.0f - b2) * g * g;
        m[i] = m_new;
        v[i] = v_new;
        const float m_hat = m_new / bc1;
        const float v_hat = v_new / bc2;
        param[i] -= lr * m_hat / (__builtin_sqrtf(v_hat) + eps);
    }
}

// AdamW fused pass: Adam plus decoupled weight decay folded into the SAME
// sweep (optax.adamw convention: update = adam_term + wd * p_pre, applied
// together from the pre-update param).  wd = 0 for non-decayed tensors
// (the matrices-only mask lives in the Python caller).
void psdt_adamw(float* param, const float* grad, float* m, float* v,
                const int64_t n, const float lr, const float b1,
                const float b2, const float eps, const float bc1,
                const float bc2, const float wd) {
    for (int64_t i = 0; i < n; ++i) {
        const float g = grad[i];
        const float p_old = param[i];
        const float m_new = b1 * m[i] + (1.0f - b1) * g;
        const float v_new = b2 * v[i] + (1.0f - b2) * g * g;
        m[i] = m_new;
        v[i] = v_new;
        const float m_hat = m_new / bc1;
        const float v_hat = v_new / bc2;
        param[i] = p_old
            - lr * (m_hat / (__builtin_sqrtf(v_hat) + eps) + wd * p_old);
    }
}

// Fused mean + SGD: param -= lr * mean(srcs) with no intermediate buffer.
void psdt_mean_sgd(float* param, const float** srcs, int32_t count,
                   const int64_t n, const float lr) {
    if (count <= 0) return;
    const float scale = lr / static_cast<float>(count);
    for (int64_t i = 0; i < n; ++i) {
        float acc = srcs[0][i];
        for (int32_t w = 1; w < count; ++w) acc += srcs[w][i];
        param[i] -= scale * acc;
    }
}

// Plain memcpy, exported so Python-side bulk copies (the shm transport
// rings — rpc/shm_transport.py) run WITHOUT the GIL: ctypes releases it
// around the call, so a colocated producer/consumer pair really overlaps
// its copies, where memoryview slice assignment would convoy them a GIL
// switch-interval at a time.
void psdt_copy(uint8_t* dst, const uint8_t* src, const int64_t n) {
    std::memcpy(dst, src, static_cast<size_t>(n));
}

// ---------------------------------------------------------------------------
// Wire codec kernels (rpc/codec.py NativeCodec).  Layouts are the Python
// codec's, byte for byte.

// WIRE_BF16 payload: n * u16 (RNE-rounded), little-endian.
void psdt_pack_bf16(const float* src, const int64_t n, uint8_t* dst) {
    for (int64_t i = 0; i < n; ++i) store16(dst + 2 * i, f32_to_bf16(src[i]));
}

void psdt_unpack_bf16(const uint8_t* src, const int64_t n, float* dst) {
    for (int64_t i = 0; i < n; ++i) dst[i] = bf16_to_f32(load16(src + 2 * i));
}

// WIRE_INT8 payload: f32 max-abs scale | n * int8.  Scale and quantization
// mirror the numpy path exactly: max|src| reduced in f32, scale computed in
// DOUBLE (max_abs / 127.0 — Python float arithmetic) then narrowed to f32,
// division + round-half-even in f32 (numpy casts the scalar to the array
// dtype; np.rint == roundeven, which unlike rintf has no FP-environment
// side effects and therefore vectorizes), clip to [-127, 127].
void psdt_quant_int8(const float* src, const int64_t n, uint8_t* dst) {
    // max|src| as an INTEGER max over the abs bit patterns (monotone for
    // non-negative floats, and integer MAX_EXPR vectorizes without any
    // fast-math relaxation) — exact, association-free
    uint32_t mx = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, src + i, 4);
        u &= 0x7fffffffu;
        mx = u > mx ? u : mx;
    }
    float max_abs;
    std::memcpy(&max_abs, &mx, 4);
    const float scale = max_abs > 0.0f
        ? static_cast<float>(static_cast<double>(max_abs) / 127.0) : 1.0f;
    std::memcpy(dst, &scale, 4);
    int8_t* q = reinterpret_cast<int8_t*>(dst + 4);
    // round-half-even via the 1.5*2^23 magic-add trick: EXACT for every
    // reachable quotient (|src/scale| <= 127 by construction of scale),
    // and plain add/sub — unlike rintf/roundevenf it vectorizes.  The
    // only divergence from np.rint is -0.0 vs +0.0, erased by the int8
    // cast.  Byte-identity with the numpy oracle is fuzz-pinned
    // (tests/test_torch_codec.py).
    const float magic = 12582912.0f;
    for (int64_t j = 0; j < n; ++j) {
        float r = (src[j] / scale + magic) - magic;
        r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
        q[j] = static_cast<int8_t>(r);
    }
}

// payload -> f32: q * scale, both factors f32 (numpy: int8.astype(f32) * f32).
void psdt_dequant_int8(const uint8_t* src, const int64_t n, float* dst) {
    float scale;
    std::memcpy(&scale, src, 4);
    const int8_t* q = reinterpret_cast<const int8_t*>(src + 4);
    for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<float>(q[i]) * scale;
}

// WIRE_TOPK payload: u32 k | k * u32 indices (ascending) | k * bf16 values.
// Deterministic selection shared with the Python oracle (rpc/codec.py
// topk_indices): take every element with |v| strictly above the k-th
// largest |v|, then fill the remaining slots with threshold-tied elements
// in ASCENDING INDEX order — tie-breaking is part of the codec contract so
// native and Python emit identical bytes.
void psdt_topk_pack(const float* src, const int64_t n, const int64_t k,
                    uint8_t* dst) {
    store32(dst, static_cast<uint32_t>(k));
    if (k <= 0) return;
    uint8_t* idst = dst + 4;
    uint8_t* vdst = dst + 4 + 4 * k;
    if (k >= n) {
        for (int64_t i = 0; i < n; ++i) {
            store32(idst + 4 * i, static_cast<uint32_t>(i));
            store16(vdst + 2 * i, f32_to_bf16(src[i]));
        }
        return;
    }
    const float thr = radix_kth_abs(src, n, n - k);
    int64_t above = 0;
    for (int64_t i = 0; i < n; ++i) above += std::fabs(src[i]) > thr;
    int64_t need = k - above;
    int64_t taken = 0;
    for (int64_t i = 0; i < n && taken < k; ++i) {
        const float a = std::fabs(src[i]);
        if (a > thr || (a == thr && need > 0)) {
            if (!(a > thr)) --need;
            store32(idst + 4 * taken, static_cast<uint32_t>(i));
            store16(vdst + 2 * taken, f32_to_bf16(src[i]));
            ++taken;
        }
    }
    if (taken < k) {
        // NaN entries compare false against any threshold (and a NaN
        // threshold against anything) but sort as the LARGEST values —
        // fill the remaining slots with the FIRST (k - taken) NaN
        // indices, merged ascending into the selection, exactly like
        // the Python oracle (codec contract: always exactly k entries).
        std::vector<uint32_t> nans;
        nans.reserve(static_cast<size_t>(k - taken));
        for (int64_t i = 0; i < n
                 && static_cast<int64_t>(nans.size()) < k - taken; ++i)
            if (src[i] != src[i]) nans.push_back(static_cast<uint32_t>(i));
        int64_t r = taken - 1;                               // read (sel)
        int64_t nw = static_cast<int64_t>(nans.size()) - 1;  // read (nan)
        int64_t w = taken + static_cast<int64_t>(nans.size()) - 1;
        while (nw >= 0) {
            if (r >= 0
                && load32(idst + 4 * r) > nans[static_cast<size_t>(nw)]) {
                store32(idst + 4 * w, load32(idst + 4 * r));
                store16(vdst + 2 * w, load16(vdst + 2 * r));
                --r;
            } else {
                const uint32_t idx = nans[static_cast<size_t>(nw)];
                store32(idst + 4 * w, idx);
                store16(vdst + 2 * w, f32_to_bf16(src[idx]));
                --nw;
            }
            --w;
        }
    }
}

// payload -> dense f32 (zero-filled, kept entries scattered back).  Returns
// 0 on success, -1 when any index is out of range (caller falls back to the
// Python path, which raises) — a silent skip would quietly corrupt decode.
int32_t psdt_topk_unpack(const uint8_t* src, const int64_t total,
                         float* dst) {
    const int64_t k = static_cast<int64_t>(load32(src));
    std::memset(dst, 0, static_cast<size_t>(total) * 4);
    const uint8_t* isrc = src + 4;
    const uint8_t* vsrc = src + 4 + 4 * k;
    for (int64_t j = 0; j < k; ++j) {
        const uint32_t idx = load32(isrc + 4 * j);
        if (static_cast<int64_t>(idx) >= total) return -1;
        dst[idx] = bf16_to_f32(load16(vsrc + 2 * j));
    }
    return 0;
}

}  // extern "C"
