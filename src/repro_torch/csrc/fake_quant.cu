// WRPN mid-tread fake-quant (quantize-dequantize) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fake_quant.py::fake_quant_pallas (body _fake_quant_kernel,
// fake_quant.py:33).  Same function as kernels/ref.py::fake_quant_ref, and
// bitwise so, element by element:
//
//   n   = bits >= 2 ? 2^(bits-1) - 1 : 1          (from integers)
//   out = bits >= 32 ? w : round(clip(w / scale, -1, 1) * n) / n * scale
//
// computed in f32 and written in w's dtype (f32, or bf16 rounded to
// nearest even).  bits and scale are device scalars (the bits vector's
// entry for this layer, the 0-d max|w| of the wrapper), read by every
// thread: one build serves every bits policy and the launch needs no host
// sync, as the Pallas kernel's SMEM scalars did.
//
// Bitwise equality with the plain version: each step is one IEEE f32
// operation in the reference's order (__fdiv_rn, __fmul_rn: never
// contracted into an FMA, never an approximate reciprocal); rintf rounds
// half to even like torch.round and jnp.round (roundf would move every
// tie); the clip is written with comparisons so a NaN stays a NaN, as
// jnp.clip keeps it (fminf/fmaxf would return the bound); n is built from
// integers (exp2f is not promised exact) and bits >= 32 is tested first,
// so 1 << 31 never happens.
//
// What bounds it on the H100: device-memory bytes -- one read and one
// write per element against ~7 f32 operations, far below the ridge.  At
// the QAT path's sizes (432 to 36,864 weights per ResNet-20 layer) a call
// moves at most 295 KB, well under a microsecond at 3.35 TB/s, so it is
// bound by the launch.  Design: a flat grid-stride loop over numel (no
// TPU tiles, no padding): 16-byte vector loads and stores (4 f32 or 8
// bf16) when the pointers are 16-byte aligned, then a masked scalar tail.
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernel
// allocates nothing; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FP_BITS = 32;

struct Params {
    int fp;      // bits >= 32: pass w through
    float n;     // levels
    float scale;
};

__device__ __forceinline__ Params load_params(const int* bits_p, const float* scale_p) {
    const int bits = *bits_p;
    Params p;
    p.fp = bits >= FP_BITS;
    p.n = p.fp ? 1.f : (bits >= 2 ? __int2float_rn((1 << (bits - 1)) - 1) : 1.f);
    p.scale = *scale_p;
    return p;
}

__device__ __forceinline__ float qdq(float w, const Params& p) {
    if (p.fp) return w;
    float wc = __fdiv_rn(w, p.scale);
    wc = wc < -1.f ? -1.f : (wc > 1.f ? 1.f : wc);   // NaN compares false: kept
    const float q = rintf(__fmul_rn(wc, p.n));
    return __fmul_rn(__fdiv_rn(q, p.n), p.scale);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

// N elements of T fill 16 bytes: one 128-bit load or store.
template <typename T>
struct alignas(16) Vec {
    static constexpr int N = 16 / sizeof(T);
    T v[N];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const T* __restrict__ w, T* __restrict__ out, const int* __restrict__ bits,
                  const float* __restrict__ scale, int64_t numel, int vectorized) {
    const Params p = load_params(bits, scale);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    constexpr int N = Vec<T>::N;
    int64_t done = 0;
    if (vectorized) {
        const int64_t nvec = numel / N;
        const Vec<T>* wv = reinterpret_cast<const Vec<T>*>(w);
        Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
        for (int64_t i = tid; i < nvec; i += stride) {
            Vec<T> a = wv[i];
            Vec<T> r;
#pragma unroll
            for (int j = 0; j < N; ++j) from_f32(qdq(to_f32(a.v[j]), p), &r.v[j]);
            ov[i] = r;
        }
        done = nvec * N;
    }
    for (int64_t i = done + tid; i < numel; i += stride) from_f32(qdq(to_f32(w[i]), p), &out[i]);
}

template <typename T>
int launch(const void* w, void* out, const int* bits, const float* scale, int64_t numel,
           int vectorized, cudaStream_t st) {
    const int64_t per_block = (int64_t)THREADS * (vectorized ? Vec<T>::N : 1);
    int64_t blocks = (numel + per_block - 1) / per_block;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 blocks per SM
    if (blocks < 1) blocks = 1;
    fake_quant_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const T*>(w), static_cast<T*>(out), bits, scale, numel, vectorized);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype (of w and out): 0 = float32, 1 = bfloat16.  w, out: numel
// contiguous elements; bits: one int32; scale: one float32 (all device
// pointers).  vectorized: w and out are 16-byte aligned.
extern "C" int fake_quant_launch(const void* w, void* out, const void* bits, const void* scale,
                                 int64_t numel, int dtype, int vectorized, void* stream) {
    if (numel <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* b = static_cast<const int*>(bits);
    const float* s = static_cast<const float*>(scale);
    if (dtype == 1) return launch<__nv_bfloat16>(w, out, b, s, numel, vectorized, st);
    return launch<float>(w, out, b, s, numel, vectorized, st);
}
