// Paged decode attention over fp KV blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_attn_kernel, paged_attention.py:37).  Same function as
// kernels/ref.py::paged_attention_ref on live rows: one decode query per
// row, GQA grouped as (KV, G, hd), attending over the row's pages of an
// (NB, bs, KV, hd) pool through its (B, nb) block table, f32 online
// softmax masked at pos < lengths[b], out = acc / max(l, 1e-20).  A row
// of length 0 returns exact zeros (the Pallas kernel's contract).
//
// What bounds it on the H100: device-memory bytes -- each live K/V token
// is read once and used for 2*G*hd flops per head group, far below the
// ridge.  On the TPU the block table was the BlockSpec index map
// (scalar-prefetched); here each CTA reads block_tables[b, j] itself.
// Design: one CTA per (row b, KV head).  It stops at ceil(len/bs) blocks
// instead of sweeping all nb, so dead pages are never read.  Each page's
// K and V rows for this KV head are staged once in shared memory with
// coalesced loads, then every warp reads them from there; a warp carries
// up to 4 of the G query heads, each lane owning hd/32 dims, and keeps
// the running max, denominator and weighted-V accumulator in registers
// (f32).  Known limit: B*KV CTAs (8 at batch 4 for glm4-9b) leave most
// SMs idle; a split-KV pass is the planned fix (PERF.md).
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernel
// allocates nothing; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HPW = 4;          // query heads per warp
constexpr float NEG = -1e30f;   // finite "-inf", as in the reference

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int DPL>
__global__ void paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ block_tables,
                                       const int* __restrict__ lengths, float* __restrict__ out,
                                       int KV, int G, int bs, int nb, float scale) {
    constexpr int HD = DPL * 32;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ks = reinterpret_cast<T*>(smem_raw);
    T* vs = ks + bs * HD;

    const int b = blockIdx.x, kvh = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int len = min(max(lengths[b], 0), nb * bs);

    float qr[HPW][DPL], acc[HPW][DPL], m[HPW], l[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
        const int g = warp * HPW + h;
        m[h] = NEG;
        l[h] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
            acc[h][d] = 0.f;
            qr[h][d] = g < G ? to_f32(q[(((size_t)b * KV + kvh) * G + g) * HD + lane * DPL + d]) : 0.f;
        }
    }

    const int nblk = (len + bs - 1) / bs;
    for (int jb = 0; jb < nblk; ++jb) {
        const int phys = block_tables[(size_t)b * nb + jb];
        const int ntok = min(bs, len - jb * bs);
        __syncthreads();
        for (int i = threadIdx.x; i < ntok * HD; i += blockDim.x) {
            const int t = i / HD, d = i % HD;
            const size_t off = (((size_t)phys * bs + t) * KV + kvh) * HD + d;
            ks[i] = k_pool[off];
            vs[i] = v_pool[off];
        }
        __syncthreads();
        for (int t = 0; t < ntok; ++t) {
            float kr[DPL], vr[DPL];
#pragma unroll
            for (int d = 0; d < DPL; ++d) {
                kr[d] = to_f32(ks[t * HD + lane * DPL + d]);
                vr[d] = to_f32(vs[t * HD + lane * DPL + d]);
            }
#pragma unroll
            for (int h = 0; h < HPW; ++h) {
                if (warp * HPW + h >= G) break;   // warp-uniform
                float s = 0.f;
#pragma unroll
                for (int d = 0; d < DPL; ++d) s = fmaf(qr[h][d], kr[d], s);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
                s *= scale;
                const float mn = fmaxf(m[h], s);
                const float corr = expf(m[h] - mn);
                const float p = expf(s - mn);
                l[h] = l[h] * corr + p;
#pragma unroll
                for (int d = 0; d < DPL; ++d) acc[h][d] = acc[h][d] * corr + p * vr[d];
                m[h] = mn;
            }
        }
    }
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
        const int g = warp * HPW + h;
        if (g >= G) break;
        const float den = fmaxf(l[h], 1e-20f);
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            out[(((size_t)b * KV + kvh) * G + g) * HD + lane * DPL + d] = acc[h][d] / den;
    }
}

template <typename T, int DPL>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
           const int* lengths, float* out, int B, int KV, int G, int bs, int nb,
           float scale, cudaStream_t st) {
    const size_t smem = 2 * (size_t)bs * DPL * 32 * sizeof(T);
    auto kern = paged_attention_kernel<T, DPL>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int warps = (G + HPW - 1) / HPW;
    kern<<<dim3(B, KV), warps * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        bt, lengths, out, KV, G, bs, nb, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k_pool, const void* v_pool, const int* bt,
              const int* lengths, float* out, int B, int KV, int G, int bs, int nb,
              float scale, cudaStream_t st) {
    switch (hd) {
        case 64: return launch<T, 2>(q, k_pool, v_pool, bt, lengths, out, B, KV, G, bs, nb, scale, st);
        case 96: return launch<T, 3>(q, k_pool, v_pool, bt, lengths, out, B, KV, G, bs, nb, scale, st);
        case 128: return launch<T, 4>(q, k_pool, v_pool, bt, lengths, out, B, KV, G, bs, nb, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype (of q and both pools): 0 = float32, 1 = bfloat16.
// q (B, KV, G, hd); pools (NB, bs, KV, hd); block_tables (B, nb) int32;
// lengths (B,) int32; out (B, KV, G, hd) float32.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* lengths, void* out,
                                      int dtype, int B, int KV, int G, int hd, int bs, int nb,
                                      float scale, void* stream) {
    if (B <= 0 || KV <= 0 || G <= 0 || G > 32 * HPW || bs <= 0 || nb <= 0 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* bt = static_cast<const int*>(block_tables);
    const int* ln = static_cast<const int*>(lengths);
    float* o = static_cast<float*>(out);
    if (dtype == 1)
        return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, bt, ln, o, B, KV, G, bs, nb, scale, st);
    return launch_hd<float>(hd, q, k_pool, v_pool, bt, ln, o, B, KV, G, bs, nb, scale, st);
}
