// Paged decode attention over quantized KV blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention_quant_pallas (body
// _paged_attn_quant_kernel, paged_attention.py:117).  Same function as
// kernels/ref.py::quant_paged_attention_ref on live rows: one decode query
// per row, GQA grouped as (KV, G, hd), attending over the row's pages of a
// quantized (NB, bs, KV, hds) pool through its (B, nb) block table --
// int8 codes (hds = hd) or nibble-packed uint8 at uniform int4 (hds =
// hd/2) -- with per-(token, KV head) f32 scales (NB, bs, KV).  Codes are
// dequantized in registers as float(code) * scale (bitwise
// kv_dequantize); f32 online softmax masked at pos < lengths[b]; out =
// acc / max(l, 1e-20).  A row of length 0 returns exact zeros (the Pallas
// kernel's contract).
//
// What bounds it on the H100: device-memory bytes -- each live token's
// codes (hd or hd/2 bytes per KV head) and two scales are read once and
// used for 4*G*hd flops, far below the ridge.  The dequantized values
// never touch device memory: the TPU kernel dequantized a DMA'd block in
// VMEM; here one page's codes and scales are staged in shared memory and
// dequantized in registers by the lane that uses them.
// Design: as csrc/paged_attention.cu -- one CTA per (row b, KV head), the
// CTA reads block_tables[b, j] itself (the TPU's scalar-prefetched index
// map) and stops at ceil(len/bs) pages; the sweep is kv_attention.cuh's.
// The container (int8 or packed int4) is a template parameter.  Known
// limit: B*KV CTAs (8 at batch 4 for glm4-9b) leave most SMs idle; a
// split-KV pass is the planned fix (PERF.md).
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernel
// allocates nothing; the entry point returns cudaGetLastError().

#include "kv_attention.cuh"

namespace {

using namespace kvattn;

template <typename T, int DPL, bool PACKED4>
__global__ void paged_attention_quant_kernel(const T* __restrict__ q,
                                             const uint8_t* __restrict__ k_pool,
                                             const uint8_t* __restrict__ v_pool,
                                             const float* __restrict__ k_scale,
                                             const float* __restrict__ v_scale,
                                             const int* __restrict__ block_tables,
                                             const int* __restrict__ lengths,
                                             float* __restrict__ out, int KV, int G, int bs,
                                             int nb, float scale) {
    constexpr int HD = DPL * 32;
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, kvh = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int len = min(max(lengths[b], 0), nb * bs);
    const size_t slab = ((size_t)b * KV + kvh) * G * HD;

    Heads<DPL> st;
    st.init(warp * HPW, G);
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            st.q[h][d] = h < st.n ? to_f32(q[slab + (size_t)(warp * HPW + h) * HD + lane * DPL + d])
                                  : 0.f;
    sweep_pages<DPL, PACKED4>(st, k_pool, v_pool, k_scale, v_scale,
                              block_tables + (size_t)b * nb, len, KV, kvh, bs, scale, smem);
    st.store(out + slab, warp * HPW, lane);
}

template <typename T, int DPL, bool PACKED4>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const int* bt, const int* lengths, float* out, int B, int KV,
           int G, int bs, int nb, float scale, cudaStream_t st) {
    const size_t smem = page_smem_bytes(bs, PACKED4 ? DPL * 16 : DPL * 32);
    auto kern = paged_attention_quant_kernel<T, DPL, PACKED4>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int warps = (G + HPW - 1) / HPW;
    kern<<<dim3(B, KV), warps * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const uint8_t*>(k_pool),
        static_cast<const uint8_t*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), bt, lengths, out, KV, G, bs, nb, scale);
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED4>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const int* bt, const int* ln, float* out, int B, int KV, int G,
              int bs, int nb, float scale, cudaStream_t st) {
    switch (hd) {
        case 64: return launch<T, 2, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, B, KV, G, bs, nb, scale, st);
        case 96: return launch<T, 3, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, B, KV, G, bs, nb, scale, st);
        case 128: return launch<T, 4, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, B, KV, G, bs, nb, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_container(int packed4, int hd, const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const int* bt, const int* ln, float* out,
                     int B, int KV, int G, int bs, int nb, float scale, cudaStream_t st) {
    if (packed4)
        return launch_hd<T, true>(hd, q, kp, vp, ks, vs, bt, ln, out, B, KV, G, bs, nb, scale, st);
    return launch_hd<T, false>(hd, q, kp, vp, ks, vs, bt, ln, out, B, KV, G, bs, nb, scale, st);
}

}  // namespace

// dtype (of q): 0 = float32, 1 = bfloat16.  packed4: 0 = int8 codes
// (NB, bs, KV, hd), 1 = nibble-packed uint8 (NB, bs, KV, hd/2).
// q (B, KV, G, hd); scales (NB, bs, KV) f32; block_tables (B, nb) int32;
// lengths (B,) int32; out (B, KV, G, hd) float32.
extern "C" int paged_attention_quant_launch(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* block_tables,
                                            const void* lengths, void* out, int dtype,
                                            int packed4, int B, int KV, int G, int hd, int bs,
                                            int nb, float scale, void* stream) {
    if (B <= 0 || KV <= 0 || G <= 0 || G > 32 * HPW || bs <= 0 || nb <= 0 ||
        (dtype != 0 && dtype != 1) || (packed4 != 0 && packed4 != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* bt = static_cast<const int*>(block_tables);
    const int* ln = static_cast<const int*>(lengths);
    float* o = static_cast<float*>(out);
    if (dtype == 1)
        return launch_container<__nv_bfloat16>(packed4, hd, q, k_pool, v_pool, k_scale, v_scale,
                                               bt, ln, o, B, KV, G, bs, nb, scale, st);
    return launch_container<float>(packed4, hd, q, k_pool, v_pool, k_scale, v_scale, bt, ln, o,
                                   B, KV, G, bs, nb, scale, st);
}
