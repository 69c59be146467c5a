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
// used for 4*G*hd flops, far below the ridge -- and, at decode's few
// hundred tokens, latency: the whole call is a few microseconds of bytes.
// The dequantized values never touch device memory: the TPU kernel
// dequantized a DMA'd block in VMEM; here a tile's codes and scales are
// staged in shared memory and dequantized in registers by the lane that
// uses them.
// Design: split-KV over a (B, KV, S) grid, S = ceil(nb / pages_per_split)
// from the block table's width alone (kernels/paged_attention.py::
// split_plan; the host never reads lengths).  Each CTA reads its split's
// block_tables[b, j] itself (the TPU's scalar-prefetched index map) and
// runs the tiled sweep of kv_attention.cuh over them: 32-token tiles with
// one softmax max and sum per head and tile, cp.async double buffering,
// the first tile in flight while q is widened to f32.
// With S > 1 the last split CTA of a (row, KV head) to finish merges the
// partials in split order (csrc/split_kv.cuh): one launch, and outputs
// that are bitwise repeatable.  The container (int8 or packed int4) is a
// template parameter.
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernel
// allocates nothing (the wrapper passes the split workspace); the entry
// point returns cudaGetLastError().

#include "kv_attention.cuh"

namespace {

using namespace kvattn;

// One CTA per (row b, KV head, split s).  ws_acc / ws_ml take the
// partial when S > 1; with S == 1 the CTA writes out itself.  MAXT: the
// most threads a launch uses (1024 above 64 query heads caps registers).
template <typename T, int DPL, bool PACKED4, int MAXT>
__global__ void __launch_bounds__(MAXT)
paged_attention_quant_kernel(const T* __restrict__ q, const uint8_t* __restrict__ k_pool,
                             const uint8_t* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ lengths, float* __restrict__ out,
                             float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                             int* __restrict__ arrived, int KV, int G, int bs, int nb, int pps,
                             float scale, int vec) {
    constexpr int HD = DPL * 32;
    extern __shared__ __align__(16) uint8_t smem[];
    float* qs = reinterpret_cast<float*>(smem);                    // (G, HD) f32
    uint8_t* sweep_mem = smem + (size_t)G * HD * sizeof(float);
    int* pages = reinterpret_cast<int*>(
        sweep_mem + sweep_smem_bytes<HD, PACKED4>(blockDim.x / 32));   // this split's

    const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z, S = gridDim.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t bk = (size_t)b * KV + kvh;
    // the split's page ids, read with the length (not after it); the first
    // tile is in flight while q is widened to f32
    for (int j = threadIdx.x; j < pps; j += blockDim.x)
        pages[j] = s * pps + j < nb ? block_tables[(size_t)b * nb + s * pps + j] : 0;
    const int len = min(max(lengths[b], 0), nb * bs);
    const int t_begin = s * pps * bs, t_end = min(len, (s + 1) * pps * bs);
    const int nh = max(0, min(HPW, G - warp * HPW));   // live heads of this warp
    __syncthreads();
    const Pages pg{k_pool, v_pool, k_scale, v_scale, pages, s * pps, KV, kvh, bs, vec != 0};
    sweep_prefetch<DPL, PACKED4>(pg, t_begin, t_end, sweep_mem);
    stage_f32(qs, q + bk * G * HD, G * HD);
    __syncthreads();

    Partial<DPL> st;
    st.init();
    sweep<DPL, PACKED4>(st, qs, pg, t_begin, t_end, scale, nh, sweep_mem);
    st.store(out + bk * G * HD, ws_acc + bk * S * G * HD, ws_ml + bk * S * G * 2, s, S, G,
             warp * HPW, nh, lane);
    if (S > 1 && splitkv::arrive_last(arrived + bk, S))
        splitkv::combine(ws_acc + bk * S * G * HD, ws_ml + bk * S * G * 2, out + bk * G * HD, S,
                         G, HD, qs);
}

template <typename T, int DPL, bool PACKED4>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const int* bt, const int* lengths, float* out, float* ws,
           int* arrived, int B, int KV, int G, int bs, int nb, int pps, float scale,
           cudaStream_t st) {
    constexpr int HD = DPL * 32;
    const int warps = sweep_warps(G);
    const int S = (nb + pps - 1) / pps;
    if (S > splitkv::MAX_SPLITS || (S > 1 && (ws == nullptr || arrived == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)G * HD * sizeof(float) + sweep_smem_bytes<HD, PACKED4>(warps) +
                        (size_t)pps * sizeof(int);
    auto kern = warps > 16 ? paged_attention_quant_kernel<T, DPL, PACKED4, 1024>
                           : paged_attention_quant_kernel<T, DPL, PACKED4, 512>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
    float* ws_ml = ws ? ws + (size_t)B * KV * S * G * HD : nullptr;
    kern<<<dim3(B, KV, S), warps * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const uint8_t*>(k_pool),
        static_cast<const uint8_t*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), bt, lengths, out, ws, ws_ml, arrived, KV, G, bs, nb,
        pps, scale, vec);
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED4>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const int* bt, const int* ln, float* out, float* ws, int* arr,
              int B, int KV, int G, int bs, int nb, int pps, float scale, cudaStream_t st) {
    switch (hd) {
        case 64: return launch<T, 2, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, ws, arr, B, KV, G, bs, nb, pps, scale, st);
        case 96: return launch<T, 3, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, ws, arr, B, KV, G, bs, nb, pps, scale, st);
        case 128: return launch<T, 4, PACKED4>(q, kp, vp, ks, vs, bt, ln, out, ws, arr, B, KV, G, bs, nb, pps, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_container(int packed4, int hd, const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const int* bt, const int* ln, float* out,
                     float* ws, int* arr, int B, int KV, int G, int bs, int nb, int pps,
                     float scale, cudaStream_t st) {
    if (packed4)
        return launch_hd<T, true>(hd, q, kp, vp, ks, vs, bt, ln, out, ws, arr, B, KV, G, bs, nb, pps, scale, st);
    return launch_hd<T, false>(hd, q, kp, vp, ks, vs, bt, ln, out, ws, arr, B, KV, G, bs, nb, pps, scale, st);
}

}  // namespace

// dtype (of q): 0 = float32, 1 = bfloat16.  packed4: 0 = int8 codes
// (NB, bs, KV, hd), 1 = nibble-packed uint8 (NB, bs, KV, hd/2).
// q (B, KV, G, hd); scales (NB, bs, KV) f32; block_tables (B, nb) int32;
// lengths (B,) int32; out (B, KV, G, hd) float32; pps: pages per split;
// ws and arrived: the split workspace and the (B, KV) int32 arrival
// counters, zero on entry and left zero (split_kv.cuh), when
// ceil(nb / pps) > 1.
extern "C" int paged_attention_quant_launch(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* block_tables,
                                            const void* lengths, void* out, void* ws,
                                            void* arrived, int dtype, int packed4, int B, int KV,
                                            int G, int hd, int bs, int nb, int pps, float scale,
                                            void* stream) {
    if (B <= 0 || KV <= 0 || G <= 0 || G > 32 * HPW || bs <= 0 || nb <= 0 || pps <= 0 ||
        (dtype != 0 && dtype != 1) || (packed4 != 0 && packed4 != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* bt = static_cast<const int*>(block_tables);
    const int* ln = static_cast<const int*>(lengths);
    float* o = static_cast<float*>(out);
    float* w = static_cast<float*>(ws);
    int* arr = static_cast<int*>(arrived);
    if (dtype == 1)
        return launch_container<__nv_bfloat16>(packed4, hd, q, k_pool, v_pool, k_scale, v_scale,
                                               bt, ln, o, w, arr, B, KV, G, bs, nb, pps, scale, st);
    return launch_container<float>(packed4, hd, q, k_pool, v_pool, k_scale, v_scale, bt, ln, o,
                                   w, arr, B, KV, G, bs, nb, pps, scale, st);
}
