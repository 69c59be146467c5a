// Paged decode attention over fp KV blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_attn_kernel, paged_attention.py:37).  Same function as
// kernels/ref.py::paged_attention_ref on live rows: one decode query per
// row, GQA grouped as (KV, G, hd), attending over the row's pages of an
// (NB, bs, KV, hd) pool through its (B, nb) block table, f32 softmax
// masked at pos < lengths[b], out = acc / max(l, 1e-20).  A row of length
// 0 returns exact zeros (the Pallas kernel's contract).
//
// What bounds it on the H100: device-memory bytes -- each live K/V token
// is read once and used for 4*G*hd flops per KV head, far below the
// ridge -- and, at decode's few hundred tokens, latency: the whole call
// is a few microseconds of bytes.  On the TPU the block table was the
// BlockSpec index map (scalar-prefetched) and the grid walked one row's
// pages in order; here each CTA reads block_tables[b, j] itself.  Design:
//   * Split-KV: grid (B, KV, S), S = ceil(nb / pages_per_split) from the
//     block table's width alone (kernels/paged_attention.py::split_plan;
//     the host never reads lengths).  Each CTA sweeps its split's live
//     tokens; a split past its row's length writes an empty partial.
//     With S > 1 the last split CTA of a (row, KV head) to finish merges
//     the partials in split order (csrc/split_kv.cuh): one launch, and
//     outputs that are bitwise repeatable.
//   * Tokens in parallel: 32-token tiles.  Each warp owns 4 of the G
//     query heads; for a tile, lane t computes token t's scores for the
//     warp's heads (f32 FMAs over hd, q in shared memory as f32), one warp
//     max and one warp sum per head and tile (not per token), then P.V
//     with lanes over the head dims, in f32.
//   * The next tile's K and V rows are prefetched with cp.async (16-byte
//     pieces, zero-filled past the live tokens) into the second of two
//     shared-memory slots while the current one is used; rows are padded
//     by 16 bytes so a warp reading 32 token rows hits distinct banks.
//     A pool whose base is not 16-byte aligned is staged with plain loads.
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernels
// allocate nothing (the wrapper passes the split workspace); the entry
// point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_kv.cuh"
#include "wgmma.cuh"

namespace {

using splitkv::NEG;

constexpr int HPW = 4;          // query heads per warp
constexpr int TILE = 32;        // tokens per tile: one per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive elements (16-byte aligned, shared or global memory) as f32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

template <typename T, int HD>
struct Layout {
    static constexpr int ROW = HD * (int)sizeof(T) + 16;   // padded staged row (bytes)
    static constexpr int PIECES = HD * (int)sizeof(T) / 16;
    static constexpr int SLOT = 2 * TILE * ROW;            // K rows, then V rows
};

// Stage tokens p0 .. p0+31 (< t_end) of row b, KV head kvh, into a slot.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint8_t* slot, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int* __restrict__ bt_row, int p0, int t_end,
                                          int KV, int kvh, int bs, bool vec) {
    using L = Layout<T, HD>;
    for (int i = threadIdx.x; i < 2 * TILE * L::PIECES; i += blockDim.x) {
        const int c = i % L::PIECES, r = (i / L::PIECES) % TILE, which = i / (TILE * L::PIECES);
        const int p = p0 + r;
        const bool ok = p < t_end;
        const T* pool = which ? v_pool : k_pool;
        const T* src = pool;
        if (ok) {
            const int phys = bt_row[p / bs];
            src = pool + (((size_t)phys * bs + p % bs) * KV + kvh) * HD + c * (16 / sizeof(T));
        }
        uint8_t* dst = slot + (which * TILE + r) * L::ROW + c * 16;
        if (vec) {
            wg::cp_async16(dst, src, ok);
        } else {
            T* d = reinterpret_cast<T*>(dst);
#pragma unroll
            for (int e = 0; e < (int)(16 / sizeof(T)); ++e) d[e] = ok ? src[e] : T(0.f);
        }
    }
}

// One CTA per (row b, KV head, split s).  ws_acc / ws_ml take the
// partial when S > 1; with S == 1 the CTA writes out itself.  MAXT: the
// most threads a launch uses (1024 above 64 query heads caps registers).
template <typename T, int DPL, int MAXT>
__global__ void __launch_bounds__(MAXT) paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ block_tables,
                                       const int* __restrict__ lengths, float* __restrict__ out,
                                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                                       int* __restrict__ arrived, int KV, int G, int bs, int nb,
                                       int pps, float scale, int vec) {
    constexpr int HD = DPL * 32;
    using L = Layout<T, HD>;
    extern __shared__ __align__(16) uint8_t smem[];
    float* qs = reinterpret_cast<float*>(smem);                    // (G, HD) f32
    uint8_t* slots = smem + (size_t)G * HD * sizeof(float);        // 2 slots
    float* ps = reinterpret_cast<float*>(slots + 2 * L::SLOT);     // (warps, HPW, TILE)
    int* pages = reinterpret_cast<int*>(ps + blockDim.x / 32 * HPW * TILE);  // this split's

    const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z, S = gridDim.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t bk = (size_t)b * KV + kvh;
    // q, widened to f32 once (it does not wait on the row's length)
    const T* qrow = q + bk * G * HD;
    if (reinterpret_cast<uintptr_t>(q) % 16 == 0) {
        for (int i = threadIdx.x; i < G * HD / 8; i += blockDim.x) {
            float v[8];
            load8(qrow + i * 8, v);
            reinterpret_cast<float4*>(qs)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(qs)[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    } else {
        for (int i = threadIdx.x; i < G * HD; i += blockDim.x) qs[i] = to_f32(qrow[i]);
    }
    // the split's page ids, read with q and the length (not after it)
    for (int j = threadIdx.x; j < pps; j += blockDim.x)
        pages[j] = s * pps + j < nb ? block_tables[(size_t)b * nb + s * pps + j] : 0;
    const int len = min(max(lengths[b], 0), nb * bs);
    const int t_begin = s * pps * bs, t_end = min(len, (s + 1) * pps * bs);
    const int nh = max(0, min(HPW, G - warp * HPW));   // live heads of this warp

    float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
        m[h] = NEG;
        l[h] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[h][d] = 0.f;
    }
    float* pw = ps + warp * HPW * TILE;
    const int* bt_row = pages - s * pps;        // indexed by the row's page number
    __syncthreads();
    // nothing live in this split (uniform per CTA): the empty partial
    const int ntiles = t_end > t_begin ? (t_end - t_begin + TILE - 1) / TILE : 0;
    if (ntiles > 0)
        load_tile<T, HD>(slots, k_pool, v_pool, bt_row, t_begin, t_end, KV, kvh, bs, vec);
    wg::cp_async_commit();

    for (int it = 0; it < ntiles; ++it) {
        const int p0 = t_begin + it * TILE;
        if (it + 1 < ntiles)
            load_tile<T, HD>(slots + ((it + 1) & 1) * L::SLOT, k_pool, v_pool, bt_row,
                             p0 + TILE, t_end, KV, kvh, bs, vec);
        wg::cp_async_commit();
        wg::cp_async_wait<1>();
        __syncthreads();
        const uint8_t* slot = slots + (it & 1) * L::SLOT;
        const T* vt = reinterpret_cast<const T*>(slot + TILE * L::ROW);
        const int ntok = min(TILE, t_end - p0);
        const bool live = lane < ntok;

        // scores of token `lane` for the warp's heads
        float sc[HPW];
#pragma unroll
        for (int h = 0; h < HPW; ++h) sc[h] = 0.f;
        const T* krow = reinterpret_cast<const T*>(slot + lane * L::ROW);
#pragma unroll 4
        for (int d0 = 0; d0 < HD; d0 += 8) {
            float kr[8];
            load8(krow + d0, kr);
#pragma unroll
            for (int h = 0; h < HPW; ++h) {
                if (h >= nh) break;                       // warp-uniform
                float qr[8];
                load8(qs + (warp * HPW + h) * HD + d0, qr);
#pragma unroll
                for (int e = 0; e < 8; ++e) sc[h] = fmaf(qr[e], kr[e], sc[h]);
            }
        }
        float corr[HPW];
#pragma unroll
        for (int h = 0; h < HPW; ++h) corr[h] = 1.f;
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= nh) break;
            const float sv = live ? sc[h] * scale : NEG;
            float mt = sv;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
            const float mn = fmaxf(m[h], mt);
            corr[h] = expf(m[h] - mn);
            const float p = live ? expf(sv - mn) : 0.f;
            float ls = p;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
            l[h] = l[h] * corr[h] + ls;
            m[h] = mn;
            pw[h * TILE + lane] = p;
        }
        __syncwarp();

        // P.V with lanes over the head dims, in f32
#pragma unroll
        for (int h = 0; h < HPW; ++h)
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[h][d] *= corr[h];
        for (int t = 0; t < ntok; ++t) {
            float vr[DPL];
#pragma unroll
            for (int d = 0; d < DPL; ++d) vr[d] = to_f32(vt[t * (L::ROW / sizeof(T)) + lane * DPL + d]);
#pragma unroll
            for (int h = 0; h < HPW; ++h) {
                if (h >= nh) break;
                const float p = pw[h * TILE + t];
#pragma unroll
                for (int d = 0; d < DPL; ++d) acc[h][d] = fmaf(p, vr[d], acc[h][d]);
            }
        }
        __syncthreads();       // the slot is refilled two tiles on
    }

#pragma unroll
    for (int h = 0; h < HPW; ++h) {
        if (h >= nh) break;
        const int g = warp * HPW + h;
        if (S == 1) {
            const float den = fmaxf(l[h], 1e-20f);
#pragma unroll
            for (int d = 0; d < DPL; ++d)
                out[(bk * G + g) * HD + lane * DPL + d] = acc[h][d] / den;
        } else {
#pragma unroll
            for (int d = 0; d < DPL; ++d)
                ws_acc[((bk * S + s) * G + g) * HD + lane * DPL + d] = acc[h][d];
            if (lane == 0) {
                ws_ml[((bk * S + s) * G + g) * 2] = m[h];
                ws_ml[((bk * S + s) * G + g) * 2 + 1] = l[h];
            }
        }
    }
    if (S > 1 && splitkv::arrive_last(arrived + bk, S))
        splitkv::combine(ws_acc + bk * S * G * HD, ws_ml + bk * S * G * 2, out + bk * G * HD, S,
                         G, HD, reinterpret_cast<float*>(slots));
}

template <typename T, int DPL>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
           const int* lengths, float* out, float* ws, int* arrived, int B, int KV, int G, int bs,
           int nb, int pps, float scale, cudaStream_t st) {
    constexpr int HD = DPL * 32;
    const int warps = (G + HPW - 1) / HPW;
    const int S = (nb + pps - 1) / pps;
    if (S > splitkv::MAX_SPLITS || (S > 1 && (ws == nullptr || arrived == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)G * HD * sizeof(float) + 2 * Layout<T, HD>::SLOT +
                        (size_t)warps * HPW * TILE * sizeof(float) + (size_t)pps * sizeof(int);
    auto kern = warps > 16 ? paged_attention_kernel<T, DPL, 1024> : paged_attention_kernel<T, DPL, 512>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
    float* ws_acc = ws;
    float* ws_ml = ws ? ws + (size_t)B * KV * S * G * HD : nullptr;
    kern<<<dim3(B, KV, S), warps * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        bt, lengths, out, ws_acc, ws_ml, arrived, KV, G, bs, nb, pps, scale, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k_pool, const void* v_pool, const int* bt,
              const int* lengths, float* out, float* ws, int* arrived, int B, int KV, int G,
              int bs, int nb, int pps, float scale, cudaStream_t st) {
    switch (hd) {
        case 64: return launch<T, 2>(q, k_pool, v_pool, bt, lengths, out, ws, arrived, B, KV, G, bs, nb, pps, scale, st);
        case 96: return launch<T, 3>(q, k_pool, v_pool, bt, lengths, out, ws, arrived, B, KV, G, bs, nb, pps, scale, st);
        case 128: return launch<T, 4>(q, k_pool, v_pool, bt, lengths, out, ws, arrived, B, KV, G, bs, nb, pps, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype (of q and both pools): 0 = float32, 1 = bfloat16.
// q (B, KV, G, hd); pools (NB, bs, KV, hd); block_tables (B, nb) int32;
// lengths (B,) int32; out (B, KV, G, hd) float32; pps: pages per split;
// ws and arrived: the split workspace and the (B, KV) int32 arrival
// counters, zero on entry and left zero (split_kv.cuh), when
// ceil(nb / pps) > 1.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* lengths, void* out,
                                      void* ws, void* arrived, int dtype, int B, int KV, int G,
                                      int hd, int bs, int nb, int pps, float scale,
                                      void* stream) {
    if (B <= 0 || KV <= 0 || G <= 0 || G > 32 * HPW || bs <= 0 || nb <= 0 || pps <= 0 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* bt = static_cast<const int*>(block_tables);
    const int* ln = static_cast<const int*>(lengths);
    float* o = static_cast<float*>(out);
    float* w = static_cast<float*>(ws);
    int* arr = static_cast<int*>(arrived);
    if (dtype == 1)
        return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, bt, ln, o, w, arr, B, KV, G, bs, nb, pps, scale, st);
    return launch_hd<float>(hd, q, k_pool, v_pool, bt, ln, o, w, arr, B, KV, G, bs, nb, pps, scale, st);
}
