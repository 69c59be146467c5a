// Device-side pieces shared by the quantized-KV decode kernels
// (paged_attention_quant.cu, and the attend launch of fused_decode.cu):
// the tiled split-KV sweep of one row's quantized pages for one KV head,
// and the partial it leaves.
//
// Layout (as the reference's quantized paged pool): codes (NB, bs, KV, hds)
// as bytes, hds = hd for int8 codes or hd/2 for nibble-packed uint8 (u = c
// + 8, the even head index in the low nibble); scales (NB, bs, KV) f32.
// A code is dequantized in registers as float(code) * scale, one f32
// multiply (__fmul_rn: never contracted into an FMA), which is bitwise
// quant.pack.kv_dequantize; a dequantized value never reaches device
// memory.
//
// Design (the fp sweep of csrc/paged_attention.cu, over code pages):
//   * A CTA owns one (row b, KV head, split s) and sweeps the live tokens
//     of its split's pages only.  It leaves, per query head, the partial
//     (m, l, acc) of split_kv.cuh; a split past its row's length leaves the
//     empty partial (m = -1e30, l = 0, acc = 0).
//   * Tokens in parallel: 32-token tiles.  Each warp owns HPW = 4 of the
//     G query heads; a CTA has at least MIN_WARPS warps, the rest only
//     staging tiles and sharing the combine, the last CTA's serial tail.  For a tile, lane t dequantizes token t's K codes from
//     shared memory and takes their dot products with the warp's q rows
//     (f32 in shared memory); then one warp max, one warp sum and one
//     correction per head and tile.  P.V follows with lanes over the head
//     dims, each V code dequantized by the lane that uses it.
//   * cp.async double buffering: the next tile's code rows (16-byte
//     pieces, zero-filled past the live tokens) and scales (4-byte pieces:
//     they are strided by KV) go into the second of two shared-memory
//     slots while the current one is used; the first tile is started
//     (sweep_prefetch) before the CTA stages its q.  A staged row is an odd number
//     of 16-byte pieces, so the 8 lanes of a 16-byte shared load hit
//     distinct banks.  A pool whose base is not aligned to the staging
//     piece is staged with byte loads (inside the kernel: not a fallback).
//   * Head dims that are not a multiple of 32 (120, h2o-danube-3-4b's):
//     the sweep computes over HDP = 32 * ceil(hd / 32) dims, so DPL = 4
//     dims per lane at hd 120 and lanes 30-31 hold none.  A code row of
//     120 bytes (int8) or 60 (packed int4) is not a 16-byte multiple, so
//     rows at that stride are only 8- or 4-byte aligned: they are staged
//     in 8- or 4-byte cp.async pieces (Layout::PB), into a staged row of
//     HDP codes whose tail (8 or 4 bytes) is zeroed once, and q is staged
//     as HDP dims with a zero tail.  The tail then adds fmaf(0, 0, s) = s
//     to every score, lanes 30-31 dequantize zero codes in P.V, and
//     nothing past hd is stored.  Head dim 16 (every smoke config) is the
//     same padded form at DPL = 1: HDP = 32, lanes 16-31 hold no dims; a
//     code row of 16 bytes (int8) or 8 (packed int4) is staged in one 16-
//     or 8-byte piece into a staged row of 32 or 16 code bytes whose tail
//     is zeroed once, and each lane dequantizes its one V code alone
//     (lane_dequant's per-code loop: the one-load form needs an even DPL).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_kv.cuh"
#include "wgmma.cuh"

namespace kvattn {

using splitkv::NEG;

constexpr int HPW = 4;          // query heads per warp
constexpr int TILE = 32;        // tokens per tile: one per lane
// warps per CTA at least: past the G heads a warp only stages tiles and
// takes part in the combine, which is a serial tail of the last CTA
constexpr int MIN_WARPS = 8;

// warps of a sweep CTA for G query heads
__host__ __device__ constexpr int sweep_warps(int G) {
    return (G + HPW - 1) / HPW > MIN_WARPS ? (G + HPW - 1) / HPW : MIN_WARPS;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive elements (16-byte aligned) as f32
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

// n (a multiple of 8) elements of T at src into f32 dst (shared memory,
// 16-byte aligned), 16-byte loads where src is aligned; every thread of
// the CTA takes part
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int n) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        for (int i = threadIdx.x; i < n / 8; i += blockDim.x) {
            float v[8];
            load8(src + i * 8, v);
            reinterpret_cast<float4*>(dst)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(dst)[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    } else {
        for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = to_f32(src[i]);
    }
}

// rows x HD elements of T at src into f32 rows of HDP (>= HD) at dst,
// dims HD .. HDP-1 zero; every thread of the CTA takes part
template <int HD, int HDP, typename T>
__device__ __forceinline__ void stage_f32_rows(float* dst, const T* src, int rows) {
    if constexpr (HD == HDP) {
        stage_f32(dst, src, rows * HD);
    } else {
        for (int i = threadIdx.x; i < rows * HDP; i += blockDim.x) {
            const int r = i / HDP, d = i % HDP;
            dst[i] = d < HD ? to_f32(src[r * HD + d]) : 0.f;
        }
    }
}

template <int HD, bool PACKED4>
struct Layout {
    static constexpr int HDP = (HD + 31) / 32 * 32;     // dims computed: whole lanes
    static constexpr int HDS = PACKED4 ? HD / 2 : HD;   // code bytes of a token row in the pool
    static constexpr int HDSP = PACKED4 ? HDP / 2 : HDP;  // ... of a staged row's HDP codes
    // staging piece: the largest of 16, 8, 4 bytes that divides a pool row
    static constexpr int PB = HDS % 16 == 0 ? 16 : HDS % 8 == 0 ? 8 : 4;
    static constexpr int NPB = HDS / PB;                // staging pieces of a row
    static constexpr int PIECES = HDSP / 16;            // 16-byte pieces a fold reads
    static constexpr int CPP = PACKED4 ? 32 : 16;       // codes per 16-byte piece
    static constexpr int ROW = (PIECES | 1) * 16;       // a staged row (bytes)
    static constexpr int CODES = TILE * ROW;            // a tile's K (or V) rows
    // K rows, V rows, then K and V scales
    static constexpr int SLOT = 2 * CODES + 2 * TILE * (int)sizeof(float);
    static_assert(HDS % 4 == 0 && HDSP % 16 == 0, "code rows of 4-byte pieces");
};

// shared-memory bytes of the sweep: two slots, then the warps' tile
// probabilities (warps, HPW, TILE) f32
template <int HD, bool PACKED4>
__host__ __device__ constexpr size_t sweep_smem_bytes(int warps) {
    return 2 * (size_t)Layout<HD, PACKED4>::SLOT + (size_t)warps * HPW * TILE * sizeof(float);
}

// code of head dim idx of a staged token row
template <bool PACKED4>
__device__ __forceinline__ int code_at(const uint8_t* row, int idx) {
    if (PACKED4) {
        const uint32_t byte = row[idx >> 1];
        return (int)((idx & 1) ? (byte >> 4) : (byte & 0xFu)) - 8;
    }
    return (int)(int8_t)row[idx];
}

// code i of a 32-bit word of a row (4 int8 codes or 8 nibbles, low first)
template <bool PACKED4>
__device__ __forceinline__ int word_code(uint32_t w, int i) {
    if (PACKED4) return (int)((w >> (4 * i)) & 0xFu) - 8;
    return (int)(int8_t)(w >> (8 * i));
}

// the CPP codes of one 16-byte piece, dequantized at scale s
template <bool PACKED4>
__device__ __forceinline__ void dequant_piece(const uint8_t* piece, float s,
                                              float (&o)[PACKED4 ? 32 : 16]) {
    constexpr int PER = PACKED4 ? 8 : 4;    // codes per 32-bit word
    const uint4 v = *reinterpret_cast<const uint4*>(piece);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) o[PER * i + j] = __fmul_rn((float)word_code<PACKED4>(w[i], j), s);
}

// this lane's DPL codes (dims lane*DPL ..) of a staged row, dequantized at s
template <int DPL, bool PACKED4>
__device__ __forceinline__ void lane_dequant(const uint8_t* row, int lane, float s,
                                             float (&o)[DPL]) {
    if constexpr (DPL % 2 == 0 && DPL <= 4) {     // the lane's codes in one load
        constexpr int BYTES = PACKED4 ? DPL / 2 : DPL;
        uint32_t w;
        if constexpr (BYTES == 4) w = *reinterpret_cast<const uint32_t*>(row + lane * 4);
        else if constexpr (BYTES == 2) w = *reinterpret_cast<const uint16_t*>(row + lane * 2);
        else w = row[lane];
#pragma unroll
        for (int d = 0; d < DPL; ++d) o[d] = __fmul_rn((float)word_code<PACKED4>(w, d), s);
    } else {
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            o[d] = __fmul_rn((float)code_at<PACKED4>(row, lane * DPL + d), s);
    }
}

// The partial of one warp's heads over a split: running max m, denominator
// l and unnormalized accumulator acc (this lane's DPL dims), all f32.  HD:
// the head dim of the output rows; lanes past it (lane * DPL >= HD) store
// nothing.
template <int DPL, int HD = DPL * 32>
struct Partial {
    float m[HPW], l[HPW], acc[HPW][DPL];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            m[h] = NEG;
            l[h] = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[h][d] = 0.f;
        }
    }

    // Heads g0 .. g0+nh-1 of one (row, KV head): with S == 1 the output
    // acc / max(l, 1e-20) into its (G, hd) slab out, else split s's
    // partial into its workspace slabs acc (S, G, hd) and ml (S, G, 2).
    __device__ __forceinline__ void store(float* out, float* ws_acc, float* ws_ml, int s, int S,
                                          int G, int g0, int nh, int lane) const {
        if (HD != DPL * 32 && lane * DPL >= HD) return;   // a lane with no dims
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= nh) break;                   // warp-uniform
            const int g = g0 + h;
            if (S == 1) {
                const float den = fmaxf(l[h], 1e-20f);
#pragma unroll
                for (int d = 0; d < DPL; ++d) out[(size_t)g * HD + lane * DPL + d] = acc[h][d] / den;
            } else {
#pragma unroll
                for (int d = 0; d < DPL; ++d)
                    ws_acc[((size_t)s * G + g) * HD + lane * DPL + d] = acc[h][d];
                if (lane == 0) {
                    ws_ml[((size_t)s * G + g) * 2] = m[h];
                    ws_ml[((size_t)s * G + g) * 2 + 1] = l[h];
                }
            }
        }
    }
};

// Where a split's pages are: the pool pair, their scales, and the split's
// page ids (pages[j] is the row's page page0 + j, staged in shared memory).
struct Pages {
    const uint8_t* k_pool;
    const uint8_t* v_pool;
    const float* k_scale;
    const float* v_scale;
    const int* pages;
    int page0, KV, kvh, bs;
    bool vec;                   // both pools aligned to the staging piece: cp.async
};

// Zero the bytes HDS .. HDSP-1 of every staged row of both slots (none
// where hd is a multiple of 32): staging never writes them, so once is
// enough.  Every thread of the CTA takes part.
template <int HD, bool PACKED4>
__device__ __forceinline__ void zero_row_tails(uint8_t* smem) {
    using L = Layout<HD, PACKED4>;
    if constexpr (L::HDSP > L::HDS) {
        constexpr int WORDS = (L::HDSP - L::HDS) / 4;
        for (int i = threadIdx.x; i < 2 * 2 * TILE * WORDS; i += blockDim.x) {
            const int row = i / WORDS;            // slot-major: 2 * TILE rows a slot
            uint8_t* dst = smem + (row / (2 * TILE)) * L::SLOT + (row % (2 * TILE)) * L::ROW +
                           L::HDS + (i % WORDS) * 4;
            *reinterpret_cast<uint32_t*>(dst) = 0u;
        }
    }
}

// Stage tokens p0 .. p0+31 (< t_end) of a split into a slot: code rows in
// PB-byte pieces and scales in 4-byte pieces, zero past t_end.
template <int HD, bool PACKED4>
__device__ __forceinline__ void load_tile(uint8_t* slot, const Pages& pg, int p0, int t_end) {
    using L = Layout<HD, PACKED4>;
    for (int i = threadIdx.x; i < 2 * TILE * L::NPB; i += blockDim.x) {
        const int c = i % L::NPB, r = (i / L::NPB) % TILE, which = i / (TILE * L::NPB);
        const int p = p0 + r;
        const bool ok = p < t_end;
        const uint8_t* src = which ? pg.v_pool : pg.k_pool;
        if (ok) {
            const int phys = pg.pages[p / pg.bs - pg.page0];
            src += (((size_t)phys * pg.bs + p % pg.bs) * pg.KV + pg.kvh) * L::HDS + c * L::PB;
        }
        uint8_t* dst = slot + (which * TILE + r) * L::ROW + c * L::PB;
        if (pg.vec) {
            if constexpr (L::PB == 16) wg::cp_async16(dst, src, ok);
            else if constexpr (L::PB == 8) wg::cp_async8(dst, src, ok);
            else wg::cp_async4(dst, src, ok);
        } else {
#pragma unroll
            for (int e = 0; e < L::PB; ++e) dst[e] = ok ? src[e] : 0;
        }
    }
    float* sc = reinterpret_cast<float*>(slot + 2 * L::CODES);
    for (int i = threadIdx.x; i < 2 * TILE; i += blockDim.x) {
        const int r = i % TILE, which = i / TILE;
        const int p = p0 + r;
        const bool ok = p < t_end;
        const float* src = which ? pg.v_scale : pg.k_scale;
        if (ok) src += ((size_t)pg.pages[p / pg.bs - pg.page0] * pg.bs + p % pg.bs) * pg.KV + pg.kvh;
        wg::cp_async4(sc + i, src, ok);
    }
}

// Fold one staged tile of ntok tokens into this warp's nh (> 0) heads: qw
// the warp's q rows (HDP f32 each, shared), pw its (HPW, TILE)
// probabilities.
template <int DPL, bool PACKED4, int HD>
__device__ __forceinline__ void fold_tile(Partial<DPL, HD>& st, const float* qw,
                                          const uint8_t* slot, int ntok, float scale, int nh,
                                          float* pw, int lane) {
    using L = Layout<HD, PACKED4>;
    static_assert(L::HDP == DPL * 32, "DPL dims per lane over the padded head dim");
    const float* ksc = reinterpret_cast<const float*>(slot + 2 * L::CODES);
    const float* vsc = ksc + TILE;
    const bool live = lane < ntok;

    // scores of token `lane` for the warp's heads
    float sc[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) sc[h] = 0.f;
    const uint8_t* krow = slot + lane * L::ROW;
    const float ks = ksc[lane];
#pragma unroll 2
    for (int c = 0; c < L::PIECES; ++c) {
        float kr[L::CPP];
        dequant_piece<PACKED4>(krow + c * 16, ks, kr);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= nh) break;                       // warp-uniform
            const float* qh = qw + h * L::HDP + c * L::CPP;
#pragma unroll
            for (int e = 0; e < L::CPP; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qh + e);
                sc[h] = fmaf(q4.x, kr[e], sc[h]);
                sc[h] = fmaf(q4.y, kr[e + 1], sc[h]);
                sc[h] = fmaf(q4.z, kr[e + 2], sc[h]);
                sc[h] = fmaf(q4.w, kr[e + 3], sc[h]);
            }
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
        const float mn = fmaxf(st.m[h], mt);
        corr[h] = expf(st.m[h] - mn);
        const float p = live ? expf(sv - mn) : 0.f;
        float ls = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
        st.l[h] = st.l[h] * corr[h] + ls;
        st.m[h] = mn;
        pw[h * TILE + lane] = p;
    }
    __syncwarp();

    // P.V with lanes over the head dims, each V code dequantized here
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
        for (int d = 0; d < DPL; ++d) st.acc[h][d] *= corr[h];
    const uint8_t* vt = slot + L::CODES;
    for (int t = 0; t < ntok; ++t) {
        float vr[DPL];
        lane_dequant<DPL, PACKED4>(vt + t * L::ROW, lane, vsc[t], vr);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= nh) break;
            const float p = pw[h * TILE + t];
#pragma unroll
            for (int d = 0; d < DPL; ++d) st.acc[h][d] = fmaf(p, vr[d], st.acc[h][d]);
        }
    }
}

// Start staging a split's first tile (tokens [t_begin, t_end) of the row)
// into the first slot of smem, after zeroing the staged rows' tails;
// sweep() waits for it.  Every thread calls this, after the split's page
// ids are in shared memory and visible.
template <int DPL, bool PACKED4, int HD = DPL * 32>
__device__ __forceinline__ void sweep_prefetch(const Pages& pg, int t_begin, int t_end,
                                               uint8_t* smem) {
    zero_row_tails<HD, PACKED4>(smem);
    if (t_end > t_begin) load_tile<HD, PACKED4>(smem, pg, t_begin, t_end);
    wg::cp_async_commit();
}

// Fold tokens [t_begin, t_end) of a row into this warp's partial, after
// sweep_prefetch of the same range.  qs: the CTA's (G, HDP) q rows as f32
// in shared memory, dims past hd zero; smem: sweep_smem_bytes (16-byte
// aligned).  nh: live heads of this warp (warp-uniform; a warp past the G
// heads only stages tiles).  Every thread of the CTA calls this (it
// synchronises); the tile count is uniform per CTA.
template <int DPL, bool PACKED4, int HD = DPL * 32>
__device__ void sweep(Partial<DPL, HD>& st, const float* qs, const Pages& pg, int t_begin,
                      int t_end, float scale, int nh, uint8_t* smem) {
    using L = Layout<HD, PACKED4>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* pw = reinterpret_cast<float*>(smem + 2 * L::SLOT) + warp * HPW * TILE;
    const int ntiles = t_end > t_begin ? (t_end - t_begin + TILE - 1) / TILE : 0;
    for (int it = 0; it < ntiles; ++it) {
        const int p0 = t_begin + it * TILE;
        if (it + 1 < ntiles)
            load_tile<HD, PACKED4>(smem + ((it + 1) & 1) * L::SLOT, pg, p0 + TILE, t_end);
        wg::cp_async_commit();
        wg::cp_async_wait<1>();
        __syncthreads();
        if (nh > 0)
            fold_tile<DPL, PACKED4, HD>(st, qs + warp * HPW * L::HDP, smem + (it & 1) * L::SLOT,
                                        min(TILE, t_end - p0), scale, nh, pw, lane);
        __syncthreads();       // the slot is refilled two tiles on
    }
}

}  // namespace kvattn
