// Device-side pieces shared by the quantized-KV decode kernels
// (paged_attention_quant.cu, fused_decode.cu): the f32 online-softmax
// state of a warp's query heads, and the sweep of one row's quantized
// pages for one KV head.
//
// Layout (as the reference's quantized paged pool): codes (NB, bs, KV, hds)
// as bytes, hds = hd for int8 codes or hd/2 for nibble-packed uint8 (u = c
// + 8, the even head index in the low nibble); scales (NB, bs, KV) f32.
// A code is dequantized in registers as float(code) * scale, one f32
// multiply (__fmul_rn: never contracted into an FMA), which is bitwise
// quant.pack.kv_dequantize.
//
// A CTA owns one (row b, KV head).  Each warp carries up to HPW of the
// head's G query heads, each lane owning DPL = hd/32 dims.  One page's
// codes and scales for this KV head are staged in shared memory with
// 32-bit loads, then every warp reads them from there.  The sweep stops
// at ceil(len/bs) pages and skips the masked tail of the last page, which
// is the -1e30 mask of the reference (a masked score adds exp(-1e30 - m)
// = 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvattn {

constexpr int HPW = 4;          // query heads per warp
constexpr float NEG = -1e30f;   // finite "-inf", as in the reference

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DPL>
struct Heads {
    float q[HPW][DPL], acc[HPW][DPL], m[HPW], l[HPW];
    int n;                        // live heads in this warp (warp-uniform)

    __device__ void init(int g0, int G) {
        n = max(0, min(HPW, G - g0));
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            m[h] = NEG;
            l[h] = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[h][d] = 0.f;
        }
    }

    // fold one key/value token (this lane's dims) into every live head
    __device__ __forceinline__ void fold(const float (&kr)[DPL], const float (&vr)[DPL],
                                         float scale) {
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= n) break;    // warp-uniform
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) s = fmaf(q[h][d], kr[d], s);
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

    // out[g, :] = acc / max(l, 1e-20) for the warp's heads; out points at
    // this (b, kvh)'s (G, hd) slab
    __device__ void store(float* out, int g0, int lane) const {
        constexpr int HD = DPL * 32;
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= n) break;
            const float den = fmaxf(l[h], 1e-20f);
#pragma unroll
            for (int d = 0; d < DPL; ++d)
                out[(size_t)(g0 + h) * HD + lane * DPL + d] = acc[h][d] / den;
        }
    }
};

// shared-memory bytes the sweep stages per page
__host__ __device__ constexpr size_t page_smem_bytes(int bs, int hds) {
    return 2 * (size_t)bs * hds + 2 * (size_t)bs * sizeof(float);
}

// code of head dim idx of one staged token row
template <bool PACKED4>
__device__ __forceinline__ int code_at(const uint8_t* row, int idx) {
    if (PACKED4) {
        const uint32_t byte = row[idx >> 1];
        return (int)((idx & 1) ? (byte >> 4) : (byte & 0xFu)) - 8;
    }
    return (int)(int8_t)row[idx];
}

// Sweep the first len tokens of a row's pages for KV head kvh.  smem holds
// page_smem_bytes(bs, hds) bytes (16-byte aligned).  Every thread of the
// CTA calls this (it synchronises).
template <int DPL, bool PACKED4>
__device__ void sweep_pages(Heads<DPL>& st, const uint8_t* __restrict__ k_pool,
                            const uint8_t* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ bt_row, int len, int KV, int kvh,
                            int bs, float scale, unsigned char* smem) {
    constexpr int HD = DPL * 32;
    constexpr int HDS = PACKED4 ? HD / 2 : HD;
    constexpr int WPR = HDS / 4;            // 32-bit words per token row
    uint32_t* kw = reinterpret_cast<uint32_t*>(smem);
    uint32_t* vw = kw + bs * WPR;
    float* ksc = reinterpret_cast<float*>(vw + bs * WPR);
    float* vsc = ksc + bs;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(kw);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(vw);
    const int lane = threadIdx.x % 32;

    const int nblk = (len + bs - 1) / bs;
    for (int jb = 0; jb < nblk; ++jb) {
        const int phys = bt_row[jb];
        const int ntok = min(bs, len - jb * bs);
        __syncthreads();
        for (int i = threadIdx.x; i < ntok * WPR; i += blockDim.x) {
            const int t = i / WPR, w = i % WPR;
            const size_t row = ((size_t)phys * bs + t) * KV + kvh;
            kw[i] = __ldg(reinterpret_cast<const uint32_t*>(k_pool + row * HDS) + w);
            vw[i] = __ldg(reinterpret_cast<const uint32_t*>(v_pool + row * HDS) + w);
        }
        for (int t = threadIdx.x; t < ntok; t += blockDim.x) {
            const size_t row = ((size_t)phys * bs + t) * KV + kvh;
            ksc[t] = __ldg(k_scale + row);
            vsc[t] = __ldg(v_scale + row);
        }
        __syncthreads();
        for (int t = 0; t < ntok; ++t) {
            float kr[DPL], vr[DPL];
            const float ks = ksc[t], vs = vsc[t];
#pragma unroll
            for (int d = 0; d < DPL; ++d) {
                const int idx = lane * DPL + d;
                kr[d] = __fmul_rn((float)code_at<PACKED4>(kb + t * HDS, idx), ks);
                vr[d] = __fmul_rn((float)code_at<PACKED4>(vb + t * HDS, idx), vs);
            }
            st.fold(kr, vr, scale);
        }
    }
}

}  // namespace kvattn
