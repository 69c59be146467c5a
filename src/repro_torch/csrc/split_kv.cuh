// Split-KV decode attention: the partial state of one split and the
// combine, shared by the paged decode attention kernels.
//
// A split of a row's tokens leaves, per query head g, its running max
// m_s[g], its denominator l_s[g] = sum_t e^{s_t - m_s} and its
// unnormalized accumulator acc_s[g, :] = sum_t e^{s_t - m_s} v_t (all f32).
// A split with no live token leaves m = -1e30, l = 0, acc = 0.  The
// combine takes, in fixed split order,
//   m = max_s m_s,  l = sum_s l_s e^{m_s - m},
//   out = sum_s acc_s e^{m_s - m} / max(l, 1e-20),
// so a row of length 0 (every split empty) gives exact zeros and two
// calls give bitwise-equal outputs.  The last split CTA of a (row, KV
// head) to finish does the combine (arrive_last), so a call is one launch.
//
// Workspace layout for B rows x KV heads x S splits x G heads x hd dims:
// acc (B, KV, S, G, hd) f32, then ml (B, KV, S, G, 2) f32 as (m, l); and
// one int32 arrival counter per (row, KV head), zero between launches.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splitkv {

constexpr float NEG = -1e30f;   // finite "-inf", as in the reference

constexpr int MAX_SPLITS = 16;

// out (G, hd) of one (row, KV head) from its S <= MAX_SPLITS partials:
// acc (S, G, hd), ml (S, G, 2), written by other CTAs of this launch (read
// through L2; hd % 4 == 0, 16-byte aligned).  sw: shared scratch of (S +
// 1) * G floats.  Every thread of the block takes part.  The per-head
// weights e^{m_s - m} and the denominator are formed once; then each
// thread takes 4 dims of an output row, with all S partial loads issued
// before the sum (taken in split order).
__device__ inline void combine(const float* acc, const float* ml, float* __restrict__ out, int S,
                               int G, int hd, float* sw) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        float ms[MAX_SPLITS], ls[MAX_SPLITS];
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
            ms[s] = s < S ? __ldcg(ml + (s * G + g) * 2) : NEG;
            ls[s] = s < S ? __ldcg(ml + (s * G + g) * 2 + 1) : 0.f;
        }
        float m = NEG;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < S) m = fmaxf(m, ms[s]);
        float l = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
            if (s < S) {
                const float w = expf(ms[s] - m);
                l += ls[s] * w;
                sw[s * G + g] = w;
            }
        }
        sw[S * G + g] = fmaxf(l, 1e-20f);
    }
    __syncthreads();
    const float4* acc4 = reinterpret_cast<const float4*>(acc);
    const int q4 = hd / 4;
    for (int i = threadIdx.x; i < G * q4; i += blockDim.x) {
        const int g = i / q4;
        float4 v[MAX_SPLITS];
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            v[s] = s < S ? __ldcg(acc4 + (size_t)s * G * q4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
            if (s < S) {
                const float w = sw[s * G + g];
                o.x += v[s].x * w;
                o.y += v[s].y * w;
                o.z += v[s].z * w;
                o.w += v[s].w * w;
            }
        }
        const float den = sw[S * G + g];
        reinterpret_cast<float4*>(out)[i] =
            make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
    }
}

// Called by every thread of a split's CTA once its partial is written:
// true in the last of the S CTAs of its (row, KV head) to arrive, which
// then combines.  counter is zero on entry and left zero.
__device__ inline bool arrive_last(int* counter, int S) {
    __shared__ int last;
    __syncthreads();                 // the CTA's partial is written ...
    if (threadIdx.x == 0) {
        __threadfence();             // ... and visible device-wide before the arrival
        last = atomicAdd(counter, 1) == S - 1;
        if (last) *counter = 0;      // every other CTA has arrived
        __threadfence();
    }
    __syncthreads();
    return last;
}

}  // namespace splitkv
