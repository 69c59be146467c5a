// Packed low-bit weight x activation matmul (qmm) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/qmm.py::qmm_pallas, both of
// its bodies:
//   _qmm_bitserial_kernel (qmm.py:78)  -> bitserial.cuh, tagged qmm_bitserial
//   _qmm_dequant_kernel   (qmm.py:57)  -> qmm_dequant_tc_kernel below (bf16 x)
// Both compute the function of kernels/ref.py::qmm_ref:
//   y[M,N] = x[M,K] @ ((u - n) / n * scale),  u = sum_b 2^b plane_b,
//   n = 2^(bits-1) - 1,
// with the planes stored as (bits, K/8, N) uint8: byte [b, j, col] holds
// bit b of rows 8j..8j+7 (row 8j+i in bit i), N minor-most.  Every
// product is exact in f32 (bf16 x times an integer code); only the order
// of the f32 sum differs from the plain version.
//
// bitserial (M <= 32, decode): GEMV-shaped and bound by the bytes of the
// planes: csrc/bitserial.cuh with one matrix (the same body computes the
// fused decode's q|k|v projections).  bf16 x takes its tensor-core body
// (mma.sync) over the grid of kernels/qmm.py::bitserial_plan: column tiles
// x K splits, the splits of a tile one cluster that sums them in split
// order (one launch, bitwise repeatable); f32 x its SIMT body, unsplit.
//
// dequant, bf16 x (M > 32, every prefill chunk): what bounds it.  A
// 64-token chunk does 2*64 flops per weight over bits/8 bytes per weight:
// ~32 flop/byte at 4 bits, under the card's ~295 flop/byte bf16 ridge, so
// the floor is the planes' bytes (1.40 ms for glm4-9b's 280 layer calls);
// but the same flops in f32 FMAs alone take 15.6 ms, so the products must
// run on the tensor cores, and what is left to bound it is rebuilding the
// codes in registers (integer work per weight) and the loads.  Design:
//   * wgmma m64nNk16, bf16 x bf16 -> f32, with the operands swapped:
//     y^T = W^T x^T.  A 64-column weight tile is wgmma's A (64 rows = 64
//     output columns), built in registers straight from the plane bytes;
//     the x tile (N = 64 or 256 tokens x 64 K, K-major, 128-byte swizzle)
//     is B in shared memory.  Codes u - n lie in [-127, 128]: exact in bf16.
//     Chosen over writing a bf16 code tile to shared memory: no extra
//     shared-memory round trip, and the x tile is what the card's
//     descriptor layout wants as it is stored (K contiguous per token).
//   * A's rows are permuted so that a thread's two rows (g, g + 8 of its
//     warp's 16) are neighbouring columns 2g, 2g + 1: one 16-bit load per
//     plane and byte row gives a thread both columns, and the bits of its
//     four K positions {2t, 2t+1, 2t+8, 2t+9} of a k16 step sit in byte
//     rows j, j + 1 at one shift, so one 32-bit word carries four
//     (column, byte row) pairs through the bit gather (2 shift/mask-or per
//     plane for 8 weights).  Codes become bf16 pairs by a byte permute,
//     one mask-and-OR with the bits of bf16 128 and one bf16x2 subtract of
//     128 + n (bits <= 7; 8 bits goes through f32).
//   * cp.async (16-byte pieces, zero-filled past the ragged K, N and M
//     edges) into a 5-slot ring per warpgroup: three 64-deep K steps load
//     while one is decoded and the one before it is still in the tensor
//     cores (wgmma.wait_group 1; the A fragments are double-buffered).
//     cp.async, not TMA: the plane rows are N bytes long, which breaks
//     TMA's 16-byte stride rule at N % 16 != 0, and one path for both
//     operands keeps the body simple; N % 16 != 0 loads the planes with
//     plain loads instead.  The ring is addressed from the shared array
//     itself, so the fragment loads stay shared-memory loads (LDS).
//   * What the chip shows (PERF.md): at wg's shape the loads alone take
//     ~60 % of a call (the x tile, re-read for every 64 columns, is most
//     of the bytes), the decode alone ~70 % (latency-bound integer
//     chains) and the wgmma loop alone ~35 %.  So
//     a CTA holds two warpgroups that share out its K steps (each with its
//     own ring and named barrier, their sums added in order through shared
//     memory), and a deterministic split-K (the plan is
//     kernels/qmm.py::dequant_plan) gives every glm4-9b shape at M = 64 at
//     least one CTA per SM; splits write f32 partials to a workspace and
//     qmm_splitk_combine sums them in split order (no float atomics: two
//     calls give bitwise-equal outputs), then applies / n * scale once.
//   * Up to 128 rows take 64-token tiles, more rows 256-token tiles (grid
//     z): two tile widths keep the build to 14 instances of the body.
// dequant, f32 x: a bf16 x would round each element, so f32 activations
// keep the f32 SIMT body (qmm_dequant_simt_kernel: 64x128 output tile per
// block, f32 FMAs).  The C entry point routes by x's dtype; the served
// path passes bf16.
//
// Plain C interface (built with nvcc, loaded with ctypes).  Kernels
// allocate nothing (the wrapper passes the split-K workspace); the entry
// point returns cudaGetLastError().

#include "bitserial.cuh"
#include "wgmma.cuh"

namespace {

using bitserial::to_f32;

struct qmm_bitserial;   // names the bit-serial kernel's instances

// ------------------------------------------------- dequant, f32 x (SIMT)
constexpr int DQ_THREADS = 256;
constexpr int DQ_BM = 64, DQ_BN = 128, DQ_BK = 32;  // DQ_BK = 4 packed byte rows
constexpr int DQ_TM = 8, DQ_TN = 4;                 // per-thread output tile
constexpr int DQ_PAD = 4;

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
qmm_dequant_simt_kernel(const T* __restrict__ x, const uint8_t* __restrict__ planes,
                        const float* __restrict__ scale, float* __restrict__ y,
                        int M, int K, int N, int bits) {
    __shared__ __align__(16) float As[DQ_BK][DQ_BM + DQ_PAD];
    __shared__ __align__(16) float Bs[DQ_BK][DQ_BN];

    const int tid = threadIdx.x;
    const int tx = tid % (DQ_BN / DQ_TN);   // 0..31: columns tx*4..+3
    const int ty = tid / (DQ_BN / DQ_TN);   // 0..7:  rows ty*8..+7
    const int m0 = blockIdx.y * DQ_BM, n0 = blockIdx.x * DQ_BN;
    const int K8 = K / 8;
    const int nli = bits > 1 ? (1 << (bits - 1)) - 1 : 1;

    float acc[DQ_TM][DQ_TN];
#pragma unroll
    for (int i = 0; i < DQ_TM; ++i)
#pragma unroll
        for (int j = 0; j < DQ_TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += DQ_BK) {
        for (int i = tid; i < DQ_BM * DQ_BK; i += DQ_THREADS) {
            const int m = i / DQ_BK, kk = i % DQ_BK;
            const int gm = m0 + m, gk = k0 + kk;
            As[kk][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
        }
        for (int e = tid; e < (DQ_BK / 8) * DQ_BN; e += DQ_THREADS) {
            const int kr = e / DQ_BN, c = e % DQ_BN;
            const int j = k0 / 8 + kr, gn = n0 + c;
            uint32_t u[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) u[i] = 0u;
            const bool ok = j < K8 && gn < N;
            if (ok) {
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    if (b < bits) {
                        const uint32_t byte = __ldg(planes + ((size_t)b * K8 + j) * N + gn);
#pragma unroll
                        for (int i = 0; i < 8; ++i) u[i] |= ((byte >> i) & 1u) << b;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
                Bs[kr * 8 + i][c] = ok ? (float)((int)u[i] - nli) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < DQ_BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * DQ_TM]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * DQ_TM + 4]);
            const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * DQ_TN]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
            for (int i = 0; i < DQ_TM; ++i)
#pragma unroll
                for (int j = 0; j < DQ_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    const float nl = (float)nli;
#pragma unroll
    for (int i = 0; i < DQ_TM; ++i) {
        const int gm = m0 + ty * DQ_TM + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < DQ_TN; ++j) {
            const int gn = n0 + tx * DQ_TN + j;
            if (gn < N) y[(size_t)gm * N + gn] = acc[i][j] / nl * scale[gn];
        }
    }
}

// --------------------------------------------- dequant, bf16 x (wgmma)
constexpr int TC_BN = 64;        // weight columns per CTA: wgmma's M
constexpr int TC_BK = 64;        // K per stage: one 128-byte swizzle row of bf16
constexpr int TC_STAGES = 5;     // per warpgroup: 3 K steps loading, 1 decoded, 1 in the tensor cores

// One ring slot: the x tile (NT tokens x 64 K, 128-byte swizzled), then
// the plane tile [bit][byte row][column], padded so the next slot's x
// tile stays 1024-byte aligned.  Each warpgroup of a CTA owns a ring.
template <int NT, int BITS>
struct TcSmem {
    static constexpr int X_BYTES = NT * TC_BK * 2;                  // multiple of 1024
    static constexpr int SLOT = X_BYTES + (BITS * (TC_BK / 8) * TC_BN + 1023) / 1024 * 1024;
    static constexpr int RING = TC_STAGES * SLOT;
    static constexpr int total(int kg) { return kg * RING + 1024; } // + alignment slack
};

struct TcArgs {
    const __nv_bfloat16* x;
    const uint8_t* planes;
    int M, K, N, m0, n0, vec_planes;
};

__device__ __forceinline__ void wg_sync(int id) {   // named barrier of one warpgroup
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Stage K step `chunk` (64 K) of the x rows m0.. and plane columns n0..
// n0+63 into one ring slot, the 128 threads of one warpgroup (index r128)
// taking part.  Pieces past M, K or N are zero-filled.
template <int NT, int BITS>
__device__ __forceinline__ void tc_load(uint8_t* slot, const TcArgs& g, int chunk, int r128) {
    const int k0 = chunk * TC_BK;
#pragma unroll
    for (int i = r128; i < NT * 8; i += 128) {                   // x: 8 pieces per token row
        const int r = i >> 3, c = i & 7;
        const int gm = g.m0 + r, gk = k0 + c * 8;
        const bool ok = gm < g.M && gk < g.K;
        wg::cp_async16(slot + r * 128 + ((c ^ (r & 7)) << 4),
                       ok ? g.x + (size_t)gm * g.K + gk : g.x, ok);
    }
    uint8_t* ps = slot + TcSmem<NT, BITS>::X_BYTES;
    const int K8 = g.K / 8, j0 = chunk * (TC_BK / 8);
    if (g.vec_planes) {                                          // N % 16 == 0
        for (int i = r128; i < BITS * 8 * 4; i += 128) {
            const int c = i & 3, r = (i >> 2) & 7, b = i >> 5;
            const int j = j0 + r, gn = g.n0 + c * 16;
            const bool ok = j < K8 && gn < g.N;
            wg::cp_async16(ps + (b * 8 + r) * TC_BN + c * 16,
                           ok ? g.planes + ((size_t)b * K8 + j) * g.N + gn : g.planes, ok);
        }
    } else {                                                     // rows not 16-byte aligned
        for (int i = r128; i < BITS * 8 * TC_BN; i += 128) {
            const int c = i & (TC_BN - 1), r = (i >> 6) & 7, b = i >> 9;
            const int j = j0 + r, gn = g.n0 + c;
            ps[(b * 8 + r) * TC_BN + c] =
                (j < K8 && gn < g.N) ? __ldg(g.planes + ((size_t)b * K8 + j) * g.N + gn)
                                     : (uint8_t)0;
        }
    }
}

// A fragment (4 x bf16x2) of k16 step kk of a staged plane tile ps for
// this thread: rows g, g + 8 of its warp's 16 are weight columns col,
// col + 1; K positions 2t, 2t+1 (byte row 2kk) and 2t+8, 2t+9 (byte row
// 2kk + 1), at bit shift sh = 2t.
template <int BITS>
__device__ __forceinline__ void tc_frag(uint32_t (&a)[4], const uint8_t* ps, int kk, int col,
                                        int sh) {
    // lo / hi: byte q holds u at bit 2t / 2t+1 of (row 2kk, col), (row 2kk,
    // col+1), (row 2kk+1, col), (row 2kk+1, col+1) for q = 0..3
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
        const uint8_t* p = ps + (b * 8 + 2 * kk) * TC_BN + col;
        const uint32_t h0 = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t h1 = *reinterpret_cast<const uint16_t*>(p + TC_BN);
        const uint32_t w = __byte_perm(h0, h1, 0x5410) >> sh;
        lo |= (w << b) & (0x01010101u << b);
        hi |= (b ? (w << (b - 1)) : (w >> 1)) & (0x01010101u << b);
    }
    constexpr int NL = (1 << (BITS - 1)) - 1;
    if constexpr (BITS <= 7) {
        // u < 128: bf16 bits 0x43uu are 128 + u exactly; subtract 128 + n
        const __nv_bfloat162 off = __floats2bfloat162_rn(128.f + NL, 128.f + NL);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            // [lo.q, -, hi.q, -], the odd bytes replaced by bf16 128's high byte
            const uint32_t v = (__byte_perm(lo, hi, q | ((4 + q) << 8)) & 0x00FF00FFu) | 0x43004300u;
            __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&v);
            c = __hsub2(c, off);
            a[q] = *reinterpret_cast<const uint32_t*>(&c);
        }
    } else {
        // u < 256: f32 bits 0x4B0000uu are 2^23 + u exactly; subtract 2^23 + n
        constexpr float OFF = 8388608.f + NL;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float f0 = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | q)) - OFF;
            const float f1 = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | q)) - OFF;
            const __nv_bfloat162 c = __floats2bfloat162_rn(f0, f1);
            a[q] = *reinterpret_cast<const uint32_t*>(&c);
        }
    }
}

// keep the compiler from moving accumulator registers while a wgmma
// that writes them is in flight
template <int R>
__device__ __forceinline__ void pin(float (&acc)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Step i of one warpgroup's K steps (K step c0 + i * kg of the CTA's
// range): wait for its slot, prefetch step i + STAGES - 2, build the A
// fragments in a (the set step i - 1's wgmma is not reading), issue its 4
// wgmma and leave them in flight (step i - 1's are retired).
template <int NT, int BITS>
__device__ __forceinline__ void tc_step(int i, int n, int c0, int kg, const TcArgs& g,
                                        uint8_t* ring, int bar, int r128, uint32_t (&a)[4][4],
                                        float (&acc)[NT / 2], int col, int sh) {
    using S = TcSmem<NT, BITS>;
    wg::cp_async_wait<TC_STAGES - 3>();      // step i has landed
    wg::fence_proxy_async();
    wg_sync(bar);                            // ... and step i - 2's slot is free
    const int nx = i + TC_STAGES - 2;
    if (nx < n) tc_load<NT, BITS>(ring + (nx % TC_STAGES) * S::SLOT, g, c0 + nx * kg, r128);
    wg::cp_async_commit();
    const uint8_t* slot = ring + (i % TC_STAGES) * S::SLOT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc_frag<BITS>(a[kk], slot + S::X_BYTES, kk, col, sh);
    const uint64_t desc = wg::desc_sw128(slot);
    pin(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::Wgmma<NT>::run(acc, a[kk], desc + 2 * kk);
    wg::commit();
    wg::wait<1>();
    pin(acc);
}

// One CTA: weight columns n0 .. n0+63 x tokens m0 .. m0+NT-1 over the K
// steps of split blockIdx.y, shared out among blockDim.x / 128
// warpgroups (warpgroup w takes every kg-th step from the w-th), each with
// its own ring; their sums are added in warpgroup order through shared
// memory.  splits == 1 writes y with / n * scale applied; otherwise the
// raw f32 partial goes to ws[split] (M x N) for qmm_splitk_combine.
template <int NT, int BITS>
__global__ void __launch_bounds__(NT == 64 ? 512 : 128)
qmm_dequant_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ planes,
                      const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                      int N, int splits, int vec_planes) {
    using S = TcSmem<NT, BITS>;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    // 1024-byte aligned for the swizzle; offset from the array itself (not
    // through an integer cast) so the compiler keeps shared-memory loads
    uint8_t* smem = smem_raw + ((1024 - (static_cast<uint32_t>(
                                             __cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
    const int kg = blockDim.x / 128, wgi = threadIdx.x / 128, r128 = threadIdx.x % 128;
    const int split = blockIdx.y;
    const int chunks = (K + TC_BK - 1) / TC_BK;
    const int c0 = (int)((long long)split * chunks / splits) + wgi;
    const int c1 = (int)((long long)(split + 1) * chunks / splits);
    const int n = c1 > c0 ? (c1 - c0 + kg - 1) / kg : 0;     // this warpgroup's steps
    const TcArgs g{x, planes, M, K, N, (int)blockIdx.z * NT, (int)blockIdx.x * TC_BN, vec_planes};
    uint8_t* ring = smem + wgi * S::RING;
    const int bar = 1 + wgi;
    const int warp = r128 / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int col = 16 * warp + 2 * (lane / 4);

    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

#pragma unroll
    for (int s = 0; s < TC_STAGES - 2; ++s) {
        if (s < n) tc_load<NT, BITS>(ring + s * S::SLOT, g, c0 + s * kg, r128);
        wg::cp_async_commit();
    }
    uint32_t a0[4][4], a1[4][4];
    int i = 0;
    for (; i + 1 < n; i += 2) {
        tc_step<NT, BITS>(i, n, c0, kg, g, ring, bar, r128, a0, acc, col, 2 * t);
        tc_step<NT, BITS>(i + 1, n, c0, kg, g, ring, bar, r128, a1, acc, col, 2 * t);
    }
    if (i < n) tc_step<NT, BITS>(i, n, c0, kg, g, ring, bar, r128, a0, acc, col, 2 * t);
    wg::wait<0>();
    pin(acc);

    if (kg > 1) {       // warpgroups 1.. hand their sums to warpgroup 0, in order
        wg::cp_async_wait<0>();
        __syncthreads();                     // every ring is done with
        float* red = reinterpret_cast<float*>(smem);
        if (wgi > 0) {
#pragma unroll
            for (int k = 0; k < NT / 2; ++k) red[((wgi - 1) * (NT / 2) + k) * 128 + r128] = acc[k];
        }
        __syncthreads();
        if (wgi > 0) return;
        for (int w = 1; w < kg; ++w) {
#pragma unroll
            for (int k = 0; k < NT / 2; ++k) acc[k] += red[((w - 1) * (NT / 2) + k) * 128 + r128];
        }
    }

    // accumulator d[4q + r]: row g + 8 (r >> 1) -> column n0 + col + (r >> 1),
    // column 8q + 2t + (r & 1) -> token
    constexpr float NLF = (float)((1 << (BITS - 1)) - 1);
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int gn = g.n0 + col + (r >> 1), gm = g.m0 + 8 * q + 2 * t + (r & 1);
            if (gn >= N || gm >= M) continue;
            const float v = acc[4 * q + r];
            if (splits == 1) out[(size_t)gm * N + gn] = v / NLF * scale[gn];
            else out[((size_t)split * M + gm) * N + gn] = v;
        }
    }
}

// y = (sum over splits, in split order, of ws[s]) / n * scale
__global__ void qmm_splitk_combine(const float* __restrict__ ws, const float* __restrict__ scale,
                                   float* __restrict__ y, int M, int N, int splits, int bits) {
    const size_t MN = (size_t)M * N;
    const float nl = (float)((1 << (bits - 1)) - 1);
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
         i += (size_t)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < splits; ++p) s += ws[p * MN + i];
        y[i] = s / nl * scale[i % N];
    }
}

template <int NT, int BITS>
int launch_tc(const __nv_bfloat16* x, const uint8_t* planes, const float* scale, float* y,
              float* ws, int M, int K, int N, int kg, int splits, cudaStream_t st) {
    auto kern = qmm_dequant_tc_kernel<NT, BITS>;
    const int smem = TcSmem<NT, BITS>::total(kg);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(planes) % 16 == 0);
    dim3 grid((N + TC_BN - 1) / TC_BN, splits, (M + NT - 1) / NT);
    kern<<<grid, 128 * kg, smem, st>>>(x, planes, scale, splits == 1 ? y : ws, M, K, N, splits,
                                       vec);
    if (splits > 1) {
        const size_t MN = (size_t)M * N;
        const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
        qmm_splitk_combine<<<blocks, 256, 0, st>>>(ws, scale, y, M, N, splits, BITS);
    }
    return (int)cudaGetLastError();
}

template <int NT>
int launch_tc_bits(int bits, const __nv_bfloat16* x, const uint8_t* planes, const float* scale,
                   float* y, float* ws, int M, int K, int N, int kg, int splits,
                   cudaStream_t st) {
    switch (bits) {
        case 2: return launch_tc<NT, 2>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 3: return launch_tc<NT, 3>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 4: return launch_tc<NT, 4>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 5: return launch_tc<NT, 5>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 6: return launch_tc<NT, 6>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 7: return launch_tc<NT, 7>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        default: return launch_tc<NT, 8>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
    }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  path: 0 = bitserial, 1 = dequant.
// The plan (kernels/qmm.py) for bf16 x: dequant, token_tile (64 or 256),
// groups (warpgroups per CTA sharing its K steps) and splits
// (dequant_plan), ws its (splits, M, N) f32 workspace when splits > 1;
// bitserial, groups (warps per CTA, 16 columns each) and splits <= 16
// (bitserial_plan; token_tile and ws unused).  f32 x ignores the plan:
// the SIMT bodies, unsplit.
extern "C" int qmm_launch(const void* x, int x_dtype, const void* planes,
                          const void* scale, void* y, void* ws, int M, int K, int N,
                          int bits, int path, int token_tile, int groups, int splits,
                          void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || K % 8 || bits < 2 || bits > 8 ||
        (path != 0 && path != 1) || (x_dtype != 0 && x_dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* p = static_cast<const uint8_t*>(planes);
    const float* s = static_cast<const float*>(scale);
    float* out = static_cast<float*>(y);
    if (path == 0) {
        bitserial::Mats mats{};
        bitserial::add(mats, p, s, N, bits);
        if (x_dtype == 0)
            return bitserial::launch_simt<qmm_bitserial>(static_cast<const float*>(x), mats, out,
                                                         M, K, 1, st);
        return bitserial::launch<qmm_bitserial>(static_cast<const __nv_bfloat16*>(x), mats, out,
                                                M, K, splits, groups, 1, st);
    }
    if (x_dtype == 0) {   // f32 activations: the f32 SIMT body
        dim3 grid((N + DQ_BN - 1) / DQ_BN, (M + DQ_BM - 1) / DQ_BM);
        qmm_dequant_simt_kernel<float><<<grid, DQ_THREADS, 0, st>>>(
            static_cast<const float*>(x), p, s, out, M, K, N, bits);
        return (int)cudaGetLastError();
    }
    const int chunks = (K + TC_BK - 1) / TC_BK;
    if (splits < 1 || splits > chunks || (splits > 1 && ws == nullptr) || groups < 1 ||
        groups > (token_tile == 64 ? 4 : 1) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    float* w = static_cast<float*>(ws);
    switch (token_tile) {
        case 64: return launch_tc_bits<64>(bits, xb, p, s, out, w, M, K, N, groups, splits, st);
        case 256: return launch_tc_bits<256>(bits, xb, p, s, out, w, M, K, N, groups, splits, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
