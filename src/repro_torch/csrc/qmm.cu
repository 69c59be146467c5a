// Packed low-bit weight x activation matmul (qmm) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/qmm.py::qmm_pallas, both of
// its bodies:
//   _qmm_bitserial_kernel (qmm.py:78)  -> bitserial.cuh, tagged qmm_bitserial
//   _qmm_dequant_kernel   (qmm.py:57)  -> qmm_dequant_tc_kernel below
// Both compute the function of kernels/ref.py::qmm_ref:
//   y[M,N] = x[M,K] @ ((u - n) / n * scale),  u = sum_b 2^b plane_b,
//   n = 2^(bits-1) - 1,
// with the planes stored as (bits, K/8, N) uint8: byte [b, j, col] holds
// bit b of rows 8j..8j+7 (row 8j+i in bit i), N minor-most.  Every
// product is exact in f32 (bf16 x times an integer code); only the order
// of the f32 sum differs from the plain version.  f32 x (RWKV's token-shift
// mixes) keeps that promise on the same tensor cores: each value is split
// into three bf16 terms whose sum is x (bitserial.cuh::split3), each term
// times a code is exact, and the three products go into one accumulator.
//
// bitserial (M <= 32, decode): GEMV-shaped and bound by the bytes of the
// planes: csrc/bitserial.cuh with one matrix (the same body computes the
// fused decode's q|k|v projections).  bf16 x takes its tensor-core body
// (mma.sync) over the grid of kernels/qmm.py::bitserial_plan: column tiles
// x K splits, the splits of a tile one cluster that sums them in split
// order (one launch, bitwise repeatable); f32 x the same, split into its
// three bf16 terms as it is staged.
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
// dequant, f32 x (RWKV's prefill chunks): the same body with three x
// tiles a K step, the bf16 terms of x (TERMS = 3): each K step issues the
// 4 wgmma of each term tile with the same register-built A into the one
// accumulator, 3x the tensor-core work of bf16 x and still ~5x the f32
// FMA rate.  The split is a pass of its own (qmm_split_x3_kernel: x -> a (3,
// M, K) bf16 copy in the caller's scratch), then the body's own cp.async
// ring loads the term tiles as it loads a bf16 x.  Chosen over splitting
// while staging: a 256-token step's x is 64 KB of f32, which would need
// that much more shared memory per slot or ~128 more registers a thread
// in a body that holds 214-228; the pass moves 10 bytes per element of x
// (5.2 MB at M 256, K 2048: 1.6 us at 3.35 TB/s) in one more launch.  Three x tiles per slot
// do not fit a 256-token ring, so f32 x takes 64-token tiles in a 4-slot
// ring (102-115 KB a warpgroup) -- 7 more instances of the body.  Its plan
// (kernels/qmm.py::dequant_plan with f32) runs one warpgroup a CTA, two
// CTAs an SM: of the plans swept at RWKV's shapes, the fastest that gives
// every SM a CTA (scripts/kernel_ablation.py f32).
//
// Plain C interface (built with nvcc, loaded with ctypes).  Kernels
// allocate nothing (the wrapper passes the split-K workspace); the entry
// point returns cudaGetLastError().

#include "bitserial.cuh"
#include "wgmma.cuh"

namespace {

struct qmm_bitserial;   // names the bit-serial kernel's instances

// ---------------------------------------------------- dequant (wgmma)
constexpr int TC_BN = 64;        // weight columns per CTA: wgmma's M
constexpr int TC_BK = 64;        // K per stage: one 128-byte swizzle row of bf16

// One ring slot: TERMS x tiles (NT tokens x 64 K, 128-byte swizzled: bf16
// x, or the three bf16 terms of f32 x), then the plane tile [bit][byte
// row][column], padded so the next slot's x tiles stay 1024-byte aligned.
// Each warpgroup of a CTA owns a ring of STAGES slots: STAGES - 2 K steps
// loading, 1 decoded, 1 in the tensor cores (5 for bf16 x, 4 for f32).
template <int NT, int BITS, int TERMS>
struct TcSmem {
    static constexpr int STAGES = TERMS == 1 ? 5 : 4;
    static constexpr int X_BYTES = NT * TC_BK * 2;                  // one tile, multiple of 1024
    static constexpr int PLANES = TERMS * X_BYTES;                  // the plane tile's offset
    static constexpr int SLOT = PLANES + (BITS * (TC_BK / 8) * TC_BN + 1023) / 1024 * 1024;
    static constexpr int RING = STAGES * SLOT;
    static constexpr int total(int kg) { return kg * RING + 1024; } // + alignment slack
};

struct TcArgs {
    const __nv_bfloat16* x;  // x (M, K), or the terms (TERMS, M, K)
    const uint8_t* planes;
    size_t term;             // M * K: elements from one term to the next
    int M, K, N, m0, n0, vec_planes;
};

__device__ __forceinline__ void wg_sync(int id) {   // named barrier of one warpgroup
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Stage K step `chunk` (64 K) of the x rows m0.. (each term's) and plane
// columns n0..n0+63 into one ring slot, the 128 threads of one warpgroup
// (index r128) taking part.  Pieces past M, K or N are zero-filled.
template <int NT, int BITS, int TERMS>
__device__ __forceinline__ void tc_load(uint8_t* slot, const TcArgs& g, int chunk, int r128) {
    using S = TcSmem<NT, BITS, TERMS>;
    const int k0 = chunk * TC_BK;
#pragma unroll
    for (int u = 0; u < TERMS; ++u) {
#pragma unroll
        for (int i = r128; i < NT * 8; i += 128) {               // x: 8 pieces per token row
            const int r = i >> 3, c = i & 7;
            const int gm = g.m0 + r, gk = k0 + c * 8;
            const bool ok = gm < g.M && gk < g.K;
            wg::cp_async16(slot + u * S::X_BYTES + r * 128 + ((c ^ (r & 7)) << 4),
                           ok ? g.x + u * g.term + (size_t)gm * g.K + gk : g.x, ok);
        }
    }
    uint8_t* ps = slot + S::PLANES;
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
// wgmma per x tile and leave them in flight (step i - 1's are retired).
template <int NT, int BITS, int TERMS>
__device__ __forceinline__ void tc_step(int i, int n, int c0, int kg, const TcArgs& g,
                                        uint8_t* ring, int bar, int r128, uint32_t (&a)[4][4],
                                        float (&acc)[NT / 2], int col, int sh) {
    using S = TcSmem<NT, BITS, TERMS>;
    wg::cp_async_wait<S::STAGES - 3>();      // step i has landed
    wg::fence_proxy_async();
    wg_sync(bar);                            // ... and step i - 2's slot is free
    const int nx = i + S::STAGES - 2;
    if (nx < n)
        tc_load<NT, BITS, TERMS>(ring + (nx % S::STAGES) * S::SLOT, g, c0 + nx * kg, r128);
    wg::cp_async_commit();
    const uint8_t* slot = ring + (i % S::STAGES) * S::SLOT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc_frag<BITS>(a[kk], slot + S::PLANES, kk, col, sh);
    pin(acc);
    wg::fence();
#pragma unroll
    for (int u = 0; u < TERMS; ++u) {        // x's terms in order, into the one accumulator
        const uint64_t desc = wg::desc_sw128(slot + u * S::X_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::Wgmma<NT>::run(acc, a[kk], desc + 2 * kk);
    }
    wg::commit();
    wg::wait<1>();
    pin(acc);
}

// One CTA: weight columns n0 .. n0+63 x tokens m0 .. m0+NT-1 over the K
// steps of split blockIdx.y, shared out among blockDim.x / 128
// warpgroups (warpgroup w takes every kg-th step from the w-th), each with
// its own ring; their sums are added in warpgroup order through shared
// memory.  splits == 1 writes y with / n * scale applied; otherwise the
// raw f32 partial goes to ws[split] (M x N) for qmm_splitk_combine.  x is
// bf16 (M, K) at TERMS == 1, the three bf16 terms (3, M, K) of an f32 x at
// TERMS == 3, whose CTAs hold at most two warpgroups (their rings fill
// the shared memory), so the bound leaves it 255 registers a thread.
template <int NT, int BITS, int TERMS>
__global__ void __launch_bounds__(NT == 64 ? (TERMS == 1 ? 512 : 256) : 128)
qmm_dequant_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ planes,
                      const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                      int N, int splits, int vec_planes) {
    using S = TcSmem<NT, BITS, TERMS>;
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
    const TcArgs g{x, planes, (size_t)M * K, M, K, N, (int)blockIdx.z * NT,
                   (int)blockIdx.x * TC_BN, vec_planes};
    uint8_t* ring = smem + wgi * S::RING;
    const int bar = 1 + wgi;
    const int warp = r128 / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int col = 16 * warp + 2 * (lane / 4);

    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

#pragma unroll
    for (int s = 0; s < S::STAGES - 2; ++s) {
        if (s < n) tc_load<NT, BITS, TERMS>(ring + s * S::SLOT, g, c0 + s * kg, r128);
        wg::cp_async_commit();
    }
    uint32_t a0[4][4], a1[4][4];
    int i = 0;
    for (; i + 1 < n; i += 2) {
        tc_step<NT, BITS, TERMS>(i, n, c0, kg, g, ring, bar, r128, a0, acc, col, 2 * t);
        tc_step<NT, BITS, TERMS>(i + 1, n, c0, kg, g, ring, bar, r128, a1, acc, col, 2 * t);
    }
    if (i < n) tc_step<NT, BITS, TERMS>(i, n, c0, kg, g, ring, bar, r128, a0, acc, col, 2 * t);
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

// f32 x (n4 groups of 4) -> its three bf16 terms, (3, M, K) in xs
__global__ void qmm_split_x3_kernel(const float4* __restrict__ x, uint2* __restrict__ xs, size_t n4) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += (size_t)gridDim.x * blockDim.x) {
        uint2 t[3];
        bitserial::split4(x[i], t);
        xs[i] = t[0];
        xs[n4 + i] = t[1];
        xs[2 * n4 + i] = t[2];
    }
}

template <int NT, int BITS, int TERMS>
int launch_tc(const __nv_bfloat16* x, const uint8_t* planes, const float* scale, float* y,
              float* ws, int M, int K, int N, int kg, int splits, cudaStream_t st) {
    auto kern = qmm_dequant_tc_kernel<NT, BITS, TERMS>;
    const int smem = TcSmem<NT, BITS, TERMS>::total(kg);
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

template <int NT, int TERMS>
int launch_tc_bits(int bits, const __nv_bfloat16* x, const uint8_t* planes, const float* scale,
                   float* y, float* ws, int M, int K, int N, int kg, int splits,
                   cudaStream_t st) {
    switch (bits) {
        case 2: return launch_tc<NT, 2, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 3: return launch_tc<NT, 3, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 4: return launch_tc<NT, 4, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 5: return launch_tc<NT, 5, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 6: return launch_tc<NT, 6, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        case 7: return launch_tc<NT, 7, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
        default: return launch_tc<NT, 8, TERMS>(x, planes, scale, y, ws, M, K, N, kg, splits, st);
    }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; x 16-byte aligned.  path: 0 =
// bitserial, 1 = dequant.  The plan (kernels/qmm.py): dequant,
// token_tile (64 or 256; f32 x 64), groups (warpgroups per CTA sharing
// its K steps) and splits (dequant_plan), ws its (splits, M, N) f32
// workspace when splits > 1, and for f32 x xs, a (3, M, K) bf16 scratch
// for x's terms; bitserial, groups (warps per CTA, 16 columns each) and
// splits <= 16 (bitserial_plan; token_tile, ws and xs unused).
extern "C" int qmm_launch(const void* x, int x_dtype, const void* planes,
                          const void* scale, void* y, void* ws, void* xs, int M, int K, int N,
                          int bits, int path, int token_tile, int groups, int splits,
                          void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || K % 8 || bits < 2 || bits > 8 ||
        (path != 0 && path != 1) || (x_dtype != 0 && x_dtype != 1) ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* p = static_cast<const uint8_t*>(planes);
    const float* s = static_cast<const float*>(scale);
    float* out = static_cast<float*>(y);
    if (path == 0) {
        bitserial::Mats mats{};
        bitserial::add(mats, p, s, N, bits);
        return bitserial::launch<qmm_bitserial>(x, x_dtype == 0, mats, out, M, K, splits, groups,
                                                1, st);
    }
    const int chunks = (K + TC_BK - 1) / TC_BK;
    const bool f32 = x_dtype == 0;
    if (splits < 1 || splits > chunks || (splits > 1 && ws == nullptr) || groups < 1 ||
        groups > (token_tile == 64 ? (f32 ? 2 : 4) : 1) ||
        (f32 && (xs == nullptr || token_tile != 64)))
        return (int)cudaErrorInvalidValue;
    float* w = static_cast<float*>(ws);
    if (f32) {
        const size_t n4 = (size_t)M * K / 4;
        const size_t want = (n4 + 255) / 256;
        qmm_split_x3_kernel<<<(unsigned)(want < 1056 ? want : 1056), 256, 0, st>>>(
            static_cast<const float4*>(x), static_cast<uint2*>(xs), n4);
        return launch_tc_bits<64, 3>(bits, static_cast<const __nv_bfloat16*>(xs), p, s, out, w, M,
                                     K, N, groups, splits, st);
    }
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    switch (token_tile) {
        case 64:
            return launch_tc_bits<64, 1>(bits, xb, p, s, out, w, M, K, N, groups, splits, st);
        case 256:
            return launch_tc_bits<256, 1>(bits, xb, p, s, out, w, M, K, N, groups, splits, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
