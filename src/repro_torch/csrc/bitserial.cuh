// Bit-serial packed-weight x activation product for decode rows, shared by
// qmm.cu (one matrix: the qmm bit-serial body) and fused_decode.cu (the
// q|k|v projections of one decode step, three matrices that share x).
//
// Computes, for each matrix i of up to three, in dequant form
//   y[m, off_i + n] = (sum_k x[m,k] * (u_i[k,n] - n_i)) / n_i * scale_i[n]
// with u = sum_b 2^b plane_b the unsigned codes and n_i = 2^(bits_i-1) - 1,
// i.e. x @ dequant(planes_i).  Planes are (bits, K/8, N) uint8: byte [b,
// j, col] holds bit b of rows 8j..8j+7 (row 8j+i in bit i), N minor-most.
// Every product x * (u - n) is exact in f32; only the order of the f32
// sum differs from the plain version.
//
// What bounds it on the H100: device-memory bytes (bits/8 bytes per
// weight, 2*M flops each, far below the ridge) -- if the products leave
// the SIMT lanes: rebuilding and multiplying ~9 thread instructions per
// weight at M = 4 alone take about twice the bytes' time at glm4-9b's
// decode shapes.  Design (bf16 x, tc_kernel):
//   * Products on the tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32,
//     A = 16 weight columns x 16 K positions as codes u - n (exact in
//     bf16: [-127, 128]), B = x rows (one n8 tile per 8 rows, up to 4).
//     mma.sync, not wgmma: one warp owns 16 columns and all of the CTA's
//     rows, so the 4-8 warps of a CTA are independent chains that hide
//     each other's latency, with no warpgroup-wide wait.
//   * The K order inside a k16 step is chosen for the code build: step s
//     of a 64-K part takes K positions s and s+4 of 8 byte rows, so a
//     thread's 4 K positions (2t, 2t+1, 2t+8, 2t+9 of the mma) are
//     positions s, s+4 of byte rows t and t+4.  One 32-bit word per plane
//     -- bytes (row t, col), (row t, col+1), (row t+4, col), (row t+4,
//     col+1) -- serves all 4 steps: an 8 x 8 bit transpose of the plane
//     words (delta swaps, every byte lane at once; two stages, 16
//     operations, at bits <= 4) leaves each step's codes in one word (low
//     and high nibble), and a byte permute, an and-or and one bf16x2 fma
//     per register make the A fragment (bits 5-7: one word per K position
//     and a bf16x2 subtract; 8 bits goes through f32).  B takes the same K
//     order: a byte permute pairs x[s], x[s+4] of the two 16-byte pieces
//     of x an n8 tile reads per 64-K part.
//   * One CTA covers up to 32 rows (grid z for more), so the planes are
//     read once per call; a K step of 128 (16 byte rows) of the x rows and
//     of the CTA's plane tile is staged with 16-byte cp.async into a
//     4-slot ring (3 steps in flight while one is used, ~15 KB a CTA at 4
//     bits), one barrier per step.  x pieces are swizzled by row parity and
//     plane rows padded by 16 bytes, so the fragment loads are free of
//     bank conflicts.  Planes whose rows are not 16-byte aligned (N % 16
//     != 0) are staged with plain byte loads instead.  Measured (PERF.md,
//     scripts/kernel_ablation.py bitserial): the loads alone and the code
//     build alone each take about 2.5x the bytes' time at glm4-9b's 4-bit
//     shapes, and a deeper ring, longer steps or more CTAs do not move
//     either; the products alone about half as long.
//   * The grid: column tiles of 16 * warps columns (kernels/qmm.py::
//     bitserial_plan), K splits and row tiles: a deterministic split-K in
//     whole steps that brings the grid to about three CTAs per SM.  Split
//     s walks steps [s * steps / splits, (s + 1) * steps / splits).  One
//     split writes y finished (/ n * scale).  qmm launches the splits of a
//     tile as one thread-block cluster (at most 16, H100's non-portable
//     size; more than 8 only where N is narrow): each leaves its sums
//     in its own shared memory, and split 0 adds the others' through
//     distributed shared memory in split order and finishes y -- one
//     launch, no workspace, bitwise repeatable, and no trip through device
//     memory, fences and atomics (~4 us a call when the last CTA to arrive
//     combined in device memory).  The fused decode writes each split's
//     raw partial to (splits, M, ntot) instead, which its attend launch
//     finishes.
//   * Column tiles of the matrices follow each other along blockIdx.x, so
//     the CTAs of all three are in flight at once; ragged N and K/8 are
//     masked in the kernel (zero-filled pieces).
// f32 x (RWKV's token-shift mixes) takes the same body.  Rounding x to
// bf16 would change the function (the plain version multiplies in f32),
// so each value is split exactly into three bf16 terms, x = x1 + x2 + x3
// (split3: 8 + 8 + 8 significand bits, by truncation).  Each term times a
// code is exact in f32, and the three products go into the one
// accumulator: only the order of the f32 sum differs, as for bf16 x.
//   * Staging: the f32 rows are copied raw into the ring (16-byte
//     cp.async, 512 bytes a row and step) and split once per CTA into
//     three bf16 tiles laid out as a bf16 x tile, a step ahead: step i + 1
//     is split while step i's products run, and the barrier of step i + 1
//     publishes it, so the split takes no barrier of its own (one step
//     fewer in flight).  The term tiles sit in two buffers beside the ring
//     (step i's in buffer i % 2), not in every slot: at RWKV's 2048 x 7168
//     a CTA then takes 49 KB at 4 bits, and the plan's 448 CTAs fit the
//     card at once (4 a SM).  The warps share the split instead of each
//     splitting its B fragments.
//   * Each A fragment -- the codes rebuilt from the planes, the costly
//     part -- is built once and multiplied by the three B fragments: 3x
//     the mma work of bf16 x, which at decode's M stays far below the
//     planes' bytes.  Splits, clusters and the combine are bf16 x's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace bitserial {

constexpr int STEP = 128;                // K per pipeline stage
constexpr int JR = STEP / 8;             // packed byte rows per stage
constexpr int lg2(int v) { return v > 1 ? 1 + lg2(v / 2) : 0; }
constexpr int LG_JR = lg2(JR);
constexpr int STAGES = 4;                // ring slots: 3 steps load while one is used
constexpr int MAX_CLUSTER = 16;          // splits of a qmm tile: one cluster (> 8: non-portable)
constexpr int ROWS = 32;                 // x rows per CTA (4 n8 tiles); grid z for more
constexpr int XROW = STEP * 2;           // bytes of one staged x row (bf16)
constexpr int XRAW = STEP * 4;           // bytes of one staged f32 x row, before the split
constexpr int PAD = 16;                  // bytes after each staged plane row
constexpr int MAX_WARPS = 8;

// x = x1 + x2 + x3, each the high half of an f32 pattern (a bf16 value,
// returned as its 16 bits): x1 is x truncated to bf16, x2 the remainder
// truncated, x3 what is left.  Truncation never overflows (rounding x1
// to nearest would turn |x| above bf16's largest finite value into inf).
// A non-finite x is x1 alone: inf itself, a NaN with its quiet bit set
// first, so that a payload only in the low half stays a NaN.  The sum is
// exact for every x that is a multiple of 2^-133 (bf16's least
// subnormal): every |x| >= 2^-110 and every bf16 value.  Below that, the
// bits under 2^-133 are dropped: no bf16 value holds them.
// kernels/ref.py::split_bf16x3 is the plain version.
__device__ __forceinline__ void split3(float x, uint32_t& h1, uint32_t& h2, uint32_t& h3) {
    const uint32_t b = __float_as_uint(x);
    const bool finite = (b & 0x7F800000u) != 0x7F800000u;
    const bool nan = !finite && (b & 0x007FFFFFu);
    const uint32_t t1 = (nan ? b | 0x00400000u : b) & 0xFFFF0000u;
    const float r1 = finite ? x - __uint_as_float(t1) : 0.f;
    const uint32_t t2 = __float_as_uint(r1) & 0xFFFF0000u;
    const float r2 = r1 - __uint_as_float(t2);
    h1 = t1 >> 16;
    h2 = t2 >> 16;
    h3 = __float_as_uint(r2) >> 16;
}

// split3 of four f32 values: t[i] = their i-th terms, 4 bf16 in order
__device__ __forceinline__ void split4(const float4& v, uint2 (&t)[3]) {
    uint32_t h[4][3];
    split3(v.x, h[0][0], h[0][1], h[0][2]);
    split3(v.y, h[1][0], h[1][1], h[1][2]);
    split3(v.z, h[2][0], h[2][1], h[2][2]);
    split3(v.w, h[3][0], h[3][1], h[3][2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        t[i] = make_uint2(h[0][i] | (h[1][i] << 16), h[2][i] | (h[3][i] << 16));
}

struct Mat {
    const uint8_t* planes;   // (bits, K/8, N)
    const float* scale;      // (1, N)
    int N, bits, col_off, tile0;
};

struct Mats {
    Mat m[3];
    int count;               // matrices in use
    int ntot;                // sum of their N: the row stride of y
    int tiles;               // column tiles of all of them: the grid's x
};

// append a matrix to a value-initialised Mats (`Mats s{};`); its columns
// follow the previous ones in y
inline void add(Mats& s, const void* planes, const void* scale, int N, int bits) {
    s.m[s.count++] = Mat{static_cast<const uint8_t*>(planes), static_cast<const float*>(scale),
                         N, bits, s.ntot, 0};
    s.ntot += N;
}

// number the column tiles of `cols` columns, the matrices' one after another
inline void tile(Mats& s, int cols) {
    s.tiles = 0;
    for (int i = 0; i < s.count; ++i) {
        s.m[i].tile0 = s.tiles;
        s.tiles += (s.m[i].N + cols - 1) / cols;
    }
}

// this CTA's matrix (constant indices only: no local copy of the params)
__device__ __forceinline__ Mat this_mat(const Mats& mats) {
    Mat mat = mats.m[0];
    if (mats.count > 1 && (int)blockIdx.x >= mats.m[1].tile0) mat = mats.m[1];
    if (mats.count > 2 && (int)blockIdx.x >= mats.m[2].tile0) mat = mats.m[2];
    return mat;
}

// ------------------------------------------------------ the tensor cores
// bytes of the x rows of one ring slot: nt * 8 rows, bf16 or raw f32
__host__ __device__ constexpr int x_bytes(int nt, bool f32) {
    return nt * 8 * (f32 ? XRAW : XROW);
}
// bytes of one ring slot: the x rows, then bmax planes x JR byte rows
__host__ __device__ constexpr int slot_bytes(int nt, int bmax, int cols, bool f32) {
    return x_bytes(nt, f32) + bmax * JR * (cols + PAD);
}
// bytes of one buffer of f32 x's three bf16 term tiles (nt * 8 rows each)
__host__ __device__ constexpr int terms_bytes(int nt) { return 3 * nt * 8 * XROW; }
// a CTA's dynamic shared memory: the ring, and for f32 x two term buffers
__host__ __device__ constexpr int smem_bytes(int nt, int bmax, int cols, bool f32) {
    return STAGES * slot_bytes(nt, bmax, cols, f32) + (f32 ? 2 * terms_bytes(nt) : 0);
}

struct Args {
    const uint8_t* x;        // (M, K) bf16 or f32, 16-byte aligned
    Mats mats;
    float* out;              // y (M, ntot) finished, or (cluster == 0, splits > 1) the
                             // raw partials (splits, M, ntot)
    int M, K, splits, steps, bmax, vec;
    int cluster;             // the splits of a tile form one cluster and combine in it
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Swap bit blocks between a and b: a keeps its bits under m and takes
// b's, shifted up by d, elsewhere; b takes a's bits off m, shifted down,
// and keeps its own off m.  Three stages of these (d = 1, 2, 4) transpose
// an 8 x 8 bit matrix held one row per register, in every byte lane at once.
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int d, uint32_t m) {
    const uint32_t a2 = (a & m) | ((b << d) & ~m);
    b = ((a >> d) & m) | (b & ~m);
    a = a2;
}

// Plane words -> codes.  In: c[b] (b < BITS; zero above) holds bit b of
// the codes of 8 K positions in each byte (position i in bit i).  Out,
// BITS <= 4: byte q of c[s] holds the code at position s (low nibble)
// and at position s + 4 (high nibble), s < 4; BITS > 4: byte q of c[i]
// holds the code at position i.
template <int BITS>
__device__ __forceinline__ void transpose(uint32_t (&c)[8]) {
    swap_bits(c[0], c[1], 1, 0x55555555u);
    swap_bits(c[2], c[3], 1, 0x55555555u);
    swap_bits(c[0], c[2], 2, 0x33333333u);
    swap_bits(c[1], c[3], 2, 0x33333333u);
    if constexpr (BITS > 4) {
        swap_bits(c[4], c[5], 1, 0x55555555u);
        swap_bits(c[6], c[7], 1, 0x55555555u);
        swap_bits(c[4], c[6], 2, 0x33333333u);
        swap_bits(c[5], c[7], 2, 0x33333333u);
#pragma unroll
        for (int i = 0; i < 4; ++i) swap_bits(c[i], c[i + 4], 4, 0x0F0F0F0Fu);
    }
}

// bf16 x[s], x[s + 4] of a staged 16-byte piece of x (8 K positions)
__device__ __forceinline__ uint32_t x_pair(const uint4& v, int s) {
    return __byte_perm(s < 2 ? v.x : v.y, s < 2 ? v.z : v.w, (s & 1) ? 0x7632 : 0x5410);
}

// A fragment of k16 step s from the transposed codes: register q = bf16
// pair (code at position s, code at position s + 4) - n of byte q's
// (row, column)
template <int BITS>
__device__ __forceinline__ void codes_to_a(uint32_t (&a)[4], const uint32_t (&c)[8], int s) {
    constexpr int NL = (1 << (BITS - 1)) - 1;
    if constexpr (BITS <= 4) {
        // low half: bf16 bits 0x43 0l = 128 + l; high half: 0x43 | 8h =
        // 128 + 8h; then x (1, 1/8) - (128 + n, 16 + n), exact
        const uint32_t cs = c[s], cs1 = cs >> 1;
        const __nv_bfloat162 mul = __floats2bfloat162_rn(1.f, 0.125f);
        const __nv_bfloat162 off = __floats2bfloat162_rn(-(128.f + NL), -(16.f + NL));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t v = (__byte_perm(cs, cs1, q | ((4 + q) << 8)) & 0x0078000Fu) | 0x43004300u;
            __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&v);
            r = __hfma2(r, mul, off);
            a[q] = *reinterpret_cast<const uint32_t*>(&r);
        }
    } else if constexpr (BITS <= 7) {
        // u < 128: bf16 bits 0x43uu are 128 + u exactly; subtract 128 + n
        const __nv_bfloat162 off = __floats2bfloat162_rn(128.f + NL, 128.f + NL);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t v =
                (__byte_perm(c[s], c[s + 4], q | ((4 + q) << 8)) & 0x00FF00FFu) | 0x43004300u;
            __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&v);
            r = __hsub2(r, off);
            a[q] = *reinterpret_cast<const uint32_t*>(&r);
        }
    } else {
        // u < 256: f32 bits 0x4B0000uu are 2^23 + u exactly; subtract 2^23 + n
        constexpr float OFF = 8388608.f + NL;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float f0 = __uint_as_float(__byte_perm(c[s], 0x4B000000u, 0x7440 | q)) - OFF;
            const float f1 = __uint_as_float(__byte_perm(c[s + 4], 0x4B000000u, 0x7440 | q)) - OFF;
            const __nv_bfloat162 r = __floats2bfloat162_rn(f0, f1);
            a[q] = *reinterpret_cast<const uint32_t*>(&r);
        }
    }
}

// 16-byte cp.async of plane bytes, zero-filling the destination when !ok.
// A CTA reads 16 * warps bytes of each plane row; the L2 prefetch hint
// fetches the whole 256-byte block, which the neighbouring column tiles'
// CTAs read at about the same time (the loads alone 8-18 % faster).
__device__ __forceinline__ void cp_plane16(void* dst, const void* src, bool ok) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// Stage K step k (x rows m0.. and the plane tile's columns n0..) into a
// ring slot, every thread of the CTA taking part.  Pieces past K, N and
// the CTA's rows are zero-filled or not loaded.  bf16 x goes to the x
// tile (pieces swizzled by row parity), f32 x raw to the slot's f32 rows.
template <int NT, int BITS, bool F32>
__device__ __forceinline__ void load_step(uint8_t* slot, const Args& a, const Mat& mat, int k,
                                          int m0, int mrows, int n0, int cols, int lg_pieces) {
    const int k0 = k * STEP;
    if constexpr (F32) {
        const float* x = reinterpret_cast<const float*>(a.x);
        for (int i = threadIdx.x; i < mrows * (STEP / 4); i += blockDim.x) {   // 4 K a piece
            const int r = i / (STEP / 4), p = i % (STEP / 4);
            const int gk = k0 + p * 4;
            const bool ok = gk < a.K;
            wg::cp_async16(slot + r * XRAW + p * 16, ok ? x + (size_t)(m0 + r) * a.K + gk : x,
                           ok);
        }
    } else {
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(a.x);
        for (int i = threadIdx.x; i < mrows * JR; i += blockDim.x) {   // x: JR pieces per row
            const int r = i >> LG_JR, p = i & (JR - 1);
            const int gk = k0 + p * 8;
            const bool ok = gk < a.K;
            wg::cp_async16(slot + r * XROW + ((p ^ ((r & 1) << 2)) << 4),
                           ok ? x + (size_t)(m0 + r) * a.K + gk : x, ok);
        }
    }
    uint8_t* ps = slot + x_bytes(NT, F32);
    const int prow = cols + PAD, K8 = a.K / 8, N = mat.N;
    if (a.vec) {                                                    // N % 16 == 0
        const int pieces = 1 << lg_pieces;                         // per plane row
        for (int i = threadIdx.x; i < BITS * JR * pieces; i += blockDim.x) {
            const int c = i & (pieces - 1), r = (i >> lg_pieces) & (JR - 1);
            const int b = i >> (lg_pieces + LG_JR);
            const int j = k * JR + r, gn = n0 + c * 16;
            const bool ok = j < K8 && gn < N;
            cp_plane16(ps + (b * JR + r) * prow + c * 16,
                       ok ? mat.planes + ((size_t)b * K8 + j) * N + gn : mat.planes, ok);
        }
    } else {                                                        // rows not 16-byte aligned
        for (int i = threadIdx.x; i < BITS * JR * cols; i += blockDim.x) {
            const int c = i % cols, r = (i / cols) & (JR - 1), b = i / (cols * JR);
            const int j = k * JR + r, gn = n0 + c;
            ps[(b * JR + r) * prow + c] =
                (j < K8 && gn < N) ? __ldg(mat.planes + ((size_t)b * K8 + j) * N + gn)
                                   : (uint8_t)0;
        }
    }
}

// f32 x: split a landed slot's raw rows into a buffer of three bf16 term
// tiles, each laid out as a bf16 x tile (term u at u * NT * 8 * XROW)
template <int NT>
__device__ __forceinline__ void split_step(const uint8_t* raw, uint8_t* terms, int mrows) {
    for (int i = threadIdx.x; i < mrows * (STEP / 4); i += blockDim.x) {
        const int r = i / (STEP / 4), q = i % (STEP / 4);      // K 4q .. 4q+3 of row r
        uint2 t[3];
        split4(*reinterpret_cast<const float4*>(raw + r * XRAW + q * 16), t);
        const int at = r * XROW + (((q >> 1) ^ ((r & 1) << 2)) << 4) + (q & 1) * 8;
#pragma unroll
        for (int u = 0; u < 3; ++u)
            *reinterpret_cast<uint2*>(terms + u * NT * 8 * XROW + at) = t[u];
    }
}

// B fragments of this part: x row 8j + g, byte rows t and t + 4 (8 K
// positions each) of an x tile
template <int NT>
__device__ __forceinline__ void load_b(uint4 (&xb)[NT][2], const uint8_t* xt, int h, int mrows,
                                       int g, int t) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + g, sw = (r & 1) << 2;
        if (r < mrows) {
            const uint8_t* xr = xt + r * XROW;
            xb[j][0] = *reinterpret_cast<const uint4*>(xr + (((8 * h + t) ^ sw) << 4));
            xb[j][1] = *reinterpret_cast<const uint4*>(xr + (((8 * h + 4 + t) ^ sw) << 4));
        } else {
            xb[j][0] = xb[j][1] = make_uint4(0u, 0u, 0u, 0u);
        }
    }
}

// The products of one staged K step for this warp's 16 columns: STEP / 64
// parts of 64 K, 4 k16 steps each.  xt: the bf16 x tile, or f32 x's three
// term tiles, each A fragment against their B fragments in term order;
// ps: the plane tile.
template <int NT, int BITS, bool F32>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const uint8_t* xt,
                                         const uint8_t* ps, int mrows, int cols, int warp, int g,
                                         int t) {
    const int prow = cols + PAD;
    const int col = warp * 16 + 2 * g;       // A rows g, g + 8: columns col, col + 1
#pragma unroll
    for (int h = 0; h < JR / 8; ++h) {
        // per plane: bytes (row t, col), (row t, col+1), (row t+4, col),
        // (row t+4, col+1) of this part's 8 byte rows, then their codes
        uint32_t c[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            c[b] = 0u;
            if (b < BITS) {
                const uint8_t* p = ps + (b * JR + 8 * h + t) * prow + col;
                const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p);
                const uint32_t r4 = *reinterpret_cast<const uint16_t*>(p + 4 * prow);
                c[b] = __byte_perm(r0, r4, 0x5410);
            }
        }
        transpose<BITS>(c);
        if constexpr (F32) {
            uint32_t af[4][4];
#pragma unroll
            for (int s = 0; s < 4; ++s) codes_to_a<BITS>(af[s], c, s);
#pragma unroll
            for (int u = 0; u < 3; ++u) {
                uint4 xb[NT][2];
                load_b<NT>(xb, xt + u * NT * 8 * XROW, h, mrows, g, t);
#pragma unroll
                for (int s = 0; s < 4; ++s)
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        mma_bf16(acc[j], af[s], x_pair(xb[j][0], s), x_pair(xb[j][1], s));
            }
        } else {
            uint4 xb[NT][2];
            load_b<NT>(xb, xt, h, mrows, g, t);
#pragma unroll
            for (int s = 0; s < 4; ++s) {       // K positions s and s + 4 of each byte row
                uint32_t af[4];
                codes_to_a<BITS>(af, c, s);
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    mma_bf16(acc[j], af, x_pair(xb[j][0], s), x_pair(xb[j][1], s));
            }
        }
    }
}

template <int NT, int BITS, bool F32>
__device__ __forceinline__ void tc_body(const Args& a, const Mat& mat, uint8_t* smem) {
    const int warps = blockDim.x / 32, cols = 16 * warps;
    const int lg_pieces = __ffs(warps) - 1;  // cols / 16 = warps, a power of two
    const int slot = slot_bytes(NT, a.bmax, cols, F32);
    uint8_t* terms = smem + STAGES * slot;   // f32 x: two buffers of term tiles
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = ((int)blockIdx.x - mat.tile0) * cols;
    const int m0 = blockIdx.z * ROWS;
    const int mrows = min(NT * 8, a.M - m0);
    const int split = blockIdx.y;
    const int s0 = split * a.steps / a.splits;
    const int n = (split + 1) * a.steps / a.splits - s0;

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n)
            load_step<NT, BITS, F32>(smem + s * slot, a, mat, s0 + s, m0, mrows, n0, cols,
                                     lg_pieces);
        wg::cp_async_commit();
    }
    if constexpr (F32) {                        // split step 0 once it has landed
        wg::cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (n > 0) split_step<NT>(smem, terms, mrows);
    }
    for (int i = 0; i < n; ++i) {
        // bf16: step i has landed; f32: step i + 1 (split below, while
        // step i, split in the last iteration, is used)
        wg::cp_async_wait<F32 ? STAGES - 3 : STAGES - 2>();
        __syncthreads();                        // ... for every thread, and step i - 1's slot is free
        const int nx = i + STAGES - 1;
        if (nx < n)
            load_step<NT, BITS, F32>(smem + (nx % STAGES) * slot, a, mat, s0 + nx, m0, mrows, n0,
                                     cols, lg_pieces);
        wg::cp_async_commit();
        const uint8_t* cur = smem + (i % STAGES) * slot;
        if constexpr (F32) {
            if (i + 1 < n)
                split_step<NT>(smem + ((i + 1) % STAGES) * slot,
                               terms + ((i + 1) & 1) * terms_bytes(NT), mrows);
            mma_step<NT, BITS, F32>(acc, terms + (i & 1) * terms_bytes(NT),
                                    cur + x_bytes(NT, F32), mrows, cols, warp, g, t);
        } else {
            mma_step<NT, BITS, F32>(acc, cur, cur + x_bytes(NT, F32), mrows, cols, warp, g, t);
        }
    }
    // the K loop is done: a grid launched as this one's programmatic
    // dependent may start its preamble (it waits for this grid's results
    // itself); without such a dependent this is a no-op
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    if (a.cluster) {
        // qmm: split 0 of the cluster adds the others' sums, in split order
        namespace cg = cooperative_groups;
        const cg::cluster_group cluster = cg::this_cluster();
        float* red = reinterpret_cast<float*>(smem);        // [warps][NT][4][32]
        wg::cp_async_wait<0>();
        __syncthreads();                                     // the ring is idle
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) red[((warp * NT + j) * 4 + r) * 32 + lane] = acc[j][r];
        cluster.sync();
        if (split == 0) {
            for (int p = 1; p < a.splits; ++p) {
                const float* other = cluster.map_shared_rank(red, p);
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        acc[j][r] += other[((warp * NT + j) * 4 + r) * 32 + lane];
            }
        }
        cluster.sync();                                      // every read of red is done
        if (split != 0) return;
    }
    // acc[j][r]: column n0 + col + (r >> 1), row m0 + 8j + 2t + (r & 1)
    constexpr float NL = (float)((1 << (BITS - 1)) - 1);
    const int ntot = a.mats.ntot;
    const bool finish = a.splits == 1 || a.cluster;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int c = n0 + warp * 16 + 2 * g + (r >> 1);
            const int m = m0 + 8 * j + 2 * t + (r & 1);
            if (c >= mat.N || m >= a.M) continue;
            const size_t at = (size_t)m * ntot + mat.col_off + c;
            if (finish) a.out[at] = acc[j][r] / NL * __ldg(mat.scale + c);
            else a.out[(size_t)split * a.M * ntot + at] = acc[j][r];
        }
    }
}

// Tag (an empty struct of the caller's) only names the caller in the
// kernel's symbol, so a profile tells qmm from the fused projection;
// F32 names the f32-x instances.
template <typename Tag, int NT, bool F32>
__global__ void __launch_bounds__(MAX_WARPS * 32) tc_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    const Mat mat = this_mat(a.mats);
    switch (mat.bits) {
        case 2: tc_body<NT, 2, F32>(a, mat, smem); break;
        case 3: tc_body<NT, 3, F32>(a, mat, smem); break;
        case 4: tc_body<NT, 4, F32>(a, mat, smem); break;
        case 5: tc_body<NT, 5, F32>(a, mat, smem); break;
        case 6: tc_body<NT, 6, F32>(a, mat, smem); break;
        case 7: tc_body<NT, 7, F32>(a, mat, smem); break;
        default: tc_body<NT, 8, F32>(a, mat, smem); break;
    }
}

template <typename Tag, int NT, bool F32>
int launch_nt(const Args& a, int warps, cudaStream_t st) {
    const int smem = smem_bytes(NT, a.bmax, 16 * warps, F32);
    auto kern = tc_kernel<Tag, NT, F32>;
    if (smem > 40 * 1024) {   // near the 48 KB default, static shared memory included
        const cudaError_t e =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (a.cluster && a.splits > 8) {
        static bool allowed = false;   // once per instance
        if (!allowed) {
            const cudaError_t e =
                cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (e != cudaSuccess) return (int)e;
            allowed = true;
        }
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.mats.tiles, a.splits, (a.M + ROWS - 1) / ROWS);
    cfg.blockDim = dim3(32 * warps);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = a.splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = a.cluster ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename Tag, bool F32>
int launch_rows(const Args& a, int warps, cudaStream_t st) {
    switch (((a.M < ROWS ? a.M : ROWS) + 7) / 8) {
        case 1: return launch_nt<Tag, 1, F32>(a, warps, st);
        case 2: return launch_nt<Tag, 2, F32>(a, warps, st);
        case 3: return launch_nt<Tag, 3, F32>(a, warps, st);
        default: return launch_nt<Tag, 4, F32>(a, warps, st);
    }
}

// x (M, K): bf16 or (f32 != 0) f32, 16-byte aligned, K % 8 == 0; warps
// per CTA 1, 2, 4 or 8 (16 columns each); splits <= ceil(K / STEP).  out
// (M, mats.ntot) f32 = x @ [dequant(m_0) | dequant(m_1) | ...], the
// splits of a tile combined in a cluster (cluster != 0, splits <=
// MAX_CLUSTER); or, with cluster == 0 and splits > 1, out (splits, M,
// mats.ntot) gets split s's raw partial sum x * (u - n) over its steps.
template <typename Tag>
int launch(const void* x, int f32, Mats mats, float* out, int M, int K, int splits, int warps,
           int cluster, cudaStream_t st) {
    const int steps = (K + STEP - 1) / STEP;
    if (M <= 0 || K <= 0 || K % 8 || splits < 1 || splits > steps ||
        (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || (cluster && splits > MAX_CLUSTER))
        return (int)cudaErrorInvalidValue;
    tile(mats, 16 * warps);
    int bmax = 2, vec = 1;
    for (int i = 0; i < mats.count; ++i) {
        bmax = mats.m[i].bits > bmax ? mats.m[i].bits : bmax;
        vec = vec && mats.m[i].N % 16 == 0 && reinterpret_cast<uintptr_t>(mats.m[i].planes) % 16 == 0;
    }
    const Args a{static_cast<const uint8_t*>(x), mats, out, M, K, splits, steps, bmax, vec,
                 cluster && splits > 1};
    return f32 ? launch_rows<Tag, true>(a, warps, st) : launch_rows<Tag, false>(a, warps, st);
}

}  // namespace bitserial
