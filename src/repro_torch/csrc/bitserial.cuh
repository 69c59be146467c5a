// Bit-serial packed-weight x activation product for decode rows, shared by
// qmm.cu (one matrix: the qmm bit-serial body) and fused_decode.cu (the
// q|k|v projections of one decode step, three matrices that share x).
//
// Computes, for each matrix i of up to three,
//   y[m, off_i + n] = (sum_k x[m,k] * u_i[k,n] - n_i * rowsum(x[m])) / n_i * scale_i[n]
// with u = sum_b 2^b plane_b the unsigned codes and n_i = 2^(bits_i-1) - 1,
// i.e. x @ dequant(planes_i), every product and sum in f32.  Planes are
// (bits, K/8, N) uint8: byte [b, j, col] holds bit b of rows 8j..8j+7 (row
// 8j+i in bit i), N minor-most.
//
// What bounds it on the H100: device-memory bytes (bits/8 bytes per
// weight, 2*M flops each, far below the ridge).  A CTA owns 64 columns of
// one matrix and up to MT = 8 rows; its 256 threads split K into 16
// interleaved slices (an in-CTA split-K, reduced through shared memory in
// a fixed order, so the result is deterministic).  A thread loads one
// 32-bit word per plane (4 columns) and rebuilds the 4 codes of one K row
// with shift/mask/or -- never an int tile -- then does one f32 FMA per
// (row, column).  The rank-1 offset n * rowsum(x) is computed once per row
// tile and applied in the epilogue.  Column tiles of the matrices follow
// each other along blockIdx.x, so the CTAs of all three are in flight at
// once and each plane byte is read once per row tile.  Ragged N and K/8
// are masked in the kernel.  A cross-CTA split-K along blockIdx.z is the
// caller's choice (splits > 1): split s walks K chunks [s * chunks /
// splits, (s + 1) * chunks / splits) and writes its raw partial, which the
// caller sums in split order and finishes (/ n * scale).  Known limit:
// latency-bound (a 512-row K chunk costs ~6 us with two barriers and
// dependent loads); N = 256 alone gives 4 CTAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitserial {

constexpr int THREADS = 256;
constexpr int TX = 16;                   // threads along N (4 columns each)
constexpr int TK = THREADS / TX;         // interleaved K slices
constexpr int COLS = TX * 4;             // columns per CTA
constexpr int KC = 512;                  // K rows of x staged per chunk
constexpr int SMEM = TK * 8 * COLS;      // floats: max(x chunk, reduction)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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
                         N, bits, s.ntot, s.tiles};
    s.ntot += N;
    s.tiles += (N + COLS - 1) / COLS;
}

// Tag (an empty struct of the caller's) only names the caller in the
// kernel's symbol, so a profile tells qmm from the fused projection.
template <typename Tag, typename T, int MT, bool VEC4>
__global__ void __launch_bounds__(THREADS)
bitserial_kernel(const T* __restrict__ x, Mats mats, float* __restrict__ y, int M, int K,
                 int splits) {
    static_assert(MT * KC <= SMEM && TK * MT * COLS <= SMEM, "smem");
    __shared__ __align__(16) float smem[SMEM];
    __shared__ float rowsum[MT];
    float* xs = smem;                            // [MT][KC] during the K loop

    // this CTA's matrix (constant indices only: no local copy of the params)
    Mat mat = mats.m[0];
    if (mats.count > 1 && (int)blockIdx.x >= mats.m[1].tile0) mat = mats.m[1];
    if (mats.count > 2 && (int)blockIdx.x >= mats.m[2].tile0) mat = mats.m[2];
    const uint8_t* __restrict__ planes = mat.planes;
    const int N = mat.N, bits = mat.bits;
    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int tk = tid / TX;
    const int warp = tid / 32, lane = tid % 32;
    const int m0 = blockIdx.y * MT;
    const int tile_col0 = ((int)blockIdx.x - mat.tile0) * COLS;
    const int col0 = tile_col0 + tx * 4;
    const int K8 = K / 8;
    // this split's K rows: whole chunks of KC
    const int split = blockIdx.z;
    const int chunks = (K + KC - 1) / KC;
    const int k_begin = split * chunks / splits * KC;
    const int k_end = min(K, (split + 1) * chunks / splits * KC);

    if (tid < MT) rowsum[tid] = 0.f;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][v] = 0.f;

    for (int kc0 = k_begin; kc0 < k_end; kc0 += KC) {
        __syncthreads();
        for (int i = tid; i < MT * KC; i += THREADS) {
            const int m = i / KC, kk = i % KC;
            const int gm = m0 + m, gk = kc0 + kk;
            xs[i] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
        }
        __syncthreads();
        // offset term: rowsum over the split's K, once per row tile
        if (warp < MT) {
            float s = 0.f;
            for (int kk = lane; kk < KC; kk += 32) s += xs[warp * KC + kk];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane == 0) rowsum[warp] += s;
        }
        if (col0 < N) {
            const int nk8 = min(KC, K - kc0) / 8;
            for (int r = tk; r < nk8; r += TK) {
                const int j = kc0 / 8 + r;
                uint32_t w[8];
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    w[b] = 0u;
                    if (b < bits) {
                        const uint8_t* p = planes + ((size_t)b * K8 + j) * N + col0;
                        if (VEC4) {
                            w[b] = __ldg(reinterpret_cast<const uint32_t*>(p));
                        } else {
#pragma unroll
                            for (int v = 0; v < 4; ++v)
                                if (col0 + v < N) w[b] |= (uint32_t)__ldg(p + v) << (8 * v);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    // unsigned codes of K row 8j+i for 4 columns, one per byte
                    uint32_t u = 0u;
#pragma unroll
                    for (int b = 0; b < 8; ++b)
                        if (b < bits) u |= ((w[b] >> i) & 0x01010101u) << b;
                    const float u0 = (float)(u & 0xffu), u1 = (float)((u >> 8) & 0xffu);
                    const float u2 = (float)((u >> 16) & 0xffu), u3 = (float)(u >> 24);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float xv = xs[m * KC + r * 8 + i];
                        acc[m][0] = fmaf(xv, u0, acc[m][0]);
                        acc[m][1] = fmaf(xv, u1, acc[m][1]);
                        acc[m][2] = fmaf(xv, u2, acc[m][2]);
                        acc[m][3] = fmaf(xv, u3, acc[m][3]);
                    }
                }
            }
        }
    }
    // the K loop is done: a grid launched as this one's programmatic
    // dependent may start its preamble (it waits for this grid's results
    // itself); without such a dependent this is a no-op
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    __syncthreads();
    float* red = smem;                           // [TK][MT][COLS]
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) red[(tk * MT + m) * COLS + tx * 4 + v] = acc[m][v];
    __syncthreads();
    const float nl = bits > 1 ? (float)((1 << (bits - 1)) - 1) : 1.f;
    for (int i = tid; i < MT * COLS; i += THREADS) {
        const int m = i / COLS, c = i % COLS;
        const int gm = m0 + m, gn = tile_col0 + c;
        if (gm >= M || gn >= N) continue;
        float s = 0.f;
        for (int t = 0; t < TK; ++t) s += red[(t * MT + m) * COLS + c];
        if (splits == 1)
            y[(size_t)gm * mats.ntot + mat.col_off + gn] = (s - nl * rowsum[m]) / nl * mat.scale[gn];
        else     // this split's raw partial
            y[((size_t)split * M + gm) * mats.ntot + mat.col_off + gn] = s - nl * rowsum[m];
    }
}

template <typename Tag, typename T, int MT>
void launch_mt(const T* x, const Mats& mats, float* y, int M, int K, int splits, bool vec4,
               cudaStream_t st) {
    dim3 grid(mats.tiles, (M + MT - 1) / MT, splits);
    if (vec4)
        bitserial_kernel<Tag, T, MT, true><<<grid, THREADS, 0, st>>>(x, mats, y, M, K, splits);
    else
        bitserial_kernel<Tag, T, MT, false><<<grid, THREADS, 0, st>>>(x, mats, y, M, K, splits);
}

// splits == 1: y (M, mats.ntot) f32 = x (M, K) @ [dequant(m_0) | dequant(m_1)
// | ...].  splits > 1 (at most ceil(K / KC)): y (splits, M, mats.ntot),
// split s's raw partial sum_k x * u - n * rowsum(x) over its K chunks.
template <typename Tag, typename T>
void launch(const T* x, const Mats& mats, float* y, int M, int K, int splits, cudaStream_t st) {
    bool vec4 = true;
    for (int i = 0; i < mats.count; ++i)
        vec4 = vec4 && mats.m[i].N % 4 == 0 &&
               reinterpret_cast<uintptr_t>(mats.m[i].planes) % 4 == 0;
    if (M <= 1) launch_mt<Tag, T, 1>(x, mats, y, M, K, splits, vec4, st);
    else if (M <= 2) launch_mt<Tag, T, 2>(x, mats, y, M, K, splits, vec4, st);
    else if (M <= 4) launch_mt<Tag, T, 4>(x, mats, y, M, K, splits, vec4, st);
    else launch_mt<Tag, T, 8>(x, mats, y, M, K, splits, vec4, st);
}

}  // namespace bitserial
