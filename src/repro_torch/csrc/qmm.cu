// Packed low-bit weight x activation matmul (qmm) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/qmm.py::qmm_pallas, both of
// its bodies:
//   _qmm_bitserial_kernel (qmm.py:78)  -> bitserial.cuh, tagged qmm_bitserial
//   _qmm_dequant_kernel   (qmm.py:57)  -> qmm_dequant_kernel below
// Both compute the function of kernels/ref.py::qmm_ref:
//   y[M,N] = x[M,K] @ ((u - n) / n * scale),  u = sum_b 2^b plane_b,
//   n = 2^(bits-1) - 1,
// with the planes stored as (bits, K/8, N) uint8: byte [b, j, col] holds
// bit b of rows 8j..8j+7 (row 8j+i in bit i), N minor-most.  x is bf16 or
// f32 and is widened to f32 exactly; every product and sum is f32.
//
// What bounds it on the H100: device-memory bytes.  At decode (M <= 32)
// a call streams bits/8 bytes per weight and does 2*M flops per weight,
// far below the card's ~295 flop/byte ridge; a 64-row prefill chunk is
// still below it.  So both bodies read every packed byte exactly once per
// row tile, as it is stored: N is minor-most, so neighbouring threads read
// neighbouring columns of one byte row (coalesced), and the packed
// operand is never padded or rewritten.  Ragged edges (N = 13696,
// K/8 = 1712 at glm4-9b) are masked in the kernel.
//
// bitserial (M <= 32, decode): GEMV-shaped, csrc/bitserial.cuh with one
// matrix (the same body computes the fused decode's q|k|v projections).
// Known limit: at N = 256 (wk, wv) the grid has 4 blocks; a split-K
// across blocks is the first fix (PERF.md).
//
// dequant (M > 32, prefill chunks): a shared-memory tiled GEMM, 64x128
// output tile per block, K step 32 (4 packed byte rows).  Each K step
// stages the x tile (widened to f32) and the rebuilt signed codes u - n
// (exact in f32) in shared memory; each thread accumulates an 8x4
// register tile with f32 FMAs; the epilogue applies / n * scale.  No
// tensor cores yet: wgmma and TMA are later work.
//
// Plain C interface (built with nvcc, loaded with ctypes).  Kernels
// allocate nothing; the entry point returns cudaGetLastError().

#include "bitserial.cuh"

namespace {

using bitserial::to_f32;

struct qmm_bitserial;   // names the bit-serial kernel's instances

// -------------------------------------------------------------- dequant
constexpr int DQ_THREADS = 256;
constexpr int DQ_BM = 64, DQ_BN = 128, DQ_BK = 32;  // DQ_BK = 4 packed byte rows
constexpr int DQ_TM = 8, DQ_TN = 4;                 // per-thread output tile
constexpr int DQ_PAD = 4;

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
qmm_dequant_kernel(const T* __restrict__ x, const uint8_t* __restrict__ planes,
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

template <typename T>
void launch(const T* x, const uint8_t* planes, const float* scale, float* y,
            int M, int K, int N, int bits, int path, cudaStream_t st) {
    if (path == 1) {
        dim3 grid((N + DQ_BN - 1) / DQ_BN, (M + DQ_BM - 1) / DQ_BM);
        qmm_dequant_kernel<T><<<grid, DQ_THREADS, 0, st>>>(x, planes, scale, y, M, K, N, bits);
        return;
    }
    bitserial::Mats mats{};
    bitserial::add(mats, planes, scale, N, bits);
    bitserial::launch<qmm_bitserial>(x, mats, y, M, K, st);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  path: 0 = bitserial, 1 = dequant.
extern "C" int qmm_launch(const void* x, int x_dtype, const void* planes,
                          const void* scale, void* y, int M, int K, int N,
                          int bits, int path, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || K % 8 || bits < 2 || bits > 8 ||
        (path != 0 && path != 1) || (x_dtype != 0 && x_dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* p = static_cast<const uint8_t*>(planes);
    const float* s = static_cast<const float*>(scale);
    float* out = static_cast<float*>(y);
    if (x_dtype == 1)
        launch(static_cast<const __nv_bfloat16*>(x), p, s, out, M, K, N, bits, path, st);
    else
        launch(static_cast<const float*>(x), p, s, out, M, K, N, bits, path, st);
    return (int)cudaGetLastError();
}
