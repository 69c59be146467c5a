// WRPN mid-tread fake-quant (quantize-dequantize) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fake_quant.py::fake_quant_pallas (body _fake_quant_kernel,
// fake_quant.py:33).  Same function as kernels/ref.py::fake_quant_ref, and
// bitwise so, element by element:
//
//   n   = bits >= 2 ? 2^(bits-1) - 1 : 1          (from integers)
//   out = bits >= 32 ? w : round(clip(w / scale, -1, 1) * n) / n * scale
//
// computed in f32 and written in w's dtype (f32, or bf16 rounded to
// nearest even).  Every body shares that arithmetic (code and value below):
//
// - The flat kernel (fake_quant_launch): one tensor at a scale the caller
//   gives, bits and scale as device scalars; a grid-stride loop over
//   numel with 16-byte vector loads and stores when the pointers are
//   aligned, then a masked scalar tail.  Its caller (the ADMM baseline)
//   makes 7 bitwidths x 20 ResNet-20 layers of at most 36,864 weights, so
//   a launch is a chain of latencies and not of bytes: each thread's
//   first vector of w is loaded before bits and scale (two DRAM trips
//   that ran in series now overlap), and the CTA tables q / n for n <=
//   TABLE_N while w is in flight (one IEEE division an element instead of
//   two).  What is left is an empty launch and one DRAM round trip
//   (scripts/kernel_ablation.py col; narrower blocks, which spread a
//   layer over more SMs, were no faster).
// - The grouped kernels of the QAT path: fake_quant_group_launch takes
//   every quantized weight of a forward in one launch and computes each
//   tensor's scale s_i = max(max|w_i|, eps) itself; fake_quant_group_bwd_launch
//   is the clipped straight-through estimator of all of them in one launch
//   (repro/quant/wrpn.py::_fq_bwd, which the JAX package leaves to XLA).
//
// Bitwise equality with the plain versions: each step is one IEEE f32
// operation in the reference's order (__fdiv_rn, __fmul_rn: never
// contracted into an FMA, never an approximate reciprocal); rintf rounds
// half to even like torch.round and jnp.round (roundf would move every
// tie); the clip is written with comparisons so a NaN stays a NaN, as
// jnp.clip keeps it (fminf/fmaxf would return the bound); n is built from
// integers (exp2f is not promised exact) and bits >= 32 is tested first,
// so 1 << 31 never happens.  The scale's max is a select that keeps a NaN
// (torch.amax and jnp.max propagate it; fmaxf would drop it), taken over
// |w| in f32, which for bf16 weights equals the max in bf16 (the widening
// is exact and monotone); the eps floor comes from the host already
// rounded to the group's dtype, as tensor_scale takes it.
//
// What bounds it on the H100: device-memory bytes -- one read and one
// write per element against ~9 f32 operations, far below the ridge.  At
// the QAT path's sizes (268,336 weights in 20 ResNet-20 layers, 1.07 MB
// in f32) the bytes take 0.64 us at 3.35 TB/s, so a launch is bound by
// its own latency: the flat kernel made 20 of them per forward, and the
// eager torch ops around them (the scale's abs/amax/maximum, the STE's
// abs/compare/cast/mul) made ~180 more.  The grouped design:
//
// - One thread-block cluster of C CTAs per tensor (C <= 8, the portable
//   size), all tensors of a forward in one grid.  The CTAs of a cluster
//   split the tensor into equal runs of 16-byte vectors; each CTA loads
//   its run into registers (up to MAX_VECS vectors a thread), takes the
//   max of |w| over them, reduces it over its warps, and writes it into a
//   slot of every CTA of its cluster through distributed shared memory
//   (map_shared_rank); one cluster barrier later each CTA combines the C
//   maxima from its own shared memory, in rank order.  (A barrier split
//   around the loads first makes sure every CTA of the cluster runs
//   before its shared memory is written.)  Each CTA then applies the
//   QDQ to the values it holds and stores them: every element is read
//   once and written once.  The QDQ's two IEEE divisions bounded the
//   launch (half its device time, scripts/kernel_ablation.py fq), so a
//   CTA first tables the 2n + 1 code values q / n * s with the same two
//   steps (n <= 127, bits <= 8), and each element divides once, by s,
//   and reads its value from shared memory.  A tensor whose run does not fit the
//   registers (glm4-9b's 56M-weight wg) walks its run twice, once for
//   the max and once for the QDQ.
// - The tensor descriptors travel by value in the kernel's parameters
//   (under 4 KB): the host builds no device table and copies nothing.
// - The backward is a flat map from block to (tensor, run of vectors),
//   one vector a thread (more CTAs were faster than longer runs):
//   grad = g * (|w| <= s_i ? 1 : 0) as an f32 product rounded to g's
//   dtype, so -0.0 and NaN come out as torch's g * inside gives them.
//
// The per-column grouped kernels of the LM QAT path
// (fake_quant_col_launch, fake_quant_col_bwd_launch) take the same QDQ at
// the scale repro/quant/qat.py::_qdq gives every stacked (L, K, N) leaf:
// s[l, n] = max(max_k |w[l, k, n]|, eps), with per-layer bits b[l].  What
// bounds the pair is device-memory bytes: the function reads and writes
// every weight once (2.46 ms at glm4-9b's 4-layer cell), and its STE reads
// w and g and writes the gradient (3.69 ms).  The forward is two passes
// over the same tiles (kernels/fake_quant.py::fake_quant_col_plan):
//
// - A tile is a strip of 512 bytes of each row (256 bf16 or 128 f32
//   columns: a warp reads one contiguous row piece, eight warps eight
//   rows) over a block of COL_ROWS = 256 rows of one layer, one CTA a tile,
//   strips fastest, so neighbouring CTAs read neighbouring pieces of the
//   same rows.  A thread walks its column vector down the block with
//   COL_RING rows in flight through its own slots of a cp.async ring in
//   shared memory (32 KB a CTA), which leaves the registers to the QDQ
//   (4 CTAs an SM).
// - The max pass takes each tile's column maxima as integer maxima of
//   |w|'s bits (exact, and order-free) and merges them into the (L, N)
//   scales, which the wrapper fills with eps, by an unsigned atomicMax of
//   their f32 bits.  It runs near the card's read rate.
// - The QDQ pass reads the tile again and writes it at those scales, one
//   IEEE division an element with q / n from a per-CTA table, through
//   streaming (evict-first) stores: write-back stores cost it a quarter
//   more time.  The pair moves 1.5x the function's bytes.
// - Measured and dropped (PERF.md): one read, each tile's K range split
//   over a cluster of up to 8 CTAs that held their rows in 64 KB shared
//   slabs, combined their maxima through distributed shared memory and
//   wrote the QDQ from the slab (slower at glm4-9b's cell: its load,
//   exchange and compute phases did not overlap at 2-3 CTAs an SM, and
//   embed and wd still read twice); and rows loaded into registers in
//   place of the ring (no faster there; scripts/kernel_ablation.py col
//   times them).
//
// The two passes are also entry points of their own
// (fake_quant_col_max_launch, fake_quant_col_qdq_launch): under tensor
// parallelism a row-parallel leaf's K is split across ranks, and its scales
// are the max over those ranks, an all_reduce MAX between the passes
// (dist/tp.py).  A max is exact, so each rank's QDQ is bitwise its shard of
// the whole leaf's.
//
// The STE backward reduces nothing: a flat map over each leaf's memory
// (fake_quant_col_bwd_kernel), STE_VECS vectors of w and g a thread in
// flight, each element's scale gathered.  Every leaf of a QAT forward goes
// in one call (descriptors by value, COL_MAX leaves a call), and its
// backward in one launch more.
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernels
// allocate nothing; the entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FP_BITS = 32;
constexpr int TABLE_N = 127;       // levels tabled up to 8 bits (n = 2^7 - 1)

struct Params {
    int fp;      // bits >= 32: pass w through
    float n;     // levels
    float scale;
};

__device__ __forceinline__ Params make_params(int bits, float scale) {
    Params p;
    p.fp = bits >= FP_BITS;
    p.n = p.fp ? 1.f : (bits >= 2 ? __int2float_rn((1 << (bits - 1)) - 1) : 1.f);
    p.scale = scale;
    return p;
}

// the code q = round(clip(w / scale, -1, 1) * n), an integer in [-n, n]
// or NaN, and its value q / n * scale
__device__ __forceinline__ float code(float w, const Params& p) {
    float wc = __fdiv_rn(w, p.scale);
    wc = wc < -1.f ? -1.f : (wc > 1.f ? 1.f : wc);   // NaN compares false: kept
    return rintf(__fmul_rn(wc, p.n));
}

__device__ __forceinline__ float value(float q, const Params& p) {
    return __fmul_rn(__fdiv_rn(q, p.n), p.scale);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

// N elements of T fill 16 bytes: one 128-bit load or store.
template <typename T>
struct alignas(16) Vec {
    static constexpr int N = 16 / sizeof(T);
    T v[N];
};

// The value of code q: __fmul_rn(q / n, scale), with q / n read from a table
// of n <= TABLE_N levels where there is one (bitwise value(): the table holds
// __fdiv_rn's results; q = +-0 keeps its sign and a NaN code stays a NaN, as
// value() gives them, since q / n is q there).
__device__ __forceinline__ float tabled_value(float q, const Params& p, const float* qn, int n) {
    if (!qn) return value(q, p);
    return __fmul_rn((q == 0.f || q != q) ? q : qn[(int)q + n], p.scale);
}

// bits >= 32 keeps the loaded bits (a bf16 NaN keeps its payload)
template <typename T>
__device__ __forceinline__ void qdq_flat(Vec<T>& r, const Params& p, const float* qn, int n) {
    if (p.fp) return;
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j)
        from_f32(tabled_value(code(to_f32(r.v[j]), p), p, qn, n), &r.v[j]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const T* __restrict__ w, T* __restrict__ out, const int* __restrict__ bits,
                  const float* __restrict__ scale, int64_t numel, int vectorized) {
    __shared__ float qn[2 * TABLE_N + 1];     // qn[q + n] = q / n
    constexpr int N = Vec<T>::N;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t nvec = vectorized ? numel / N : 0;
    const Vec<T>* wv = reinterpret_cast<const Vec<T>*>(w);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
    Vec<T> r;
    if (tid < nvec) r = wv[tid];              // in flight while bits and scale are read
    const Params p = make_params(__ldg(bits), __ldg(scale));
    const int n = (int)p.n;
    const bool tabled = n <= TABLE_N && !p.fp;   // the same for every thread
    if (tabled) {
        for (int q = (int)threadIdx.x - n; q <= n; q += blockDim.x)
            qn[q + n] = __fdiv_rn((float)q, p.n);
        __syncthreads();
    }
    const float* table = tabled ? qn : nullptr;
    for (int64_t i = tid; i < nvec; i += stride) {
        if (i != tid) r = wv[i];
        qdq_flat(r, p, table, n);
        ov[i] = r;
    }
    for (int64_t i = nvec * N + tid; i < numel; i += stride) {
        const float x = to_f32(w[i]);
        if (p.fp) out[i] = w[i];
        else from_f32(tabled_value(code(x, p), p, table, n), &out[i]);
    }
}

template <typename T>
int launch(const void* w, void* out, const int* bits, const float* scale, int64_t numel,
           int vectorized, cudaStream_t st) {
    const int64_t per_block = (int64_t)THREADS * (vectorized ? Vec<T>::N : 1);
    int64_t blocks = (numel + per_block - 1) / per_block;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 blocks per SM
    if (blocks < 1) blocks = 1;
    fake_quant_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const T*>(w), static_cast<T*>(out), bits, scale, numel, vectorized);
    return (int)cudaGetLastError();
}

// An empty kernel: the launch-latency floor that a launch-bound kernel's
// byte bound cannot show.
__global__ void empty_kernel() {}


// ---- the grouped kernels of the QAT path ------------------------------------

constexpr int GROUP_MAX = 102;     // tensors per launch: BwdArgs fills 4 KB
constexpr int MAX_VECS = 8;        // 16-byte vectors a forward thread holds
constexpr int BWD_VECS = 1;        // 16-byte vectors a backward thread handles
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

struct FwdTensor {
    const void* w;
    void* out;
    int64_t numel;
};

struct FwdArgs {
    const int* bits;   // bits[i]: tensor i's bitwidth
    float* scale;      // scale[i] = s_i, written for the backward
    float eps;         // the floor, rounded to the group's dtype
    int count;
    FwdTensor t[GROUP_MAX];
};

struct BwdTensor {
    const void* w;
    const void* g;
    void* grad;
    int64_t numel;
    int64_t block0;    // first block of this tensor
};

struct BwdArgs {
    const float* scale;
    int count;
    BwdTensor t[GROUP_MAX];
};

static_assert(sizeof(FwdArgs) <= 4096 && sizeof(BwdArgs) <= 4096,
              "a launch's tensor descriptors must fit the 4 KB of kernel parameters");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// max that keeps a NaN in either operand (a select, so its bits too)
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

template <typename T>
__device__ __forceinline__ float max_abs(float m, const Vec<T>& r) {
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) m = max_nan(m, fabsf(to_f32(r.v[j])));
    return m;
}

// Vector v of a tensor of numel elements: one 16-byte load when the
// pointer is aligned and the vector whole, else element by element up to
// numel; zeros at and past v_end (zeros leave max|w| as it is).
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int64_t v, int64_t v_end,
                                         int64_t numel, bool aligned, Vec<T>& r) {
    constexpr int N = Vec<T>::N;
    if (aligned && v < v_end && (v + 1) * N <= numel) {
        r = reinterpret_cast<const Vec<T>*>(p)[v];
        return;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const int64_t i = v * N + j;
        if (v < v_end && i < numel) r.v[j] = p[i];
        else from_f32(0.f, &r.v[j]);
    }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int64_t v, int64_t v_end,
                                          int64_t numel, bool aligned, const Vec<T>& r) {
    constexpr int N = Vec<T>::N;
    if (v >= v_end) return;
    if (aligned && (v + 1) * N <= numel) {
        reinterpret_cast<Vec<T>*>(p)[v] = r;
        return;
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
        if (v * N + j < numel) p[v * N + j] = r.v[j];
}

// bits >= 32 stores the loaded bits unchanged (a bf16 NaN keeps its payload).
// With a table (levels[q + n] = value(q), built by the CTA for n <= TABLE_N)
// a code's value is a shared-memory read instead of a division and a
// multiply: bitwise the same, since the table holds value()'s own results,
// except at q = +-0, whose sign value() keeps (-0 / n * s = -0), and at a
// NaN code, for which value() returns the NaN itself (the card's arithmetic
// writes every NaN as 0x7fffffff): both select q.
template <typename T>
__device__ __forceinline__ void qdq_vec(Vec<T>& r, const Params& p, const float* levels, int n) {
    if (p.fp) return;
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) {
        const float q = code(to_f32(r.v[j]), p);
        float v;
        if (levels) v = (q == 0.f || q != q) ? q : levels[(int)q + n];
        else v = value(q, p);
        from_f32(v, &r.v[j]);
    }
}

__device__ __forceinline__ int cluster_ctas() {
    unsigned n;
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return (int)n;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster per tensor: blockIdx.x / C is the tensor, the rank in the
// cluster the run of vectors.  A run of at most THREADS * MAX_VECS
// vectors stays in registers between the max and the QDQ; a longer one is
// read twice.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_group_kernel(const __grid_constant__ FwdArgs a) {
    namespace cg = cooperative_groups;
    __shared__ float warp_max[THREADS / 32];
    __shared__ float cta_max[MAX_CLUSTER];    // slot q: the max of the cluster's rank q
    __shared__ float levels[2 * TABLE_N + 1]; // levels[q + n]: the value of code q
    const cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive_relaxed();         // this CTA runs: the others may write its slots
    const int C = cluster_ctas();
    const int rank = (int)cluster.block_rank();
    const int ti = blockIdx.x / C;
    const int bits = __ldg(a.bits + ti);
    const T* w = static_cast<const T*>(a.t[ti].w);
    T* out = static_cast<T*>(a.t[ti].out);
    const int64_t numel = a.t[ti].numel;
    constexpr int N = Vec<T>::N;
    const int64_t nvec = (numel + N - 1) / N;
    const int64_t run = (nvec + C - 1) / C;
    const int64_t v0 = min64((int64_t)rank * run, nvec);
    const int64_t v1 = min64(v0 + run, nvec);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const bool resident = run <= (int64_t)THREADS * MAX_VECS;
    const int nv = resident ? (int)((run + THREADS - 1) / THREADS) : MAX_VECS;
    const int tid = threadIdx.x;

    Vec<T> r[MAX_VECS];
    float m = 0.f;
    if (resident) {
#pragma unroll
        for (int k = 0; k < MAX_VECS; ++k)
            if (k < nv) load_vec(w, v0 + k * THREADS + tid, v1, numel, aligned, r[k]);
#pragma unroll
        for (int k = 0; k < MAX_VECS; ++k)
            if (k < nv) m = max_abs(m, r[k]);
    } else {
        for (int64_t base = v0; base < v1; base += THREADS * MAX_VECS) {
#pragma unroll
            for (int k = 0; k < MAX_VECS; ++k)
                load_vec(w, base + k * THREADS + tid, v1, numel, aligned, r[k]);
#pragma unroll
            for (int k = 0; k < MAX_VECS; ++k) m = max_abs(m, r[k]);
        }
    }

    // max over the CTA, then over the cluster's CTAs in rank order
#pragma unroll
    for (int off = 16; off; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    cluster_wait();                   // every CTA of the cluster has started
    if (tid < C) {                    // thread q writes this CTA's max into rank q's slot
        float c = warp_max[0];
#pragma unroll
        for (int i = 1; i < THREADS / 32; ++i) c = max_nan(c, warp_max[i]);
        *cluster.map_shared_rank(&cta_max[rank], tid) = c;
    }
    cluster_arrive();                 // release: this CTA's writes are visible
    cluster_wait();                   // acquire: every rank's max is in cta_max
    float s = cta_max[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < C) s = max_nan(s, cta_max[q]);
    // torch's f32 abs on the card writes every NaN as 0x7fffffff, so the
    // plain version's scale does too; its bf16 abs writes every NaN as
    // 0x7fff (the card's f32 -> bf16 conversion), whatever the payload
    if (s != s) s = __int_as_float(sizeof(T) == 4 ? 0x7fffffff : 0x7fff0000);
    s = max_nan(s, a.eps);
    if (rank == 0 && tid == 0) a.scale[ti] = s;

    const Params p = make_params(bits, s);
    const int n = (int)p.n;
    const float* table = nullptr;
    if (!p.fp && n <= TABLE_N) {      // bits[ti] and s are the CTA's own: no divergence
        for (int q = tid - n; q <= n; q += THREADS) levels[q + n] = value((float)q, p);
        __syncthreads();
        table = levels;
    }
    if (resident) {
#pragma unroll
        for (int k = 0; k < MAX_VECS; ++k) {
            if (k < nv) {
                qdq_vec(r[k], p, table, n);
                store_vec(out, v0 + k * THREADS + tid, v1, numel, aligned, r[k]);
            }
        }
    } else {
        for (int64_t base = v0; base < v1; base += THREADS * MAX_VECS) {
#pragma unroll
            for (int k = 0; k < MAX_VECS; ++k)
                load_vec(w, base + k * THREADS + tid, v1, numel, aligned, r[k]);
#pragma unroll
            for (int k = 0; k < MAX_VECS; ++k) {
                qdq_vec(r[k], p, table, n);
                store_vec(out, base + k * THREADS + tid, v1, numel, aligned, r[k]);
            }
        }
    }
}

// Blocks of a tensor cover THREADS * BWD_VECS vectors each, from its block0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_group_bwd_kernel(const __grid_constant__ BwdArgs a) {
    int lo = 0, hi = a.count - 1;     // the last tensor whose block0 <= blockIdx.x
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.t[mid].block0 <= (int64_t)blockIdx.x) lo = mid;
        else hi = mid - 1;
    }
    const T* w = static_cast<const T*>(a.t[lo].w);
    const T* g = static_cast<const T*>(a.t[lo].g);
    T* grad = static_cast<T*>(a.t[lo].grad);
    const int64_t numel = a.t[lo].numel;
    const float s = __ldg(a.scale + lo);
    constexpr int N = Vec<T>::N;
    const int64_t nvec = (numel + N - 1) / N;
    const int64_t base = ((int64_t)blockIdx.x - a.t[lo].block0) * THREADS * BWD_VECS;
    const bool aligned = ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(grad)) & 15) == 0;
    Vec<T> wr[BWD_VECS], gr[BWD_VECS];
#pragma unroll
    for (int k = 0; k < BWD_VECS; ++k) {
        const int64_t v = base + k * THREADS + threadIdx.x;
        load_vec(w, v, nvec, numel, aligned, wr[k]);
        load_vec(g, v, nvec, numel, aligned, gr[k]);
    }
#pragma unroll
    for (int k = 0; k < BWD_VECS; ++k) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const float inside = fabsf(to_f32(wr[k].v[j])) <= s ? 1.f : 0.f;
            from_f32(__fmul_rn(to_f32(gr[k].v[j]), inside), &gr[k].v[j]);
        }
        store_vec(grad, base + k * THREADS + threadIdx.x, nvec, numel, aligned, gr[k]);
    }
}

template <typename T>
int launch_group(const FwdArgs& a, int cluster, cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(a.count * cluster));
    cfg.blockDim = dim3(THREADS);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, fake_quant_group_kernel<T>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename T>
int launch_group_bwd(const BwdArgs& a, int64_t blocks, cudaStream_t st) {
    fake_quant_group_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}



// ---- the per-column grouped kernels of the LM QAT path ----------------------

constexpr int COL_MAX = 56;        // leaves per launch: ColArgs fills 4 KB
constexpr int COL_TX = 32;         // threads across a strip: a warp reads 512 bytes of a row
constexpr int COL_TY = THREADS / COL_TX;   // rows a CTA takes at a time
constexpr int COL_ROWS = 256;      // rows of a row block: a tile is a strip of one
constexpr int COL_RING = 8;        // rows a thread has in flight through its cp.async ring
constexpr int COL_UNROLL = 4;      // rows a thread has in flight in registers (unaligned leaves)
constexpr int COL_MIN_CTAS = 4;    // CTAs an SM the QDQ pass's register budget leaves room for
constexpr int STE_VECS = 2;        // 16-byte vectors of w and of g a backward thread has in flight

struct ColLeaf {
    const void* w;
    void* out;
    float* scale;      // (L, N) f32: filled with eps before the max pass
    const int* bits;   // bits[bits_run ? l / bits_run : 0]
    int64_t K;
    int64_t cta0;      // first CTA of this leaf
    int N;
    int strips;        // column strips per layer
    int blocks;        // row blocks per layer
    int bits_run;      // flattened layers sharing a bitwidth; 0: one for the leaf
};

struct ColArgs {
    int count;
    int pad[3];
    ColLeaf t[COL_MAX];
};

struct ColBwdLeaf {
    const void* w;
    const void* g;
    void* grad;
    const float* scale;   // (L, N) f32, the forward's
    int64_t numel;
    int64_t block0;       // first block of this leaf
    int64_t K;
    int N;
    int pad;
};

struct ColBwdArgs {
    int count;
    int pad[3];
    ColBwdLeaf t[COL_MAX];
};

static_assert(sizeof(ColArgs) <= 4096 && sizeof(ColBwdArgs) <= 4096,
              "the per-column descriptors must fit 4 KB");

// A column's max key: the bits of |w| as an unsigned integer (for bf16 the
// 16 bits of the bf16 value).  Over non-negative floats the integer order is
// the float order, and every NaN sits above +inf, so the max is exact, keeps
// a NaN, and does not depend on the order in which partial maxima meet.
__device__ __forceinline__ void max_keys(uint32_t (&acc)[4], const Vec<float>& r) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(r.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = max(acc[i], u[i] & 0x7fffffffu);
}

// bf16: two 16-bit keys a word, compared as unsigned halves
__device__ __forceinline__ void max_keys(uint32_t (&acc)[4], const Vec<__nv_bfloat16>& r) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(r.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __vmaxu2(acc[i], u[i] & 0x7fff7fffu);
}

// column j (< Vec<T>::N) of a thread's keys
__device__ __forceinline__ uint32_t key_of(const uint32_t (&acc)[4], int j, float) { return acc[j]; }
__device__ __forceinline__ uint32_t key_of(const uint32_t (&acc)[4], int j, __nv_bfloat16) {
    return (acc[j >> 1] >> (16 * (j & 1))) & 0xffffu;
}

// The f32 bits of a column's max |w| (a bf16 one widened exactly), a NaN
// written as the plain version's abs writes it on the card whatever its
// payload: torch's f32 abs as 0x7fffffff, its bf16 abs as 0x7fff (see
// fake_quant_group_kernel).  That is the largest key of its dtype, so an
// unsigned max of these bits keeps it, and which NaN meets which does not
// matter.
__device__ __forceinline__ uint32_t scale_bits(uint32_t key, float) {
    return key > 0x7f800000u ? 0x7fffffffu : key;
}
__device__ __forceinline__ uint32_t scale_bits(uint32_t key, __nv_bfloat16) {
    return key > 0x7f80u ? 0x7fff0000u : key << 16;
}

// A row's NV columns from c, element by element, zeros at and past N.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ row, int64_t c, int64_t N,
                                          Vec<T>& r) {
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) {
        if (c + j < N) r.v[j] = row[c + j];
        else from_f32(0.f, &r.v[j]);
    }
}

// The QDQ pass's stores: streaming (st.global.cs, evict-first); nothing
// the pass writes is read again in it.
template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ row, int64_t c, int64_t N,
                                           bool aligned, const Vec<T>& r) {
    constexpr int NV = Vec<T>::N;
    if (aligned && c + NV <= N) {
        __stcs(reinterpret_cast<int4*>(row + c), *reinterpret_cast<const int4*>(&r));
        return;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
        if (c + j < N) row[c + j] = r.v[j];
}

// The QDQ of one row vector at its columns' scales (bits >= 32: unchanged).
template <typename T>
__device__ __forceinline__ void qdq_cols(Vec<T>& r, bool fp, const Params (&p)[Vec<T>::N],
                                         const float* qn, int n) {
    if (fp) return;
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j)
        from_f32(tabled_value(code(to_f32(r.v[j]), p[j]), p[j], qn, n), &r.v[j]);
}

// This CTA's leaf, layer, first row, rows and first column: strips fastest,
// then row blocks, then layers, so neighbouring CTAs read neighbouring
// pieces of the same rows.
struct ColCta {
    int leaf;
    int64_t layer, k0, col0;
    int rows;
};

__device__ __forceinline__ ColCta col_cta(const ColArgs& a, int sw) {
    int lo = 0, hi = a.count - 1;     // the last leaf whose cta0 <= blockIdx.x
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.t[mid].cta0 <= (int64_t)blockIdx.x) lo = mid;
        else hi = mid - 1;
    }
    const ColLeaf& L = a.t[lo];
    int64_t local = (int64_t)blockIdx.x - L.cta0;
    ColCta c;
    c.leaf = lo;
    c.col0 = (local % L.strips) * (int64_t)sw;
    local /= L.strips;
    c.k0 = (local % L.blocks) * (int64_t)COL_ROWS;
    c.layer = local / L.blocks;
    c.rows = (int)min64((int64_t)COL_ROWS, L.K - c.k0);
    return c;
}

// Walks this thread's rows ty, ty + COL_TY, ... < rows of the column vector
// col of an aligned leaf (row 0 at w), COL_RING 16-byte cp.async copies in
// flight through the thread's own slots of the ring: each row's vector is
// handed to f(v, r), then its slot takes the row COL_RING further on.  A
// thread reads back only its own copies, so no barrier is needed.  Columns
// past N load zeros (and store nothing).
template <typename T, typename F>
__device__ __forceinline__ void ring_rows(Vec<T> (*ring)[THREADS], const T* w, int64_t N,
                                          int64_t col, int ty, int rows, F&& f) {
    const int m = ty < rows ? (rows - ty + COL_TY - 1) / COL_TY : 0;
    const bool live = col < N;
    Vec<T>* mine = &ring[0][threadIdx.x];
#pragma unroll
    for (int i = 0; i < COL_RING; ++i) {
        const bool ok = live && i < m;
        wg::cp_async16(mine + i * THREADS, ok ? w + (int64_t)(ty + i * COL_TY) * N + col : w,
                       ok);
        wg::cp_async_commit();
    }
    for (int i = 0; i < m; ++i) {
        wg::cp_async_wait<COL_RING - 1>();         // row i has landed
        Vec<T>* slot = mine + (i % COL_RING) * THREADS;
        Vec<T> v = *slot;
        f(v, ty + i * COL_TY);                     // consumes v before the slot is refilled
        const bool ok = live && i + COL_RING < m;
        wg::cp_async16(slot, ok ? w + (int64_t)(ty + (i + COL_RING) * COL_TY) * N + col : w,
                       ok);
        wg::cp_async_commit();
    }
    wg::cp_async_wait<0>();
}

// The same walk for a leaf whose N is not a multiple of the vector or whose
// pointers are not 16-byte aligned: element-by-element loads, COL_UNROLL rows
// in flight.
template <typename T, typename F>
__device__ __forceinline__ void unaligned_rows(const T* w, int64_t N, int64_t col, int ty,
                                               int rows, F&& f) {
    for (int r0 = 0; r0 < rows; r0 += COL_TY * COL_UNROLL) {
        Vec<T> v[COL_UNROLL];
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
            const int r = r0 + u * COL_TY + ty;
            if (r < rows) load_cols(w + r * N, col, N, v[u]);
        }
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
            const int r = r0 + u * COL_TY + ty;
            if (r < rows) f(v[u], r);
        }
    }
}

// Pass 1: each CTA takes the column maxima of its row block of one strip
// and merges them into the (L, N) scales, which hold eps, with an unsigned
// atomicMax on their bits: exact, and independent of the order in which
// CTAs arrive (a maximum already as large is read first and left alone).
template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_col_max_kernel(const __grid_constant__ ColArgs a) {
    constexpr int NV = Vec<T>::N;
    constexpr int SW = COL_TX * NV;               // columns a strip covers
    __shared__ Vec<T> ring[COL_RING][THREADS];
    __shared__ uint32_t red[COL_TY][SW];
    const ColCta c = col_cta(a, SW);
    const ColLeaf& L = a.t[c.leaf];
    const int64_t N = L.N;
    const T* w = static_cast<const T*>(L.w) + ((size_t)c.layer * L.K + c.k0) * (size_t)N;
    const bool aligned = N % NV == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const int tx = threadIdx.x % COL_TX, ty = threadIdx.x / COL_TX;
    const int64_t col = c.col0 + (int64_t)tx * NV;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    auto take = [&](Vec<T>& v, int) { max_keys(acc, v); };
    if (aligned) ring_rows(ring, w, N, col, ty, c.rows, take);
    else unaligned_rows(w, N, col, ty, c.rows, take);
#pragma unroll
    for (int j = 0; j < NV; ++j) red[ty][tx * NV + j] = key_of(acc, j, T{});
    __syncthreads();
    for (int i = threadIdx.x; i < SW; i += THREADS) {
        uint32_t k = red[0][i];
#pragma unroll
        for (int y = 1; y < COL_TY; ++y) k = max(k, red[y][i]);
        if (!k || c.col0 + i >= N) continue;
        unsigned int* dst = reinterpret_cast<unsigned int*>(L.scale + c.layer * N + c.col0 + i);
        const uint32_t bits = scale_bits(k, T{});
        if (*reinterpret_cast<volatile unsigned int*>(dst) < bits) atomicMax(dst, bits);
    }
}

// Pass 2: each CTA reads its row block of one strip again and writes the
// QDQ at its columns' scales, with its layer's q / n table.
template <typename T>
__global__ void __launch_bounds__(THREADS, COL_MIN_CTAS)
fake_quant_col_kernel(const __grid_constant__ ColArgs a) {
    constexpr int NV = Vec<T>::N;
    constexpr int SW = COL_TX * NV;
    __shared__ Vec<T> ring[COL_RING][THREADS];
    __shared__ float qn[2 * TABLE_N + 1];         // qn[q + n] = q / n
    const ColCta c = col_cta(a, SW);
    const ColLeaf& L = a.t[c.leaf];
    const int64_t N = L.N;
    const size_t off = ((size_t)c.layer * L.K + c.k0) * (size_t)N;
    const T* w = static_cast<const T*>(L.w) + off;
    T* out = static_cast<T*>(L.out) + off;
    const bool aligned = N % NV == 0 &&
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int tx = threadIdx.x % COL_TX, ty = threadIdx.x / COL_TX;
    const int64_t col = c.col0 + (int64_t)tx * NV;
    const int bits = __ldg(L.bits + (L.bits_run ? c.layer / L.bits_run : 0));
    const bool fp = bits >= FP_BITS;
    const int n = fp ? 1 : (bits >= 2 ? (1 << (bits - 1)) - 1 : 1);
    const bool tabled = n <= TABLE_N && !fp;
    if (tabled) {
        for (int q = (int)threadIdx.x - n; q <= n; q += THREADS)
            qn[q + n] = __fdiv_rn((float)q, (float)n);
        __syncthreads();
    }
    Params p[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
        p[j] = {0, (float)n, col + j < N ? L.scale[c.layer * N + col + j] : 1.f};
    const float* table = tabled ? qn : nullptr;
    auto put = [&](Vec<T>& v, int r) {
        qdq_cols(v, fp, p, table, n);
        store_cols(out + r * N, col, N, aligned, v);
    };
    if (aligned) ring_rows(ring, w, N, col, ty, c.rows, put);
    else unaligned_rows(w, N, col, ty, c.rows, put);
}

// The forward's passes over the same CTAs: the max pass (max_pass), the QDQ
// pass (qdq_pass), or both in turn.
template <typename T>
int launch_col(const ColArgs& a, int64_t ctas, cudaStream_t st, bool max_pass, bool qdq_pass) {
    if (max_pass) {
        fake_quant_col_max_kernel<T><<<(unsigned)ctas, THREADS, 0, st>>>(a);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess || !qdq_pass) return (int)e;
    }
    fake_quant_col_kernel<T><<<(unsigned)ctas, THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// The STE backward as a flat map over each leaf's contiguous (L, K, N)
// elements: STE_VECS 16-byte vectors of w and of g a thread in flight, each
// element's scale gathered from scale[l * N + n] (L2-resident: glm4-9b's
// lm_head holds 606 KB of them).  grad = g * (|w| <= s) as an f32 product
// rounded to g's dtype, so -0.0 and NaN come out as torch's g * inside
// gives them.  A leaf whose N is not a multiple of the vector, or whose
// pointers are not 16-byte aligned, takes element-by-element loads.
template <typename T>
__device__ __forceinline__ void ste_vec(Vec<T>& g, const Vec<T>& w, const float* s) {
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) {
        const float inside = fabsf(to_f32(w.v[j])) <= s[j] ? 1.f : 0.f;
        from_f32(__fmul_rn(to_f32(g.v[j]), inside), &g.v[j]);
    }
}

// element e's (layer-major) scale index l * N + n
__device__ __forceinline__ int64_t scale_index(int64_t e, int64_t K, int64_t N, bool narrow) {
    if (narrow) {                                  // numel < 2^32: 32-bit divisions
        const uint32_t row = (uint32_t)e / (uint32_t)N;
        return (int64_t)((row / (uint32_t)K) * (uint32_t)N + ((uint32_t)e - row * (uint32_t)N));
    }
    const int64_t row = e / N;
    return (row / K) * N + (e - row * N);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_col_bwd_kernel(const __grid_constant__ ColBwdArgs a) {
    constexpr int NV = Vec<T>::N;
    int lo = 0, hi = a.count - 1;     // the last leaf whose block0 <= blockIdx.x
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.t[mid].block0 <= (int64_t)blockIdx.x) lo = mid;
        else hi = mid - 1;
    }
    const ColBwdLeaf& L = a.t[lo];
    const T* w = static_cast<const T*>(L.w);
    const T* g = static_cast<const T*>(L.g);
    T* grad = static_cast<T*>(L.grad);
    const int64_t numel = L.numel, K = L.K, N = L.N;
    const bool narrow = numel <= 0xffffffffLL;
    const int64_t nvec = (numel + NV - 1) / NV;
    const int64_t base = ((int64_t)blockIdx.x - L.block0) * THREADS * STE_VECS + threadIdx.x;
    const bool aligned = N % NV == 0 &&
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
          reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(L.scale)) & 15) == 0;
    if (aligned) {                    // a vector lies in one row: NV adjacent scales
        Vec<T> wr[STE_VECS], gr[STE_VECS];
#pragma unroll
        for (int u = 0; u < STE_VECS; ++u) {
            const int64_t v = base + u * THREADS;
            if (v < nvec) {
                wr[u] = reinterpret_cast<const Vec<T>*>(w)[v];
                gr[u] = reinterpret_cast<const Vec<T>*>(g)[v];
            }
        }
#pragma unroll
        for (int u = 0; u < STE_VECS; ++u) {
            const int64_t v = base + u * THREADS;
            if (v >= nvec) continue;
            const float4* sp = reinterpret_cast<const float4*>(
                L.scale + scale_index(v * NV, K, N, narrow));
            float s[NV];
#pragma unroll
            for (int i = 0; i < NV / 4; ++i) {
                const float4 q = __ldg(sp + i);
                s[4 * i] = q.x, s[4 * i + 1] = q.y, s[4 * i + 2] = q.z, s[4 * i + 3] = q.w;
            }
            ste_vec(gr[u], wr[u], s);
            reinterpret_cast<Vec<T>*>(grad)[v] = gr[u];
        }
        return;
    }
    for (int u = 0; u < STE_VECS; ++u) {
        const int64_t v = base + u * THREADS;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int64_t e = v * NV + j;
            if (v >= nvec || e >= numel) continue;
            const float s = __ldg(L.scale + scale_index(e, K, N, narrow));
            const float inside = fabsf(to_f32(w[e])) <= s ? 1.f : 0.f;
            from_f32(__fmul_rn(to_f32(g[e]), inside), &grad[e]);
        }
    }
}

template <typename T>
int launch_col_bwd(const ColBwdArgs& a, int64_t blocks, cudaStream_t st) {
    fake_quant_col_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype (of w and out): 0 = float32, 1 = bfloat16.  w, out: numel
// contiguous elements; bits: one int32; scale: one float32 (all device
// pointers).  vectorized: w and out are 16-byte aligned.
extern "C" int fake_quant_launch(const void* w, void* out, const void* bits, const void* scale,
                                 int64_t numel, int dtype, int vectorized, void* stream) {
    if (numel <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* b = static_cast<const int*>(bits);
    const float* s = static_cast<const float*>(scale);
    if (dtype == 1) return launch<__nv_bfloat16>(w, out, b, s, numel, vectorized, st);
    return launch<float>(w, out, b, s, numel, vectorized, st);
}

// The constants a launch plan must agree with (kernels/fake_quant.py):
// out = {THREADS, MAX_VECS, BWD_VECS, GROUP_MAX, MAX_CLUSTER, sizeof(FwdArgs),
// sizeof(BwdArgs)}.
extern "C" void fake_quant_group_limits(int* out) {
    out[0] = THREADS;
    out[1] = MAX_VECS;
    out[2] = BWD_VECS;
    out[3] = GROUP_MAX;
    out[4] = MAX_CLUSTER;
    out[5] = (int)sizeof(FwdArgs);
    out[6] = (int)sizeof(BwdArgs);
}

// Grouped forward.  ws[i], outs[i]: numels[i] > 0 contiguous elements of
// one dtype (0 = float32, 1 = bfloat16), i < count <= GROUP_MAX; bits:
// count int32 and scale: count float32 (device pointers); eps: the floor
// in that dtype, as f32; cluster: CTAs per tensor, 1 to MAX_CLUSTER.
// Writes outs[i] = qdq(ws[i], bits[i], s_i) and scale[i] = s_i.
extern "C" int fake_quant_group_launch(const void* const* ws, void* const* outs,
                                       const int64_t* numels, int count, const void* bits,
                                       void* scale, float eps, int dtype, int cluster,
                                       void* stream) {
    if (count < 1 || count > GROUP_MAX || cluster < 1 || cluster > MAX_CLUSTER ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    FwdArgs a = {};
    a.bits = static_cast<const int*>(bits);
    a.scale = static_cast<float*>(scale);
    a.eps = eps;
    a.count = count;
    for (int i = 0; i < count; ++i) {
        if (numels[i] <= 0) return (int)cudaErrorInvalidValue;
        a.t[i] = {ws[i], outs[i], numels[i]};
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_group<__nv_bfloat16>(a, cluster, st);
    return launch_group<float>(a, cluster, st);
}

// Grouped STE backward.  ws[i], gs[i], grads[i]: numels[i] > 0 contiguous
// elements of one dtype; scale: count float32 (the forward's s_i).
// Writes grads[i] = gs[i] * (|ws[i]| <= s_i).
extern "C" int fake_quant_group_bwd_launch(const void* const* ws, const void* const* gs,
                                           void* const* grads, const int64_t* numels,
                                           int count, const void* scale, int dtype,
                                           void* stream) {
    if (count < 1 || count > GROUP_MAX || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int64_t per_block = (int64_t)THREADS * BWD_VECS * (dtype == 1 ? 8 : 4);
    BwdArgs a = {};
    a.scale = static_cast<const float*>(scale);
    a.count = count;
    int64_t blocks = 0;
    for (int i = 0; i < count; ++i) {
        if (numels[i] <= 0) return (int)cudaErrorInvalidValue;
        a.t[i] = {ws[i], gs[i], grads[i], numels[i], blocks};
        blocks += (numels[i] + per_block - 1) / per_block;
    }
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_group_bwd<__nv_bfloat16>(a, blocks, st);
    return launch_group_bwd<float>(a, blocks, st);
}

// The per-column constants a plan must agree with (kernels/fake_quant.py):
// out = {THREADS, COL_TX, COL_TY, COL_ROWS, COL_RING, COL_UNROLL, STE_VECS,
// COL_MAX, sizeof(ColArgs), sizeof(ColBwdArgs)}.
extern "C" void fake_quant_col_limits(int* out) {
    out[0] = THREADS;
    out[1] = COL_TX;
    out[2] = COL_TY;
    out[3] = COL_ROWS;
    out[4] = COL_RING;
    out[5] = COL_UNROLL;
    out[6] = STE_VECS;
    out[7] = COL_MAX;
    out[8] = (int)sizeof(ColArgs);
    out[9] = (int)sizeof(ColBwdArgs);
}

// Per-column grouped forward.  Leaf i: ws[i] and outs[i] hold dims[3i] x
// dims[3i+1] x dims[3i+2] = (L, K, N) contiguous elements of one dtype
// (0 = float32, 1 = bfloat16); bits[i]: int32, one per run of
// bits_runs[i] layers (an expert bank's (L,) bits over L·E layers: run E;
// one per layer: run 1) or one for the leaf (run 0); scales[i]: L x N
// float32.  count <= COL_MAX.
//
// fake_quant_col_launch: the max pass, then the QDQ pass, on scales that
// hold eps (the floor in the dtype): writes scales[i][l, n] = max(max_k
// |ws[i][l, k, n]|, eps) and outs[i][l, k, n] = qdq(ws[i][l, k, n],
// bits[i][l / run], scales[i][l, n]).
// fake_quant_col_max_launch: the max pass alone (outs and bits unused): a
// leaf sharded on K across ranks takes its scales' max over the ranks
// (an all_reduce MAX outside), then
// fake_quant_col_qdq_launch: the QDQ pass alone, at the given scales.
namespace {

int col_args(const void* const* ws, void* const* outs, void* const* scales,
             const void* const* bits, const int64_t* dims, const int* bits_runs, int count,
             int dtype, ColArgs* a, int64_t* ctas_out) {
    if (count < 1 || count > COL_MAX || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int sw = COL_TX * (dtype == 1 ? 8 : 4);
    *a = {};
    a->count = count;
    int64_t ctas = 0;
    for (int i = 0; i < count; ++i) {
        const int64_t Lc = dims[3 * i], K = dims[3 * i + 1], N = dims[3 * i + 2];
        if (Lc < 1 || K < 1 || N < 1 || N > 0x7fffffff) return (int)cudaErrorInvalidValue;
        const int64_t strips = (N + sw - 1) / sw, blocks = (K + COL_ROWS - 1) / COL_ROWS;
        if (strips * blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
        a->t[i] = {ws[i], outs ? outs[i] : nullptr, static_cast<float*>(scales[i]),
                   bits ? static_cast<const int*>(bits[i]) : nullptr, K, ctas, (int)N,
                   (int)strips, (int)blocks, bits_runs ? bits_runs[i] : 0};
        ctas += Lc * strips * blocks;
    }
    if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
    *ctas_out = ctas;
    return 0;
}

int col_forward(const void* const* ws, void* const* outs, void* const* scales,
                const void* const* bits, const int64_t* dims, const int* bits_runs, int count,
                int dtype, void* stream, bool max_pass, bool qdq_pass) {
    ColArgs a;
    int64_t ctas = 0;
    const int err = col_args(ws, outs, scales, bits, dims, bits_runs, count, dtype, &a, &ctas);
    if (err) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_col<__nv_bfloat16>(a, ctas, st, max_pass, qdq_pass);
    return launch_col<float>(a, ctas, st, max_pass, qdq_pass);
}

}  // namespace

extern "C" int fake_quant_col_launch(const void* const* ws, void* const* outs,
                                     void* const* scales, const void* const* bits,
                                     const int64_t* dims, const int* bits_runs, int count,
                                     int dtype, void* stream) {
    return col_forward(ws, outs, scales, bits, dims, bits_runs, count, dtype, stream, true,
                       true);
}

extern "C" int fake_quant_col_max_launch(const void* const* ws, void* const* scales,
                                         const int64_t* dims, int count, int dtype,
                                         void* stream) {
    return col_forward(ws, nullptr, scales, nullptr, dims, nullptr, count, dtype, stream, true,
                       false);
}

extern "C" int fake_quant_col_qdq_launch(const void* const* ws, void* const* outs,
                                         void* const* scales, const void* const* bits,
                                         const int64_t* dims, const int* bits_runs, int count,
                                         int dtype, void* stream) {
    return col_forward(ws, outs, scales, bits, dims, bits_runs, count, dtype, stream, false,
                       true);
}

// Per-column grouped STE backward over the same leaves (dims as above,
// scales[i] the forward's L x N float32): grads[i] = gs[i] * (|ws[i]| <=
// scales[i][l, n]), in the dtype.
extern "C" int fake_quant_col_bwd_launch(const void* const* ws, const void* const* gs,
                                         void* const* grads, void* const* scales,
                                         const int64_t* dims, int count, int dtype,
                                         void* stream) {
    if (count < 1 || count > COL_MAX || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int64_t per_block = (int64_t)THREADS * STE_VECS * (dtype == 1 ? 8 : 4);
    ColBwdArgs a = {};
    a.count = count;
    int64_t blocks = 0;
    for (int i = 0; i < count; ++i) {
        const int64_t Lc = dims[3 * i], K = dims[3 * i + 1], N = dims[3 * i + 2];
        if (Lc < 1 || K < 1 || N < 1 || N > 0x7fffffff) return (int)cudaErrorInvalidValue;
        const int64_t numel = Lc * K * N;
        a.t[i] = {ws[i], gs[i], grads[i], static_cast<const float*>(scales[i]), numel, blocks,
                  K, (int)N, 0};
        blocks += (numel + per_block - 1) / per_block;
    }
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_col_bwd<__nv_bfloat16>(a, blocks, st);
    return launch_col_bwd<float>(a, blocks, st);
}

// An empty kernel, back to back: `launches` launches of `blocks` CTAs of
// `threads` threads.
extern "C" int fake_quant_empty_launch(int launches, int blocks, int threads, void* stream) {
    if (launches < 1 || blocks < 1 || threads < 1 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int i = 0; i < launches; ++i) empty_kernel<<<blocks, threads, 0, st>>>();
    return (int)cudaGetLastError();
}
