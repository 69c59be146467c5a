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
// nearest even).  Two bodies share that arithmetic (qdq below):
//
// - The flat kernel (fake_quant_launch): one tensor at a scale the caller
//   gives, bits and scale as device scalars; a grid-stride loop over
//   numel with 16-byte vector loads and stores when the pointers are
//   aligned, then a masked scalar tail.
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
// s[l, n] = max(max_k |w[l, k, n]|, eps), with per-layer bits b[l].  The
// max runs down the strided K dimension, so a thread owns one 16-byte
// vector of adjacent columns (8 bf16 or 4 f32) and walks K; 8 threads
// cover a tile of 64 bf16 (32 f32) columns, 32 rows at a time, each warp
// loading four 128-byte row segments.  A tile's K range is split over the
// C CTAs of a thread-block cluster (C <= 8, one per launch, planned by
// kernels/fake_quant.py::fake_quant_col_plan); each CTA reduces its
// columns' maxima over its rows and warps in shared memory, and every CTA
// combines the C partial maxima from the cluster's shared memories in
// rank order (map_shared_rank).  Then each CTA reads its rows a second
// time and writes the QDQ: glm4-9b's embed reduces over 151,552 rows,
// which fit no register file or shared memory, so every leaf is read
// twice and written once (1.5x the bound's bytes).  The per-layer bits
// make one code table per CTA: q / n for q in [-n, n] (the scale differs
// per column, so the table holds the division, and a value is
// __fmul_rn(table[q + n], s), bitwise value()'s).  The STE backward
// walks the same tiles without a cluster: grad = g * (|w| <= s[l, n]).
// Every leaf of a QAT forward goes in one launch (descriptors by value,
// COL_MAX leaves a launch), and its backward in one more.
//
// Plain C interface (built with nvcc, loaded with ctypes).  The kernels
// allocate nothing; the entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace {

constexpr int THREADS = 256;
constexpr int FP_BITS = 32;

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

__device__ __forceinline__ float qdq(float w, const Params& p) {
    if (p.fp) return w;
    return value(code(w, p), p);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const T* __restrict__ w, T* __restrict__ out, const int* __restrict__ bits,
                  const float* __restrict__ scale, int64_t numel, int vectorized) {
    const Params p = make_params(*bits, *scale);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    constexpr int N = Vec<T>::N;
    int64_t done = 0;
    if (vectorized) {
        const int64_t nvec = numel / N;
        const Vec<T>* wv = reinterpret_cast<const Vec<T>*>(w);
        Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
        for (int64_t i = tid; i < nvec; i += stride) {
            Vec<T> a = wv[i];
            Vec<T> r;
#pragma unroll
            for (int j = 0; j < N; ++j) from_f32(qdq(to_f32(a.v[j]), p), &r.v[j]);
            ov[i] = r;
        }
        done = nvec * N;
    }
    for (int64_t i = done + tid; i < numel; i += stride) from_f32(qdq(to_f32(w[i]), p), &out[i]);
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


// ---- the grouped kernels of the QAT path ------------------------------------

constexpr int GROUP_MAX = 102;     // tensors per launch: BwdArgs fills 4 KB
constexpr int MAX_VECS = 8;        // 16-byte vectors a forward thread holds
constexpr int BWD_VECS = 1;        // 16-byte vectors a backward thread handles
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int TABLE_N = 127;       // levels tabled up to 8 bits (n = 2^7 - 1)

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
    // plain version's scale does too; its bf16 abs keeps the payload, and
    // so does the exact widening here
    if (sizeof(T) == 4 && s != s) s = __int_as_float(0x7fffffff);
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
constexpr int COL_TX = 8;          // threads across a tile, one 16-byte vector each
constexpr int COL_TY = THREADS / COL_TX;   // rows a CTA takes at a time

struct ColLeaf {
    const void* w;
    void* out;         // forward: the QDQ; backward: the gradient
    const void* g;     // backward: the incoming gradient
    float* scale;      // (L, N) f32: written by the forward, read by the backward
    const int* bits;   // bits[bits_run ? l / bits_run : 0]
    int64_t K;
    int64_t tile0;     // first tile of this leaf
    int N;
    int tiles_n;       // column tiles per layer
    int bits_run;      // flattened layers sharing a bitwidth; 0: one for the leaf
    int pad;
};

struct ColArgs {
    float eps;         // the floor, rounded to the group's dtype
    int count;
    int split;         // CTAs a tile's K range is split over (the cluster)
    int pad;
    ColLeaf t[COL_MAX];
};

static_assert(sizeof(ColArgs) <= 4096, "the per-column descriptors must fit 4 KB");

// This CTA's leaf, layer, first column and K range; the tile is
// blockIdx.x / split, the K part its rank.
struct ColTile {
    int leaf;
    int64_t layer;
    int64_t col0;
    int64_t k0, k1;
};

__device__ __forceinline__ ColTile col_tile(const ColArgs& a, int tpc) {
    const int64_t tile = (int64_t)blockIdx.x / a.split;
    const int part = (int)((int64_t)blockIdx.x % a.split);
    int lo = 0, hi = a.count - 1;     // the last leaf whose tile0 <= tile
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.t[mid].tile0 <= tile) lo = mid;
        else hi = mid - 1;
    }
    const ColLeaf& L = a.t[lo];
    const int64_t local = tile - L.tile0;
    ColTile c;
    c.leaf = lo;
    c.layer = local / L.tiles_n;
    c.col0 = (local % L.tiles_n) * (int64_t)tpc;
    const int64_t run = (L.K + a.split - 1) / a.split;
    c.k0 = min64((int64_t)part * run, L.K);
    c.k1 = min64(c.k0 + run, L.K);
    return c;
}

// Row k's NV columns from c (masked at N): one 16-byte load when aligned.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ row, int64_t c, int64_t N,
                                          bool aligned, Vec<T>& r) {
    constexpr int NV = Vec<T>::N;
    if (aligned && c + NV <= N) {
        r = *reinterpret_cast<const Vec<T>*>(row + c);
        return;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        if (c + j < N) r.v[j] = row[c + j];
        else from_f32(0.f, &r.v[j]);
    }
}

template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ row, int64_t c, int64_t N,
                                           bool aligned, const Vec<T>& r) {
    constexpr int NV = Vec<T>::N;
    if (aligned && c + NV <= N) {
        *reinterpret_cast<Vec<T>*>(row + c) = r;
        return;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
        if (c + j < N) row[c + j] = r.v[j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_col_kernel(const __grid_constant__ ColArgs a) {
    namespace cg = cooperative_groups;
    constexpr int NV = Vec<T>::N;
    constexpr int TPC = COL_TX * NV;              // columns a tile covers
    __shared__ float red[COL_TY][TPC];
    __shared__ float cmax[TPC];                   // this CTA's column maxima
    __shared__ float cscale[TPC];
    __shared__ float qn[2 * TABLE_N + 1];         // qn[q + n] = q / n
    const cg::cluster_group cluster = cg::this_cluster();
    const ColTile c = col_tile(a, TPC);
    const ColLeaf& L = a.t[c.leaf];
    const int64_t N = L.N;
    const size_t off = (size_t)c.layer * (size_t)L.K * (size_t)N;
    const T* w = static_cast<const T*>(L.w) + off;
    T* out = static_cast<T*>(L.out) + off;
    const bool aligned = N % NV == 0 &&
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int tid = threadIdx.x;
    const int tx = tid % COL_TX, ty = tid / COL_TX;
    const int64_t col = c.col0 + (int64_t)tx * NV;

    float m[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) m[j] = 0.f;
    for (int64_t k = c.k0 + ty; k < c.k1; k += COL_TY) {
        Vec<T> r;
        load_cols(w + k * N, col, N, aligned, r);
#pragma unroll
        for (int j = 0; j < NV; ++j) m[j] = max_nan(m[j], fabsf(to_f32(r.v[j])));
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) red[ty][tx * NV + j] = m[j];
    __syncthreads();
    if (tid < TPC) {
        float s = red[0][tid];
        for (int y = 1; y < COL_TY; ++y) s = max_nan(s, red[y][tid]);
        cmax[tid] = s;
    }
    cluster.sync();                               // every rank's maxima are in its cmax
    if (tid < TPC) {
        float s = *cluster.map_shared_rank(&cmax[tid], 0);
        for (int q = 1; q < a.split; ++q) s = max_nan(s, *cluster.map_shared_rank(&cmax[tid], q));
        // torch's f32 abs on the card writes every NaN as 0x7fffffff (see
        // fake_quant_group_kernel); its bf16 abs keeps the payload
        if (sizeof(T) == 4 && s != s) s = __int_as_float(0x7fffffff);
        s = max_nan(s, a.eps);
        cscale[tid] = s;
        if (cluster.block_rank() == 0 && c.col0 + tid < N)
            L.scale[c.layer * N + c.col0 + tid] = s;
    }
    const int bits = __ldg(L.bits + (L.bits_run ? c.layer / L.bits_run : 0));
    const bool fp = bits >= FP_BITS;
    const int n = fp ? 1 : (bits >= 2 ? (1 << (bits - 1)) - 1 : 1);
    const bool tabled = !fp && n <= TABLE_N;
    if (tabled)
        for (int q = tid - n; q <= n; q += THREADS) qn[q + n] = __fdiv_rn((float)q, (float)n);
    cluster.sync();                               // the other ranks are done reading cmax;
                                                  // cscale and qn are written
    if (fp) {                                     // bits >= 32: the loaded bits, unchanged
        for (int64_t k = c.k0 + ty; k < c.k1; k += COL_TY) {
            Vec<T> r;
            load_cols(w + k * N, col, N, aligned, r);
            store_cols(out + k * N, col, N, aligned, r);
        }
        return;
    }
    Params p[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        p[j].fp = 0;
        p[j].n = (float)n;
        p[j].scale = cscale[min(tx * NV + j, TPC - 1)];
    }
    for (int64_t k = c.k0 + ty; k < c.k1; k += COL_TY) {
        Vec<T> r;
        load_cols(w + k * N, col, N, aligned, r);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const float q = code(to_f32(r.v[j]), p[j]);
            const float v = (!tabled || q == 0.f || q != q)
                                ? value(q, p[j]) : __fmul_rn(qn[(int)q + n], p[j].scale);
            from_f32(v, &r.v[j]);
        }
        store_cols(out + k * N, col, N, aligned, r);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_col_bwd_kernel(const __grid_constant__ ColArgs a) {
    constexpr int NV = Vec<T>::N;
    constexpr int TPC = COL_TX * NV;
    const ColTile c = col_tile(a, TPC);
    const ColLeaf& L = a.t[c.leaf];
    const int64_t N = L.N;
    const size_t off = (size_t)c.layer * (size_t)L.K * (size_t)N;
    const T* w = static_cast<const T*>(L.w) + off;
    const T* g = static_cast<const T*>(L.g) + off;
    T* grad = static_cast<T*>(L.out) + off;
    const bool aligned = N % NV == 0 &&
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
          reinterpret_cast<uintptr_t>(grad)) & 15) == 0;
    const int tx = threadIdx.x % COL_TX, ty = threadIdx.x / COL_TX;
    const int64_t col = c.col0 + (int64_t)tx * NV;
    float s[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
        s[j] = col + j < N ? __ldg(L.scale + c.layer * N + col + j) : 0.f;
    for (int64_t k = c.k0 + ty; k < c.k1; k += COL_TY) {
        Vec<T> wr, gr;
        load_cols(w + k * N, col, N, aligned, wr);
        load_cols(g + k * N, col, N, aligned, gr);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const float inside = fabsf(to_f32(wr.v[j])) <= s[j] ? 1.f : 0.f;
            from_f32(__fmul_rn(to_f32(gr.v[j]), inside), &gr.v[j]);
        }
        store_cols(grad + k * N, col, N, aligned, gr);
    }
}

template <typename T>
int launch_col(const ColArgs& a, int64_t tiles, int cluster, cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * a.split));
    cfg.blockDim = dim3(THREADS);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster ? 1 : 0;
    const cudaError_t e = cluster ? cudaLaunchKernelEx(&cfg, fake_quant_col_kernel<T>, a)
                                  : cudaLaunchKernelEx(&cfg, fake_quant_col_bwd_kernel<T>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Fills a launch's descriptors; -> tiles, or -1 on a bad argument.
int64_t col_args(ColArgs& a, const void* const* ws, void* const* outs, const void* const* gs,
                 void* const* scales, const void* const* bits, const int64_t* dims,
                 const int* bits_runs, int count, float eps, int dtype, int split) {
    if (count < 1 || count > COL_MAX || split < 1 || split > MAX_CLUSTER ||
        (dtype != 0 && dtype != 1))
        return -1;
    const int tpc = COL_TX * (dtype == 1 ? 8 : 4);
    a.eps = eps;
    a.count = count;
    a.split = split;
    int64_t tiles = 0;
    for (int i = 0; i < count; ++i) {
        const int64_t Lc = dims[3 * i], K = dims[3 * i + 1], N = dims[3 * i + 2];
        if (Lc < 1 || K < 1 || N < 1 || N > 0x7fffffff) return -1;
        const int64_t tn = (N + tpc - 1) / tpc;
        a.t[i] = {ws[i], outs[i], gs ? gs[i] : nullptr, static_cast<float*>(scales[i]),
                  static_cast<const int*>(bits ? bits[i] : nullptr), K, tiles, (int)N,
                  (int)tn, bits_runs ? bits_runs[i] : 0, 0};
        tiles += Lc * tn;
    }
    if (tiles * split > 0x7fffffff) return -1;
    return tiles;
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
// out = {THREADS, COL_TX, COL_MAX, MAX_CLUSTER, sizeof(ColArgs)}.
extern "C" void fake_quant_col_limits(int* out) {
    out[0] = THREADS;
    out[1] = COL_TX;
    out[2] = COL_MAX;
    out[3] = MAX_CLUSTER;
    out[4] = (int)sizeof(ColArgs);
}

// Per-column grouped forward.  Leaf i: ws[i] and outs[i] hold dims[3i] x
// dims[3i+1] x dims[3i+2] = (L, K, N) contiguous elements of one dtype
// (0 = float32, 1 = bfloat16); bits[i]: int32, one per run of
// bits_runs[i] layers (an expert bank's (L,) bits over L·E layers: run E;
// one per layer: run 1) or one for the leaf (run 0); scales[i]: L x N
// float32, written.  count <= COL_MAX;
// split: the cluster's CTAs along K, 1 to MAX_CLUSTER.  Writes
// outs[i][l, k, n] = qdq(ws[i][l, k, n], bits[i][l / run], s) with s =
// scales[i][l, n] = max(max_k |ws[i][l, k, n]|, eps).
extern "C" int fake_quant_col_launch(const void* const* ws, void* const* outs,
                                     void* const* scales, const void* const* bits,
                                     const int64_t* dims, const int* bits_runs, int count,
                                     float eps, int dtype, int split, void* stream) {
    ColArgs a = {};
    const int64_t tiles = col_args(a, ws, outs, nullptr, scales, bits, dims, bits_runs,
                                   count, eps, dtype, split);
    if (tiles < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_col<__nv_bfloat16>(a, tiles, 1, st);
    return launch_col<float>(a, tiles, 1, st);
}

// Per-column grouped STE backward over the same leaves: grads[i] =
// gs[i] * (|ws[i]| <= scales[i][l, n]), in the dtype.
extern "C" int fake_quant_col_bwd_launch(const void* const* ws, const void* const* gs,
                                         void* const* grads, void* const* scales,
                                         const int64_t* dims, int count, int dtype, int split,
                                         void* stream) {
    ColArgs a = {};
    const int64_t tiles = col_args(a, ws, grads, gs, scales, nullptr, dims, nullptr, count,
                                   0.f, dtype, split);
    if (tiles < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch_col<__nv_bfloat16>(a, tiles, 0, st);
    return launch_col<float>(a, tiles, 0, st);
}
