// Fused bit-serial QKV projection + quantized paged decode attention for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_decode.py::fused_qkv_paged_decode_pallas (body
// _fused_kernel, fused_decode.py:63, with _bitserial_row :44 and _rope_row
// :56).  Same function as kernels/ref.py::fused_qkv_paged_decode_ref:
// for each decode row b,
//   q|k|v = x[b] @ dequant(W_q|W_k|W_v)   (bit-serial off the packed planes,
//                                          bits may differ per matrix)
//   q, k, v rounded to the activation dtype; RoPE of q and k from the
//   passed cos/sin rows (position lengths[b]), rounded again;
//   the new K/V quantized as quant.pack.kv_quantize (amax / qmax, then
//   rint(x / safe) clipped to +-qmax) and emitted as codes (nibble-packed
//   when the pool is uint8) and scales for the caller to scatter -- the
//   kernel never writes the pool;
//   attention of q over the pre-write pool (pos < lengths[b]) with the
//   new token's dequantized K/V folded in last (write-then-attend).
//
// What bounds it on the H100: device-memory bytes.  One call streams the
// three packed weight matrices (9.44 MB at glm4-9b 4-bit) and does 2*B
// flops per weight, far below the ridge; the page sweep reads each live
// token's codes once.  At decode's sizes both halves are latency-bound.
// Why the structure differs from the Pallas grid: the TPU kernel ran a
// (B, nb) grid whose j == 0 step did a whole row's q/k/v projection with
// the planes resident in VMEM.  On Hopper the projection needs many CTAs
// across columns and K, while the attention needs a whole head's k/v (the
// amax over hd).  So one C entry point makes two launches on one stream:
//   (A) every row of x against every q|k|v column tile: qmm's bit-serial
//       body (bitserial.cuh, tagged fused_project; the tensor-core body for
//       bf16 x) over the three matrices at once, with a deterministic
//       split-K: a grid of (72 column tiles at glm4-9b, splits, row tiles)
//       CTAs, split s walking its own range of 128-row K steps and writing
//       its raw partial (sum x*(u-n)) to a (splits, B, ntot) f32 workspace
//       (kernels/fused_decode.py::project_plan, the split rule of qmm's
//       bitserial_plan).  A CTA holds up to 32 rows, so at B <= 32 each
//       plane byte is read once per call.
//   (B) fused_attend_kernel over a (B, KV, S + 1) grid (S from the block
//       table's width: kernels/fused_decode.py::attend_plan), launched as
//       a programmatic dependent of (A): a CTA reads its page ids and
//       starts its first tile while (A) finishes, then waits for (A)
//       (griddepcontrol).  Every CTA sums the projection partials of its
//       q rows in split order and applies / n * scale once
//       (qmm_splitk_combine's arithmetic), then rounds and ropes them.  Split CTAs s < S run the tiled sweep
//       of kv_attention.cuh over their split's pre-write pages; CTA s = S
//       alone does the new token: k/v rounding and RoPE, kv_quantize, code
//       and scale emission, and the partial of the single new token (m =
//       its score, l = 1, acc = its dequantized v).  The last CTA to
//       arrive merges the S + 1 partials in split order, the new token
//       last (csrc/split_kv.cuh): the reference's write-then-attend,
//       reassociated, and bitwise repeatable.
// Every product that must match the plain version bitwise (RoPE, the
// division by the scale, the dequantized new token) uses __fmul_rn /
// __fsub_rn / __fadd_rn / __fdiv_rn, so nvcc cannot contract it into an
// FMA; there are no transcendental functions besides the softmax's expf.
//
// Plain C interface (built with nvcc, loaded with ctypes).  Kernels
// allocate nothing; the entry points return cudaGetLastError().

#include "bitserial.cuh"
#include "kv_attention.cuh"

namespace {

using namespace kvattn;

struct fused_project;   // names phase (A)'s bit-serial kernel instances
constexpr int PROJECT_WARPS = 4;   // (A)'s CTAs: 64 columns (fused_decode.py COLS)

// ------------------------------------------------------------- (B) attention
// round through the activation dtype (identity for f32)
__device__ __forceinline__ float round_act(float v, float*) { return v; }
__device__ __forceinline__ float round_act(float v, __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float act(float v) { return round_act(v, static_cast<T*>(nullptr)); }

// How (B) reads a projection: psplits == 1, proj (B, ntot) is finished;
// otherwise proj (psplits, B, ntot) holds (A)'s raw partials, summed here
// in split order and finished as / n * scale of the column's matrix.
struct Proj {
    const float* proj;
    int psplits;
    const float* scale[3];     // each matrix's (1, N) scale
    float nl[3];               // 2^(bits-1) - 1
    int off[3];                // first column of each matrix
};

// the finished projections of row b, columns col .. col+3 (one matrix)
__device__ __forceinline__ void proj4(const Proj& pj, int B, int b, int ntot, int col,
                                      float (&x)[4]) {
    if (pj.psplits == 1) {
        const float* src = pj.proj + (size_t)b * ntot + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = src[e];
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = 0.f;
#pragma unroll 4
    for (int p = 0; p < pj.psplits; ++p) {
        const float* src = pj.proj + ((size_t)p * B + b) * ntot + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] += src[e];
    }
    const int m = col < pj.off[1] ? 0 : col < pj.off[2] ? 1 : 2;
    const float* sc = pj.scale[m] + (col - pj.off[m]);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = x[e] / pj.nl[m] * sc[e];
}

struct AttendArgs {
    Proj pj;
    const void *k_pool, *v_pool;
    const float *k_scale, *v_scale;
    const int *bt, *lengths;
    const float *cos, *sin, *qmax;
    float* out;
    void *kc_out, *vc_out;
    float *ksc_out, *vsc_out;
    float* ws;                 // the attention partials (S + 1 per row and head)
    int* arrived;
    int B, KV, G, bs, nb, pps;
    float scale;
};

// shared memory of one attend CTA: roped q (G rows of hd f32), the new
// token's roped k and v (2 rows), its dequantized k|v (2 rows), its codes
// (2 rows of int8, padded to 16 bytes), the sweep, the split's page ids
template <int HD, bool PACKED4>
constexpr size_t attend_smem_bytes(int G, int warps, int pps) {
    return (size_t)(G + 4) * HD * sizeof(float) + (2 * HD + 15) / 16 * 16 +
           sweep_smem_bytes<HD, PACKED4>(warps) + (size_t)pps * sizeof(int);
}

template <typename T, int DPL, bool PACKED4, int MAXT>
__global__ void __launch_bounds__(MAXT) fused_attend_kernel(const AttendArgs a, int vec) {
    constexpr int HD = DPL * 32;
    constexpr int HALF = HD / 2;
    constexpr int HDS = PACKED4 ? HD / 2 : HD;
    extern __shared__ __align__(16) unsigned char smem[];
    const int G = a.G, KV = a.KV;
    float* qkv = reinterpret_cast<float*>(smem);          // [(G + 2) * HD]: q, then k, v
    float* newkv = qkv + (G + 2) * HD;                    // [2 * HD]
    int8_t* codes = reinterpret_cast<int8_t*>(newkv + 2 * HD);   // [2 * HD]
    uint8_t* sweep_mem = smem + (size_t)(G + 4) * HD * sizeof(float) + (2 * HD + 15) / 16 * 16;
    int* pages = reinterpret_cast<int*>(sweep_mem + sweep_smem_bytes<HD, PACKED4>(blockDim.x / 32));

    const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z, S = gridDim.z - 1;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nwarps = blockDim.x / 32;
    const int H = KV * G;
    const int ntot = (H + 2 * KV) * HD;
    const size_t bk = (size_t)b * KV + kvh;
    const float* cs = a.cos + (size_t)b * HALF;
    const float* sn = a.sin + (size_t)b * HALF;
    const bool newtok = s == S;

    // the split's page ids, read with the length (not after it), and the
    // first tile in flight: none of it waits on launch (A)
    for (int j = threadIdx.x; j < a.pps; j += blockDim.x)
        pages[j] = !newtok && s * a.pps + j < a.nb ? a.bt[(size_t)b * a.nb + s * a.pps + j] : 0;
    const int len = min(max(a.lengths[b], 0), a.nb * a.bs);
    const int nh = max(0, min(HPW, G - warp * HPW));   // live heads of this warp
    const int t_begin = s * a.pps * a.bs, t_end = newtok ? 0 : min(len, (s + 1) * a.pps * a.bs);
    __syncthreads();
    const Pages pg{static_cast<const uint8_t*>(a.k_pool), static_cast<const uint8_t*>(a.v_pool),
                   a.k_scale, a.v_scale, pages, s * a.pps, KV, kvh, a.bs, vec != 0};
    sweep_prefetch<DPL, PACKED4>(pg, t_begin, t_end, sweep_mem);
    // launched after (A) as a programmatic dependent: wait for its
    // projections here (a no-op after an ordinary launch)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    // q (G heads of this KV group) and, in the new-token CTA, k: round,
    // RoPE, round; v: round.  One thread takes dims j .. j+3 and their
    // partners j + hd/2 .., with every load issued before the arithmetic.
    const int rows = newtok ? G + 2 : G;
    for (int i = threadIdx.x; i < rows * (HALF / 4); i += blockDim.x) {
        const int r = i / (HALF / 4), j0 = i % (HALF / 4) * 4;
        const int base = r < G ? (kvh * G + r) * HD : (H + (r - G) * KV + kvh) * HD;
        float x1[4], x2[4];
        proj4(a.pj, a.B, b, ntot, base + j0, x1);
        proj4(a.pj, a.B, b, ntot, base + j0 + HALF, x2);
        float* o = qkv + r * HD;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = j0 + e;
            const float v1 = act<T>(x1[e]), v2 = act<T>(x2[e]);
            if (r == G + 1) {
                o[j] = v1;
                o[j + HALF] = v2;
                continue;
            }
            const float c = cs[j], sv = sn[j];
            o[j] = act<T>(__fsub_rn(__fmul_rn(v1, c), __fmul_rn(v2, sv)));
            o[j + HALF] = act<T>(__fadd_rn(__fmul_rn(v1, sv), __fmul_rn(v2, c)));
        }
    }
    __syncthreads();

    float* ws_acc = a.ws + bk * (S + 1) * G * HD;
    float* ws_ml = a.ws + (size_t)a.B * KV * (S + 1) * G * HD + bk * (S + 1) * G * 2;
    Partial<DPL> st;
    st.init();
    if (!newtok) {
        // the split's pre-write pages
        sweep<DPL, PACKED4>(st, qkv, pg, t_begin, t_end, a.scale, nh, sweep_mem);
    } else {
        // kv_quantize of the new k (row G) and v (row G + 1)
        const float qmax = *a.qmax;
        for (int which = warp; which < 2; which += nwarps) {
            const float* xr = qkv + (G + which) * HD;
            float amax = 0.f;
            for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(xr[d]));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
            const float sc = __fdiv_rn(amax, qmax);
            const float safe = sc > 0.f ? sc : 1.f;
            for (int d = lane; d < HD; d += 32) {
                const float c = fminf(fmaxf(rintf(__fdiv_rn(xr[d], safe)), -qmax), qmax);
                codes[which * HD + d] = (int8_t)c;
                newkv[which * HD + d] = __fmul_rn(c, sc);
            }
            if (lane == 0) (which ? a.vsc_out : a.ksc_out)[bk] = sc;
        }
        __syncthreads();
        // emit the codes: int8, or two per byte (u = c + 8, even index low)
        for (int i = threadIdx.x; i < 2 * HDS; i += blockDim.x) {
            const int which = i / HDS, j = i % HDS;
            const int8_t* c = codes + which * HD;
            const uint8_t byte = PACKED4 ? (uint8_t)((c[2 * j] + 8) | ((c[2 * j + 1] + 8) << 4))
                                         : (uint8_t)c[j];
            static_cast<uint8_t*>(which ? a.vc_out : a.kc_out)[bk * HDS + j] = byte;
        }
        // the new token's partial: m = its score, l = 1, acc = its v
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
            if (h >= nh) break;                   // warp-uniform
            const float* qh = qkv + (warp * HPW + h) * HD;
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) dot = fmaf(qh[lane * DPL + d], newkv[lane * DPL + d], dot);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
            st.m[h] = dot * a.scale;
            st.l[h] = 1.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) st.acc[h][d] = newkv[HD + lane * DPL + d];
        }
    }
    st.store(nullptr, ws_acc, ws_ml, s, S + 1, G, warp * HPW, nh, lane);
    if (splitkv::arrive_last(a.arrived + bk, S + 1))
        splitkv::combine(ws_acc, ws_ml, a.out + bk * G * HD, S + 1, G, HD, qkv);
}

// pdl: launch as a programmatic dependent of the previous kernel on the
// stream (launch (A)), so the CTAs' preamble overlaps its tail
template <typename T, int DPL, bool PACKED4>
int launch_attend(const AttendArgs& a, bool pdl, cudaStream_t st) {
    constexpr int HD = DPL * 32;
    const int S = (a.nb + a.pps - 1) / a.pps;
    if (S + 1 > splitkv::MAX_SPLITS || a.ws == nullptr || a.arrived == nullptr)
        return (int)cudaErrorInvalidValue;
    const int warps = sweep_warps(a.G);
    const size_t smem = attend_smem_bytes<HD, PACKED4>(a.G, warps, a.pps);
    auto kern = warps > 16 ? fused_attend_kernel<T, DPL, PACKED4, 1024>
                           : fused_attend_kernel<T, DPL, PACKED4, 512>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = reinterpret_cast<uintptr_t>(a.k_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.v_pool) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B, a.KV, S + 1);
    cfg.blockDim = dim3(warps * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kern, a, vec);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED4>
int attend_hd(int hd, const AttendArgs& a, bool pdl, cudaStream_t st) {
    switch (hd) {
        case 64: return launch_attend<T, 2, PACKED4>(a, pdl, st);
        case 96: return launch_attend<T, 3, PACKED4>(a, pdl, st);
        case 128: return launch_attend<T, 4, PACKED4>(a, pdl, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

int attend(int act_dtype, int packed4, int hd, const AttendArgs& a, bool pdl, cudaStream_t st) {
    if (act_dtype == 1)
        return packed4 ? attend_hd<__nv_bfloat16, true>(hd, a, pdl, st)
                       : attend_hd<__nv_bfloat16, false>(hd, a, pdl, st);
    return packed4 ? attend_hd<float, true>(hd, a, pdl, st)
                   : attend_hd<float, false>(hd, a, pdl, st);
}

bool attend_args_ok(int act_dtype, int packed4, int B, int KV, int G, int bs, int nb, int pps) {
    return B > 0 && KV > 0 && G > 0 && G <= 32 * HPW && bs > 0 && nb > 0 && pps > 0 &&
           (act_dtype == 0 || act_dtype == 1) && (packed4 == 0 || packed4 == 1);
}

AttendArgs attend_args(Proj pj, const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* block_tables, const void* lengths,
                       const void* cos, const void* sin, const void* qmax, void* out,
                       void* kc_out, void* vc_out, void* ksc_out, void* vsc_out, void* ws,
                       void* arrived, int B, int KV, int G, int bs, int nb, int pps,
                       float scale) {
    return AttendArgs{pj, k_pool, v_pool,
                      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
                      static_cast<const float*>(cos), static_cast<const float*>(sin),
                      static_cast<const float*>(qmax), static_cast<float*>(out), kc_out, vc_out,
                      static_cast<float*>(ksc_out), static_cast<float*>(vsc_out),
                      static_cast<float*>(ws), static_cast<int*>(arrived), B, KV, G, bs, nb, pps,
                      scale};
}

}  // namespace

// Phase (B) alone, on finished projections the caller supplies: proj
// (B, H*hd + 2*KV*hd) f32; act_dtype (rounding of q/k/v): 0 = float32,
// 1 = bfloat16; packed4: 0 = int8 pool (NB, bs, KV, hd), 1 = nibble-packed
// uint8 (NB, bs, KV, hd/2); scales (NB, bs, KV) f32; block_tables (B, nb)
// int32; lengths (B,) int32 (before the new token); cos/sin (B, hd/2) f32;
// qmax one f32 on the card.  Out: out (B, KV, G, hd) f32, kc/vc (B, KV,
// hds) bytes, ksc/vsc (B, KV) f32.  pps: pages per split, S = ceil(nb /
// pps) <= 15; ws: the split workspace for S + 1 partials; arrived: the
// (B, KV) int32 arrival counters, zero on entry and left zero.
extern "C" int fused_attend_launch(const void* proj, int act_dtype, const void* k_pool,
                                   const void* v_pool, const void* k_scale, const void* v_scale,
                                   const void* block_tables, const void* lengths,
                                   const void* cos, const void* sin, const void* qmax,
                                   void* out, void* kc_out, void* vc_out, void* ksc_out,
                                   void* vsc_out, void* ws, void* arrived, int packed4, int B,
                                   int KV, int G, int hd, int bs, int nb, int pps, float scale,
                                   void* stream) {
    if (!attend_args_ok(act_dtype, packed4, B, KV, G, bs, nb, pps))
        return (int)cudaErrorInvalidValue;
    Proj pj{};
    pj.proj = static_cast<const float*>(proj);
    pj.psplits = 1;
    const AttendArgs a = attend_args(pj, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
                                     cos, sin, qmax, out, kc_out, vc_out, ksc_out, vsc_out, ws,
                                     arrived, B, KV, G, bs, nb, pps, scale);
    return attend(act_dtype, packed4, hd, a, false, static_cast<cudaStream_t>(stream));
}

// Phase (A) alone: x (B, D) of act_dtype (bf16 16-byte aligned); each
// matrix's planes (bits, D/8, N) uint8 and scale (1, N) f32, N = H*hd for
// q and KV*hd for k and v.  proj (splits, B, ntot) f32: with splits == 1
// the finished projections, else split s's raw partial over its K steps
// (splits <= ceil(D / 128)).
extern "C" int fused_project_launch(const void* x, int act_dtype, const void* q_planes,
                                    const void* q_scale, int q_bits, const void* k_planes,
                                    const void* k_scale_w, int k_bits, const void* v_planes,
                                    const void* v_scale_w, int v_bits, void* proj, int B, int D,
                                    int Nq, int Nkv, int splits, void* stream) {
    const int bits[3] = {q_bits, k_bits, v_bits};
    for (int b : bits)
        if (b < 2 || b > 8) return (int)cudaErrorInvalidValue;
    if (B <= 0 || D <= 0 || D % 8 || Nq <= 0 || Nkv <= 0 || (act_dtype != 0 && act_dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bitserial::Mats mats{};
    bitserial::add(mats, q_planes, q_scale, Nq, q_bits);
    bitserial::add(mats, k_planes, k_scale_w, Nkv, k_bits);
    bitserial::add(mats, v_planes, v_scale_w, Nkv, v_bits);
    float* y = static_cast<float*>(proj);
    if (act_dtype == 1)
        return bitserial::launch<fused_project>(static_cast<const __nv_bfloat16*>(x), mats, y,
                                                B, D, splits, PROJECT_WARPS, 0, st);
    return bitserial::launch_simt<fused_project>(static_cast<const float*>(x), mats, y, B, D,
                                                 splits, st);
}

// The whole fused decode: (A) then (B) on one stream.  proj (splits, B,
// H*hd + 2*KV*hd) f32 scratch for (A)'s output, summed and finished by
// (B).  The rest as fused_project_launch and fused_attend_launch.
extern "C" int fused_decode_launch(const void* x, int act_dtype, const void* q_planes,
                                   const void* q_scale, int q_bits, const void* k_planes,
                                   const void* k_scale_w, int k_bits, const void* v_planes,
                                   const void* v_scale_w, int v_bits, void* proj, int splits,
                                   const void* k_pool, const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* block_tables,
                                   const void* lengths, const void* cos, const void* sin,
                                   const void* qmax, void* out, void* kc_out, void* vc_out,
                                   void* ksc_out, void* vsc_out, void* ws, void* arrived,
                                   int packed4, int B, int D, int KV, int G, int hd, int bs,
                                   int nb, int pps, float scale, void* stream) {
    if (!attend_args_ok(act_dtype, packed4, B, KV, G, bs, nb, pps))
        return (int)cudaErrorInvalidValue;
    const int H = KV * G;
    int e = fused_project_launch(x, act_dtype, q_planes, q_scale, q_bits, k_planes, k_scale_w,
                                 k_bits, v_planes, v_scale_w, v_bits, proj, B, D, H * hd,
                                 KV * hd, splits, stream);
    if (e != 0) return e;
    const float nl[3] = {(float)((1 << (q_bits - 1)) - 1), (float)((1 << (k_bits - 1)) - 1),
                         (float)((1 << (v_bits - 1)) - 1)};
    const Proj pj{static_cast<const float*>(proj), splits,
                  {static_cast<const float*>(q_scale), static_cast<const float*>(k_scale_w),
                   static_cast<const float*>(v_scale_w)},
                  {nl[0], nl[1], nl[2]},
                  {0, H * hd, H * hd + KV * hd}};
    const AttendArgs a = attend_args(pj, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
                                     cos, sin, qmax, out, kc_out, vc_out, ksc_out, vsc_out, ws,
                                     arrived, B, KV, G, bs, nb, pps, scale);
    return attend(act_dtype, packed4, hd, a, true, static_cast<cudaStream_t>(stream));
}
