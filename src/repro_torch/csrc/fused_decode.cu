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
// token's codes once.
// Why the structure differs from the Pallas grid: the TPU kernel ran a
// (B, nb) grid whose j == 0 step did a whole row's q/k/v projection with
// the planes resident in VMEM.  On Hopper that would push all 9.44 MB of
// planes through B*KV = 8 CTAs per row.  The projection needs many CTAs
// across columns, while the attention needs a whole head's k/v (the amax
// over hd).  So one C entry point makes two launches on one stream:
//   (A) every row of x against every q|k|v column tile: qmm's bit-serial
//       body (bitserial.cuh, tagged fused_project) over the three
//       matrices at once (72 CTAs of 64 columns at glm4-9b); a CTA holds
//       up to 8 rows, so at B <= 8 each plane byte is read once per call.
//       Out: f32 (B, H*hd + 2*KV*hd) scratch.
//   (B) fused_attend_kernel: one CTA per (row b, KV head): rounding, RoPE,
//       kv_quantize, code emission, and the page sweep of
//       kv_attention.cuh with the new token folded in last.
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

// ------------------------------------------------------------- (B) attention
// round through the activation dtype (identity for f32)
__device__ __forceinline__ float round_act(float v, float*) { return v; }
__device__ __forceinline__ float round_act(float v, __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float act(float v) { return round_act(v, static_cast<T*>(nullptr)); }

// shared memory of one attend CTA: roped q|k|v (G+2 rows of hd f32), the
// new token's dequantized k|v (2 rows), its codes (2 rows of int8), then
// the page-sweep staging
__host__ __device__ constexpr size_t attend_smem_bytes(int G, int hd, int bs, int hds) {
    return ((size_t)(G + 4) * hd * sizeof(float) + 2 * (size_t)hd + 15) / 16 * 16 +
           page_smem_bytes(bs, hds);
}

template <typename T, int DPL, bool PACKED4>
__global__ void fused_attend_kernel(const float* __restrict__ proj,
                                    const uint8_t* __restrict__ k_pool,
                                    const uint8_t* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ block_tables,
                                    const int* __restrict__ lengths,
                                    const float* __restrict__ cos_rows,
                                    const float* __restrict__ sin_rows,
                                    const float* __restrict__ qmax_p, float* __restrict__ out,
                                    uint8_t* __restrict__ kc_out, uint8_t* __restrict__ vc_out,
                                    float* __restrict__ ksc_out, float* __restrict__ vsc_out,
                                    int KV, int G, int bs, int nb, float scale) {
    constexpr int HD = DPL * 32;
    constexpr int HALF = HD / 2;
    constexpr int HDS = PACKED4 ? HD / 2 : HD;
    extern __shared__ __align__(16) unsigned char smem[];
    float* qkv = reinterpret_cast<float*>(smem);          // [(G + 2) * HD]
    float* newkv = qkv + (G + 2) * HD;                    // [2 * HD]
    int8_t* codes = reinterpret_cast<int8_t*>(newkv + 2 * HD);   // [2 * HD]
    unsigned char* pages = smem + ((size_t)(G + 4) * HD * sizeof(float) + 2 * HD + 15) / 16 * 16;

    const int b = blockIdx.x, kvh = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nwarps = blockDim.x / 32;
    const int H = KV * G;
    const int ntot = (H + 2 * KV) * HD;
    const float* prow = proj + (size_t)b * ntot;
    const float* cs = cos_rows + (size_t)b * HALF;
    const float* sn = sin_rows + (size_t)b * HALF;

    // q (G heads of this KV group) and k: round, RoPE, round; v: round
    for (int i = threadIdx.x; i < (G + 2) * HD; i += blockDim.x) {
        const int r = i / HD, d = i % HD;
        const size_t base = r < G ? (size_t)(kvh * G + r) * HD
                                  : (size_t)(H + (r - G) * KV + kvh) * HD;
        if (r == G + 1) {
            qkv[i] = act<T>(prow[base + d]);
            continue;
        }
        const int j = d < HALF ? d : d - HALF;
        const float x1 = act<T>(prow[base + j]), x2 = act<T>(prow[base + j + HALF]);
        const float c = cs[j], s = sn[j];
        const float val = d < HALF ? __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))
                                   : __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
        qkv[i] = act<T>(val);
    }
    __syncthreads();

    // kv_quantize of the new k (row G) and v (row G + 1)
    const float qmax = *qmax_p;
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
        if (lane == 0) (which ? vsc_out : ksc_out)[(size_t)b * KV + kvh] = sc;
    }
    __syncthreads();

    // emit the codes: int8, or two per byte (u = c + 8, even index low)
    for (int i = threadIdx.x; i < 2 * HDS; i += blockDim.x) {
        const int which = i / HDS, j = i % HDS;
        const int8_t* c = codes + which * HD;
        const uint8_t byte = PACKED4 ? (uint8_t)((c[2 * j] + 8) | ((c[2 * j + 1] + 8) << 4))
                                     : (uint8_t)c[j];
        (which ? vc_out : kc_out)[((size_t)b * KV + kvh) * HDS + j] = byte;
    }

    // attention over the pre-write pages, then the new token last
    Heads<DPL> st;
    st.init(warp * HPW, G);
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            st.q[h][d] = h < st.n ? qkv[(warp * HPW + h) * HD + lane * DPL + d] : 0.f;
    const int len = min(max(lengths[b], 0), nb * bs);
    sweep_pages<DPL, PACKED4>(st, k_pool, v_pool, k_scale, v_scale,
                              block_tables + (size_t)b * nb, len, KV, kvh, bs, scale, pages);
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
        kr[d] = newkv[lane * DPL + d];
        vr[d] = newkv[HD + lane * DPL + d];
    }
    st.fold(kr, vr, scale);
    st.store(out + ((size_t)b * KV + kvh) * G * HD, warp * HPW, lane);
}

struct AttendArgs {
    const float* proj;
    const void *k_pool, *v_pool;
    const float *k_scale, *v_scale;
    const int *bt, *lengths;
    const float *cos, *sin, *qmax;
    float* out;
    void *kc_out, *vc_out;
    float *ksc_out, *vsc_out;
    int B, KV, G, bs, nb;
    float scale;
};

template <typename T, int DPL, bool PACKED4>
int launch_attend(const AttendArgs& a, cudaStream_t st) {
    const size_t smem = attend_smem_bytes(a.G, DPL * 32, a.bs, PACKED4 ? DPL * 16 : DPL * 32);
    auto kern = fused_attend_kernel<T, DPL, PACKED4>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int warps = max(2, (a.G + HPW - 1) / HPW);
    kern<<<dim3(a.B, a.KV), warps * 32, smem, st>>>(
        a.proj, static_cast<const uint8_t*>(a.k_pool), static_cast<const uint8_t*>(a.v_pool),
        a.k_scale, a.v_scale, a.bt, a.lengths, a.cos, a.sin, a.qmax, a.out,
        static_cast<uint8_t*>(a.kc_out), static_cast<uint8_t*>(a.vc_out), a.ksc_out, a.vsc_out,
        a.KV, a.G, a.bs, a.nb, a.scale);
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED4>
int attend_hd(int hd, const AttendArgs& a, cudaStream_t st) {
    switch (hd) {
        case 64: return launch_attend<T, 2, PACKED4>(a, st);
        case 96: return launch_attend<T, 3, PACKED4>(a, st);
        case 128: return launch_attend<T, 4, PACKED4>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

int attend(int act_dtype, int packed4, int hd, const AttendArgs& a, cudaStream_t st) {
    if (act_dtype == 1)
        return packed4 ? attend_hd<__nv_bfloat16, true>(hd, a, st)
                       : attend_hd<__nv_bfloat16, false>(hd, a, st);
    return packed4 ? attend_hd<float, true>(hd, a, st) : attend_hd<float, false>(hd, a, st);
}

bool attend_args_ok(int act_dtype, int packed4, int B, int KV, int G, int bs, int nb) {
    return B > 0 && KV > 0 && G > 0 && G <= 32 * HPW && bs > 0 && nb > 0 &&
           (act_dtype == 0 || act_dtype == 1) && (packed4 == 0 || packed4 == 1);
}

}  // namespace

// Phase (B) alone, on projections the caller supplies: proj (B, H*hd +
// 2*KV*hd) f32; act_dtype (rounding of q/k/v): 0 = float32, 1 = bfloat16;
// packed4: 0 = int8 pool (NB, bs, KV, hd), 1 = nibble-packed uint8 (NB,
// bs, KV, hd/2); scales (NB, bs, KV) f32; block_tables (B, nb) int32;
// lengths (B,) int32 (before the new token); cos/sin (B, hd/2) f32; qmax
// one f32 on the card.  Out: out (B, KV, G, hd) f32, kc/vc (B, KV, hds)
// bytes, ksc/vsc (B, KV) f32.
extern "C" int fused_attend_launch(const void* proj, int act_dtype, const void* k_pool,
                                   const void* v_pool, const void* k_scale, const void* v_scale,
                                   const void* block_tables, const void* lengths,
                                   const void* cos, const void* sin, const void* qmax,
                                   void* out, void* kc_out, void* vc_out, void* ksc_out,
                                   void* vsc_out, int packed4, int B, int KV, int G, int hd,
                                   int bs, int nb, float scale, void* stream) {
    if (!attend_args_ok(act_dtype, packed4, B, KV, G, bs, nb)) return (int)cudaErrorInvalidValue;
    AttendArgs a{static_cast<const float*>(proj), k_pool, v_pool,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
                 static_cast<const float*>(cos), static_cast<const float*>(sin),
                 static_cast<const float*>(qmax), static_cast<float*>(out), kc_out, vc_out,
                 static_cast<float*>(ksc_out), static_cast<float*>(vsc_out), B, KV, G, bs, nb,
                 scale};
    return attend(act_dtype, packed4, hd, a, static_cast<cudaStream_t>(stream));
}

// The whole fused decode: (A) then (B) on one stream.  x (B, D) of
// act_dtype; each matrix's planes (bits, D/8, N) uint8 and scale (1, N)
// f32, N = H*hd for q and KV*hd for k and v; proj (B, H*hd + 2*KV*hd) f32
// scratch.  The rest as fused_attend_launch.
extern "C" int fused_decode_launch(const void* x, int act_dtype, const void* q_planes,
                                   const void* q_scale, int q_bits, const void* k_planes,
                                   const void* k_scale_w, int k_bits, const void* v_planes,
                                   const void* v_scale_w, int v_bits, void* proj,
                                   const void* k_pool, const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* block_tables,
                                   const void* lengths, const void* cos, const void* sin,
                                   const void* qmax, void* out, void* kc_out, void* vc_out,
                                   void* ksc_out, void* vsc_out, int packed4, int B, int D,
                                   int KV, int G, int hd, int bs, int nb, float scale,
                                   void* stream) {
    const int bits[3] = {q_bits, k_bits, v_bits};
    for (int b : bits)
        if (b < 2 || b > 8) return (int)cudaErrorInvalidValue;
    if (D <= 0 || D % 8 || !attend_args_ok(act_dtype, packed4, B, KV, G, bs, nb))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int H = KV * G;
    bitserial::Mats mats{};
    bitserial::add(mats, q_planes, q_scale, H * hd, q_bits);
    bitserial::add(mats, k_planes, k_scale_w, KV * hd, k_bits);
    bitserial::add(mats, v_planes, v_scale_w, KV * hd, v_bits);
    float* y = static_cast<float*>(proj);
    if (act_dtype == 1)
        bitserial::launch<fused_project>(static_cast<const __nv_bfloat16*>(x), mats, y, B, D, st);
    else
        bitserial::launch<fused_project>(static_cast<const float*>(x), mats, y, B, D, st);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return fused_attend_launch(proj, act_dtype, k_pool, v_pool, k_scale, v_scale, block_tables,
                               lengths, cos, sin, qmax, out, kc_out, vc_out, ksc_out, vsc_out,
                               packed4, B, KV, G, hd, bs, nb, scale, stream);
}
