// Forward of the WaveNet gated-residual stack (kernel_size 2 and 3) for
// Hopper, in two modes.
//
// Replaces pytorchwavenetvocoder_tpu/ops/train_kernel.py::_fwd_pallas:
//   * streams only (save_st=False), which fills the decode warm-up's ring
//     buffers: wn_layer_stack_fwd; plain PyTorch version
//     ops/train_kernel.py::ref_layer_stack_streams;
//   * training (save_st=True), which also writes the sigma/tanh saves and
//     the f32 skip sum for the backward (csrc/layer_stack_bwd.cu):
//     wn_layer_stack_fwd_train; plain version ops/train_kernel.py::
//     ref_layer_stack.
//
// Bound on the H100: per layer a (B*T, kR) x (kR, 2R) plus a (B*T, R) x
// (R, R) bf16 product (and in training a (B*T, R) x (R, S) skip product); at
// the warm-up's ~10^5 rows and the training windows' ~2 x 10^4 this is
// tensor-core work.  The bf16 streams, and in training the (B*T, 2R) bf16
// saves (1.42 GB over 30 layers at the arctic flagship window), are the
// only device-memory traffic that grows with B*T.  Design: one launch per
// layer; a block owns 32 time steps of one utterance.  It stages the K taps
// x[t - m d], m = 0 .. K-1 (zero where t - m d < 0: the causal padding)
// from the previous layer's stream into shared memory (K, the kernel size,
// is a template parameter: the kernel_size 2 instance is unchanged by the
// third tap), computes z in 64-channel chunks (sigmoid and tanh halves)
// with wmma bf16 tiles and f32 accumulation, adds the aux projection and
// bias, applies the f32 gate into a bf16 tile that stays in shared memory,
// then runs the 1x1s on it: in training the skip 1x1, added into the f32
// skip sum (each block owns its rows, so no two blocks touch one element;
// layer 0 writes it, later layers read-modify-write), and the residual
// 1x1, out = bf16(g @ W_res + b_res + x), which the last layer of a
// training stack skips (its output feeds nothing).  Shared memory grows
// with K: (K + 1) x 32 x R bf16 tiles, 152 KB at K = 3, R = 512, which
// keeps kernel_size 3 under Hopper's 227 KB up to R = 768
// (ops/train_kernel.py::_smem_bytes).  The TPU kernel's ring of tiles,
// packed int32 pairs and tile cadence were Mosaic constraints and are not
// carried over.
#include "wn_common.cuh"

using namespace nvcuda;

#define LS_THREADS 256
#define LS_TM 32          // time steps per block: 2 wmma row tiles
#define LS_ZC 128         // staged accumulator columns

template <int K>
static size_t ls_smem_bytes(int R, int A) {
    return (size_t)(K + 1) * LS_TM * R * sizeof(bf16) // the K taps, gate
         + (size_t)LS_TM * LS_ZC * sizeof(float)       // accumulator stage
         + (size_t)LS_TM * A * sizeof(float);          // aux rows
}

// TRAIN adds the sigma/tanh saves and the skip sum; without it the kernel
// is the streams-only one the decode warm-up runs.  K: the kernel size.
template <int K, bool TRAIN>
__global__ void __launch_bounds__(LS_THREADS) stack_layer_kernel(
    const bf16* __restrict__ x_in,    // (B, T, R) this layer's input stream
    bf16* __restrict__ x_out,         // (B, T, R) its output stream
    const bf16* __restrict__ h,       // (B, T, A)
    const bf16* __restrict__ dil_w,   // (K, R, 2R): [K-1-m] taps x[t - m d]
    const bf16* __restrict__ aux_w,   // (A, 2R)
    const float* __restrict__ zb,     // (2R) dil_b + aux_b
    const bf16* __restrict__ res_w,   // (R, R)
    const float* __restrict__ res_b,  // (R)
    int T, int R, int A, int d,
    // training mode only
    bf16* __restrict__ st,            // (B, T, 2R) this layer's sigma | tanh
    float* __restrict__ skip_sum,     // (B, T, S)
    const bf16* __restrict__ skip_w,  // (R, S)
    const float* __restrict__ skip_b, // (S)
    int S, int first_layer, int do_res) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xc = (bf16*)smem;                    // (K, TM, R) x[t - m d]
    bf16* gs = xc + K * LS_TM * R;             // (TM, R) gate output
    float* zs = (float*)(gs + LS_TM * R);      // (TM, ZC) accumulators
    float* hs = zs + LS_TM * LS_ZC;            // (TM, A) aux
    const int b = blockIdx.y, t0 = blockIdx.x * LS_TM;
    const int warp = threadIdx.x >> 5;
    const int R2 = 2 * R;
    const bf16* xb = x_in + (size_t)b * T * R;

    // stage the K taps, 16-byte vectors, zeros outside [0, T)
    const int vec = R / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < LS_TM * vec; i += LS_THREADS) {
        const int r = i / vec, v = i - r * vec, t = t0 + r;
#pragma unroll
        for (int m = 0; m < K; ++m) {
            const int ts = t - m * d;
            ((uint4*)(xc + ((size_t)m * LS_TM + r) * R))[v] =
                (t < T && ts >= 0) ? ((const uint4*)(xb + (size_t)ts * R))[v]
                                   : zero;
        }
    }
    for (int i = threadIdx.x; i < LS_TM * A; i += LS_THREADS) {
        const int r = i / A, a = i - r * A, t = t0 + r;
        hs[i] = t < T ? bf2f(h[((size_t)b * T + t) * A + a]) : 0.f;
    }
    __syncthreads();

    // gate, 64 channels (128 z columns) per chunk; warp w owns one 16-wide
    // column tile: sigmoid half for w < 4, tanh half otherwise
    for (int c = 0; c < R; c += 64) {
        const int col = warp < 4 ? c + 16 * warp : R + c + 16 * (warp - 4);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
        for (int k = 0; k < R; k += 16) {
            // bw[m]: the weight of tap x[t - m d], dil_w[K-1-m]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[K];
#pragma unroll
            for (int m = 0; m < K; ++m)
                wmma::load_matrix_sync(
                    bw[m], dil_w + ((size_t)(K - 1 - m) * R + k) * R2 + col, R2);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                    wmma::load_matrix_sync(
                        a, xc + ((size_t)m * LS_TM + 16 * t) * R + k, R);
                    wmma::mma_sync(acc[t], a, bw[m], acc[t]);
                }
            }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(zs + (size_t)(16 * t) * LS_ZC + 16 * warp,
                                    acc[t], LS_ZC, wmma::mem_row_major);
        __syncthreads();
        for (int i = threadIdx.x; i < LS_TM * 64; i += LS_THREADS) {
            const int r = i >> 6, j = i & 63, cc = c + j;
            float as = 0.f, at = 0.f;
            for (int a = 0; a < A; ++a) {
                const float hv = hs[r * A + a];
                as += hv * bf2f(aux_w[(size_t)a * R2 + cc]);
                at += hv * bf2f(aux_w[(size_t)a * R2 + R + cc]);
            }
            const float s = zs[r * LS_ZC + j] + as + zb[cc];
            const float tt = zs[r * LS_ZC + 64 + j] + at + zb[R + cc];
            if constexpr (TRAIN) {
                const float sg = wn_sigmoid(s), th = tanhf(tt);
                gs[(size_t)r * R + cc] = f2bf(sg * th);
                const int t = t0 + r;
                if (t < T) {
                    bf16* row = st + ((size_t)b * T + t) * R2;
                    row[cc] = f2bf(sg);
                    row[R + cc] = f2bf(th);
                }
            } else {
                gs[(size_t)r * R + cc] = f2bf(wn_gate(s, tt));
            }
        }
        __syncthreads();
    }

    if constexpr (TRAIN) {
        // skip 1x1 into the f32 skip sum, 128 columns per chunk
        for (int c = 0; c < S; c += LS_ZC) {
            const int col = c + 16 * warp;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
            wmma::fill_fragment(acc[0], 0.f);
            wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
            for (int k = 0; k < R; k += 16) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
                wmma::load_matrix_sync(bw, skip_w + (size_t)k * S + col, S);
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                    wmma::load_matrix_sync(a, gs + (size_t)(16 * t) * R + k, R);
                    wmma::mma_sync(acc[t], a, bw, acc[t]);
                }
            }
#pragma unroll
            for (int t = 0; t < 2; ++t)
                wmma::store_matrix_sync(zs + (size_t)(16 * t) * LS_ZC + 16 * warp,
                                        acc[t], LS_ZC, wmma::mem_row_major);
            __syncthreads();
            for (int i = threadIdx.x; i < LS_TM * LS_ZC; i += LS_THREADS) {
                const int r = i >> 7, j = i & (LS_ZC - 1), t = t0 + r, cc = c + j;
                if (t < T) {
                    float* dst = skip_sum + ((size_t)b * T + t) * S + cc;
                    const float v = zs[r * LS_ZC + j] + skip_b[cc];
                    *dst = first_layer ? v : *dst + v;
                }
            }
            __syncthreads();
        }
        if (!do_res) return;    // the last layer's output stream feeds nothing
    }

    // residual 1x1, 128 output columns per chunk; warp w owns 16 of them
    for (int c = 0; c < R; c += LS_ZC) {
        const int col = c + 16 * warp;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
        for (int k = 0; k < R; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
            wmma::load_matrix_sync(bw, res_w + (size_t)k * R + col, R);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                wmma::load_matrix_sync(a, gs + (size_t)(16 * t) * R + k, R);
                wmma::mma_sync(acc[t], a, bw, acc[t]);
            }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(zs + (size_t)(16 * t) * LS_ZC + 16 * warp,
                                    acc[t], LS_ZC, wmma::mem_row_major);
        __syncthreads();
        for (int i = threadIdx.x; i < LS_TM * LS_ZC; i += LS_THREADS) {
            const int r = i >> 7, j = i & (LS_ZC - 1), t = t0 + r, cc = c + j;
            if (t < T) {
                const float v = zs[r * LS_ZC + j] + res_b[cc]
                              + bf2f(xc[(size_t)r * R + cc]);
                x_out[((size_t)b * T + t) * R + cc] = f2bf(v);
            }
        }
        __syncthreads();
    }
}

// Runs layers 0 .. n_run-1 on `stream`: layer l reads stream l (x0 for
// l = 0, else streams[l-1]) and writes streams[l]; streams is
// (n_run, B, T, R).  dilations is a host array of n_run ints; dil_w is
// (n_run.., K, R, 2R).  Returns cudaGetLastError() (0 = success).
template <int K>
static int run_fwd(const void* x0, void* streams, const void* h,
                   const void* dil_w, const void* aux_w, const void* zb,
                   const void* res_w, const void* res_b, const int* dilations,
                   int n_run, int B, int T, int R, int A, cudaStream_t st) {
    const size_t smem = ls_smem_bytes<K>(R, A);
    cudaError_t e = cudaFuncSetAttribute(
        stack_layer_kernel<K, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const size_t stream_sz = (size_t)B * T * R;
    const dim3 grid((T + LS_TM - 1) / LS_TM, B);
    for (int l = 0; l < n_run; ++l) {
        const bf16* in = l == 0 ? (const bf16*)x0
                                : (const bf16*)streams + (size_t)(l - 1) * stream_sz;
        bf16* out = (bf16*)streams + (size_t)l * stream_sz;
        stack_layer_kernel<K, false><<<grid, LS_THREADS, smem, st>>>(
            in, out, (const bf16*)h,
            (const bf16*)dil_w + (size_t)l * K * R * 2 * R,
            (const bf16*)aux_w + (size_t)l * A * 2 * R,
            (const float*)zb + (size_t)l * 2 * R,
            (const bf16*)res_w + (size_t)l * R * R,
            (const float*)res_b + (size_t)l * R, T, R, A, dilations[l],
            nullptr, nullptr, nullptr, nullptr, 0, 0, 0);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// The training forward: runs all L layers.  Layer l reads stream l (x0 for
// l = 0, else streams[l-1]), writes streams[l] for l < L-1 (streams is
// (L-1, B, T, R)), its sigma | tanh saves into st[l] (st is (L, B, T, 2R)),
// and adds its skip 1x1 into skip_sum (B, T, S) f32.
template <int K>
static int run_fwd_train(
    const void* x0, void* streams, void* st_v, void* skip_sum, const void* h,
    const void* dil_w, const void* aux_w, const void* zb, const void* skip_w,
    const void* skip_b, const void* res_w, const void* res_b,
    const int* dilations, int L, int B, int T, int R, int S, int A,
    cudaStream_t cs) {
    const size_t smem = ls_smem_bytes<K>(R, A);
    cudaError_t e = cudaFuncSetAttribute(
        stack_layer_kernel<K, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const size_t stream_sz = (size_t)B * T * R;
    const dim3 grid((T + LS_TM - 1) / LS_TM, B);
    for (int l = 0; l < L; ++l) {
        const bf16* in = l == 0 ? (const bf16*)x0
                                : (const bf16*)streams + (size_t)(l - 1) * stream_sz;
        bf16* out = l < L - 1 ? (bf16*)streams + (size_t)l * stream_sz : nullptr;
        stack_layer_kernel<K, true><<<grid, LS_THREADS, smem, cs>>>(
            in, out, (const bf16*)h,
            (const bf16*)dil_w + (size_t)l * K * R * 2 * R,
            (const bf16*)aux_w + (size_t)l * A * 2 * R,
            (const float*)zb + (size_t)l * 2 * R,
            (const bf16*)res_w + (size_t)l * R * R,
            (const float*)res_b + (size_t)l * R, T, R, A, dilations[l],
            (bf16*)st_v + (size_t)l * 2 * stream_sz, (float*)skip_sum,
            (const bf16*)skip_w + (size_t)l * R * S,
            (const float*)skip_b + (size_t)l * S, S, l == 0, l < L - 1);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// The streams-only forward (run_fwd) at kernel size K (2 or 3; any other
// returns cudaErrorInvalidValue).
extern "C" int wn_layer_stack_fwd(
    const void* x0, void* streams, const void* h, const void* dil_w,
    const void* aux_w, const void* zb, const void* res_w, const void* res_b,
    const void* dilations_v, int n_run, int B, int T, int R, int A, int K,
    void* stream) {
    const int* dil = (const int*)dilations_v;
    cudaStream_t st = (cudaStream_t)stream;
    if (K == 2)
        return run_fwd<2>(x0, streams, h, dil_w, aux_w, zb, res_w, res_b, dil,
                          n_run, B, T, R, A, st);
    if (K == 3)
        return run_fwd<3>(x0, streams, h, dil_w, aux_w, zb, res_w, res_b, dil,
                          n_run, B, T, R, A, st);
    return (int)cudaErrorInvalidValue;
}

// The training forward (run_fwd_train) at kernel size K (2 or 3).
extern "C" int wn_layer_stack_fwd_train(
    const void* x0, void* streams, void* st_v, void* skip_sum, const void* h,
    const void* dil_w, const void* aux_w, const void* zb, const void* skip_w,
    const void* skip_b, const void* res_w, const void* res_b,
    const void* dilations_v, int L, int B, int T, int R, int S, int A, int K,
    void* stream) {
    const int* dil = (const int*)dilations_v;
    cudaStream_t cs = (cudaStream_t)stream;
    if (K == 2)
        return run_fwd_train<2>(x0, streams, st_v, skip_sum, h, dil_w, aux_w,
                                zb, skip_w, skip_b, res_w, res_b, dil, L, B,
                                T, R, S, A, cs);
    if (K == 3)
        return run_fwd_train<3>(x0, streams, st_v, skip_sum, h, dil_w, aux_w,
                                zb, skip_w, skip_b, res_w, res_b, dil, L, B,
                                T, R, S, A, cs);
    return (int)cudaErrorInvalidValue;
}
