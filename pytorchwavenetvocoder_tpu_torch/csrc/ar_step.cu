// The WaveNet AR sample loop (kernel_size 2 and 3, bf16 or int8) for Hopper.
//
// Replaces pytorchwavenetvocoder_tpu/ops/ar_kernel.py::_pallas_ar_generate
// (the fused Pallas TPU kernel), bf16 and int8 (quantize=True), where
// ops/ar_kernel.py::ar_route picks this loop over the persistent kernel of
// csrc/ar_persistent.cu: kernel_size 3 fleets from AR_LOOP_FROM_B
// (AR_INT8_LOOP_FROM_B) rows, and configs whose stages that kernel cannot
// cut in shared memory (bf16 kernel_size 3 with n_resch >= 768).  The
// plain PyTorch version is ops/ar_kernel.py::ar_generate_reference.
//
// Bound on the H100: each step reads the whole bf16 weight pack,
// L * R * (2kR + S + R) * 2 bytes (86.5 MB at 30 x 512 with k = 2, 118.0 MB
// with k = 3, more than the 50 MB L2), for only B rows, so a large fleet is bound by device-memory bytes
// and a small one by the dependent launches of the step.  The TPU kernel
// kept the pack resident in VMEM across its sequential grid; a Hopper SM
// holds 227 KB and blocks share nothing between launches, so here:
//   * the step loop runs in C++ (wn_ar_generate), not in Python;
//   * ar_embed_kernel starts each step with the input conv (two row
//     gathers of the causal weights); ar_aux_kernel projects the step's aux
//     column for all L layers at once (it does not depend on the chain);
//   * per layer, ar_gate_kernel computes out @ [W_cur | W_past] over
//     16-column slices (8 warps split K, loads unrolled so several are in
//     flight): blocks of current-tap columns hold the sigmoid and tanh
//     halves of 8 channels and apply the ring tap, aux term, bias and f32
//     gate; blocks of past-tap columns stage the projection-forwarded ring
//     values for step p + d;
//   * ar_res_kernel computes g @ [W_skip | W_res] over 16-column slices,
//     the f32 skip sum and the residual add, and copies the staged ring
//     values into slot p mod d (the slot the gate launch just read:
//     (p - d) mod d = p mod d), so no block writes what another reads;
//   * the post stack is two ar_dense_kernel GEMMs (ReLU/1x1 twice), then
//     ar_sample_kernel takes, per row, the argmax (ties to the lowest
//     index) or the Gumbel-max with noise from a counter-based
//     Philox4x32-10 on (seed, row, step, class).
// Matmuls use wmma bf16 16x16x16 tiles with f32 accumulation; operands
// come straight from device memory, and a second grid axis over 64-row
// chunks keeps large fleets parallel.  65 launches per step.  The ring is
// updated in place in the caller's carry.
//
// int8 (the INT8 template instances, one launch structure): the layer
// packs are int8 with one f32 scale per output column, stored as whole
// 16 x 16 tiles so each wmma s8 16x16x16 operand load is one aligned
// 256-byte block (a row-major int8 tile at k = 16 would sit 16 bytes off
// the 32-byte alignment wmma asks for); int32 accumulation is exact.  The
// quantization is fused into the producers: the embed and each res launch
// write the residual stream as int8 tiles at the scale of the layer that
// reads it (from the f32 stream, round half to even, clip to +-127), the
// gate launch writes g as int8 tiles at 1/127, and each GEMM's epilogue
// dequantizes by (activation scale x column scale).  The ring keeps the
// bf16 projection of the int8 product.  The epilogues round with
// __fmul_rn / __fadd_rn (no FMA contraction), as the plain version does:
// an f32 difference that flips one int8 value would move the rest of the
// row's layers by int8 quanta.  Same 65 launches per step; the int8 pack
// (43.3 MB at 30 x 512) halves the bytes each step reads, and each gate
// block's re-read of its input rows, which bounds large fleets; small
// fleets stay bound by the launches' latency (an s8 16x16x16 MMA covers
// the K of a bf16 one, so the dependent wmma steps are as many).
//
// kernel_size 3 (the ljspeech models; K = 3 at run time, same template
// instances): the rings are raw, capacity 2d, and hold each layer's input
// row at slot p mod 2d: bf16, or the int8 row at the layer's scale that
// the current tap already multiplies.  There is nothing to project, so
// per step ar_lag_gather_kernel first copies every layer's two lagged rows
// ((p - d) and (p - 2d) mod 2d) into a zero-padded scratch (int8 as 16 x 16
// tiles, which also fixes the row-major ring's wmma alignment); per layer
// ar_gate3_kernel then runs the three K = R products [x | lag d | lag 2d]
// @ [W_cur; W_d; W_2d] onto the 2R gate columns (interleaved as above) and
// the gate, and writes the layer's input row into slot p mod 2d, which the
// gather has read already; ar_res_kernel is unchanged.  int8 dequantizes
// each product by its own column scales and adds them in the plain
// version's order.  66 launches per step; the packs are 118.0 MB (bf16)
// and 59.0 MB (int8), neither of which fits the L2.
#include <algorithm>
#include <type_traits>

#include "wn_common.cuh"
#include "wn_hopper.cuh"

using namespace nvcuda;

#define AR_THREADS 256
#define AR_ROWS 64        // rows per block of the K-split GEMMs: 4 row tiles
#define AR_AUX_MAX 96
#define AR_AUX_ROWS 32

// ---------------------------------------------------------------- int8

// Offset of element (b, c) of a (rows, C) int8 matrix stored as whole
// 16 x 16 tiles, row-major over tiles: [rows/16][C/16][16][16].
static __device__ __forceinline__ size_t tix(int b, int c, int C) {
    return ((size_t)(b >> 4) * (C >> 4) + (c >> 4)) * 256
           + ((b & 15) << 4) + (c & 15);
}

// clip(round_half_even(v), -127, 127): jnp.round / torch.round semantics
static __device__ __forceinline__ int8_t quant_i8(float v) {
    return (int8_t)max(-127, min(127, __float2int_rn(v)));
}

// ---------------------------------------------------------------- kernels

// The input conv over the K ids at p-K+1 .. p (tap j reads causal_w[j] at
// the id j steps after the oldest).  bf16: out = ((causal_b + w_0) + w_1)
// (+ w_2), also as bf16 rows.  INT8: out = ((w_0 + w_1) (+ w_2)) + causal_b
// (the JAX kernel's one-hot matmul, then the bias), also as int8 tiles at
// layer 0's scale (ainv = its reciprocal).  skip = 0.
template <bool INT8>
__global__ void __launch_bounds__(AR_THREADS) ar_embed_kernel(
    const bf16* __restrict__ causal_w,   // (K, Q, R)
    const float* __restrict__ causal_b,  // (R)
    const int* __restrict__ ids,         // (B, K): ids at p-K+1 .. p
    float* __restrict__ out_f32,         // (Bp, R)
    void* __restrict__ out_lo,           // (Bp, R): bf16 rows, or int8 tiles
    const float* __restrict__ ainv,      // INT8: layer 0's 1 / scale
    float* __restrict__ skip,            // (B, S)
    int R, int S, int Q, int K) {
    const int b = blockIdx.x;
    const bf16* w[3];
    for (int j = 0; j < K; ++j)
        w[j] = causal_w + ((size_t)j * Q + ((ids[K * b + j] % Q) + Q) % Q) * R;
    for (int r = threadIdx.x; r < R; r += AR_THREADS) {
        if constexpr (INT8) {
            float v = bf2f(w[0][r]);
            for (int j = 1; j < K; ++j) v = __fadd_rn(v, bf2f(w[j][r]));
            v = __fadd_rn(v, causal_b[r]);
            out_f32[(size_t)b * R + r] = v;
            ((int8_t*)out_lo)[tix(b, r, R)] = quant_i8(__fmul_rn(v, ainv[0]));
        } else {
            float v = causal_b[r];
            for (int j = 0; j < K; ++j) v += bf2f(w[j][r]);
            out_f32[(size_t)b * R + r] = v;
            ((bf16*)out_lo)[(size_t)b * R + r] = f2bf(v);
        }
    }
    for (int s = threadIdx.x; s < S; s += AR_THREADS) skip[(size_t)b * S + s] = 0.f;
}

// za[b, n] = bf16(h_up[b, p]) @ auxw[:, n] + zb[n] for all L * 2R columns n
// (auxw (L, A, 2R), column n = l * 2R + c); one thread per column.
__global__ void __launch_bounds__(AR_THREADS) ar_aux_kernel(
    const bf16* __restrict__ auxw, const float* __restrict__ zb,
    const float* __restrict__ h_up, int h_T, int p,
    float* __restrict__ za, int B, int A, int R, int L) {
    __shared__ float hs[AR_AUX_ROWS][AR_AUX_MAX];
    const int N = L * 2 * R;
    const int n = blockIdx.x * AR_THREADS + threadIdx.x;
    const int l = n / (2 * R), c = n - l * 2 * R;
    const bf16* w = auxw + (size_t)l * A * 2 * R + c;
    for (int row0 = 0; row0 < B; row0 += AR_AUX_ROWS) {
        __syncthreads();
        for (int i = threadIdx.x; i < AR_AUX_ROWS * A; i += AR_THREADS) {
            const int r = i / A, a = i - r * A, b = row0 + r;
            hs[r][a] = b < B ? bf_round(h_up[((size_t)b * h_T + p) * A + a]) : 0.f;
        }
        __syncthreads();
        if (n >= N) continue;
        float acc[AR_AUX_ROWS];
#pragma unroll
        for (int r = 0; r < AR_AUX_ROWS; ++r) acc[r] = 0.f;
        for (int a = 0; a < A; ++a) {
            const float wa = bf2f(w[(size_t)a * 2 * R]);
#pragma unroll
            for (int r = 0; r < AR_AUX_ROWS; ++r) acc[r] += hs[r][a] * wa;
        }
        const float bias = zb[n];
#pragma unroll
        for (int r = 0; r < AR_AUX_ROWS; ++r)
            if (row0 + r < B) za[(size_t)(row0 + r) * N + n] = acc[r] + bias;
    }
}

// The K-split GEMM core of the 1x1 layers: acc = A[row0:row0+64] @ W[:, col0:col0+16]
// summed over the 8 warps' K slices [w K/8, (w+1) K/8) into cs.
static __device__ __forceinline__ void ksplit_gemm(
    const bf16* __restrict__ A, int K, const bf16* __restrict__ W, int N,
    int row0, int col0, int nt, float (*cs)[AR_ROWS][16]) {
    const int warp = threadIdx.x >> 5;
    const int kc = K / 8, kbeg = warp * kc, kend = kbeg + kc;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll 4
    for (int k = kbeg; k < kend; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, W + (size_t)k * N + col0, N);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t < nt) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
                wmma::load_matrix_sync(afr, A + (size_t)(row0 + 16 * t) * K + k, K);
                wmma::mma_sync(acc[t], afr, bfr, acc[t]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
        if (t < nt)
            wmma::store_matrix_sync(&cs[warp][16 * t][0], acc[t], 16,
                                    wmma::mem_row_major);
    __syncthreads();
}

// The same K split on int8 tiles (A: (Bp, K) tiles, W: (K, N) tiles),
// int32 accumulation: acc = A[row0:row0+64] @ W[:, col0:col0+16].
static __device__ __forceinline__ void ksplit_gemm_i8(
    const int8_t* __restrict__ A, int K, const int8_t* __restrict__ W, int N,
    int row0, int col0, int nt, int (*cs)[AR_ROWS][16]) {
    const int warp = threadIdx.x >> 5;
    const int KT = K / 16, NT = N / 16;
    const int kc = KT / 8, kbeg = warp * kc, kend = kbeg + kc;   // k tiles
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0);
#pragma unroll 4
    for (int kt = kbeg; kt < kend; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bfr;
        wmma::load_matrix_sync(
            bfr, (const signed char*)W + ((size_t)kt * NT + (col0 >> 4)) * 256, 16);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t < nt) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> afr;
                wmma::load_matrix_sync(
                    afr, (const signed char*)A
                             + ((size_t)((row0 >> 4) + t) * KT + kt) * 256, 16);
                wmma::mma_sync(acc[t], afr, bfr, acc[t]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
        if (t < nt)
            wmma::store_matrix_sync(&cs[warp][16 * t][0], acc[t], 16,
                                    wmma::mem_row_major);
    __syncthreads();
}

// One layer's z = out @ W4 over 16 columns x 64 rows per block.  W4's
// first 2R columns hold the current tap with sigmoid and tanh columns
// interleaved in groups of 8 (column 16q + i: sigmoid channel 8q + i,
// column 16q + 8 + i: tanh channel 8q + i), so block q < R/8 holds both
// halves of channels [8q, 8q+8) and applies the gate with the ring tap and
// aux term.  Blocks q >= R/8 compute the projection-forwarded ring values
// (the past tap) into proj; ar_res_kernel copies them into the ring slot,
// after every gate block of this layer has read the slot's old values.
// INT8: the product of the int8 stream and int8 pack, dequantized by
// (the layer's activation scale x the column's scale); z = zfull + (ring +
// za); g goes out as int8 tiles at 1 / ginv.
template <bool INT8>
__global__ void __launch_bounds__(AR_THREADS) ar_gate_kernel(
    const void* __restrict__ w4,       // (R, 4R) this layer: bf16 rows / int8 tiles
    const float* __restrict__ w4s,     // INT8: (4R) column scales of this layer
    const float* __restrict__ ascale,  // INT8: this layer's activation scale
    const float* __restrict__ za,      // aux term + biases of this layer; row stride zs
    int zs,
    const void* __restrict__ x_in,     // (Bp, R) stream: bf16 rows / int8 tiles
    void* __restrict__ g_out,          // (Bp, R) gate: bf16 rows / int8 tiles
    float ginv,                        // INT8: 1 / the gate's scale
    const bf16* __restrict__ ring_slot,// (B, 2R): this layer's slot p % d
    bf16* __restrict__ proj,           // (B, 2R)
    int B, int R) {
    using Acc = std::conditional_t<INT8, int, float>;
    __shared__ __align__(32) Acc cs[8][AR_ROWS][16];
    constexpr int PAIRS = AR_ROWS * 8 / AR_THREADS;
    const int col0 = blockIdx.x * 16, row0 = blockIdx.y * AR_ROWS;
    const int nt = min(4, (B - row0 + 15) / 16);
    const bool gate = blockIdx.x < R / 8;
    // gate blocks: thread owns (row, channel) pairs; load their operands
    // before the GEMM so the latency overlaps the weight loads
    const int jj = threadIdx.x & 7, c = blockIdx.x * 8 + jj;
    float ring_s[PAIRS], ring_t[PAIRS], za_s[PAIRS], za_t[PAIRS];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
        const int b = row0 + ((threadIdx.x + q * AR_THREADS) >> 3);
        const bool live = gate && b < B;
        ring_s[q] = live ? bf2f(ring_slot[(size_t)b * 2 * R + c]) : 0.f;
        ring_t[q] = live ? bf2f(ring_slot[(size_t)b * 2 * R + R + c]) : 0.f;
        za_s[q] = live ? za[(size_t)b * zs + c] : 0.f;
        za_t[q] = live ? za[(size_t)b * zs + R + c] : 0.f;
    }
    if constexpr (INT8)
        ksplit_gemm_i8((const int8_t*)x_in, R, (const int8_t*)w4, 4 * R, row0,
                       col0, nt, cs);
    else
        ksplit_gemm((const bf16*)x_in, R, (const bf16*)w4, 4 * R, row0, col0,
                    nt, cs);
    if (gate) {
        float sc_s = 0.f, sc_t = 0.f;
        if constexpr (INT8) {
            sc_s = __fmul_rn(ascale[0], w4s[col0 + jj]);
            sc_t = __fmul_rn(ascale[0], w4s[col0 + 8 + jj]);
        }
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const int r = (threadIdx.x + q * AR_THREADS) >> 3, b = row0 + r;
            if (b >= B) continue;
            Acc zsig = 0, ztanh = 0;
#pragma unroll
            for (int w = 0; w < 8; ++w) {
                zsig += cs[w][r][jj];
                ztanh += cs[w][r][8 + jj];
            }
            if constexpr (INT8) {
                // _rn intrinsics: no FMA contraction, the plain version's
                // rounding of the dequantized product and the sums
                const float g = wn_gate(
                    __fadd_rn(__fmul_rn((float)zsig, sc_s),
                              __fadd_rn(ring_s[q], za_s[q])),
                    __fadd_rn(__fmul_rn((float)ztanh, sc_t),
                              __fadd_rn(ring_t[q], za_t[q])));
                ((int8_t*)g_out)[tix(b, c, R)] = quant_i8(__fmul_rn(g, ginv));
            } else {
                ((bf16*)g_out)[(size_t)b * R + c] = f2bf(
                    wn_gate((zsig + ring_s[q]) + za_s[q],
                            (ztanh + ring_t[q]) + za_t[q]));
            }
        }
    } else {
        for (int i = threadIdx.x; i < AR_ROWS * 16; i += AR_THREADS) {
            const int r = i >> 4, j = i & 15, b = row0 + r;
            if (b >= B) continue;
            Acc v = 0;
#pragma unroll
            for (int w = 0; w < 8; ++w) v += cs[w][r][j];
            float fv;
            if constexpr (INT8)
                fv = __fmul_rn((float)v, __fmul_rn(ascale[0], w4s[col0 + j]));
            else fv = v;
            proj[(size_t)b * 2 * R + (col0 - 2 * R + j)] = f2bf(fv);
        }
    }
}

// kernel_size 3, once per step before any layer: lag[l][j] (Bp, R) =
// ring rows of layer l at slot (p - (j+1) d_l) mod 2 d_l, j = 0, 1, for rows
// b < B: bf16 rows, or INT8 16 x 16 tiles (the ring's rows are row-major
// int8, 16 bytes off wmma's 32-byte alignment at k = 16).  Every read
// precedes this step's ring writes, which reuse the lag-2d slot.
template <bool INT8>
__global__ void __launch_bounds__(AR_THREADS) ar_lag_gather_kernel(
    const void* __restrict__ ring,     // (total_cap, B, R) bf16 / int8
    const int* __restrict__ meta,      // (L, 2): ring offset, dilation
    int p, void* __restrict__ lag,     // (L, 2, Bp, R)
    int B, int Bp, int R, int L) {
    constexpr int ESZ = INT8 ? 1 : 2;
    const int vpr = R * ESZ / 16;                  // 16-byte vectors a row
    const long long n = (long long)L * 2 * B * vpr;
    for (long long i = (long long)blockIdx.x * AR_THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * AR_THREADS) {
        const int v = (int)(i % vpr);
        long long rest = i / vpr;
        const int b = (int)(rest % B);
        rest /= B;
        const int j = (int)(rest & 1), l = (int)(rest >> 1);
        const int d = meta[2 * l + 1], cap = 2 * d;
        const int slot = meta[2 * l] + (((p - (j + 1) * d) % cap) + cap) % cap;
        const uint4 val = ((const uint4*)((const char*)ring
                                          + ((size_t)slot * B + b) * R * ESZ))[v];
        char* dst = (char*)lag + (size_t)(2 * l + j) * Bp * R * ESZ;
        if constexpr (INT8) dst += tix(b, 16 * v, R);
        else dst += ((size_t)b * R + 8 * v) * 2;
        *(uint4*)dst = val;
    }
}

// kernel_size 3: one layer's z = [x | lag d | lag 2d] @ [W_cur; W_d; W_2d]
// over 16 columns x 64 rows per block, the three K = R products in turn
// through the same K-split core, each summed over the warps into the
// threads' (row, channel) pairs.  wz holds the three (R, 2R) blocks side by
// side, [cur | lag d | lag 2d], each interleaved like W4's current tap, so
// block q holds the sigmoid and tanh halves of channels [8q, 8q+8) and
// applies the gate.  The grid also copies the layer's input rows (bf16
// rows or int8 tiles) into its ring slot p mod 2d as row-major (B, R): the
// lag gather has read that slot already.  INT8: each product dequantized
// by (activation scale x its column's scale), summed in the plain
// version's order, cur + (((lag d + lag 2d) + za)); g goes out as int8
// tiles at 1 / ginv.
template <bool INT8>
__global__ void __launch_bounds__(AR_THREADS) ar_gate3_kernel(
    const void* __restrict__ wz,       // (R, 6R) this layer: bf16 rows / int8 tiles
    const float* __restrict__ wzs,     // INT8: (6R) column scales of this layer
    const float* __restrict__ ascale,  // INT8: this layer's activation scale
    const float* __restrict__ za,      // aux term + biases of this layer; row stride zs
    int zs,
    const void* __restrict__ x_in,     // (Bp, R) stream: bf16 rows / int8 tiles
    const void* __restrict__ lag,      // (2, Bp, R) this layer's lagged rows
    void* __restrict__ g_out,          // (Bp, R) gate: bf16 rows / int8 tiles
    float ginv,                        // INT8: 1 / the gate's scale
    void* __restrict__ ring_slot,      // (B, R) bf16 / int8: slot p mod 2d
    int B, int Bp, int R) {
    using Acc = std::conditional_t<INT8, int, float>;
    constexpr int ESZ = INT8 ? 1 : 2;
    __shared__ __align__(32) Acc cs[8][AR_ROWS][16];
    constexpr int PAIRS = AR_ROWS * 8 / AR_THREADS;
    {
        const int vpr = R * ESZ / 16;
        const int n_vec = B * vpr;
        const int nthreads = gridDim.x * gridDim.y * AR_THREADS;
        for (int v = (blockIdx.y * gridDim.x + blockIdx.x) * AR_THREADS + threadIdx.x;
             v < n_vec; v += nthreads) {
            const int b = v / vpr, c16 = v - b * vpr;
            const char* src = (const char*)x_in;
            if constexpr (INT8) src += tix(b, 16 * c16, R);
            else src += (size_t)v * 16;
            ((uint4*)ring_slot)[v] = *(const uint4*)src;
        }
    }
    const int col0 = blockIdx.x * 16, row0 = blockIdx.y * AR_ROWS;
    const int nt = min(4, (B - row0 + 15) / 16);
    const int jj = threadIdx.x & 7, c = blockIdx.x * 8 + jj;
    float za_s[PAIRS], za_t[PAIRS], ps[3][PAIRS], pt[3][PAIRS];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
        const int b = row0 + ((threadIdx.x + q * AR_THREADS) >> 3);
        za_s[q] = b < B ? za[(size_t)b * zs + c] : 0.f;
        za_t[q] = b < B ? za[(size_t)b * zs + R + c] : 0.f;
    }
#pragma unroll
    for (int seg = 0; seg < 3; ++seg) {
        const int cseg = col0 + seg * 2 * R;
        const char* a = seg == 0 ? (const char*)x_in
                                 : (const char*)lag + (size_t)(seg - 1) * Bp * R * ESZ;
        if constexpr (INT8)
            ksplit_gemm_i8((const int8_t*)a, R, (const int8_t*)wz, 6 * R, row0,
                           cseg, nt, cs);
        else
            ksplit_gemm((const bf16*)a, R, (const bf16*)wz, 6 * R, row0, cseg,
                        nt, cs);
        float sc_s = 1.f, sc_t = 1.f;
        if constexpr (INT8) {
            sc_s = __fmul_rn(ascale[0], wzs[cseg + jj]);
            sc_t = __fmul_rn(ascale[0], wzs[cseg + 8 + jj]);
        }
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const int r = (threadIdx.x + q * AR_THREADS) >> 3;
            Acc zsig = 0, ztanh = 0;
#pragma unroll
            for (int w = 0; w < 8; ++w) {
                zsig += cs[w][r][jj];
                ztanh += cs[w][r][8 + jj];
            }
            if constexpr (INT8) {
                ps[seg][q] = __fmul_rn((float)zsig, sc_s);
                pt[seg][q] = __fmul_rn((float)ztanh, sc_t);
            } else {
                ps[seg][q] = zsig;
                pt[seg][q] = ztanh;
            }
        }
        __syncthreads();   // cs is rewritten by the next product
    }
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
        const int b = row0 + ((threadIdx.x + q * AR_THREADS) >> 3);
        if (b >= B) continue;
        if constexpr (INT8) {
            const float g = wn_gate(
                __fadd_rn(ps[0][q], __fadd_rn(__fadd_rn(ps[1][q], ps[2][q]), za_s[q])),
                __fadd_rn(pt[0][q], __fadd_rn(__fadd_rn(pt[1][q], pt[2][q]), za_t[q])));
            ((int8_t*)g_out)[tix(b, c, R)] = quant_i8(__fmul_rn(g, ginv));
        } else {
            ((bf16*)g_out)[(size_t)b * R + c] = f2bf(
                wn_gate(((ps[0][q] + ps[1][q]) + ps[2][q]) + za_s[q],
                        ((pt[0][q] + pt[1][q]) + pt[2][q]) + za_t[q]));
        }
    }
}

// sr = g @ [W_skip | W_res] + b, 16 columns x 64 rows per block; skip +=
// sr[:S]; out += sr[S:].  On the last layer (skip_relu set) it also writes
// bf16(relu(skip)), the post stack's input.  Each thread loads the values
// it will update before the GEMM.  The grid also copies the layer's staged
// ring values (proj) into its ring slot.  INT8: sr's product is
// dequantized by (the gate's scale x the column's scale), and the new
// stream goes out as int8 tiles at the next layer's scale (none after the
// last layer).
template <bool INT8>
__global__ void __launch_bounds__(AR_THREADS) ar_res_kernel(
    const void* __restrict__ wsr,      // (R, S+R) this layer: bf16 rows / int8 tiles
    const float* __restrict__ wsrs,    // INT8: (S+R) column scales of this layer
    float gscale,                      // INT8: the gate's scale
    const float* __restrict__ srb,     // (S+R)
    const void* __restrict__ g_in,     // (Bp, R) gate: bf16 rows / int8 tiles
    float* __restrict__ skip,          // (B, S)
    float* __restrict__ out_f32,       // (Bp, R)
    void* __restrict__ x_out,          // (Bp, R) stream: bf16 rows / int8 tiles
    const float* __restrict__ next_inv,// INT8: next layer's 1 / scale, or null
    bf16* __restrict__ skip_relu,      // (Bp, S) or null
    const bf16* __restrict__ proj,     // (B, 2R), or null (kernel_size 3)
    bf16* __restrict__ ring_slot,      // (B, 2R), or null
    int B, int R, int S) {
    using Acc = std::conditional_t<INT8, int, float>;
    __shared__ __align__(32) Acc cs[8][AR_ROWS][16];
    if (proj) {   // kernel_size 2: the staged projections into the ring
        const int n_vec = B * 2 * R / 8;   // 16-byte vectors
        const int nthreads = gridDim.x * gridDim.y * AR_THREADS;
        for (int v = (blockIdx.y * gridDim.x + blockIdx.x) * AR_THREADS + threadIdx.x;
             v < n_vec; v += nthreads)
            ((uint4*)ring_slot)[v] = ((const uint4*)proj)[v];
    }
    constexpr int PAIRS = AR_ROWS * 16 / AR_THREADS;
    const int col0 = blockIdx.x * 16, row0 = blockIdx.y * AR_ROWS;
    const int nt = min(4, (B - row0 + 15) / 16);
    const int j = threadIdx.x & 15, col = col0 + j;
    float* dst = col < S ? skip + col : out_f32 + (col - S);
    const int ld = col < S ? S : R;
    const float bias = srb[col];
    float wsc = 0.f;
    if constexpr (INT8) wsc = __fmul_rn(gscale, wsrs[col]);
    float old[PAIRS];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
        const int b = row0 + ((threadIdx.x + q * AR_THREADS) >> 4);
        old[q] = b < B ? dst[(size_t)b * ld] : 0.f;
    }
    if constexpr (INT8)
        ksplit_gemm_i8((const int8_t*)g_in, R, (const int8_t*)wsr, S + R, row0,
                       col0, nt, cs);
    else
        ksplit_gemm((const bf16*)g_in, R, (const bf16*)wsr, S + R, row0, col0,
                    nt, cs);
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
        const int r = (threadIdx.x + q * AR_THREADS) >> 4, b = row0 + r;
        if (b >= B) continue;
        Acc v = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += cs[w][r][j];
        float nv;
        if constexpr (INT8) nv = __fadd_rn(__fadd_rn(__fmul_rn((float)v, wsc), bias), old[q]);
        else nv = (v + bias) + old[q];
        dst[(size_t)b * ld] = nv;
        if (col < S) {
            if (skip_relu) skip_relu[(size_t)b * S + col] = f2bf(fmaxf(nv, 0.f));
        } else if constexpr (INT8) {
            if (next_inv)
                ((int8_t*)x_out)[tix(b, col - S, R)] = quant_i8(__fmul_rn(nv, next_inv[0]));
        } else {
            ((bf16*)x_out)[(size_t)b * R + (col - S)] = f2bf(nv);
        }
    }
}

// y = x @ W + b (x (Bp, K) bf16, W (K, N) bf16), 16 columns x 64 rows per
// block: to out_relu as bf16(relu(y)) if set, else to out as f32.
__global__ void __launch_bounds__(AR_THREADS) ar_dense_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ W,
    const float* __restrict__ bias, bf16* __restrict__ out_relu,
    float* __restrict__ out, int K, int N, int B) {
    __shared__ __align__(32) float cs[8][AR_ROWS][16];
    const int col0 = blockIdx.x * 16, row0 = blockIdx.y * AR_ROWS;
    const int nt = min(4, (B - row0 + 15) / 16);
    ksplit_gemm(x, K, W, N, row0, col0, nt, cs);
    for (int i = threadIdx.x; i < AR_ROWS * 16; i += AR_THREADS) {
        const int r = i >> 4, j = i & 15, b = row0 + r;
        if (b >= B) continue;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += cs[w][r][j];
        v += bias[col0 + j];
        if (out_relu) out_relu[(size_t)b * N + col0 + j] = f2bf(fmaxf(v, 0.f));
        else out[(size_t)b * N + col0 + j] = v;
    }
}

// Per row: the argmax of the logits, plus Gumbel noise in sampling mode.
__global__ void __launch_bounds__(AR_THREADS) ar_sample_kernel(
    const float* __restrict__ logits,                 // (B, Q)
    int* __restrict__ ids, int* __restrict__ samples, // (B, K), (B, max_n)
    int Q, int K, int step, int max_n, int sampling, unsigned long long seed) {
    __shared__ float rv[AR_THREADS];
    __shared__ int ri[AR_THREADS];
    const int b = blockIdx.x, tid = threadIdx.x;
    float best = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < Q; j += AR_THREADS) {
        float v = logits[(size_t)b * Q + j];
        if (sampling) v += gumbel_noise(seed, b, step, j);
        if (v > best || (v == best && j < bi)) { best = v; bi = j; }
    }
    rv[tid] = best;
    ri[tid] = bi;
    __syncthreads();
    for (int s = AR_THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) {
            const float ov = rv[tid + s];
            const int oi = ri[tid + s];
            if (ov > rv[tid] || (ov == rv[tid] && oi < ri[tid])) {
                rv[tid] = ov;
                ri[tid] = oi;
            }
        }
        __syncthreads();
    }
    if (tid == 0) {
        const int smp = ri[0] < Q ? ri[0] : 0;   // all-NaN logits -> 0
        samples[(size_t)b * max_n + step] = smp;
        for (int j = 0; j + 1 < K; ++j) ids[K * b + j] = ids[K * b + j + 1];
        ids[K * b + K - 1] = smp;
    }
}

// ---------------------------------------------------------------- entry

// The step loop.  Weight packs are raw bytes: bf16 rows or int8 tiles.
// K = 2: projection-forwarded rings (B, 2R); K = 3: raw rings (B, R), their
// lagged rows gathered into lag at each step's start (lag_meta: (L, 2)
// ring offset and dilation on the device).
template <bool INT8>
static int run_steps(
    const char* wz, const char* wsr, const float* wzs, const float* wsrs,
    const float* ascale, const float* ainv, float gscale, float ginv,
    const bf16* auxw, const float* zb, const float* srb, const bf16* causal_w,
    const float* causal_b, const bf16* post1_w, const float* post1_b,
    const bf16* post2_w, const float* post2_b, char* ring, const int* offsets,
    const int* caps, const float* h_up, int h_T, float* za, float* out_f32,
    void* x_lo, void* g_lo, bf16* proj, float* skip, bf16* skip_relu,
    bf16* h1, float* logits, int* ids, int* samples, int B, int R, int S,
    int Q, int A, int L, int T0, int max_n, int sampling,
    unsigned long long seed, int K, void* lag, const int* lag_meta,
    cudaStream_t st) {
    const size_t esz = INT8 ? 1 : 2;
    const size_t wz_l = (size_t)R * 2 * K * R * esz, wsr_l = (size_t)R * (S + R) * esz;
    // ring row width in bytes: (B, 2R) bf16 projections, or (B, R) rows
    const size_t slot_bytes = K == 2 ? (size_t)B * 2 * R * 2 : (size_t)B * R * esz;
    const int Bp = (B + 15) / 16 * 16;
    const int N_aux = L * 2 * R;
    const int rows = (B + AR_ROWS - 1) / AR_ROWS;
    const dim3 g_gate(K == 2 ? 4 * R / 16 : 2 * R / 16, rows);
    const dim3 g_res((S + R) / 16, rows);
    const dim3 g_p1(S / 16, rows);
    const dim3 g_p2(Q / 16, rows);
    const long long lag_vec = (long long)L * 2 * B * R * esz / 16;
    const int g_lag = (int)std::min<long long>((lag_vec + AR_THREADS - 1) / AR_THREADS, 1024);
    for (int i = 0; i < max_n; ++i) {
        const int p = T0 - 1 + i;
        ar_embed_kernel<INT8><<<B, AR_THREADS, 0, st>>>(
            causal_w, causal_b, ids, out_f32, x_lo, ainv, skip, R, S, Q, K);
        ar_aux_kernel<<<(N_aux + AR_THREADS - 1) / AR_THREADS, AR_THREADS, 0, st>>>(
            auxw, zb, h_up, h_T, p, za, B, A, R, L);
        if (K == 3)
            ar_lag_gather_kernel<INT8><<<g_lag, AR_THREADS, 0, st>>>(
                ring, lag_meta, p, lag, B, Bp, R, L);
        for (int l = 0; l < L; ++l) {
            char* slot = ring + ((size_t)offsets[l] + (size_t)(p % caps[l])) * slot_bytes;
            const float* l_wzs = INT8 ? wzs + (size_t)l * 2 * K * R : nullptr;
            const float* l_as = INT8 ? ascale + l : nullptr;
            if (K == 2)
                ar_gate_kernel<INT8><<<g_gate, AR_THREADS, 0, st>>>(
                    wz + l * wz_l, l_wzs, l_as, za + (size_t)l * 2 * R, N_aux,
                    x_lo, g_lo, ginv, (const bf16*)slot, proj, B, R);
            else
                ar_gate3_kernel<INT8><<<g_gate, AR_THREADS, 0, st>>>(
                    wz + l * wz_l, l_wzs, l_as, za + (size_t)l * 2 * R, N_aux,
                    x_lo, (const char*)lag + (size_t)l * 2 * Bp * R * esz, g_lo,
                    ginv, slot, B, Bp, R);
            ar_res_kernel<INT8><<<g_res, AR_THREADS, 0, st>>>(
                wsr + l * wsr_l, INT8 ? wsrs + (size_t)l * (S + R) : nullptr,
                gscale, srb + (size_t)l * (S + R), g_lo, skip, out_f32, x_lo,
                INT8 && l + 1 < L ? ainv + l + 1 : nullptr,
                l == L - 1 ? skip_relu : nullptr, K == 2 ? proj : nullptr,
                K == 2 ? (bf16*)slot : nullptr, B, R, S);
        }
        ar_dense_kernel<<<g_p1, AR_THREADS, 0, st>>>(
            skip_relu, post1_w, post1_b, h1, nullptr, S, S, B);
        ar_dense_kernel<<<g_p2, AR_THREADS, 0, st>>>(
            h1, post2_w, post2_b, nullptr, logits, S, Q, B);
        ar_sample_kernel<<<B, AR_THREADS, 0, st>>>(
            logits, ids, samples, Q, K, i, max_n, sampling, seed);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// Runs max_n steps on `stream`.  Returns cudaGetLastError() (0 = success;
// cudaErrorInvalidValue for a kernel size other than 2 and 3).  offsets /
// caps are host arrays of L ints (the ring layout of
// models/wavenet.py::_buffer_layout).  K = 2: the ring is (total_cap, B, 2R)
// bf16 projections, proj (B, 2R) bf16 scratch, wz = W4 (L, R, 4R).  K = 3:
// the ring is (total_cap, B, R) raw rows (bf16, or int8 under quantize),
// wz = W6 (L, R, 6R), lag (L, 2, Bp, R) scratch of the ring's type (int8:
// tiles), lag_meta (L, 2) int32 on the device.  ids (B, K).  Scratch: za
// (B, L*2R) f32; out_f32 (Bp, R); skip (B, S) f32; skip_relu, h1 (Bp, S)
// bf16; logits (B, Q) f32.  bf16 (quantize 0): wz and wsr (L, R, S+R) bf16
// rows; out_bf16, g_bf16 (Bp, R) bf16.  int8 (quantize 1): wz, wsr int8 in
// 16 x 16 tiles per layer, wzs (L, 2KR) and wsrs (L, S+R) f32 column scales,
// ascale / ainv (L) f32 activation scales and their reciprocals, gscale /
// ginv the gate's scale and its reciprocal; out_i8, g_i8 (Bp, R) int8
// tiles.  Rows B..Bp-1 of the row-tiled scratch (lag too) must be zero.
extern "C" int wn_ar_generate(
    const void* wz, const void* wsr, const void* auxw, const void* zb,
    const void* srb, const void* causal_w, const void* causal_b,
    const void* post1_w, const void* post1_b, const void* post2_w,
    const void* post2_b, void* ring, const void* offsets_v,
    const void* caps_v, const void* h_up, int h_T, void* za, void* out_f32,
    void* out_bf16, void* g_bf16, void* proj, void* skip, void* skip_relu,
    void* h1, void* logits, void* ids, void* samples, int B, int R, int S, int Q,
    int A, int L, int T0, int max_n, int sampling, unsigned long long seed,
    int quantize, const void* wzs, const void* wsrs, const void* ascale,
    const void* ainv, void* out_i8, void* g_i8, float gscale, float ginv,
    int K, void* lag, const void* lag_meta, void* stream) {
    if (K != 2 && K != 3) return (int)cudaErrorInvalidValue;
#define WN_AR_ARGS(X_LO, G_LO)                                                 \
    (const char*)wz, (const char*)wsr, (const float*)wzs, (const float*)wsrs, \
    (const float*)ascale, (const float*)ainv, gscale, ginv,                   \
    (const bf16*)auxw, (const float*)zb, (const float*)srb,                   \
    (const bf16*)causal_w, (const float*)causal_b, (const bf16*)post1_w,      \
    (const float*)post1_b, (const bf16*)post2_w, (const float*)post2_b,       \
    (char*)ring, (const int*)offsets_v, (const int*)caps_v,                   \
    (const float*)h_up, h_T, (float*)za, (float*)out_f32, X_LO, G_LO,         \
    (bf16*)proj, (float*)skip, (bf16*)skip_relu, (bf16*)h1, (float*)logits,   \
    (int*)ids, (int*)samples, B, R, S, Q, A, L, T0, max_n, sampling, seed,    \
    K, lag, (const int*)lag_meta, (cudaStream_t)stream
    if (quantize) return run_steps<true>(WN_AR_ARGS(out_i8, g_i8));
    return run_steps<false>(WN_AR_ARGS(out_bf16, g_bf16));
#undef WN_AR_ARGS
}
