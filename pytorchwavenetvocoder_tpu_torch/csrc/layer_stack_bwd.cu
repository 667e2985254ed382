// Backward of the WaveNet gated-residual stack (kernel_size 2 and 3) for
// Hopper.
//
// Replaces pytorchwavenetvocoder_tpu/ops/train_kernel.py::_bwd_pallas; the
// plain PyTorch version is ops/train_kernel.py::ref_layer_stack_bwd.  It
// consumes what the training forward (csrc/layer_stack_fwd.cu,
// wn_layer_stack_fwd_train) saved: every layer's bf16 input stream and its
// bf16 sigma | tanh saves.
//
// Bound on the H100: per layer and row, the backward does about twice the
// forward's products (dg, dx over both taps, and five weight-gradient
// reductions over all B*T rows), 4.1 x 10^12 FLOP per flagship window;
// only the saves (2.1 GB written by the forward and read back here) grow
// with B*T besides that.  It is tensor-core work.  The TPU kernel walked a
// sequential grid (layers reversed, tiles descending), kept a ring of dz
// tiles in VMEM and accumulated the weight gradients in its output blocks
// from one grid step to the next.  Hopper blocks run in no order and share
// nothing, so each layer is a few launches instead (layers in reverse):
//   (a) bwd_dz_kernel, per 32-row tile: dg = dout @ res_w^T +
//       bf16(dskip) @ skip_w^T (the transposed products read the row-major
//       weights as wmma col_major fragments, no transposed copies),
//       ds = dg t s (1 - s), dt = dg s (1 - t^2), dz = bf16(ds | dt) into a
//       full (B*T, 2R) buffer (47 MB at the flagship window; it takes the
//       place of the TPU's dz ring), the dh partial bf16(dz @ aux_w^T)
//       added in f32 into dh, and per-tile column sums of ds | dt and dout
//       for the bias gradients;
//   (b) bwd_dx_kernel<K>, per 32-row tile: dx[t] = sum over m < K of
//       dz[t + m d] @ W_{K-1-m}^T, + dout[t] (the t + m d terms zero past
//       the window's end), rounded to bf16 into a ping-pong buffer, or into
//       dstream0 at layer 0; it stages K tiles of dz (192 KB of shared
//       memory at K = 3, R = 512, which bounds kernel_size 3 to R <= 512);
//   (c) wgrad_kernel, one per weight gradient: x^T dz[t + m d] for each
//       tap m < K, h^T dz, g^T bf16(dskip), g^T dout (g = bf16(sigma tanh)
//       recomputed from the saves).  Each block reduces one 64 x 128 output tile over a
//       chunk of rows into f32 partials; reduce_chunks_kernel then adds the
//       chunks (and the bias column sums of (a)) in a fixed order.
// No atomics: two runs give bitwise-equal gradients.  Matmuls use wmma bf16
// 16x16x16 tiles with f32 accumulation.
#include <algorithm>

#include "wn_common.cuh"

using namespace nvcuda;

#define BW_THREADS 256
#define BW_TM 32          // rows per block of the dz and dx passes
#define BW_ZC 128         // staged accumulator columns
#define WG_BM 64          // weight-gradient output tile: rows (M)
#define WG_BN 128         //                              columns (N)
#define WG_BK 64          // data rows staged per step
#define WG_TARGET_BLOCKS 528   // blocks one weight-gradient launch aims for

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_frag;

static size_t dz_smem_bytes(int R, int S) {
    return (size_t)BW_TM * (R + S + 2 * R) * sizeof(bf16)   // dout, dskip, dz
         + (size_t)BW_TM * BW_ZC * sizeof(float)             // accumulator stage
         + (size_t)2 * 2 * BW_ZC * sizeof(float);            // column sums
}

static size_t dx_smem_bytes(int K, int R) {
    return (size_t)K * BW_TM * 2 * R * sizeof(bf16)          // dz[t + m d]
         + (size_t)BW_TM * BW_ZC * sizeof(float);
}

// (a) dz, the dh partial and the bias column sums of one 32-row tile
__global__ void __launch_bounds__(BW_THREADS) bwd_dz_kernel(
    const bf16* __restrict__ dout,    // (rows, R) dx of the layer above
    const bf16* __restrict__ dsk,     // (rows, S) bf16(dskip)
    const bf16* __restrict__ st,      // (rows, 2R) sigma | tanh of this layer
    const bf16* __restrict__ res_w,   // (R, R)
    const bf16* __restrict__ skip_w,  // (R, S)
    const bf16* __restrict__ aux_wp,  // (A_pad, 2R), rows >= A are zero
    bf16* __restrict__ dz,            // (rows, 2R)
    float* __restrict__ dh,           // (rows, A), += bf16(dz @ aux_w^T)
    float* __restrict__ zb_part,      // (tiles, 2R) column sums of ds | dt
    float* __restrict__ rb_part,      // (tiles, R) column sums of dout
    int rows, int R, int S, int A, int A_pad) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int R2 = 2 * R;
    bf16* Do = (bf16*)smem;                    // (TM, R)
    bf16* Ds = Do + BW_TM * R;                 // (TM, S)
    bf16* Dz = Ds + BW_TM * S;                 // (TM, 2R)
    float* Zs = (float*)(Dz + BW_TM * R2);     // (TM, ZC)
    float* red = Zs + BW_TM * BW_ZC;           // (2 row groups, ds | dt, ZC)
    const int tile = blockIdx.x, row0 = tile * BW_TM;
    const int warp = threadIdx.x >> 5;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    // stage dout and dskip, 16-byte vectors, zeros past the last row
    const int vr = R / 8, vs = S / 8;
    for (int i = threadIdx.x; i < BW_TM * vr; i += BW_THREADS) {
        const int r = i / vr, v = i - r * vr, row = row0 + r;
        ((uint4*)(Do + (size_t)r * R))[v] =
            row < rows ? ((const uint4*)(dout + (size_t)row * R))[v] : zero;
    }
    for (int i = threadIdx.x; i < BW_TM * vs; i += BW_THREADS) {
        const int r = i / vs, v = i - r * vs, row = row0 + r;
        ((uint4*)(Ds + (size_t)r * S))[v] =
            row < rows ? ((const uint4*)(dsk + (size_t)row * S))[v] : zero;
    }
    __syncthreads();

    // res_b's gradient: column sums of dout
    for (int c = threadIdx.x; c < R; c += BW_THREADS) {
        float s = 0.f;
        for (int r = 0; r < BW_TM; ++r) s += bf2f(Do[(size_t)r * R + c]);
        rb_part[(size_t)tile * R + c] = s;
    }

    // dg = dout @ res_w^T + dskip @ skip_w^T, 128 channels per chunk; warp w
    // owns 16 of them
    for (int c = 0; c < R; c += BW_ZC) {
        const int col = c + 16 * warp;
        acc_frag acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
        for (int k = 0; k < R; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
            wmma::load_matrix_sync(bw, res_w + (size_t)col * R + k, R);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                wmma::load_matrix_sync(a, Do + (size_t)(16 * t) * R + k, R);
                wmma::mma_sync(acc[t], a, bw, acc[t]);
            }
        }
#pragma unroll 4
        for (int k = 0; k < S; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
            wmma::load_matrix_sync(bw, skip_w + (size_t)col * S + k, S);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                wmma::load_matrix_sync(a, Ds + (size_t)(16 * t) * S + k, S);
                wmma::mma_sync(acc[t], a, bw, acc[t]);
            }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(Zs + (size_t)(16 * t) * BW_ZC + 16 * warp,
                                    acc[t], BW_ZC, wmma::mem_row_major);
        __syncthreads();
        // thread = (channel j, row group rg): rows rg, rg + 2, ...
        const int j = threadIdx.x & (BW_ZC - 1), rg = threadIdx.x >> 7;
        const int cc = c + j;
        float ssum = 0.f, tsum = 0.f;
        for (int r = rg; r < BW_TM; r += 2) {
            const int row = row0 + r;
            float ds = 0.f, dt = 0.f;
            if (row < rows) {
                const float dg = Zs[r * BW_ZC + j];
                const float s = bf2f(st[(size_t)row * R2 + cc]);
                const float t = bf2f(st[(size_t)row * R2 + R + cc]);
                ds = dg * t * s * (1.f - s);
                dt = dg * s * (1.f - t * t);
                dz[(size_t)row * R2 + cc] = f2bf(ds);
                dz[(size_t)row * R2 + R + cc] = f2bf(dt);
            }
            Dz[(size_t)r * R2 + cc] = f2bf(ds);
            Dz[(size_t)r * R2 + R + cc] = f2bf(dt);
            ssum += ds;
            tsum += dt;
        }
        red[(2 * rg) * BW_ZC + j] = ssum;
        red[(2 * rg + 1) * BW_ZC + j] = tsum;
        __syncthreads();
        if (threadIdx.x < BW_ZC) {
            const int jj = threadIdx.x;
            zb_part[(size_t)tile * R2 + c + jj] = red[jj] + red[2 * BW_ZC + jj];
            zb_part[(size_t)tile * R2 + R + c + jj] =
                red[BW_ZC + jj] + red[3 * BW_ZC + jj];
        }
    }
    __syncthreads();

    // dh partial: bf16(dz @ aux_w^T), (TM, A_pad) in 16 x 16 tiles
    const int n_frag = 2 * (A_pad / 16);
    for (int f = warp; f < n_frag; f += BW_THREADS / 32) {
        const int t = f & 1, ac = f >> 1;
        acc_frag acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
        for (int k = 0; k < R2; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
            wmma::load_matrix_sync(bw, aux_wp + (size_t)(16 * ac) * R2 + k, R2);
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, Dz + (size_t)(16 * t) * R2 + k, R2);
            wmma::mma_sync(acc, a, bw, acc);
        }
        wmma::store_matrix_sync(Zs + (size_t)(16 * t) * BW_ZC + 16 * ac, acc,
                                BW_ZC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BW_TM * A; i += BW_THREADS) {
        const int r = i / A, a = i - r * A, row = row0 + r;
        if (row < rows) dh[(size_t)row * A + a] += bf_round(Zs[r * BW_ZC + a]);
    }
}

// (b) dx = sum over m < K of dz[t + m d] @ W_{K-1-m}^T, + dout[t], one
// 32-row tile
template <int K>
__global__ void __launch_bounds__(BW_THREADS) bwd_dx_kernel(
    const bf16* __restrict__ dz,      // (rows, 2R)
    const bf16* __restrict__ dout,    // (rows, R)
    const bf16* __restrict__ dil_w,   // (K, R, 2R): [K-1-m] taps x[t - m d]
    bf16* __restrict__ dx,            // (rows, R)
    int rows, int T, int R, int d) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int R2 = 2 * R;
    bf16* Zc = (bf16*)smem;                    // (K, TM, 2R) dz[t + m d]
    float* Zs = (float*)(Zc + K * BW_TM * R2); // (TM, ZC)
    const int row0 = blockIdx.x * BW_TM;
    const int warp = threadIdx.x >> 5;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    // rows are (b, t) flattened: dz[t + m d] lies m d rows on, inside the
    // same utterance while t + m d < T, and reads as zero past its end
    const int vec = R2 / 8;
    for (int i = threadIdx.x; i < BW_TM * vec; i += BW_THREADS) {
        const int r = i / vec, v = i - r * vec, row = row0 + r;
#pragma unroll
        for (int m = 0; m < K; ++m)
            ((uint4*)(Zc + ((size_t)m * BW_TM + r) * R2))[v] =
                (row < rows && row % T + m * d < T)
                    ? ((const uint4*)(dz + (size_t)(row + m * d) * R2))[v]
                    : zero;
    }
    __syncthreads();

    for (int c = 0; c < R; c += BW_ZC) {
        const int col = c + 16 * warp;
        acc_frag acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
        for (int k = 0; k < R2; k += 16) {
            // bw[m]: W_{K-1-m}^T, the transposed weight of tap x[t - m d]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[K];
#pragma unroll
            for (int m = 0; m < K; ++m)
                wmma::load_matrix_sync(
                    bw[m], dil_w + ((size_t)(K - 1 - m) * R + col) * R2 + k, R2);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                    wmma::load_matrix_sync(
                        a, Zc + ((size_t)m * BW_TM + 16 * t) * R2 + k, R2);
                    wmma::mma_sync(acc[t], a, bw[m], acc[t]);
                }
            }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(Zs + (size_t)(16 * t) * BW_ZC + 16 * warp,
                                    acc[t], BW_ZC, wmma::mem_row_major);
        __syncthreads();
        for (int i = threadIdx.x; i < BW_TM * BW_ZC; i += BW_THREADS) {
            const int r = i >> 7, j = i & (BW_ZC - 1), row = row0 + r;
            if (row < rows) {
                const size_t o = (size_t)row * R + c + j;
                dx[o] = f2bf(Zs[r * BW_ZC + j] + bf2f(dout[o]));
            }
        }
        __syncthreads();
    }
}

// (c) part[z][m][n] = sum over the rows of chunk z of A[row, m] * B[row, n].
// AKIND 0: A is a bf16 matrix (rows, lda), columns m < M.  AKIND 1: A is the
// gate output g = bf16(sigma * tanh) of the saves (rows, 2M).  B is a bf16
// (rows, N) matrix; with shift > 0 row r reads row r + shift, zero where
// (r mod T) + shift >= T.  part is (chunks, M_pad, N), M_pad = 64 * gridDim.y.
template <int AKIND>
__global__ void __launch_bounds__(BW_THREADS) wgrad_kernel(
    const bf16* __restrict__ A, int lda, int M,
    const bf16* __restrict__ Bm, int N,
    int rows, int T, int shift, int rpc, float* __restrict__ part) {
    __shared__ __align__(128) bf16 As[WG_BK * WG_BM];    // (BK rows, BM)
    __shared__ __align__(128) bf16 Bs[WG_BK * WG_BN];    // (BK rows, BN)
    const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WG_BM;
    const int M_pad = gridDim.y * WG_BM;
    const int r_begin = blockIdx.z * rpc, r_end = min(rows, r_begin + rpc);
    const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const bool a_vec = AKIND == 1 || (lda % 8 == 0 && m0 + WG_BM <= M);

    acc_frag acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int r0 = r_begin; r0 < r_end; r0 += WG_BK) {
        if (a_vec) {
            for (int i = threadIdx.x; i < WG_BK * WG_BM / 8; i += BW_THREADS) {
                const int r = i / (WG_BM / 8), v = i - r * (WG_BM / 8);
                const int row = r0 + r;
                uint4 val = zero;
                if (row < r_end) {
                    const bf16* src = A + (size_t)row * lda + m0 + 8 * v;
                    if (AKIND == 0) {
                        val = *(const uint4*)src;
                    } else {
                        const uint4 sv = *(const uint4*)src;
                        const uint4 tv = *(const uint4*)(src + M);
                        const bf16* sp = (const bf16*)&sv;
                        const bf16* tp = (const bf16*)&tv;
                        bf16* gp = (bf16*)&val;
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                            gp[e] = f2bf(bf2f(sp[e]) * bf2f(tp[e]));
                    }
                }
                *(uint4*)(As + r * WG_BM + 8 * v) = val;
            }
        } else {
            for (int i = threadIdx.x; i < WG_BK * WG_BM; i += BW_THREADS) {
                const int r = i / WG_BM, m = i - r * WG_BM, row = r0 + r;
                As[i] = (row < r_end && m0 + m < M)
                            ? A[(size_t)row * lda + m0 + m] : f2bf(0.f);
            }
        }
        for (int i = threadIdx.x; i < WG_BK * WG_BN / 8; i += BW_THREADS) {
            const int r = i / (WG_BN / 8), v = i - r * (WG_BN / 8);
            const int row = r0 + r;
            uint4 val = zero;
            if (row < r_end && (shift == 0 || row % T + shift < T))
                val = *(const uint4*)(Bm + (size_t)(row + shift) * N + n0 + 8 * v);
            *(uint4*)(Bs + r * WG_BN + 8 * v) = val;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < WG_BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + kk * WG_BM + wm * 32 + 16 * i, WG_BM);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], Bs + kk * WG_BN + wn * 32 + 16 * j, WG_BN);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* out = part + (size_t)blockIdx.z * M_pad * N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(
                out + (size_t)(m0 + wm * 32 + 16 * i) * N + n0 + wn * 32 + 16 * j,
                acc[i][j], N, wmma::mem_row_major);
}

// out[i] = sum over z of part[z * stride + i], i < n, in a fixed order:
// thread group g adds chunks g, g + 8, ..., then the 8 group sums in order
__global__ void __launch_bounds__(BW_THREADS) reduce_chunks_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n,
    size_t stride, int chunks) {
    __shared__ float red[BW_THREADS / 32][32];
    const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
    const size_t i = (size_t)blockIdx.x * 32 + lane;
    float s = 0.f;
    if (i < (size_t)n)
        for (int z = g; z < chunks; z += BW_THREADS / 32)
            s += part[(size_t)z * stride + i];
    red[g][lane] = s;
    __syncthreads();
    if (g == 0 && i < (size_t)n) {
        float t = red[0][lane];
        for (int k = 1; k < BW_THREADS / 32; ++k) t += red[k][lane];
        out[i] = t;
    }
}

struct WgPlan {
    int chunks, rpc;
};

// Row chunks of one weight-gradient launch: enough blocks to fill the card
// (a fixed target, so the summation order does not depend on the device)
static WgPlan wg_plan(int rows, int M, int N) {
    const int tiles = (N / WG_BN) * ((M + WG_BM - 1) / WG_BM);
    int chunks = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
    chunks = std::max(1, std::min(chunks, (rows + WG_BK - 1) / WG_BK));
    const int rpc = ((rows + chunks - 1) / chunks + WG_BK - 1) / WG_BK * WG_BK;
    return {(rows + rpc - 1) / rpc, rpc};
}

static size_t wg_part_floats(int rows, int M, int N) {
    const WgPlan p = wg_plan(rows, M, N);
    return (size_t)p.chunks * ((M + WG_BM - 1) / WG_BM * WG_BM) * N;
}

static size_t part_floats(int rows, int R, int S, int A) {
    size_t n = wg_part_floats(rows, R, 2 * R);
    n = std::max(n, wg_part_floats(rows, A, 2 * R));
    n = std::max(n, wg_part_floats(rows, R, S));
    n = std::max(n, wg_part_floats(rows, R, R));
    return (n + 63) / 64 * 64;
}

static int reduce_chunks(cudaStream_t cs, const float* part, float* out,
                         int n, size_t stride, int chunks) {
    reduce_chunks_kernel<<<(n + 31) / 32, BW_THREADS, 0, cs>>>(
        part, out, n, stride, chunks);
    return (int)cudaGetLastError();
}

// out (M, N) = A^T B over all rows (see wgrad_kernel)
static int wgrad(cudaStream_t cs, int akind, const bf16* A, int lda, int M,
                 const bf16* Bm, int N, int rows, int T, int shift,
                 float* part, float* out) {
    const WgPlan p = wg_plan(rows, M, N);
    const int M_pad = (M + WG_BM - 1) / WG_BM * WG_BM;
    const dim3 grid(N / WG_BN, M_pad / WG_BM, p.chunks);
    if (akind == 0)
        wgrad_kernel<0><<<grid, BW_THREADS, 0, cs>>>(A, lda, M, Bm, N, rows, T,
                                                     shift, p.rpc, part);
    else
        wgrad_kernel<1><<<grid, BW_THREADS, 0, cs>>>(A, lda, M, Bm, N, rows, T,
                                                     shift, p.rpc, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return reduce_chunks(cs, part, out, M * N, (size_t)M_pad * N, p.chunks);
}

// Floats of f32 workspace wn_layer_stack_bwd needs at this shape.
extern "C" long long wn_layer_stack_bwd_workspace(int B, int T, int R, int S,
                                                  int A) {
    const int rows = B * T;
    const size_t tiles = (rows + BW_TM - 1) / BW_TM;
    return (long long)(part_floats(rows, R, S, A) + tiles * 3 * R);
}

// The backward of wn_layer_stack_fwd_train.  Inputs: x0 (B, T, R) and
// streams (L-1, B, T, R) bf16, the layers' input streams; st (L, B, T, 2R)
// bf16; dsk (B, T, S) bf16(dskip); h (B, T, A) bf16; weights dil_w
// (L, K, R, 2R), aux_wp (L, A_pad, 2R) zero-padded, skip_w (L, R, S),
// res_w (L, R, R), all bf16; dilations, a host array of L ints; K the
// kernel size (2 or 3).  Outputs (f32 unless noted): ddil (L, K, R, 2R),
// daux (L, A, 2R), dskip_w
// (L, R, S), dres_w (L, R, R), dzb (L, 2R), dres_b (L, R), dstream0
// (B, T, R) bf16, and dh (B, T, A), which must hold zeros on entry.
// Scratch: dz (B, T, 2R) and dx_pp (2, B, T, R) bf16, ws f32 of
// wn_layer_stack_bwd_workspace floats.  Returns cudaGetLastError().
extern "C" int wn_layer_stack_bwd(
    const void* x0_v, const void* streams_v, const void* st_v,
    const void* dsk_v, const void* h_v, const void* dil_w_v,
    const void* aux_wp_v, const void* skip_w_v, const void* res_w_v,
    const void* dilations_v, void* ddil_v, void* daux_v, void* dskip_w_v,
    void* dres_w_v, void* dzb_v, void* dres_b_v, void* dstream0_v, void* dh_v,
    void* dz_v, void* dx_pp_v, void* ws_v, int L, int B, int T, int R, int S,
    int A, int A_pad, int K, void* stream) {
    const int* dilations = (const int*)dilations_v;
    cudaStream_t cs = (cudaStream_t)stream;
    const int rows = B * T, R2 = 2 * R;
    const size_t rs = (size_t)rows * R;
    if (K != 2 && K != 3) return (int)cudaErrorInvalidValue;
    const size_t dz_smem = dz_smem_bytes(R, S), dx_smem = dx_smem_bytes(K, R);
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dz_smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        K == 2 ? bwd_dx_kernel<2> : bwd_dx_kernel<3>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dx_smem);
    if (e != cudaSuccess) return (int)e;

    const bf16* x0 = (const bf16*)x0_v;
    const bf16* streams = (const bf16*)streams_v;
    const bf16* st = (const bf16*)st_v;
    const bf16* dsk = (const bf16*)dsk_v;
    const bf16* h = (const bf16*)h_v;
    bf16* dz = (bf16*)dz_v;
    const int tiles = (rows + BW_TM - 1) / BW_TM;
    float* part = (float*)ws_v;
    float* zb_part = part + part_floats(rows, R, S, A);
    float* rb_part = zb_part + (size_t)tiles * R2;
    bf16* pp[2] = {(bf16*)dx_pp_v, (bf16*)dx_pp_v + rs};

    // the top layer has no layer above: its dout is zero
    e = cudaMemsetAsync(pp[L % 2], 0, rs * sizeof(bf16), cs);
    if (e != cudaSuccess) return (int)e;
    for (int l = L - 1; l >= 0; --l) {
        const int d = dilations[l];
        const bf16* x = l == 0 ? x0 : streams + (size_t)(l - 1) * rs;
        const bf16* st_l = st + (size_t)l * 2 * rs;
        const bf16* dout = pp[(l + 1) % 2];
        bf16* dxo = l == 0 ? (bf16*)dstream0_v : pp[l % 2];
        bwd_dz_kernel<<<tiles, BW_THREADS, dz_smem, cs>>>(
            dout, dsk, st_l, (const bf16*)res_w_v + (size_t)l * R * R,
            (const bf16*)skip_w_v + (size_t)l * R * S,
            (const bf16*)aux_wp_v + (size_t)l * A_pad * R2, dz, (float*)dh_v,
            zb_part, rb_part, rows, R, S, A, A_pad);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const bf16* dil_w = (const bf16*)dil_w_v + (size_t)l * K * R * R2;
        if (K == 2)
            bwd_dx_kernel<2><<<tiles, BW_THREADS, dx_smem, cs>>>(
                dz, dout, dil_w, dxo, rows, T, R, d);
        else
            bwd_dx_kernel<3><<<tiles, BW_THREADS, dx_smem, cs>>>(
                dz, dout, dil_w, dxo, rows, T, R, d);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;

        float* ddil = (float*)ddil_v + (size_t)l * K * R * R2;
        int err;
        for (int m = 0; m < K; ++m)   // tap x[t - m d]: x^T dz[t + m d]
            if ((err = wgrad(cs, 0, x, R, R, dz, R2, rows, T, m * d, part,
                             ddil + (size_t)(K - 1 - m) * R * R2)))
                return err;
        if ((err = wgrad(cs, 0, h, A, A, dz, R2, rows, T, 0, part,
                         (float*)daux_v + (size_t)l * A * R2)))
            return err;
        if ((err = wgrad(cs, 1, st_l, R2, R, dsk, S, rows, T, 0, part,
                         (float*)dskip_w_v + (size_t)l * R * S)))
            return err;
        if ((err = wgrad(cs, 1, st_l, R2, R, dout, R, rows, T, 0, part,
                         (float*)dres_w_v + (size_t)l * R * R)))
            return err;
        if ((err = reduce_chunks(cs, zb_part, (float*)dzb_v + (size_t)l * R2,
                                 R2, R2, tiles)))
            return err;
        if ((err = reduce_chunks(cs, rb_part, (float*)dres_b_v + (size_t)l * R,
                                 R, R, tiles)))
            return err;
    }
    return (int)cudaGetLastError();
}
