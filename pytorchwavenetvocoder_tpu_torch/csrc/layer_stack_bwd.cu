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
// forward's products (dg, dx over the taps, and five weight-gradient
// reductions over all B*T rows), ~4 x 10^12 FLOP per flagship window;
// besides that only the saves (written by the forward, read back here)
// grow with B*T.  It is tensor-core work.  The TPU kernel walked a
// sequential grid (layers reversed, tiles descending), kept a ring of dz
// tiles in VMEM and accumulated the weight gradients in its output blocks
// from one grid step to the next.  Hopper blocks run in no order and share
// nothing, so each layer (in reverse) is a few launches of the wgmma + TMA
// product core of wn_wgmma.cuh (128 x 128 output tiles; two blocks an SM,
// but one for (a), whose epilogue's registers do not fit two):
//   (a) dg = [dout | bf16(dskip)] @ [W_res^T ; W_skip^T] (the row-major
//       weights are K-major B operands as they lie); its epilogue reads the
//       saves, forms ds = dg t s (1 - s), dt = dg s (1 - t^2), writes
//       dz = bf16(ds | dt) and g = bf16(s t), and sums ds | dt over its
//       128 rows (warp shuffles, then the 8 warps in a fixed order) into
//       per-tile partials of the bias gradient; the top layer has no dout;
//   (b) the dh partial bf16(dz @ aux_w^T), added in f32 into dh, in
//       128-column tiles of n_aux (the weights' rows past n_aux read as
//       zeros from the map);
//   (c) dx = sum over m < K of dz[t + m d] @ W_{K-1-m}^T + dout: the taps
//       loaded by TMA at row coordinate t0 + m d, zeros past the window's
//       end from the map's fill; rounded to bf16 into a ping-pong buffer,
//       or into dstream0 at layer 0;
//   (d) the weight gradients, K = the data rows: x^T [dz[t + m d]]_m (all
//       taps as one product, N = K 2R), h^T dz, g^T [bf16(dskip) | dout];
//       the transposed operands read through wgmma's MN-major layout from
//       the row-major (t, channel) tiles.  The rows are split into chunks
//       (ops/train_kernel.py::wgrad_plan: a fixed count of items, so the
//       summation order does not depend on the device), each writing an
//       f32 partial; reduce_chunks_kernel adds the chunks, and the bias
//       partials, in a fixed order; colsum_kernel gives res_b's partials.
// No atomics: two runs give bitwise-equal gradients.
#include "wn_wgmma.cuh"

#define BW_THREADS 256

// (a) dg, dz, g and the bias partials of one layer
struct BwdDG {
    // one block per SM: its epilogue's registers do not fit two
    static constexpr int A_MN = 0, B_MN = 0, BN = 128, BLOCKS = 1;
    CUtensorMap dout_map;   // the ping-pong dx buffers (2B, T, R), rows 128
    CUtensorMap dsk_map;    // bf16(dskip) (B, T, S), rows 128
    CUtensorMap resw_map;   // res_w (L, R, R), rows 128
    CUtensorMap skipw_map;  // skip_w (L, R, S), rows 128
    const bf16* st;         // this layer's saves (B, T, 2R)
    bf16* dz;               // (B, T, 2R)
    bf16* g;                // (B, T, R)
    float* zb_part;         // (row tiles, 2R)
    int B, T, R, S, l, ntt, nN, dout_plane0, top;

    __device__ int items() const { return B * ntt * nN; }
    __device__ int ksteps(int) const { return ((top ? 0 : R) + S) / WG_BK; }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int kk = ks * WG_BK + (top ? R : 0);
        if (kk < R) {
            tma_load_3d(sa, &dout_map, bar, kk, t0, dout_plane0 + b);
            tma_load_3d(sb, &resw_map, bar, kk, nt * BN, l);
        } else {
            tma_load_3d(sa, &dsk_map, bar, kk - R, t0, b);
            tma_load_3d(sb, &skipw_map, bar, kk - R, nt * BN, l);
        }
    }

    // the saves of the thread's rows and columns: sigma, tanh pairs
    struct Pre {
        __nv_bfloat162 s[16][2], t[16][2];
    };
    __device__ void prefetch(int it, WgFrag f, Pre& pre) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = nt * BN + 8 * j + f.col;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int t = min(t0 + f.row + 8 * h, T - 1);   // rows past T: unused
                const bf16* sr = st + ((size_t)b * T + t) * 2 * R;
                pre.s[j][h] = *(const __nv_bfloat162*)(sr + c);
                pre.t[j][h] = *(const __nv_bfloat162*)(sr + R + c);
            }
        }
    }

    __device__ void epilogue(int it, const float (&acc)[64], WgFrag f, int tid,
                             unsigned char* scratch, const Pre& pre) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int lane = tid & 31, warp = tid >> 5;
        float* red = (float*)scratch;          // (ds | dt, 8 warps, 128 columns)
        const int q = lane & 3;
        size_t row[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = t0 + f.row + 8 * h;
            row[h] = (size_t)b * T + (t < T ? t : 0);
        }
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
            uint32_t dsw[2][4], dtw[2][4], gw[2][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = 4 * jb + u;
                float sum[4] = {0.f, 0.f, 0.f, 0.f};   // ds c, ds c+1, dt c, dt c+1
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const bool valid = t0 + f.row + 8 * h < T;
                    const float2 s = bits_bf2(*(const uint32_t*)&pre.s[j][h]);
                    const float2 v = bits_bf2(*(const uint32_t*)&pre.t[j][h]);
                    const float sg[2] = {s.x, s.y}, th[2] = {v.x, v.y};
                    float ds[2], dt[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float dg = acc[4 * j + 2 * h + e];
                        ds[e] = valid ? dg * th[e] * sg[e] * (1.f - sg[e]) : 0.f;
                        dt[e] = valid ? dg * sg[e] * (1.f - th[e] * th[e]) : 0.f;
                        sum[e] += ds[e];
                        sum[2 + e] += dt[e];
                    }
                    dsw[h][u] = bf2_bits(ds[0], ds[1]);
                    dtw[h][u] = bf2_bits(dt[0], dt[1]);
                    gw[h][u] = bf2_bits(sg[0] * th[0], sg[1] * th[1]);
                }
                // the warp's 16 rows: lanes of equal lane % 4 hold one column
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 4);
                    sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 8);
                    sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], 16);
                }
                if (lane < 4) {
                    const int col = 8 * j + f.col;
                    red[warp * BN + col] = sum[0];
                    red[warp * BN + col + 1] = sum[1];
                    red[(8 + warp) * BN + col] = sum[2];
                    red[(8 + warp) * BN + col + 1] = sum[3];
                }
            }
            // dz and g by 8-column groups
            const int c8 = nt * BN + 8 * (4 * jb + q);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                quad_transpose(dsw[h]);
                quad_transpose(dtw[h]);
                quad_transpose(gw[h]);
                if (t0 + f.row + 8 * h < T) {
                    bf16* dzr = dz + row[h] * 2 * R;
                    *(uint4*)(dzr + c8) = make_uint4(dsw[h][0], dsw[h][1], dsw[h][2], dsw[h][3]);
                    *(uint4*)(dzr + R + c8) =
                        make_uint4(dtw[h][0], dtw[h][1], dtw[h][2], dtw[h][3]);
                    *(uint4*)(g + row[h] * R + c8) =
                        make_uint4(gw[h][0], gw[h][1], gw[h][2], gw[h][3]);
                }
            }
        }
        consumers_sync();
        {   // thread: (ds or dt, column); the 8 warps in order
            const int which = tid >> 7, col = tid & 127;
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < 8; ++w) s += red[(8 * which + w) * BN + col];
            zb_part[(size_t)rt * 2 * R + which * R + nt * BN + col] = s;
        }
        consumers_sync();
    }
};

// (b) dh += bf16(dz @ aux_w^T): an item is a 128-row tile x one of the
// nA = ceil(n_aux / 128) 128-column tiles of dh (the column tile fastest)
struct BwdDH {
    static constexpr int A_MN = 0, B_MN = 0, BN = 128, BLOCKS = 2;
    CUtensorMap dz_map;     // (B, T, 2R), rows 128
    CUtensorMap auxw_map;   // aux_w (L, A, 2R), rows 128
    float* dh;              // (B, T, A)
    int B, T, R, A, l, ntt, nA;

    __device__ int items() const { return B * ntt * nA; }
    __device__ int ksteps(int) const { return 2 * R / WG_BK; }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int rt = it / nA, at = it - rt * nA;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        tma_load_3d(sa, &dz_map, bar, ks * WG_BK, t0, b);
        tma_load_3d(sb, &auxw_map, bar, ks * WG_BK, at * BN, l);
    }

    struct Pre {};
    __device__ void prefetch(int, WgFrag, Pre&) const {}

    __device__ void epilogue(int it, const float (&acc)[64], WgFrag f, int,
                             unsigned char*, const Pre&) const {
        const int rt = it / nA, at = it - rt * nA;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int n = at * BN + 8 * j + f.col + (q & 1);
                const int t = t0 + f.row + 8 * (q >> 1);
                if (n < A && t < T) dh[((size_t)b * T + t) * A + n] += bf_round(acc[4 * j + q]);
            }
    }
};

// (c) dx = sum over m < K of dz[t + m d] @ W_{K-1-m}^T + dout
struct BwdDX {
    static constexpr int A_MN = 0, B_MN = 0, BN = 128, BLOCKS = 2;
    CUtensorMap dz_map;     // (B, T, 2R), rows 128
    CUtensorMap dil_map;    // dil_w (L*K, R, 2R), rows 128
    const bf16* dout;       // (B, T, R)
    bf16* dx;               // (B, T, R)
    int B, T, R, K, d, l, ntt, nN;

    __device__ int items() const { return B * ntt * nN; }
    __device__ int ksteps(int) const { return K * 2 * R / WG_BK; }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int kk = ks * WG_BK, m = kk / (2 * R), c = kk - m * 2 * R;
        tma_load_3d(sa, &dz_map, bar, c, t0 + m * d, b);
        tma_load_3d(sb, &dil_map, bar, c, nt * BN, l * K + (K - 1 - m));
    }

    struct Pre {};
    __device__ void prefetch(int, WgFrag, Pre&) const {}

    __device__ void epilogue(int it, const float (&acc)[64], WgFrag f, int,
                             unsigned char*, const Pre&) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int q = threadIdx.x & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = t0 + f.row + 8 * h;
            const size_t row = (size_t)b * T + (t < T ? t : 0);
#pragma unroll
            for (int jb = 0; jb < BN / 32; ++jb) {
                // dout by 8-column groups, turned to the lanes' pairs and back
                const size_t o = row * R + nt * BN + 8 * (4 * jb + q);
                uint4 d4 = make_uint4(0u, 0u, 0u, 0u);
                if (t < T) d4 = *(const uint4*)(dout + o);
                uint32_t v[4] = {d4.x, d4.y, d4.z, d4.w};
                quad_transpose(v);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int j = 4 * jb + u;
                    const float2 dv = bits_bf2(v[u]);
                    v[u] = bf2_bits(acc[4 * j + 2 * h] + dv.x, acc[4 * j + 2 * h + 1] + dv.y);
                }
                quad_transpose(v);
                if (t < T) *(uint4*)(dx + o) = make_uint4(v[0], v[1], v[2], v[3]);
            }
        }
    }
};

// (d) part[z] (+ offsets) = A^T B over the row blocks of chunk z; A and B
// are (t, channel) tiles read MN-major.  KIND 0: x^T [dz[t + m d]]_m, N =
// K 2R, part (K, R, 2R); 1: h^T dz, M = n_aux in ceil(n_aux / 128) row
// tiles (h's columns past A64 read as zeros), part (A, 2R); 2: g^T
// [bf16(dskip) | dout], N = S + R, part (R, S) then (R, R).
enum { WG_X = 0, WG_H = 1, WG_G = 2 };

template <int KIND>
struct Wgrad {
    static constexpr int A_MN = 1, B_MN = 1, BN = 128, BLOCKS = 2;
    CUtensorMap a_map;      // x, h or g, rows 64
    CUtensorMap b_map;      // dz, or bf16(dskip) for KIND 2, rows 64
    CUtensorMap b2_map;     // KIND 2: the ping-pong dout buffers, rows 64
    float* part;
    long long zstride;      // floats per chunk
    int B, T, R, S, A, K, d, a_plane0, b2_plane0, ntb, nM, nN, chunks, rbpc;

    __device__ int items() const { return chunks * nM * nN; }
    __device__ int ksteps(int it) const {
        const int z = it / (nM * nN), start = z * rbpc, total = B * ntb;
        return min(rbpc, total - start);
    }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int z = it / (nM * nN), r = it - z * nM * nN;
        const int mt = r / nN, nt = r - mt * nN;
        const int rb = z * rbpc + ks, b = rb / ntb, t0 = (rb - b * ntb) * 64;
        const int m0 = mt * WG_BM, n0 = nt * BN;
        tma_load_3d(sa, &a_map, bar, m0, t0, a_plane0 + b);
        tma_load_3d(sa + WG_A_BYTES / 2, &a_map, bar, m0 + 64, t0, a_plane0 + b);
        // B: BN / 64 boxes of 64 rows x 64 columns, 8 KB apart
        const CUtensorMap* bm = &b_map;
        int c = n0, t = t0, plane = b;
        if (KIND == WG_X) {
            const int j = n0 / (2 * R);
            c = n0 - j * 2 * R;
            t = t0 + (K - 1 - j) * d;
        } else if (KIND == WG_G && n0 >= S) {
            bm = &b2_map;
            c = n0 - S;
            plane = b2_plane0 + b;
        }
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
            tma_load_3d(sb + q * (WG_A_BYTES / 2), bm, bar, c + 64 * q, t, plane);
    }

    struct Pre {};
    __device__ void prefetch(int, WgFrag, Pre&) const {}

    __device__ void epilogue(int it, const float (&acc)[BN / 2], WgFrag f, int,
                             unsigned char*, const Pre&) const {
        const int z = it / (nM * nN), r = it - z * nM * nN;
        const int mt = r / nN, nt = r - mt * nN;
        float* out = part + (size_t)z * zstride;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int n = nt * BN + 8 * j + f.col;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = mt * WG_BM + f.row + 8 * h;
                size_t o;
                if (KIND == WG_X) {
                    const int jt = n / (2 * R);
                    o = ((size_t)jt * R + m) * 2 * R + (n - jt * 2 * R);
                } else if (KIND == WG_H) {
                    if (m >= A) continue;
                    o = (size_t)m * 2 * R + n;
                } else {
                    o = n < S ? (size_t)m * S + n
                              : (size_t)R * S + (size_t)m * R + (n - S);
                }
                *(float2*)(out + o) = make_float2(acc[4 * j + 2 * h],
                                                  acc[4 * j + 2 * h + 1]);
            }
        }
    }
};

// One reduction: out[i] = sum over z < chunks of part[z * stride + i],
// i < n, in a fixed order (the same on every device and in every run): the
// chunks are cut into 8 contiguous groups of ceil(chunks / 8), each group
// summed in chunk order, then the 8 group sums in group order.
struct RedSeg {
    const float* part;
    float* out;
    long long stride;
    int n, chunks, block0;   // block0: its first block in the launch
};

// every reduction of a layer in one launch (at most 6)
struct RedArgs {
    RedSeg seg[6];
    int nseg;
};

// A block: 8 groups x 32 lanes, a lane 4 outputs, so 128 outputs a block
__global__ void __launch_bounds__(BW_THREADS) reduce_chunks_kernel(
    const __grid_constant__ RedArgs ra) {
    __shared__ float4 red[8][32];
    int k = 0;
    while (k + 1 < ra.nseg && (int)blockIdx.x >= ra.seg[k + 1].block0) ++k;
    const RedSeg& g = ra.seg[k];
    const float* part = g.part;
    const size_t stride = (size_t)g.stride, n = (size_t)g.n;
    const int chunks = g.chunks;
    const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
    const size_t i = ((size_t)(blockIdx.x - g.block0) * 32 + lane) * 4;
    const int per = (chunks + 7) / 8;
    const int z0 = grp * per, z1 = min(chunks, z0 + per);
    const bool vec = stride % 4 == 0 && ((uintptr_t)part & 15) == 0;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
        if (vec && i + 4 <= n) {
#pragma unroll 4
            for (int z = z0; z < z1; ++z) {
                const float4 v = *(const float4*)(part + (size_t)z * stride + i);
                s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
            }
        } else {
            float* sp = &s.x;
            for (int e = 0; e < 4 && i + e < n; ++e)
                for (int z = z0; z < z1; ++z) sp[e] += part[(size_t)z * stride + i + e];
        }
    }
    red[grp][lane] = s;
    __syncthreads();
    if (grp == 0 && i < n) {
        float4 t = red[0][lane];
        for (int q = 1; q < 8; ++q) {
            const float4 v = red[q][lane];
            t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
        }
        const float* tp = &t.x;
        for (int e = 0; e < 4 && i + e < n; ++e) g.out[i + e] = tp[e];
    }
}

// part[tile][c] = sum of x[row][c] over the rows of 128-row tile `tile`
// (tiles of each utterance, rows past T excluded), in row order
__global__ void __launch_bounds__(128) colsum_kernel(
    const bf16* __restrict__ x, float* __restrict__ part, int T, int C, int ntt) {
    const int tile = blockIdx.x, c = blockIdx.y * 128 + threadIdx.x;
    const int b = tile / ntt, t0 = (tile - b * ntt) * WG_BM;
    const int t1 = min(T, t0 + WG_BM);
    float s = 0.f;
    for (int t = t0; t < t1; ++t) s += bf2f(x[((size_t)b * T + t) * C + c]);
    part[(size_t)tile * C + c] = s;
}

// adds one reduction to a layer's launch
static void add_reduction(RedArgs& ra, int& blocks, const float* part, float* out,
                          int n, size_t stride, int chunks) {
    RedSeg& g = ra.seg[ra.nseg++];
    g.part = part; g.out = out; g.stride = (long long)stride; g.n = n;
    g.chunks = chunks; g.block0 = blocks;
    blocks += (n + 127) / 128;
}

static bool plan_ok(int chunks, int rbpc, int total) {
    return chunks >= 1 && rbpc >= 1 && (long long)(chunks - 1) * rbpc < total
        && (long long)chunks * rbpc >= total;
}

// The backward of wn_layer_stack_fwd_train.  Inputs: x0 (B, T, R) and
// streams (L-1, B, T, R) bf16, the layers' input streams; st (L, B, T, 2R)
// bf16; dsk (B, T, S) bf16(dskip); h (B, T, A64) bf16, zero past n_aux;
// weights dil_w (L, K, R, 2R), aux_w (L, A, 2R), skip_w (L, R, S), res_w
// (L, R, R), all bf16 as they lie; dilations, a host array of L ints; K
// the kernel size (2 or 3); plan: 6 host ints, (chunks, row blocks per
// chunk) of the x, h and g weight-gradient products
// (ops/train_kernel.py::wgrad_plan).  Outputs (f32 unless noted): ddil
// (L, K, R, 2R), daux (L, A, 2R), dskip_w (L, R, S), dres_w (L, R, R), dzb
// (L, 2R), dres_b (L, R), dstream0 (B, T, R) bf16, and dh (B, T, A), which
// must hold zeros on entry.  Scratch: dz (B, T, 2R), g (B, T, R) and dx_pp
// (2, B, T, R) bf16; part (f32: chunks x M x N of each of the three
// products, side by side), zb_part (row tiles, 2R) and rb_part (row tiles,
// R) f32.
// Returns cudaGetLastError().
extern "C" int wn_layer_stack_bwd(
    const void* x0_v, const void* streams_v, const void* st_v,
    const void* dsk_v, const void* h_v, const void* dil_w_v,
    const void* aux_w_v, const void* skip_w_v, const void* res_w_v,
    const void* dilations_v, const void* plan_v, void* ddil_v, void* daux_v,
    void* dskip_w_v, void* dres_w_v, void* dzb_v, void* dres_b_v,
    void* dstream0_v, void* dh_v, void* dz_v, void* g_v, void* dx_pp_v,
    void* part_v, void* zb_part_v, void* rb_part_v, int L, int B, int T, int R,
    int S, int A, int A64, int K, void* stream) {
    const int* dilations = (const int*)dilations_v;
    const int* plan = (const int*)plan_v;
    cudaStream_t cs = (cudaStream_t)stream;
    if ((K != 2 && K != 3) || L < 1 || B < 1 || T < 1 || R % 128 != 0
        || S % 128 != 0 || S < 128 || A < 1 || A64 < A || A64 % WG_BK != 0)
        return (int)cudaErrorInvalidValue;
    const int ntt = (T + WG_BM - 1) / WG_BM, ntb = (T + 63) / 64;
    const int n_rt = B * ntt, R2 = 2 * R;
    for (int i = 0; i < 3; ++i)
        if (!plan_ok(plan[2 * i], plan[2 * i + 1], B * ntb))
            return (int)cudaErrorInvalidValue;
    const size_t rs = (size_t)B * T * R;
    bf16* pp = (bf16*)dx_pp_v;

    // every operand's tensor map: row products read 128-row tiles (K-major),
    // the weight gradients 64-row tiles (MN-major)
    CUtensorMap x0_w, xs_w, h_w, dz_r, dz_w, pp_r, pp_w, dsk_r, dsk_w, g_w;
    CUtensorMap resw, skipw, auxw, dil;
    int e;
    if ((e = wg_map(&x0_w, x0_v, R, T, B, 64))) return e;
    if (L > 1 && (e = wg_map(&xs_w, streams_v, R, T, (long long)(L - 1) * B, 64)))
        return e;
    if ((e = wg_map(&h_w, h_v, A64, T, B, 64))) return e;
    if ((e = wg_map(&dz_r, dz_v, R2, T, B, WG_BM))) return e;
    if ((e = wg_map(&dz_w, dz_v, R2, T, B, 64))) return e;
    if ((e = wg_map(&pp_r, dx_pp_v, R, T, 2 * B, WG_BM))) return e;
    if ((e = wg_map(&pp_w, dx_pp_v, R, T, 2 * B, 64))) return e;
    if ((e = wg_map(&dsk_r, dsk_v, S, T, B, WG_BM))) return e;
    if ((e = wg_map(&dsk_w, dsk_v, S, T, B, 64))) return e;
    if ((e = wg_map(&g_w, g_v, R, T, B, 64))) return e;
    if ((e = wg_map(&resw, res_w_v, R, R, L, BwdDG::BN))) return e;
    if ((e = wg_map(&skipw, skip_w_v, S, R, L, BwdDG::BN))) return e;
    if ((e = wg_map(&auxw, aux_w_v, R2, A, L, BwdDH::BN))) return e;
    if ((e = wg_map(&dil, dil_w_v, R2, R, (long long)L * K, BwdDX::BN))) return e;

    // the three weight gradients' partials, side by side
    float* part_x = (float*)part_v;
    float* part_h = part_x + (size_t)plan[0] * K * R * R2;
    float* part_g = part_h + (size_t)plan[2] * A * R2;
    float* zb_part = (float*)zb_part_v;
    float* rb_part = (float*)rb_part_v;
    // the top layer has no layer above: its dout is zero
    if (cudaMemsetAsync(pp + (size_t)(L % 2) * rs, 0, rs * sizeof(bf16), cs) != cudaSuccess)
        return (int)cudaGetLastError();
    for (int l = L - 1; l >= 0; --l) {
        const int d = dilations[l], in = (l + 1) % 2;
        const bf16* dout = pp + (size_t)in * rs;
        bf16* dxo = l == 0 ? (bf16*)dstream0_v : pp + (size_t)(l % 2) * rs;

        BwdDG pg;
        pg.dout_map = pp_r; pg.dsk_map = dsk_r; pg.resw_map = resw; pg.skipw_map = skipw;
        pg.st = (const bf16*)st_v + (size_t)l * 2 * rs;
        pg.dz = (bf16*)dz_v; pg.g = (bf16*)g_v; pg.zb_part = zb_part;
        pg.B = B; pg.T = T; pg.R = R; pg.S = S; pg.l = l; pg.ntt = ntt;
        pg.nN = R / pg.BN; pg.dout_plane0 = in * B; pg.top = l == L - 1;
        if ((e = wg_launch(pg, n_rt * pg.nN, cs))) return e;
        colsum_kernel<<<dim3(n_rt, R / 128), 128, 0, cs>>>(dout, rb_part, T, R, ntt);
        if ((e = (int)cudaGetLastError())) return e;

        // (b) and (c): dx and the dh partial, one launch
        WgBoth<BwdDX, BwdDH> pxh;
        BwdDX& px = pxh.p1;
        px.dz_map = dz_r; px.dil_map = dil; px.dout = dout; px.dx = dxo;
        px.B = B; px.T = T; px.R = R; px.K = K; px.d = d; px.l = l; px.ntt = ntt;
        px.nN = R / px.BN;
        BwdDH& ph = pxh.p2;
        ph.dz_map = dz_r; ph.auxw_map = auxw; ph.dh = (float*)dh_v;
        ph.B = B; ph.T = T; ph.R = R; ph.A = A; ph.l = l; ph.ntt = ntt;
        ph.nA = (A + ph.BN - 1) / ph.BN;
        pxh.n1 = n_rt * px.nN;
        if ((e = wg_launch(pxh, pxh.n1 + n_rt * ph.nA, cs))) return e;

        // (d): the three weight gradients, one launch, each into its own
        // partials
        WgBoth<Wgrad<WG_X>, WgBoth<Wgrad<WG_H>, Wgrad<WG_G>>> pw;
        Wgrad<WG_X>& wx = pw.p1;
        Wgrad<WG_H>& wh = pw.p2.p1;
        Wgrad<WG_G>& wgg = pw.p2.p2;
        wx.a_map = l == 0 ? x0_w : xs_w; wx.b_map = dz_w; wx.b2_map = dz_w;
        wx.part = part_x; wx.zstride = (long long)K * R * R2;
        wx.B = B; wx.T = T; wx.R = R; wx.S = S; wx.A = A; wx.K = K; wx.d = d;
        wx.a_plane0 = l == 0 ? 0 : (l - 1) * B; wx.b2_plane0 = 0; wx.ntb = ntb;
        wx.nM = R / WG_BM; wx.nN = K * R2 / wx.BN; wx.chunks = plan[0]; wx.rbpc = plan[1];
        wh.a_map = h_w; wh.b_map = dz_w; wh.b2_map = dz_w;
        wh.part = part_h; wh.zstride = (long long)A * R2;
        wh.B = B; wh.T = T; wh.R = R; wh.S = S; wh.A = A; wh.K = K; wh.d = 0;
        wh.a_plane0 = 0; wh.b2_plane0 = 0; wh.ntb = ntb;
        wh.nM = (A + WG_BM - 1) / WG_BM; wh.nN = R2 / wh.BN; wh.chunks = plan[2];
        wh.rbpc = plan[3];
        wgg.a_map = g_w; wgg.b_map = dsk_w; wgg.b2_map = pp_w;
        wgg.part = part_g; wgg.zstride = (long long)R * (S + R);
        wgg.B = B; wgg.T = T; wgg.R = R; wgg.S = S; wgg.A = A; wgg.K = K; wgg.d = 0;
        wgg.a_plane0 = 0; wgg.b2_plane0 = in * B; wgg.ntb = ntb;
        wgg.nM = R / WG_BM; wgg.nN = (S + R) / wgg.BN; wgg.chunks = plan[4];
        wgg.rbpc = plan[5];
        pw.n1 = wx.chunks * wx.nM * wx.nN;
        pw.p2.n1 = wh.chunks * wh.nM * wh.nN;
        if ((e = wg_launch(pw, pw.n1 + pw.p2.n1 + wgg.chunks * wgg.nM * wgg.nN, cs)))
            return e;

        // every reduction of the layer, one launch: the weight gradients'
        // chunks and the bias gradients' per-tile partials
        RedArgs ra;
        ra.nseg = 0;
        int blocks = 0;
        add_reduction(ra, blocks, part_x, (float*)ddil_v + (size_t)l * K * R * R2,
                      K * R * R2, (size_t)wx.zstride, wx.chunks);
        add_reduction(ra, blocks, part_h, (float*)daux_v + (size_t)l * A * R2, A * R2,
                      (size_t)wh.zstride, wh.chunks);
        add_reduction(ra, blocks, part_g, (float*)dskip_w_v + (size_t)l * R * S, R * S,
                      (size_t)wgg.zstride, wgg.chunks);
        add_reduction(ra, blocks, part_g + (size_t)R * S,
                      (float*)dres_w_v + (size_t)l * R * R, R * R,
                      (size_t)wgg.zstride, wgg.chunks);
        add_reduction(ra, blocks, zb_part, (float*)dzb_v + (size_t)l * R2, R2, R2, n_rt);
        add_reduction(ra, blocks, rb_part, (float*)dres_b_v + (size_t)l * R, R, R, n_rt);
        reduce_chunks_kernel<<<blocks, BW_THREADS, 0, cs>>>(ra);
        if ((e = (int)cudaGetLastError())) return e;
    }
    return (int)cudaGetLastError();
}
