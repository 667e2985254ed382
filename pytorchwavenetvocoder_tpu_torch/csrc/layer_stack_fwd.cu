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
// Bound on the H100: per layer a (B*T, kR + A) x (kR + A, 2R) plus a
// (B*T, R) x (R, R) bf16 product (and in training a (B*T, R) x (R, S) skip
// product); at the warm-up's ~10^5 rows and the training windows' ~2 x
// 10^4 this is tensor-core work.  The bf16 streams, and in training the
// (B*T, 2R) bf16 saves, are the only device-memory traffic that grows with
// B*T.
//
// Design: two products per layer on the wgmma + TMA core of wn_wgmma.cuh
// (persistent blocks over 128-row output tiles: the gate's 256 columns
// wide, one block an SM; the 1x1s' 128 wide, two blocks an SM, so that one
// block's epilogue runs beside the other's products), g going through
// device memory between them:
//   (1) the gate: A = [x[t] | x[t-d] | (x[t-2d]) | h[t]], each row tile
//       loaded by TMA at row coordinate t0 - m d of a 3-D (utterance, t,
//       channel) map, whose zero fill outside [0, T) is the causal padding
//       (no row crosses into the previous utterance); the aux rows zero-
//       padded to 64 by the map.  B: the gate weights packed per call
//       (ops/train_kernel.py::pack_gate_weights), K-major, with the columns
//       interleaved in groups of 8 so that each thread's accumulators hold
//       the sigmoid and the tanh pre-activations of the same channels: the
//       epilogue adds the bias, gates in f32 and writes bf16 g (and in
//       training the bf16 sigma | tanh saves) from registers;
//   (2) out = bf16(g @ W_res + b_res + x) and, in training, the skip 1x1
//       into the f32 skip sum as extra output columns of the same product
//       (B: [W_res^T ; W_skip^T], packed per call): the block that owns an
//       element reads, adds and writes it, no atomics.  The last layer of a
//       training stack runs the skip columns only.
// g's round trip through device memory costs 2 x rows x R x 2 bytes a
// layer (201 MB, ~60 us, at the warm-up chunk of 32 x 3,070 rows).  The
// TPU kernel's ring of tiles, packed int32 pairs and tile cadence were
// Mosaic constraints and are not carried over.
#include "wn_wgmma.cuh"

// (1) the gate product of one layer
template <bool TRAIN>
struct FwdGate {
    static constexpr int A_MN = 0, B_MN = 0, BN = 256, BLOCKS = 1;
    CUtensorMap xmap;    // this layer's input stream, (planes, T, R), rows 128
    CUtensorMap hmap;    // aux (B, T, A64), rows 128
    CUtensorMap wmap;    // packed gate weights (layers, 2G, K*R + A64), rows 128
    const float* zb;     // (2G) dil_b + aux_b
    bf16* g;             // (B, T, G)
    bf16* st;            // (B, T, 2R) this layer's sigma | tanh (training)
    int B, T, R, A64, K, d, l, plane0, ntt, nN;
    int G;               // the gate's half width (the mu-law model's: R)

    __device__ int items() const { return B * ntt * nN; }
    __device__ int ksteps(int) const { return (K * R + A64) / WG_BK; }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int kk = ks * WG_BK;
        if (kk < K * R) {                 // tap m: x[t - m d]
            const int m = kk / R;
            tma_load_3d(sa, &xmap, bar, kk - m * R, t0 - m * d, plane0 + b);
        } else {
            tma_load_3d(sa, &hmap, bar, kk - K * R, t0, b);
        }
        tma_load_3d(sb, &wmap, bar, kk, nt * BN, l);
    }

    struct Pre {};
    __device__ void prefetch(int, WgFrag, Pre&) const {}

    // columns 16 i .. 16 i + 7 of the item are the sigmoid pre-activations
    // of channels nt*BN/2 + 8 i + (0..7), columns 16 i + 8 .. 16 i + 15
    // their tanh ones
    __device__ void epilogue(int it, const float (&acc)[BN / 2], WgFrag f, int,
                             unsigned char*, const Pre&) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
#pragma unroll
        for (int i = 0; i < BN / 16; ++i) {
            const int c = nt * (BN / 2) + 8 * i + f.col;
            const float bs0 = zb[c], bs1 = zb[c + 1];
            const float bt0 = zb[G + c], bt1 = zb[G + c + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int t = t0 + f.row + 8 * h;
                if (t >= T) continue;
                const size_t row = (size_t)b * T + t;
                const float s0 = acc[8 * i + 2 * h] + bs0;
                const float s1 = acc[8 * i + 2 * h + 1] + bs1;
                const float u0 = acc[8 * i + 4 + 2 * h] + bt0;
                const float u1 = acc[8 * i + 4 + 2 * h + 1] + bt1;
                if constexpr (TRAIN) {
                    const float sg0 = wn_sigmoid(s0), sg1 = wn_sigmoid(s1);
                    const float th0 = tanhf(u0), th1 = tanhf(u1);
                    *(uint32_t*)(g + row * R + c) = bf2_bits(sg0 * th0, sg1 * th1);
                    bf16* sr = st + row * 2 * R;
                    *(uint32_t*)(sr + c) = bf2_bits(sg0, sg1);
                    *(uint32_t*)(sr + R + c) = bf2_bits(th0, th1);
                } else {
                    *(uint32_t*)(g + row * G + c) =
                        bf2_bits(wn_gate(s0, u0), wn_gate(s1, u1));
                }
            }
        }
    }
};

// (2) the residual 1x1 (columns [0, R)) and the skip 1x1 (columns
// [R, R + S)) on g, over output columns [n_lo, n_lo + 128 nN); the output
// stream bf16((g W_res + b_res + x) rscale) where rscale is not 1 (the
// MoL model's sqrt(0.5))
struct FwdOut {
    static constexpr int A_MN = 0, B_MN = 0, BN = 128, BLOCKS = 2;
    CUtensorMap gmap;      // g (B, T, G), rows 128
    CUtensorMap wmap;      // packed (layers, R + S, G): W_res^T then W_skip^T
    const bf16* x;         // this layer's input stream (B, T, R)
    bf16* out;             // its output stream (B, T, R)
    const float* res_b;    // (R)
    float* skip;           // (B, T, S) f32 skip sum (training)
    const float* skip_b;   // (S)
    int B, T, R, S, l, ntt, n_lo, nN, first;
    int G;                 // the product's K: the gate's half width
    float rscale;

    __device__ int items() const { return B * ntt * nN; }
    __device__ int ksteps(int) const { return G / WG_BK; }

    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        tma_load_3d(sa, &gmap, bar, ks * WG_BK, t0, b);
        tma_load_3d(sb, &wmap, bar, ks * WG_BK, n_lo + nt * BN, l);
    }

    struct Pre {};
    __device__ void prefetch(int, WgFrag, Pre&) const {}

    __device__ void epilogue(int it, const float (&acc)[64], WgFrag f, int,
                             unsigned char*, const Pre&) const {
        const int rt = it / nN, nt = it - rt * nN;
        const int b = rt / ntt, t0 = (rt - b * ntt) * WG_BM;
        const int n0 = n_lo + nt * BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int n = n0 + 8 * j + f.col;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int t = t0 + f.row + 8 * h;
                if (t >= T) continue;
                const size_t row = (size_t)b * T + t;
                const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
                if (n0 < R) {
                    const float2 xv = bits_bf2(*(const uint32_t*)(x + row * R + n));
                    float v0 = a0 + res_b[n] + xv.x, v1 = a1 + res_b[n + 1] + xv.y;
                    if (rscale != 1.f) {
                        v0 *= rscale;
                        v1 *= rscale;
                    }
                    *(uint32_t*)(out + row * R + n) = bf2_bits(v0, v1);
                } else {
                    const int sc = n - R;
                    float2* dst = (float2*)(skip + row * S + sc);
                    float2 v = make_float2(a0 + skip_b[sc], a1 + skip_b[sc + 1]);
                    if (!first) {
                        const float2 o = *dst;
                        v = make_float2(o.x + v.x, o.y + v.y);
                    }
                    *dst = v;
                }
            }
        }
    }
};

struct FwdMaps {
    CUtensorMap x0, xs, h, wg, g, wo;
};

// the maps of one call: x0 (B, T, R), streams (n_str, B, T, R), h (B, T,
// A64), the packed weights of n_w layers, g (B, T, G)
static int fwd_maps(FwdMaps& m, const void* x0, const void* streams, int n_str,
                    const void* h, const void* wgate, const void* wout, int n_w,
                    int n_out, const void* g, int B, int T, int R, int A64, int K,
                    int G) {
    int e;
    if ((e = wg_map(&m.x0, x0, R, T, B, WG_BM))) return e;
    if (n_str > 0 && (e = wg_map(&m.xs, streams, R, T, (long long)n_str * B, WG_BM)))
        return e;
    if ((e = wg_map(&m.h, h, A64, T, B, WG_BM))) return e;
    if ((e = wg_map(&m.wg, wgate, (long long)K * R + A64, 2 * G, n_w,
                    FwdGate<true>::BN)))
        return e;
    if ((e = wg_map(&m.g, g, G, T, B, WG_BM))) return e;
    return wg_map(&m.wo, wout, G, n_out, n_w, FwdOut::BN);
}

template <bool TRAIN>
static FwdGate<TRAIN> gate_problem(const FwdMaps& m, int l, int d, const void* zb,
                                   void* g, void* st, int B, int T, int R, int A64,
                                   int K, int G) {
    FwdGate<TRAIN> p;
    p.xmap = l == 0 ? m.x0 : m.xs;
    p.hmap = m.h;
    p.wmap = m.wg;
    p.zb = (const float*)zb + (size_t)l * 2 * G;
    p.g = (bf16*)g;
    p.st = (bf16*)st;
    p.B = B; p.T = T; p.R = R; p.A64 = A64; p.K = K; p.d = d; p.l = l;
    p.G = G;
    p.plane0 = l == 0 ? 0 : (l - 1) * B;
    p.ntt = (T + WG_BM - 1) / WG_BM;
    p.nN = 2 * G / p.BN;
    return p;
}

static int check_fwd_shape(int B, int T, int R, int A64, int K) {
    if ((K != 2 && K != 3) || B < 1 || T < 1 || R % FwdOut::BN != 0 || A64 < WG_BK
        || A64 % WG_BK != 0)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// The streams-only forward: layers 0 .. n_run-1 on `stream`.  Layer l reads
// stream l (x0 for l = 0, else streams[l-1]) and writes streams[l];
// streams is (n_run, B, T, R) bf16.  h: (B, T, A64) bf16, zero past n_aux;
// wgate: (n_run, 2G, K*R + A64) and wres: (n_run, R, G) bf16, packed by
// ops/train_kernel.py, G the gate's half width (R, or a multiple of 128);
// zb (n_run, 2G) and res_b (n_run, R) f32; g: (B, T, G) bf16 scratch;
// dilations: a host array of n_run ints; rscale the output streams' scale
// (1, or the MoL model's sqrt(0.5)).  Returns cudaGetLastError() (0 =
// success).
extern "C" int wn_layer_stack_fwd(
    const void* x0, void* streams, const void* h, const void* wgate,
    const void* wres, const void* zb, const void* res_b, void* g,
    const void* dilations_v, int n_run, int B, int T, int R, int G, int A64, int K,
    float rscale, void* stream) {
    const int* dil = (const int*)dilations_v;
    cudaStream_t cs = (cudaStream_t)stream;
    int e;
    if ((e = check_fwd_shape(B, T, R, A64, K))) return e;
    if (G < FwdGate<false>::BN / 2 || G % (FwdGate<false>::BN / 2) != 0)
        return (int)cudaErrorInvalidValue;
    if (n_run < 1) return 0;
    FwdMaps m;
    if ((e = fwd_maps(m, x0, streams, n_run, h, wgate, wres, n_run, R, g, B, T, R,
                      A64, K, G)))
        return e;
    const size_t ss = (size_t)B * T * R;
    const int ntt = (T + WG_BM - 1) / WG_BM;
    for (int l = 0; l < n_run; ++l) {
        const FwdGate<false> pg = gate_problem<false>(m, l, dil[l], zb, g, nullptr,
                                                      B, T, R, A64, K, G);
        if ((e = wg_launch(pg, pg.B * pg.ntt * pg.nN, cs))) return e;
        FwdOut po;
        po.gmap = m.g;
        po.wmap = m.wo;
        po.x = l == 0 ? (const bf16*)x0 : (const bf16*)streams + (l - 1) * ss;
        po.out = (bf16*)streams + l * ss;
        po.res_b = (const float*)res_b + (size_t)l * R;
        po.skip = nullptr;
        po.skip_b = nullptr;
        po.B = B; po.T = T; po.R = R; po.S = 0; po.l = l; po.ntt = ntt;
        po.n_lo = 0; po.nN = R / po.BN; po.first = 0;
        po.G = G; po.rscale = rscale;
        if ((e = wg_launch(po, B * ntt * po.nN, cs))) return e;
    }
    return (int)cudaGetLastError();
}

// The training forward: all L layers.  Layer l reads stream l (x0 for
// l = 0, else streams[l-1]), writes streams[l] for l < L-1 (streams is
// (L-1, B, T, R)), its sigma | tanh saves into st[l] (st is (L, B, T, 2R)),
// and adds its skip 1x1 into skip_sum (B, T, S) f32.  wout: (L, R + S, R)
// packed [W_res^T ; W_skip^T]; skip_b (L, S) f32; the rest as
// wn_layer_stack_fwd.
extern "C" int wn_layer_stack_fwd_train(
    const void* x0, void* streams, void* st, void* skip_sum, const void* h,
    const void* wgate, const void* wout, const void* zb, const void* res_b,
    const void* skip_b, void* g, const void* dilations_v, int L, int B, int T,
    int R, int S, int A64, int K, void* stream) {
    const int* dil = (const int*)dilations_v;
    cudaStream_t cs = (cudaStream_t)stream;
    int e;
    if ((e = check_fwd_shape(B, T, R, A64, K))) return e;
    if (L < 1 || S < FwdOut::BN || S % FwdOut::BN != 0)
        return (int)cudaErrorInvalidValue;
    FwdMaps m;
    if ((e = fwd_maps(m, x0, streams, L - 1, h, wgate, wout, L, R + S, g, B, T, R,
                      A64, K, R)))
        return e;
    const size_t ss = (size_t)B * T * R;
    const int ntt = (T + WG_BM - 1) / WG_BM;
    for (int l = 0; l < L; ++l) {
        const FwdGate<true> pg = gate_problem<true>(
            m, l, dil[l], zb, g, (bf16*)st + (size_t)l * 2 * ss, B, T, R, A64, K, R);
        if ((e = wg_launch(pg, pg.B * pg.ntt * pg.nN, cs))) return e;
        FwdOut po;
        po.gmap = m.g;
        po.wmap = m.wo;
        po.x = l == 0 ? (const bf16*)x0 : (const bf16*)streams + (l - 1) * ss;
        po.out = l < L - 1 ? (bf16*)streams + l * ss : nullptr;
        po.res_b = (const float*)res_b + (size_t)l * R;
        po.skip = (float*)skip_sum;
        po.skip_b = (const float*)skip_b + (size_t)l * S;
        po.B = B; po.T = T; po.R = R; po.S = S; po.l = l; po.ntt = ntt;
        // the last layer's output stream feeds nothing: its skip columns only
        po.n_lo = l < L - 1 ? 0 : R;
        po.nN = ((l < L - 1 ? R : 0) + S) / po.BN;
        po.first = l == 0;
        po.G = R; po.rscale = 1.f;
        if ((e = wg_launch(po, B * ntt * po.nN, cs))) return e;
    }
    return (int)cudaGetLastError();
}
