// The serial matmul-chain probe for Hopper: one persistent cooperative
// kernel runs every step and every layer of the chain.
//
// Replaces scripts/matmul_chain_probe.py::main's Pallas kernel (the inner
// `kernel`, pallas_call at :194); the plain PyTorch version is
// ops/matmul_chain.py::matmul_chain_reference, whose docstring gives the
// seven variants' math.  Widths are the script's: L = 30, R = 512, S = 256.
//
// What bounds it on the H100.  Each layer is two dependent products on a
// (B, R) carry, so a step is 60 serial stages.  The TPU kernel kept every
// weight resident in VMEM; here they cannot stay on chip (86.5 MB bf16,
// 43.6 MB int8 against 132 SMs x 227 KB of shared memory and a 50 MB L2),
// so every stage streams its layer's weights from L2/HBM: the step's
// bytes over 3.35 TB/s (25.8 us for split's 86.5 MB) are its floor at
// small B.  The operations (86.5 MFLOP x B per step for split) bound it
// only at large B.  Between the stages sits a grid-wide barrier, and that
// barrier is the term this probe exists to expose: the one-kernel floor
// of the AR loop (csrc/ar_persistent.cu, one cooperative launch per call,
// 63 grid barriers a step).
//
// Design:
//  - one launch with cudaLaunchCooperativeKernel, one block per SM (checked
//    against cudaOccupancyMaxActiveBlocksPerMultiprocessor: a grid that
//    cannot be co-resident is refused, there is no fallback; a second block
//    per SM, where shared memory allows it, makes the barriers dearer);
//    cooperative_groups::this_grid().sync() between dependent products:
//    two per layer, 60 per step;
//  - each product is cut into units (row group of at most 64 rows, column
//    group; int8's first product: the same columns in each of its four
//    R-wide quarters, so the gate, the tanh half and both sink halves of a
//    channel meet in one unit), one per block where the grid allows.  A unit
//    takes all of K, so it needs no other block's sums: no split-K partials,
//    counters or second barrier.  Its 8 warps split the unit's column tiles
//    and K instead, with wmma bf16 16x16x16 and f32 sums (s8 and int32 for
//    int8), four independent sums per warp (one per row tile, or per
//    interleaved K tile where the unit has one row tile: a single chain of
//    dependent products stalls on each); the sums meet in shared memory in
//    a fixed order, so two runs are bitwise equal;
//  - every operand lies in memory as whole 16 x 16 tiles, in the order a
//    unit reads it: the wrapper packs each unit's weight slice into one
//    contiguous run (ops/matmul_chain.py::pack_chain_weights), and the
//    epilogues write the A operands tiled, so a unit's A rows are one run
//    too.  One thread moves each run into shared memory with one bulk copy
//    (cp.async.bulk, completing on an mbarrier): per-thread 16-byte copies
//    took longer to issue than the stage's products, and held up their
//    shared-memory loads behind them.  Tiles also keep wmma's operands
//    32-byte aligned (an int8 row at an odd tile column is only 16-byte
//    aligned);
//  - the weights do not depend on the data: during each stage a block asks
//    for its weight slice of the next stage into a second buffer, so the
//    weight stream from HBM overlaps the stage and the barrier, and a stage
//    waits only for its A rows (L2) and its products;
//  - every column the script counts is computed, the dead ones too (split's
//    z[:, R:2R], every variant's sr[:, :S], int8raw's z[:, R:2R]): their
//    sums go to a dead-column scratch, so the TFLOP/s means the script's
//    work;
//  - B is padded to 16-row tiles (dual: each half separately); pad rows are
//    zeros and stay zeros through every variant.  On Hopper dual's two
//    halves are rows of one product per stage: there is no matrix-unit
//    pipeline to drain between them.
//
// Where trouble lies, and what is done about it:
//  (1) rounding: jnp.round is half-to-even (rintf), astype(int32) from a
//      float truncates (__float2int_rz), shift_right_arithmetic is a signed
//      >>, bf16 casts round to nearest even (__float2bfloat16);
//  (2) FMA contraction: int8's z * wsc, sr * wsc + out, out * 25.4 and
//      out + 1e-20 sink use __fmul_rn/__fadd_rn, which nvcc never fuses;
//  (3) the bf16 chains leave bf16's range after tens of steps: values are
//      checked at a few steps, long runs are timed only;
//  (4) grid co-residency and barrier cost: see the launch above; the bulk
//      copies read (async proxy) what other blocks wrote (generic proxy)
//      before the barrier, so the writers fence the proxies before it.
#include <cooperative_groups.h>
#include <algorithm>
#include <stdint.h>

#include "wn_common.cuh"
#include "wn_hopper.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

#define MC_L 30
#define MC_R 512
#define MC_S 256
#define MC_THREADS 256
#define MC_WARPS (MC_THREADS / 32)
#define MC_ACC 4           // independent sums per warp
#define MC_ROWS (16 * MC_ACC)   // rows of a unit at most
#define MC_B_MAX 256

// MC_SYNC runs the launch and the 60 barriers per step with no product: the
// barrier chain's own cost
enum { MC_SPLIT, MC_MERGED, MC_SPINE, MC_FULL, MC_DUAL, MC_INT8, MC_INT8RAW,
       MC_SYNC, MC_NVARIANTS };

struct McArgs {
    const bf16* x0;        // (B, R)
    const void* w[2];      // each product's weights, packed per unit
    const float* wsc;      // int8: (L, 4R + S + R) column scales
    bf16* y;               // (B, R)
    // workspace; a1 and a2 as 16 x 16 tiles ([Mp/16][K/16][16][16])
    void* a1;              // (Mp, R) first product's A: bf16 out, int8 xq/x8
    void* a2;              // (Mp, K2) second product's A: bf16 g / bf16(z), int8
    void* st;              // int8: (Mp, R) f32 out; int8raw: int32 out
    void* sink;            // int8: f32, int8raw: int32 (Mp, R)
    void* dead;            // (Mp, R + S) dead-column sums (f32 / int32)
    int B, Mp, Mh, n_steps;
    // per product: K, N, column groups, columns of a group (per quarter),
    // row groups, the warps' K split
    int K[2], N[2], groups[2], cw[2], rg[2], ks[2];
    // shared memory: two weight buffers, the A rows, the warps' sums
    int smem_w[2], smem_a, smem_p;
    // phase times (null: off): per block, MC_PHASES nanosecond sums, see
    // wn_matmul_chain
    unsigned long long* phase;
};

#define MC_PHASES 8

template <int V> struct McTypes {
    typedef bf16 T;
    typedef float Acc;
};
template <> struct McTypes<MC_INT8> {
    typedef signed char T;
    typedef int Acc;
};
template <> struct McTypes<MC_INT8RAW> {
    typedef signed char T;
    typedef int Acc;
};

// quarters a unit spans: int8's first product couples the gate, tanh and
// both sink columns of a channel
template <int V, int P> struct McQ {
    static constexpr int value = (P == 0 && (V == MC_INT8 || V == MC_INT8RAW)) ? 4 : 1;
};

// the product shapes: K, N and the quarters Q a unit spans
static void product_shape(int V, int p, int* K, int* N, int* Q) {
    const int R = MC_R, S = MC_S;
    *Q = 1;
    if (p == 0) {
        *N = (V == MC_INT8 || V == MC_INT8RAW) ? 4 * R : 2 * R;
        *K = (V == MC_SPLIT || V == MC_MERGED) ? 2 * R : R;
        if (V == MC_INT8 || V == MC_INT8RAW) *Q = 4;
    } else {
        *N = (V == MC_FULL || V == MC_DUAL) ? R : S + R;
        *K = (V == MC_FULL || V == MC_DUAL) ? 2 * R : R;
    }
}

// element (m, k) of a tiled (rows, kw) operand
static __device__ __forceinline__ size_t tiled(int m, int k, int kw) {
    return ((size_t)(m >> 4) * (kw >> 4) + (k >> 4)) * 256 + (m & 15) * 16 + (k & 15);
}

// the real row of padded row m, or -1 for a pad row (dual: two halves, each
// padded to Mh rows)
static __device__ __forceinline__ int real_row(const McArgs& a, int m, bool dual) {
    if (!dual) return m < a.B ? m : -1;
    const int h = m >= a.Mh, r = m - h * a.Mh;
    const int b1 = a.B / 2, size = h ? a.B - b1 : b1;
    return r < size ? h * b1 + r : -1;
}

// round half to even, clip to +-127 (jnp.round + clip + astype(int8))
static __device__ __forceinline__ signed char q8(float v) {
    return (signed char)max(-127, min(127, __float2int_rn(v)));
}

static __device__ __forceinline__ signed char clip8(int v) {
    return (signed char)max(-127, min(127, v));
}

// wrapping int32 add (JAX's int32 arithmetic wraps; signed overflow is
// undefined in C++)
static __device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// Per block: three mbarriers (the two weight buffers, the A rows) and the
// parity each waits on next.
struct McBars {
    uint64_t* bar;         // [w0, w1, a]
    unsigned parity[3];
};

// ---- the carry from x0 ------------------------------------------------------
template <int V>
static __device__ void init_stage(const McArgs& a) {
    const int R = MC_R;
    const int total = a.Mp * R;
    for (int i = blockIdx.x * MC_THREADS + threadIdx.x; i < total;
         i += gridDim.x * MC_THREADS) {
        const int m = i / R, j = i - m * R;
        const int row = real_row(a, m, V == MC_DUAL);
        const bf16 x = row >= 0 ? a.x0[(size_t)row * R + j] : f2bf(0.f);
        const size_t t = tiled(m, j, R);
        if (V == MC_INT8) {
            const float o = bf2f(x);
            ((float*)a.st)[i] = o;
            ((signed char*)a.a1)[t] = q8(__fmul_rn(o, 25.4f));
        } else if (V == MC_INT8RAW) {
            const int o = __float2int_rz(bf2f(x));
            ((int*)a.st)[i] = o;
            ((signed char*)a.a1)[t] = clip8(o);
        } else {
            ((bf16*)a.a1)[t] = x;
        }
    }
}

// ---- the epilogues: one reduced element of a product ----------------------
// first product of split / merged / spine / full / dual at (m, c)
template <int V>
static __device__ __forceinline__ void epi1_bf16(const McArgs& a, int m, int c,
                                                 float z) {
    const int R = MC_R, S = MC_S;
    if (V == MC_FULL || V == MC_DUAL) {
        ((bf16*)a.a2)[tiled(m, c, 2 * R)] = f2bf(z);
    } else if (c < R) {
        ((bf16*)a.a2)[tiled(m, c, R)] = f2bf(z);             // g
    } else {
        ((float*)a.dead)[(size_t)m * (R + S) + c - R] = z;   // dead z[:, R:]
    }
}

// second product of the bf16 variants at (m, c): out = bf16(sr) + out
template <int V>
static __device__ __forceinline__ void epi2_bf16(const McArgs& a, int m, int c,
                                                 float sr, bool final_) {
    const int R = MC_R, S = MC_S;
    const int j = (V == MC_FULL || V == MC_DUAL) ? c : c - S;
    if (j < 0) {                                             // dead sr[:, :S]
        ((float*)a.dead)[(size_t)m * (R + S) + R + c] = sr;
        return;
    }
    bf16* out = (bf16*)a.a1 + tiled(m, j, R);
    const bf16 o = f2bf(__fadd_rn(bf_round(sr), bf2f(__ldcg(out))));
    *out = o;
    if (final_) {
        const int row = real_row(a, m, V == MC_DUAL);
        if (row >= 0) a.y[(size_t)row * R + j] = o;
    }
}

// int8's first product at (m, j): z of the four quarters
static __device__ __forceinline__ void epi1_int8(const McArgs& a, int l, int m,
                                                 int j, const int z[4]) {
    const int R = MC_R, S = MC_S;
    const float* sc = a.wsc + (size_t)l * (4 * R + S + R);
    float zf[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) zf[q] = __fmul_rn((float)z[q], __ldg(sc + q * R + j));
    const float gate = __fmul_rn(wn_sigmoid(zf[0]), tanhf(zf[1]));
    ((signed char*)a.a2)[tiled(m, j, R)] = q8(__fmul_rn(gate, 127.f));
    float* sk = (float*)a.sink + (size_t)m * R + j;
    const float prev = l == 0 ? 0.f : __ldcg(sk);
    *sk = __fadd_rn(__fadd_rn(prev, zf[2]), zf[3]);
}

// int8raw's first product at (m, j)
static __device__ __forceinline__ void epi1_int8raw(const McArgs& a, int l, int m,
                                                    int j, const int z[4]) {
    const int R = MC_R, S = MC_S;
    ((signed char*)a.a2)[tiled(m, j, R)] = clip8(z[0] >> 9);
    ((int*)a.dead)[(size_t)m * (R + S) + j] = z[1];          // dead z[:, R:2R]
    int* sk = (int*)a.sink + (size_t)m * R + j;
    const int prev = l == 0 ? 0 : __ldcg(sk);
    *sk = wadd(wadd(prev, z[2]), z[3]);
}

// int8's second product at (m, c)
static __device__ __forceinline__ void epi2_int8(const McArgs& a, int l, int m,
                                                 int c, int sr, bool last,
                                                 bool final_) {
    const int R = MC_R, S = MC_S;
    const float srf = __fmul_rn((float)sr,
                                __ldg(a.wsc + (size_t)l * (4 * R + S + R) + 4 * R + c));
    if (c < S) {
        ((float*)a.dead)[(size_t)m * (R + S) + R + c] = srf;
        return;
    }
    const int j = c - S;
    const size_t i = (size_t)m * R + j;
    float o = __fadd_rn(srf, __ldcg((float*)a.st + i));
    if (last) {   // the step's carry: bf16(out + 1e-20 sink), back to f32
        const bf16 acc = f2bf(__fadd_rn(o, __fmul_rn(1e-20f,
                                                     __ldcg((float*)a.sink + i))));
        o = bf2f(acc);
        if (final_ && m < a.B) a.y[(size_t)m * R + j] = acc;
    }
    ((float*)a.st)[i] = o;
    ((signed char*)a.a1)[tiled(m, j, R)] = q8(__fmul_rn(o, 25.4f));
}

// int8raw's second product at (m, c)
static __device__ __forceinline__ void epi2_int8raw(const McArgs& a, int m, int c,
                                                    int sr, bool last,
                                                    bool final_) {
    const int R = MC_R, S = MC_S;
    if (c < S) {
        ((int*)a.dead)[(size_t)m * (R + S) + R + c] = sr;
        return;
    }
    const int j = c - S;
    const size_t i = (size_t)m * R + j;
    int o = wadd(sr >> 9, __ldcg((int*)a.st + i));
    if (last) {   // the step's carry: bf16(out + (sink >> 30)), truncated back
        const bf16 acc = f2bf((float)wadd(o, __ldcg((int*)a.sink + i) >> 30));
        o = __float2int_rz(bf2f(acc));
        if (final_ && m < a.B) a.y[(size_t)m * R + j] = acc;
    }
    ((int*)a.st)[i] = o;
    ((signed char*)a.a1)[tiled(m, j, R)] = clip8(o);
}

// ---- the operands of a unit ------------------------------------------------
// Thread 0 asks for the weight slice of unit u of product P at layer l (all
// K rows, the unit's columns in each quarter: one packed run) into buffer b.
template <int V, int P>
static __device__ void fetch_w(const McArgs& a, unsigned char* smem, McBars& bars,
                               int b, int l, int u) {
    typedef typename McTypes<V>::T T;
    if (threadIdx.x != 0) return;
    const unsigned bytes = a.K[P] * McQ<V, P>::value * a.cw[P] * sizeof(T);
    const T* src = (const T*)a.w[P] + ((size_t)l * a.groups[P] + u % a.groups[P])
                                      * (bytes / sizeof(T));
    mbar_expect(bars.bar + b, bytes);
    bulk_copy(smem + a.smem_w[b], src, bytes, bars.bar + b);
}

// The weights of this block's first unit in the next stage (product np at
// layer nl; np < 0: none) into buffer cur ^ 1.
template <int V>
static __device__ void prefetch_next(const McArgs& a, unsigned char* smem,
                                     McBars& bars, int cur, int nl, int np) {
    if (np < 0 || (int)blockIdx.x >= a.rg[np] * a.groups[np]) return;
    if (np == 0) fetch_w<V, 0>(a, smem, bars, cur ^ 1, nl, blockIdx.x);
    else fetch_w<V, 1>(a, smem, bars, cur ^ 1, nl, blockIdx.x);
}

// ---- one product stage -------------------------------------------------------
// Unit u (row group, column group) takes all K: it needs no other block's
// sums.  The weight slice of a block's first unit was asked for during the
// previous stage (further units ask for theirs now); its A rows are one bulk
// copy; the 8 warps split K, their sums meet in shared memory in a fixed
// order, and the epilogue writes the next product's A and the carried
// state.  Right after asking for its A rows, the block asks for its first
// unit's weights of the next stage, so that stream overlaps this stage and
// the barrier.
template <int V, int P>
static __device__ void product_stage(const McArgs& a, McBars& bars, int step,
                                     int l, int cur, int nl, int np) {
    // the dynamic shared memory named here, not passed in: the compiler then
    // knows the operands are shared and loads them as such
    extern __shared__ __align__(128) unsigned char smem[];
    typedef typename McTypes<V>::T T;
    typedef typename McTypes<V>::Acc Acc;
    constexpr int TILE = 256, QC = McQ<V, P>::value;
    const int R = MC_R, K = a.K[P], cw = a.cw[P];
    const int G = a.groups[P], rows = a.Mp / a.rg[P], units = a.rg[P] * G;
    const int ntu = QC * (cw / 16), ktn = K / 16, mt = rows / 16;
    // the A operand: a1 (Mp, R) for the first product (split and merged
    // take [out | out], K = 2R: tile column kt mod R/16), a2 (Mp, K) for the
    // second
    const int kwa = P == 0 ? R : K, kta = kwa / 16;
    const int ks = a.ks[P], kts = ktn / ks;       // warps' K split
    const int cols = QC * cw;
    const bool last_layer = l == MC_L - 1;
    const bool final_ = last_layer && step == a.n_steps - 1;
    const T* As = (const T*)(smem + a.smem_a);
    Acc* Ps = (Acc*)(smem + a.smem_p);
    const int warp = threadIdx.x >> 5;
    // a block with no unit here still asks for its weights of the next stage
    if ((int)blockIdx.x >= units) prefetch_next<V>(a, smem, bars, cur, nl, np);
    unsigned long long t[4] = {0, 0, 0, 0};    // phase marks, first unit
    const bool timed = a.phase != nullptr && threadIdx.x == 0;
    if (timed) t[0] = now_ns();

    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int rgi = u / G, grp = u - rgi * G, r0 = rgi * rows;
        const T* Ws = (const T*)(smem + a.smem_w[cur]);
        __syncthreads();   // the previous unit's tiles and sums are consumed
        if (threadIdx.x == 0) {
            if (u != blockIdx.x) fetch_w<V, P>(a, smem, bars, cur, l, u);
            const unsigned bytes = rows * kwa * sizeof(T);
            const T* src = (const T*)(P == 0 ? a.a1 : a.a2) + (size_t)r0 * kwa;
            mbar_expect(bars.bar + 2, bytes);
            bulk_copy(smem + a.smem_a, src, bytes, bars.bar + 2);
            // the next stage's weights for this block's first unit there
            if (u == blockIdx.x) prefetch_next<V>(a, smem, bars, cur, nl, np);
        }
        if (timed && u == blockIdx.x) t[1] = now_ns();
        mbar_wait(bars.bar + 2, bars.parity[2]);
        bars.parity[2] ^= 1;
        mbar_wait(bars.bar + cur, bars.parity[cur]);
        bars.parity[cur] ^= 1;
        if (timed && u == blockIdx.x) t[2] = now_ns();

        // task = (16-column tile, K slice) over the unit's row tiles, with
        // MC_ACC independent sums per warp (a single dependent chain of
        // products stalls on each): one per row tile where the
        // unit has several (each weight fragment then serves them all), else
        // one per K phase, interleaved; the sums are added in a fixed order
        for (int task = warp; task < ntu * ks; task += MC_WARPS) {
            const int nt = task % ntu, ksi = task / ntu;
            const int kb = ksi * kts, ke = kb + kts;
            wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[MC_ACC];
#pragma unroll
            for (int h = 0; h < MC_ACC; ++h) wmma::fill_fragment(acc[h], (Acc)0);
            if (mt == 1) {
                for (int k0 = kb; k0 < ke; k0 += MC_ACC) {
#pragma unroll
                    for (int h = 0; h < MC_ACC; ++h) {
                        const int kt = k0 + h;
                        if (kt < ke) {
                            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bw;
                            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
                            wmma::load_matrix_sync(bw, Ws + ((size_t)kt * ntu + nt) * TILE, 16);
                            wmma::load_matrix_sync(fa, As + (size_t)(kt % kta) * TILE, 16);
                            wmma::mma_sync(acc[h], fa, bw, acc[h]);
                        }
                    }
                }
#pragma unroll
                for (int h = 1; h < MC_ACC; ++h)
#pragma unroll
                    for (int t = 0; t < acc[0].num_elements; ++t) acc[0].x[t] += acc[h].x[t];
            } else {
#pragma unroll 2
                for (int kt = kb; kt < ke; ++kt) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bw;
                    wmma::load_matrix_sync(bw, Ws + ((size_t)kt * ntu + nt) * TILE, 16);
#pragma unroll
                    for (int i = 0; i < MC_ACC; ++i) {
                        if (i < mt) {
                            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
                            wmma::load_matrix_sync(fa, As + ((size_t)i * kta + kt % kta) * TILE, 16);
                            wmma::mma_sync(acc[i], fa, bw, acc[i]);
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < MC_ACC; ++i)
                if (i < mt)
                    wmma::store_matrix_sync(Ps + ((size_t)ksi * rows + i * 16) * cols + nt * 16,
                                            acc[i], cols, wmma::mem_row_major);
        }
        __syncthreads();
        if (timed && u == blockIdx.x) t[3] = now_ns();

        // the K slices in slice order (split: wc's and wp's halves each, then
        // the two, as z = out @ wc + out @ wp), then the epilogue
        const int half = (V == MC_SPLIT && P == 0 && ks > 1) ? ks / 2 : ks;
        for (int e = threadIdx.x; e < rows * cw; e += MC_THREADS) {
            const int ml = e / cw, jj = e - ml * cw, m = r0 + ml;
            Acc v[QC];
#pragma unroll
            for (int q = 0; q < QC; ++q) {
                Acc s0 = 0, s1 = 0;
                for (int k = 0; k < ks; ++k) {
                    const Acc t = Ps[((size_t)k * rows + ml) * cols + q * cw + jj];
                    if (k < half) s0 = s0 + t;
                    else s1 = s1 + t;
                }
                v[q] = half < ks ? s0 + s1 : s0;
            }
            const int c = grp * cw + jj;
            if constexpr (QC == 4) {
                const int z[4] = {(int)v[0], (int)v[1], (int)v[2], (int)v[3]};
                if constexpr (V == MC_INT8) epi1_int8(a, l, m, c, z);
                else epi1_int8raw(a, l, m, c, z);
            } else if constexpr (V == MC_INT8) {
                epi2_int8(a, l, m, c, (int)v[0], last_layer, final_);
            } else if constexpr (V == MC_INT8RAW) {
                epi2_int8raw(a, m, c, (int)v[0], last_layer, final_);
            } else if constexpr (P == 0) {
                epi1_bf16<V>(a, m, c, (float)v[0]);
            } else {
                epi2_bf16<V>(a, m, c, (float)v[0], final_);
            }
        }
    }
    if (a.phase != nullptr && (int)blockIdx.x < units) {
        __syncthreads();   // every thread's epilogue
        if (timed) {
            unsigned long long* ph = a.phase + blockIdx.x * MC_PHASES;
            ph[0] += t[1] - t[0];        // asking for the operands
            ph[1] += t[2] - t[1];        // waiting for them
            ph[2] += t[3] - t[2];        // the products
            ph[3] += now_ns() - t[3];    // sums and epilogue
            ph[4] += 1;
        }
    }
    // the next stage's bulk copies read what this stage wrote
    fence_proxy_async();
}

// the grid barrier; with phase times on, thread 0 of each block adds its
// wait (its arrival to the last block's) to slot 5
static __device__ __forceinline__ void timed_sync(const McArgs& a, cg::grid_group& grid) {
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    grid.sync();
    if (a.phase != nullptr && threadIdx.x == 0) {
        a.phase[blockIdx.x * MC_PHASES + 5] += now_ns() - t0;
        a.phase[blockIdx.x * MC_PHASES + 6] += 1;
    }
}

template <int V>
__global__ void __launch_bounds__(MC_THREADS) matmul_chain_kernel(McArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar[3];
    cg::grid_group grid = cg::this_grid();
    McBars bars = {bar, {0u, 0u, 0u}};
    if constexpr (V != MC_SYNC) {
        if (threadIdx.x == 0) {
            for (int i = 0; i < 3; ++i) mbar_init(bar + i);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
        init_stage<V>(a);
        fence_proxy_async();
        if ((int)blockIdx.x < a.rg[0] * a.groups[0])
            fetch_w<V, 0>(a, smem, bars, 0, 0, blockIdx.x);
    }
    grid.sync();
    int cur = 0;
    for (int s = 0; s < a.n_steps; ++s) {
        for (int l = 0; l < MC_L; ++l) {
            // the stage after each: (l, 1), then (l + 1, 0) or the next step's
            // (0, 0), none after the last
            const bool last = s == a.n_steps - 1 && l == MC_L - 1;
            if constexpr (V != MC_SYNC)
                product_stage<V, 0>(a, bars, s, l, cur, l, 1);
            cur ^= 1;
            timed_sync(a, grid);
            if constexpr (V != MC_SYNC)
                product_stage<V, 1>(a, bars, s, l, cur,
                                    l == MC_L - 1 ? 0 : l + 1, last ? -1 : 0);
            cur ^= 1;
            timed_sync(a, grid);
        }
    }
}

// ---- host side -----------------------------------------------------------
static const void* kernel_fn(int V) {
    switch (V) {
    case MC_SPLIT: return (const void*)matmul_chain_kernel<MC_SPLIT>;
    case MC_MERGED: return (const void*)matmul_chain_kernel<MC_MERGED>;
    case MC_SPINE: return (const void*)matmul_chain_kernel<MC_SPINE>;
    case MC_FULL: return (const void*)matmul_chain_kernel<MC_FULL>;
    case MC_DUAL: return (const void*)matmul_chain_kernel<MC_DUAL>;
    case MC_INT8: return (const void*)matmul_chain_kernel<MC_INT8>;
    case MC_INT8RAW: return (const void*)matmul_chain_kernel<MC_INT8RAW>;
    default: return (const void*)matmul_chain_kernel<MC_SYNC>;
    }
}

static size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct McPlan {
    int grid, max_bps, smem, Mp, Mh;
    int K[2], N[2], Q[2], groups[2], cw[2], rg[2], ks[2];
    int smem_w[2], smem_a, smem_p;
    size_t a1, a2, st, sink, dead, total;
};

// Shared memory a unit may take: a weight slice (two are kept: this
// stage's and the next), the A rows, the warps' sums
#define MC_W_MAX (64 * 1024)
#define MC_A_MAX (64 * 1024)
#define MC_P_MAX (32 * 1024)

// How a product is cut into units (row group of <= MC_ROWS rows, column group of
// cw columns per quarter), each taking all of K: as many units as the grid
// holds (every unit streams its own weight slice), of those the widest
// column groups (each column group reads the A rows once).  Where no cut
// fits the grid, the fewest units: blocks then take several.
static bool cut_product(McPlan* p, int i, size_t esz) {
    const int K = p->K[i], N = p->N[i], Q = p->Q[i], Mp = p->Mp;
    const int kwa = i == 0 ? MC_R : K;           // columns of the A operand
    long best = -1;
    for (int cw = 64; cw >= 16; cw /= 2) {
        if (N % (Q * cw) || (size_t)K * Q * cw * esz > MC_W_MAX) continue;
        const int G = N / (Q * cw);
        for (int rg = 1; rg <= Mp / 16; ++rg) {    // any divisor of the tiles
            const int rows = Mp / rg;
            if ((Mp / 16) % rg || rows > MC_ROWS
                || (size_t)rows * kwa * esz > MC_A_MAX)
                continue;
            const long units = (long)rg * G;
            const bool better = best < 0
                || (units <= p->grid && (best > p->grid || units > best))
                || (units > p->grid && best > p->grid && units < best);
            if (!better) continue;
            // the warps split K so that every warp has a task
            int ks = 1;
            while (Q * (cw / 16) * ks * 2 <= MC_WARPS && (K / 16) % (ks * 2) == 0
                   && (size_t)ks * 2 * rows * Q * cw * 4 <= MC_P_MAX)
                ks *= 2;
            best = units;
            p->cw[i] = cw;
            p->groups[i] = G;
            p->rg[i] = rg;
            p->ks[i] = ks;
        }
    }
    return best > 0;
}

// 0, or -1 (not co-resident), -2 (no cooperative launch), -3 (bad B), or a
// CUDA error
static int make_plan(int V, int B, McPlan* p) {
    if (V < 0 || V >= MC_NVARIANTS || B < 1 || B > MC_B_MAX
        || (V == MC_DUAL && B < 2))
        return -3;
    int dev = 0, sms = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return -2;
    p->grid = sms;
    const bool dual = V == MC_DUAL;
    p->Mh = dual ? ((B - B / 2 + 15) / 16) * 16 : 0;
    p->Mp = dual ? 2 * p->Mh : ((B + 15) / 16) * 16;
    const size_t esz = (V == MC_INT8 || V == MC_INT8RAW) ? 1 : 2;
    size_t wmax = 0, amax = 0, pmax = 0;
    for (int i = 0; i < 2; ++i) {
        product_shape(V, i, &p->K[i], &p->N[i], &p->Q[i]);
        if (!cut_product(p, i, esz)) return -3;
        const size_t rows = p->Mp / p->rg[i], cols = (size_t)p->Q[i] * p->cw[i];
        wmax = std::max(wmax, (size_t)p->K[i] * cols * esz);
        amax = std::max(amax, rows * (i == 0 ? MC_R : p->K[i]) * esz);
        pmax = std::max(pmax, (size_t)p->ks[i] * rows * cols * 4);
    }
    p->smem_w[0] = 0;
    p->smem_w[1] = (int)align256(wmax);
    p->smem_a = 2 * (int)align256(wmax);
    p->smem_p = p->smem_a + (int)align256(amax);
    p->smem = p->smem_p + (int)align256(pmax);
    e = cudaFuncSetAttribute(kernel_fn(V), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p->smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->max_bps, kernel_fn(V),
                                                      MC_THREADS, p->smem);
    if (e != cudaSuccess) return (int)e;
    const size_t R = MC_R, S = MC_S, Mp = p->Mp;
    p->a1 = 0;
    p->a2 = p->a1 + align256(Mp * R * esz);
    p->st = p->a2 + align256(Mp * p->K[1] * esz);
    p->sink = p->st + align256(Mp * R * 4);
    p->dead = p->sink + align256(Mp * R * 4);
    p->total = p->dead + align256(Mp * (R + S) * 4);
    if (p->max_bps < 1) return -1;
    return 0;
}

extern "C" {

// info: workspace bytes, grid, max co-resident blocks per SM, shared memory
// bytes, padded rows, then per product: the warps' K split, column groups,
// columns per group, row groups
int wn_matmul_chain_plan(int variant, int B, long long* info) {
    McPlan p;
    const int err = make_plan(variant, B, &p);
    if (err != 0 && err != -1) return err;
    const long long v[13] = {(long long)p.total, p.grid, p.max_bps, p.smem,
                             p.Mp, p.ks[0], p.groups[0], p.cw[0], p.rg[0],
                             p.ks[1], p.groups[1], p.cw[1], p.rg[1]};
    for (int i = 0; i < 13; ++i) info[i] = v[i];
    return err;
}

// w1, w2: each product's weights packed per unit as the plan cuts them
// (ops/matmul_chain.py::pack_chain_weights); wsc: int8's column scales;
// phase: null, or (grid, MC_PHASES) zeroed u64 that the run adds
// nanoseconds to, per block: asking for a stage's operands, waiting for
// them, the products, sums and epilogue, the stages with a unit, then the
// barrier waits and their count (globaltimer; thread 0, a stage's first
// unit)
int wn_matmul_chain(const void* x0, const void* w1, const void* w2,
                    const void* wsc, void* y, void* ws, void* phase, int variant,
                    int B, int n_steps, void* stream) {
    McPlan p;
    int err = make_plan(variant, B, &p);
    if (err != 0) return err;
    McArgs a;
    a.x0 = (const bf16*)x0;
    a.w[0] = w1;
    a.w[1] = w2;
    a.wsc = (const float*)wsc;
    a.y = (bf16*)y;
    unsigned char* base = (unsigned char*)ws;
    a.a1 = base + p.a1;
    a.a2 = base + p.a2;
    a.st = base + p.st;
    a.sink = base + p.sink;
    a.dead = base + p.dead;
    a.B = B;
    a.Mp = p.Mp;
    a.Mh = p.Mh;
    a.n_steps = n_steps;
    for (int i = 0; i < 2; ++i) {
        a.K[i] = p.K[i];
        a.N[i] = p.N[i];
        a.groups[i] = p.groups[i];
        a.cw[i] = p.cw[i];
        a.rg[i] = p.rg[i];
        a.ks[i] = p.ks[i];
        a.smem_w[i] = p.smem_w[i];
    }
    a.smem_a = p.smem_a;
    a.smem_p = p.smem_p;
    a.phase = (unsigned long long*)phase;
    void* args[] = {&a};
    cudaError_t e = cudaLaunchCooperativeKernel(kernel_fn(variant), dim3(p.grid),
                                                dim3(MC_THREADS), args, p.smem,
                                                (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
