// The WaveNet AR sample loop in bf16 (kernel_size 2 and 3) for Hopper: one
// persistent cooperative kernel runs every step of a call.
//
// Replaces pytorchwavenetvocoder_tpu/ops/ar_kernel.py::_pallas_ar_generate
// (the fused Pallas TPU kernel) in bf16 at kernel_size 2 and 3; the plain
// PyTorch version is ops/ar_kernel.py::ar_generate_reference.  int8
// (quantize=True) stays on the launch loop of csrc/ar_step.cu, and so do
// the bf16 fleets and configs for which ops/ar_kernel.py::ar_route picks
// that loop (kernel_size 3 from AR_LOOP_FROM_B rows, where a block takes
// several gate units in turn; configs with no cut of the stages).
//
// Bounds on the H100.  Each step reads the whole bf16 weight pack,
// L * R * (2kR + S + R) * 2 bytes (86.5 MB at 30 x 512 with k = 2, 118.0 MB
// with k = 3, more than the 50 MB L2): 25.8 and 35.2 us at 3.35 TB/s.  The
// step is a chain of dependent products: per layer the gate (which needs
// the layer's input) and skip/res (which needs the gate), then the post
// stack and the sample, 2L + 3 = 63 stages at L = 30, each ended by a grid
// barrier (~1.08 us each on this card, ops/matmul_chain.py::barrier_chain):
// ~68 us of barriers per step.  The launch loop of csrc/ar_step.cu pays
// one launch and its gap per stage instead.
//
// Design (the machinery of K4, csrc/matmul_chain.cu, shared through
// wn_hopper.cuh):
//  - one launch with cudaLaunchCooperativeKernel, one block per SM, checked
//    against the occupancy (a grid that cannot be co-resident raises; there
//    is no fallback); cooperative_groups grid.sync() between stages;
//  - the stage plan per step: for each layer a gate stage and a res stage,
//    then post1, post2 and the sample stage.  The input conv (embed) needs
//    only the sampled ids and the aux term nothing of the chain, so neither
//    has a barrier of its own: the sample stage embeds the new ids for the
//    next step and stores that step's aux column (bf16) beside the stream
//    (xs = [x | aux]), and the gate stage multiplies the aux column as an
//    extra K of its product (the pack carries the aux rows under the gate
//    columns);
//  - gate stage, kernel_size 2: [x | aux] @ [[W_cur | W_past]; [auxw | 0]],
//    the current and past taps both interleaved (column 16q + i: sigmoid
//    channel 8q + i, 16q + 8 + i: tanh), a unit covering the same channels
//    in both; its epilogue adds the ring tap and the biases, applies the
//    f32 gate, and writes the past-tap projections for step p + d into the
//    ring elements it has just read;
//    kernel_size 3: [x | aux | lag d | lag 2d] @ [W_cur; auxw; W_d; W_2d],
//    the lag rows bulk-copied straight from the raw ring, and the gate;
//  - res stage: g @ [W_skip | W_res], the f32 skip sum and the residual
//    add; it writes the next layer's stream (f32 and bf16) and, at
//    kernel_size 3, the layer's input row into ring slot p mod 2d;
//  - post1 (ReLU/1x1), post2 (1x1 to logits), then the sample stage: one
//    warp per row takes the argmax (ties to the lowest index) or the
//    Gumbel-max with the Philox4x32-10 noise of (seed, row, step, class)
//    that csrc/ar_step.cu draws, shifts the ids, and embeds them;
//  - units, as in K4: a row group of at most 64 rows x a column group, each
//    taking all of K, so no block needs another's sums; a block takes a
//    contiguous run of a stage's units (column group major, so consecutive
//    units share their weight slice and fetch it once), so any fleet size
//    runs (B = 16,384 takes thousands of units a stage); 8 warps split the
//    unit's column tiles and K (wmma bf16 16x16x16 from shared memory, f32
//    sums), and the sums meet in shared memory in a fixed order;
//  - operands: each unit's weight slice is one contiguous run of 16 x 16
//    tiles followed by its biases (ops/ar_kernel.py::pack_ar_units), moved
//    by one bulk copy (cp.async.bulk on an mbarrier); the next stage's run
//    of a block's first unit is asked for during this stage, into a second
//    buffer, so the weight stream overlaps the stage and the barrier.  The
//    stages write their A operands (the stream with its aux column, the
//    gate, relu(skip), post1's output) in rows padded by 16 bytes, as the
//    units hold them in shared memory (wmma's 16-byte row chunks then fall
//    on distinct banks), so a unit's A rows are one bulk copy; only the
//    kernel_size 3 gate's lagged rows, row-major in the ring, go row by row.
//    The epilogue's per-row operands (ring taps, old skip sums and stream)
//    come by cp.async beside the A rows.  The writers of every array a later
//    stage bulk-copies fence the proxies before the barrier.
//
// What the card showed (PERF.md): asking for every operand row by row
// made "asking" a third of a stage (each bulk copy costs its lane time);
// epilogue operands loaded before the A wait by plain loads stalled the
// products behind them; a second A buffer and an L2 prefetch of the ring
// rows a stage ahead did not pay, and neither did the lagged rows by
// cp.async or 4-byte epilogue stores.  What remains per stage at the main
// path's fleets is ~0.5-1.9 us asking, ~1.1-2.4 us of products (K4's wmma
// core), ~0.5-1.4 us of epilogue, and the barrier.
//
// The ring hazard.  kernel_size 2: the gate stage of layer l reads ring slot
// p mod d (the projection written d steps ago) and writes the projection
// for step p + d into the same slot: the thread that reads an element is
// the one that overwrites it, after reading.  kernel_size 3: the gate stage
// reads slots (p - d) and (p - 2d) mod 2d, the second being slot p mod 2d,
// which the layer's input row overwrites; that write happens in the res
// stage, one barrier after the last read.
//
// Numbers: the products sum in f32 in another order than the plain version
// (the aux term inside the product, the biases after the ring tap), so
// values agree up to f32 summation order before each bf16 rounding.
#include <cooperative_groups.h>
#include <stdint.h>

#include "wn_common.cuh"
#include "wn_hopper.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

#define AP_THREADS 256
#define AP_WARPS (AP_THREADS / 32)
#define AP_ACC 4          // independent sums per warp
#define AP_PAD 8          // bf16 elements of padding per A row in shared memory
#define AP_MT_MAX 4       // row tiles of a unit at most

// the weighted stages; GATE and POST1 use weight buffer 0, RES and POST2
// buffer 1 (stage & 1), so consecutive weighted stages alternate
enum { AP_GATE, AP_RES, AP_POST1, AP_POST2, AP_NSTAGES };

struct ApStage {
    int K, quarters, N;    // weight rows (= A row width), quarters, columns per quarter
    int cw, G, mt, rg, ks; // columns per quarter and unit, column groups, row
                           // tiles per row group, row groups, the warps' K split
    int units;             // rg * G
};

struct ApArgs {
    const bf16* w[AP_NSTAGES];   // packed per unit: [L][G] runs of [K/16][ntu][16][16]
                                 // tiles, then the unit's cw f32 biases
    const bf16* causal_w;        // (K, Q, R)
    const float* causal_b;       // (R)
    const float* h_up;           // (B, h_T, A)
    bf16* ring;                  // k = 2: (total_cap, B, 2R); k = 3: (total_cap, B, R)
    const int* meta;             // (L, 2): ring offset (slots), dilation
    // the A operands of the stages, rows padded by AP_PAD (row strides
    // xs_ld, gs_ld, s_ld) as the units hold them in shared memory, so that a
    // unit's rows are one bulk copy
    bf16* xs;                    // (B, xs_ld): the stream in bf16, the step's aux column
    float* of;                   // (B, R) the stream in f32
    float* skip;                 // (B, S)
    bf16* gs;                    // (B, gs_ld) the gate
    bf16* sr;                    // (B, s_ld) bf16(relu(skip))
    bf16* h1;                    // (B, s_ld)
    float* logits;               // (B, Q)
    int* ids;                    // (B, K) the ids at p-K+1 .. p
    int* samples;                // (B, max_n)
    int B, Mt, R, S, Q, A, Ap, L, h_T, T0, max_n, sampling, xs_ld, gs_ld, s_ld;
    unsigned long long seed;
    ApStage st[AP_NSTAGES];
    // shared memory: two weight buffers, the A rows, the warps' sums, the
    // epilogue's operands
    int smem_w[2], smem_a, smem_p, smem_e;
    // phase times (null: off): per block AP_PH u64, see wn_ar_phase_slots
    unsigned long long* phase;
};

// phase-time slots per block: per stage type (the four weighted ones, then
// the sample stage) asking for operands, waiting for them, the products,
// the epilogue, the stages with a unit, the units (ns sums and counts);
// then the barrier waits and their count
#define AP_PH_STAGE 6
#define AP_PH (5 * AP_PH_STAGE + 2)

// Per block: three mbarriers (the two weight buffers, the A rows) and the
// parity each waits on next.
struct ApBars {
    uint64_t* bar;
    unsigned parity[3];
};

static __device__ __forceinline__ float ldcg_bf(const bf16* p) {
    return bf2f(__ushort_as_bfloat16(__ldcg((const unsigned short*)p)));
}

// the first unit block `blk` takes in a stage of `units` units
static __device__ __forceinline__ int unit_begin(int units, int blk) {
    return (int)((long long)blk * units / gridDim.x);
}

// Thread 0: the weight slice of column group grp of stage T at layer l into
// buffer T & 1 (one packed run, one bulk copy).
static __device__ void fetch_w(const ApArgs& a, unsigned char* smem, ApBars& bars,
                               int T, int l, int grp) {
    const ApStage& s = a.st[T];
    const unsigned elems = (unsigned)(s.K * s.quarters + 2) * s.cw;
    const bf16* src = a.w[T] + ((size_t)l * s.G + grp) * elems;
    uint64_t* bar = bars.bar + (T & 1);
    mbar_expect(bar, elems * 2);
    bulk_copy(smem + a.smem_w[T & 1], src, elems * 2, bar);
}

// Thread 0: the weights of this block's first unit in stage Tn at layer ln
// (Tn < 0: none, or the block has no unit there).
static __device__ void prefetch(const ApArgs& a, unsigned char* smem, ApBars& bars,
                                int Tn, int ln) {
    if (Tn < 0) return;
    const ApStage& s = a.st[Tn];
    const int u0 = unit_begin(s.units, blockIdx.x);
    if (u0 >= unit_begin(s.units, blockIdx.x + 1)) return;
    fetch_w(a, smem, bars, Tn, ln, u0 / s.rg);
}

// The embed of row b for position p from its K ids: out = ((causal_b + w_0)
// + w_1) (+ w_2) in f32 and bf16, and the aux column h_up[b, p] in bf16
// after the stream (the gate's extra K).  One warp.
template <int KS>
static __device__ void embed_row(const ApArgs& a, int b, const int* id, int p,
                                 int lane) {
    const int R = a.R, Q = a.Q, W = a.xs_ld;
    const bf16* w[KS];
#pragma unroll
    for (int j = 0; j < KS; ++j)
        w[j] = a.causal_w + ((size_t)j * Q + ((id[j] % Q) + Q) % Q) * R;
    for (int r = lane; r < R; r += 32) {
        float v = a.causal_b[r];
#pragma unroll
        for (int j = 0; j < KS; ++j) v += bf2f(w[j][r]);
        a.of[(size_t)b * R + r] = v;
        a.xs[(size_t)b * W + r] = f2bf(v);
    }
    const float* hp = a.h_up + ((size_t)b * a.h_T + p) * a.A;
    for (int i = lane; i < a.A; i += 32) a.xs[(size_t)b * W + R + i] = f2bf(hp[i]);
}

// The row stride of stage T's padded A rows (part 0 in shared memory).
template <int T>
static __device__ __forceinline__ int a_ld(const ApArgs& a) {
    return T == AP_GATE ? a.xs_ld : T == AP_RES ? a.gs_ld : a.s_ld;
}

// Warp 0: the A rows [r0, r0 + n) of stage T into shared memory,
// completing on the A mbarrier (whose one arrival lane 0 has made,
// expecting every byte): the stage's padded rows (xs, gs, sr or h1) as one
// bulk copy into part 0, whose rows have the same stride; at kernel_size 3
// the gate's two lagged ring rows (row-major in the ring) row by row into
// part 1 (rows of 2R + AP_PAD: lag d, then lag 2d), rmax rows after part 0.
template <int KS, int T>
static __device__ void copy_a(const ApArgs& a, unsigned char* As, uint64_t* bar,
                              int l, int p, int r0, int n, int rmax, int lane) {
    const bf16* src = T == AP_GATE ? a.xs : T == AP_RES ? a.gs
                    : T == AP_POST1 ? a.sr : a.h1;
    const int ld = a_ld<T>(a);
    if (lane == 0) bulk_copy(As, src + (size_t)r0 * ld, (unsigned)n * ld * 2, bar);
    if constexpr (KS == 3 && T == AP_GATE) {
        const int R = a.R, ld1 = 2 * R + AP_PAD;
        const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
        const int cap = 2 * d;
        unsigned char* A1 = As + (size_t)rmax * ld * 2;
        for (int i = lane; i < 2 * n; i += 32) {
            const int j = i / n, m = i - j * n;
            const int slot = o + ((p - (j + 1) * d) % cap + cap) % cap;
            bulk_copy(A1 + ((size_t)m * ld1 + j * R) * 2,
                      a.ring + ((size_t)slot * a.B + r0 + m) * R, R * 2, bar);
        }
    }
}

// The rows of unit u of stage T: real rows [*r0, *r0 + *n) of a row group
// of *rows (16-row tiles), column group *grp.
static __device__ __forceinline__ void unit_rows(const ApArgs& a, const ApStage& s,
                                                 int u, int* grp, int* r0,
                                                 int* rows, int* n) {
    *grp = u / s.rg;
    const int rgi = u - *grp * s.rg;
    *r0 = rgi * 16 * s.mt;
    *rows = 16 * min(s.mt, a.Mt - rgi * s.mt);
    *n = min(*rows, a.B - *r0);
}

// Warp 0: ask for unit u's A rows (lane 0 makes the A barrier's one
// arrival, expecting every byte, before the copies).
template <int KS, int T>
static __device__ void issue_a(const ApArgs& a, unsigned char* smem, ApBars& bars,
                               int l, int p, int u, int lane) {
    const ApStage& s = a.st[T];
    int grp, r0, rows, n;
    unit_rows(a, s, u, &grp, &r0, &rows, &n);
    unsigned bytes = (unsigned)n * a_ld<T>(a) * 2;
    if (KS == 3 && T == AP_GATE) bytes += (unsigned)n * 2 * a.R * 2;
    if (lane == 0) mbar_expect(bars.bar + 2, bytes);
    __syncwarp();
    copy_a<KS, T>(a, smem + a.smem_a, bars.bar + 2, l, p, r0, n, 16 * s.mt, lane);
}

// Every thread: its share of the 16-byte chunks of `runs` contiguous runs
// of `bytes` each (run i from src + i * sstride bytes to dst + i * dstride)
// by cp.async, committed as one group.
static __device__ __forceinline__ void fetch_runs(unsigned char* dst, int dstride,
                                                  const void* src, size_t sstride,
                                                  int runs, int bytes, int first) {
    const int per = bytes / 16;
    for (int i = threadIdx.x - first; i < runs * per; i += AP_THREADS) {
        if (i < 0) continue;
        const int r = i / per, c = i - r * per;
        cp_async16(dst + (size_t)r * dstride + 16 * c,
                   (const char*)src + r * sstride + 16 * c);
    }
}

// The epilogue's per-row operands of a unit into Es ([rmax][cw]), by
// cp.async once the A rows are in, so that they arrive during the products
// (asked for earlier, they competed with the A rows): the ring tap of the
// unit's sigmoid then tanh channels (kernel_size 2 gate, bf16), the old
// skip sum or stream (res, f32).  The biases come with the weights.
template <int KS, int T>
static __device__ void fetch_e(const ApArgs& a, unsigned char* Es, int l, int p,
                               int grp, int r0, int n, int cw) {
    const int R = a.R, S = a.S;
    if constexpr (T == AP_GATE && KS == 2) {
        const int hc = cw / 2;
        const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
        const bf16* row0 = a.ring + (((size_t)o + p % d) * a.B + r0) * 2 * R + grp * hc;
        // per row: the sigmoid channels at row0, the tanh ones at + R
        fetch_runs(Es, cw * 2, row0, (size_t)2 * R * 2, n, hc * 2, 0);
        fetch_runs(Es + hc * 2, cw * 2, row0 + R, (size_t)2 * R * 2, n, hc * 2, 128);
    } else if constexpr (T == AP_RES) {
        const int c0 = grp * cw;   // a column group lies wholly in skip or in res
        if (c0 >= S)
            fetch_runs(Es, cw * 4, a.of + (size_t)r0 * R + c0 - S, (size_t)R * 4, n,
                       cw * 4, 0);
        else if (l > 0)
            fetch_runs(Es, cw * 4, a.skip + (size_t)r0 * S + c0, (size_t)S * 4, n,
                       cw * 4, 0);
    }
    cp_async_commit();
}

// the sum of column col of row ml over the warps' K slices, in slice order
static __device__ __forceinline__ float psum(const float* Ps, int ks, int rows,
                                             int cols, int ml, int col) {
    float v = 0.f;
    for (int k = 0; k < ks; ++k) v += Ps[((size_t)k * rows + ml) * cols + col];
    return v;
}

// The epilogue of one unit: rows [r0, r0 + n) (real rows only) of column
// group grp; the sums in Ps ([ks][rows][cols]), the per-row operands in Es
// (fetch_e), the biases in eb (after the unit's weight tiles).
template <int KS, int T>
static __device__ void epilogue(const ApArgs& a, const float* Ps,
                                const unsigned char* Es, const float* eb,
                                int l, int p, int grp, int r0, int n, int rows,
                                int cols, int ks, int cw) {
    const int R = a.R, S = a.S;
    if constexpr (T == AP_GATE) {
        const int hc = cw / 2;
        bf16* slot = nullptr;
        if constexpr (KS == 2) {
            const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
            slot = a.ring + ((size_t)o + p % d) * a.B * 2 * R;
        }
        for (int e = threadIdx.x; e < n * hc; e += AP_THREADS) {
            const int ml = e / hc, ci = e - ml * hc, jt = ci >> 3, ii = ci & 7;
            const int b = r0 + ml, c = grp * hc + ci;
            const int cs = jt * 16 + ii, ct = cs + 8;
            float zs = psum(Ps, ks, rows, cols, ml, cs);
            float zt = psum(Ps, ks, rows, cols, ml, ct);
            if constexpr (KS == 2) {
                // the ring tap this block read before the products (every
                // read of the unit precedes the __syncthreads before this
                // epilogue), then the projection for step p + d over it
                const bf16* tap = (const bf16*)Es + (size_t)ml * cw;
                zs += bf2f(tap[ci]);
                zt += bf2f(tap[hc + ci]);
                bf16* rr = slot + (size_t)b * 2 * R;
                rr[c] = f2bf(psum(Ps, ks, rows, cols, ml, cw + cs));
                rr[R + c] = f2bf(psum(Ps, ks, rows, cols, ml, cw + ct));
            }
            a.gs[(size_t)b * a.gs_ld + c] = f2bf(wn_gate(zs + eb[ci], zt + eb[hc + ci]));
        }
    } else if constexpr (T == AP_RES) {
        const bool last = l == a.L - 1;
        bf16* slot = nullptr;
        if constexpr (KS == 3) {
            const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
            slot = a.ring + ((size_t)o + p % (2 * d)) * a.B * R;
        }
        for (int e = threadIdx.x; e < n * cw; e += AP_THREADS) {
            const int ml = e / cw, jj = e - ml * cw;
            const int b = r0 + ml, col = grp * cw + jj;
            const float v = psum(Ps, ks, rows, cols, ml, jj) + eb[jj];
            const float old = col < S && l == 0
                ? 0.f : ((const float*)Es)[(size_t)ml * cw + jj];
            const float nv = v + old;
            if (col < S) {
                a.skip[(size_t)b * S + col] = nv;
                if (last) a.sr[(size_t)b * a.s_ld + col] = f2bf(fmaxf(nv, 0.f));
            } else {
                const int j = col - S;
                a.of[(size_t)b * R + j] = nv;
                a.xs[(size_t)b * a.xs_ld + j] = f2bf(nv);
                if constexpr (KS == 3) slot[(size_t)b * R + j] = f2bf(old);
            }
        }
    } else {
        const int N = T == AP_POST1 ? S : a.Q;
        for (int e = threadIdx.x; e < n * cols; e += AP_THREADS) {
            const int ml = e / cols, jj = e - ml * cols;
            const int b = r0 + ml, col = grp * cols + jj;
            const float v = psum(Ps, ks, rows, cols, ml, jj) + eb[jj];
            if constexpr (T == AP_POST1) a.h1[(size_t)b * a.s_ld + col] = f2bf(fmaxf(v, 0.f));
            else a.logits[(size_t)b * N + col] = v;
        }
    }
}

// One weighted stage: this block's run of units, each taking all of K.  The
// first unit's weights were asked for during the previous stage; a later
// unit asks for its own only where its column group changes.  Right after
// asking for its first unit's A rows, the block asks for its first unit's
// weights of the next stage (Tn at layer ln; Tn < 0: none).
template <int KS, int T>
static __device__ void wstage(const ApArgs& a, ApBars& bars, int l, int p,
                              int Tn, int ln) {
    // the dynamic shared memory named here, not passed in: the compiler then
    // knows the operands are shared and loads them as such
    extern __shared__ __align__(128) unsigned char smem[];
    const ApStage& s = a.st[T];
    constexpr int buf = T & 1;
    const int u0 = unit_begin(s.units, blockIdx.x);
    const int u1 = unit_begin(s.units, blockIdx.x + 1);
    if (u0 >= u1) {   // no unit here: still ask for the next stage's weights
        if (threadIdx.x == 0) prefetch(a, smem, bars, Tn, ln);
        return;
    }
    const int K = s.K, KT = K / 16, cols = s.quarters * s.cw, ntu = cols / 16;
    const int ks = s.ks, rmax = 16 * s.mt;
    // the A operand: part 0 (k tiles below kt0, row stride ld0), then at
    // kernel_size 3 the gate's lagged rows in part 1 (row stride ld1)
    const int ld0 = a_ld<T>(a), ld1 = 2 * a.R + AP_PAD;
    const int kt0 = KS == 3 && T == AP_GATE ? (a.R + a.Ap) / 16 : KT;
    const bf16* As = (const bf16*)(smem + a.smem_a);
    const bf16* A1 = As + (size_t)rmax * ld0;
    const bf16* Ws = (const bf16*)(smem + a.smem_w[buf]);
    const float* eb = (const float*)(Ws + (size_t)K * s.quarters * s.cw);
    float* Ps = (float*)(smem + a.smem_p);
    unsigned char* Es = smem + a.smem_e;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned long long* ph = a.phase != nullptr && threadIdx.x == 0
        ? a.phase + (size_t)blockIdx.x * AP_PH + T * AP_PH_STAGE : nullptr;
    unsigned long long t[5] = {0, 0, 0, 0, 0};
    int have = -1;     // the column group whose weights the buffer holds
    for (int u = u0; u < u1; ++u) {
        int grp, r0, rows, n;
        unit_rows(a, s, u, &grp, &r0, &rows, &n);
        const bool fetch = u != u0 && grp != have;
        if (ph) t[0] = now_ns();
        __syncthreads();   // the previous unit's tiles, sums and operands are consumed
        if (warp == 0) {
            if (lane == 0 && fetch) fetch_w(a, smem, bars, T, l, grp);
            issue_a<KS, T>(a, smem, bars, l, p, u, lane);
            if (lane == 0 && u == u0) prefetch(a, smem, bars, Tn, ln);
        }
        fetch_e<KS, T>(a, Es, l, p, grp, r0, n, s.cw);
        if (ph) t[1] = now_ns();
        mbar_wait(bars.bar + 2, bars.parity[2]);
        bars.parity[2] ^= 1;
        if (u == u0 || fetch) {
            mbar_wait(bars.bar + buf, bars.parity[buf]);
            bars.parity[buf] ^= 1;
        }
        have = grp;
        if (ph) t[2] = now_ns();
        const int mtu = rows / 16;

        // task = (16-column tile, K slice) over the unit's row tiles, with
        // AP_ACC independent sums per warp: one per row tile where the unit
        // has several, else one per K phase, interleaved (a single chain of
        // dependent products stalls on each); fixed order throughout
        for (int task = warp; task < ntu * ks; task += AP_WARPS) {
            const int nt = task % ntu, ksi = task / ntu;
            const int kb = ksi * KT / ks, ke = (ksi + 1) * KT / ks;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[AP_ACC];
#pragma unroll
            for (int h = 0; h < AP_ACC; ++h) wmma::fill_fragment(acc[h], 0.f);
            if (mtu == 1) {
                for (int k0 = kb; k0 < ke; k0 += AP_ACC) {
#pragma unroll
                    for (int h = 0; h < AP_ACC; ++h) {
                        const int kt = k0 + h;
                        if (kt < ke) {
                            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
                            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                            wmma::load_matrix_sync(bw, Ws + ((size_t)kt * ntu + nt) * 256, 16);
                            if (kt < kt0) wmma::load_matrix_sync(fa, As + kt * 16, ld0);
                            else wmma::load_matrix_sync(fa, A1 + (kt - kt0) * 16, ld1);
                            wmma::mma_sync(acc[h], fa, bw, acc[h]);
                        }
                    }
                }
#pragma unroll
                for (int h = 1; h < AP_ACC; ++h)
#pragma unroll
                    for (int i = 0; i < acc[0].num_elements; ++i) acc[0].x[i] += acc[h].x[i];
            } else {
#pragma unroll 2
                for (int kt = kb; kt < ke; ++kt) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
                    wmma::load_matrix_sync(bw, Ws + ((size_t)kt * ntu + nt) * 256, 16);
#pragma unroll
                    for (int i = 0; i < AP_ACC; ++i) {
                        if (i < mtu) {
                            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                            if (kt < kt0)
                                wmma::load_matrix_sync(fa, As + (size_t)i * 16 * ld0 + kt * 16, ld0);
                            else
                                wmma::load_matrix_sync(fa, A1 + (size_t)i * 16 * ld1
                                                           + (kt - kt0) * 16, ld1);
                            wmma::mma_sync(acc[i], fa, bw, acc[i]);
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < AP_ACC; ++i)
                if (i < mtu)
                    wmma::store_matrix_sync(Ps + ((size_t)ksi * rows + i * 16) * cols + nt * 16,
                                            acc[i], cols, wmma::mem_row_major);
        }
        cp_async_wait();   // this thread's epilogue operands
        __syncthreads();
        if (ph) t[3] = now_ns();
        epilogue<KS, T>(a, Ps, Es, eb, l, p, grp, r0, n, rows, cols, ks, s.cw);
        if (a.phase != nullptr) {
            __syncthreads();   // every thread's epilogue
            if (ph) {
                t[4] = now_ns();
                for (int i = 0; i < 4; ++i) ph[i] += t[i + 1] - t[i];
                ph[5] += 1;
            }
        }
    }
    if (ph) ph[4] += 1;
    // the next stages' bulk copies read what this stage wrote
    fence_proxy_async();
}

// One warp per row: the argmax of the logits (plus the Gumbel noise in
// sampling mode; ties to the lowest index, all-NaN logits to 0), the ids
// shifted, and, before a next step, its embed and aux column.
template <int KS>
static __device__ void sample_stage(const ApArgs& a, int step, int p) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    for (int b = blockIdx.x * AP_WARPS + warp; b < a.B; b += gridDim.x * AP_WARPS) {
        float best = -INFINITY;
        int bi = 0x7fffffff;
        for (int j = lane; j < a.Q; j += 32) {
            float v = __ldcg(a.logits + (size_t)b * a.Q + j);
            if (a.sampling) v += gumbel_noise(a.seed, b, step, j);
            if (v > best || (v == best && j < bi)) { best = v; bi = j; }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
        }
        int id[KS];
#pragma unroll
        for (int j = 0; j + 1 < KS; ++j) id[j] = a.ids[(size_t)b * KS + j + 1];
        id[KS - 1] = bi < a.Q ? bi : 0;
        __syncwarp();
        if (lane == 0) {
            a.samples[(size_t)b * a.max_n + step] = id[KS - 1];
#pragma unroll
            for (int j = 0; j < KS; ++j) a.ids[(size_t)b * KS + j] = id[j];
        }
        if (step + 1 < a.max_n) embed_row<KS>(a, b, id, p + 1, lane);
    }
    fence_proxy_async();
    if (a.phase != nullptr) {
        __syncthreads();
        if (threadIdx.x == 0) {
            unsigned long long* ph = a.phase + (size_t)blockIdx.x * AP_PH
                                     + AP_NSTAGES * AP_PH_STAGE;
            ph[3] += now_ns() - t0;
            ph[4] += 1;
        }
    }
}

// the grid barrier; with phase times on, thread 0 of each block adds its
// wait (its arrival to the last block's) and counts it
static __device__ __forceinline__ void timed_sync(const ApArgs& a, cg::grid_group& grid) {
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    grid.sync();
    if (a.phase != nullptr && threadIdx.x == 0) {
        unsigned long long* ph = a.phase + (size_t)blockIdx.x * AP_PH + 5 * AP_PH_STAGE;
        ph[0] += now_ns() - t0;
        ph[1] += 1;
    }
}

template <int KS>
__global__ void __launch_bounds__(AP_THREADS, 1) ar_persistent_kernel(ApArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar[3];
    cg::grid_group grid = cg::this_grid();
    ApBars bars = {bar, {0u, 0u, 0u}};
    if (threadIdx.x == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the first step's embed and aux column, from the carry's ids
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int b = blockIdx.x * AP_WARPS + warp; b < a.B; b += gridDim.x * AP_WARPS) {
        int id[KS];
#pragma unroll
        for (int j = 0; j < KS; ++j) id[j] = a.ids[(size_t)b * KS + j];
        embed_row<KS>(a, b, id, a.T0 - 1, lane);
    }
    fence_proxy_async();
    if (threadIdx.x == 0) prefetch(a, smem, bars, AP_GATE, 0);
    timed_sync(a, grid);
    for (int i = 0; i < a.max_n; ++i) {
        const int p = a.T0 - 1 + i;
        for (int l = 0; l < a.L; ++l) {
            wstage<KS, AP_GATE>(a, bars, l, p, AP_RES, l);
            timed_sync(a, grid);
            if (l + 1 < a.L) wstage<KS, AP_RES>(a, bars, l, p, AP_GATE, l + 1);
            else wstage<KS, AP_RES>(a, bars, l, p, AP_POST1, 0);
            timed_sync(a, grid);
        }
        wstage<KS, AP_POST1>(a, bars, 0, p, AP_POST2, 0);
        timed_sync(a, grid);
        // the next step's first gate weights: buffer 0, free since post1
        wstage<KS, AP_POST2>(a, bars, 0, p, i + 1 < a.max_n ? AP_GATE : -1, 0);
        timed_sync(a, grid);
        sample_stage<KS>(a, i, p);
        if (i + 1 < a.max_n) timed_sync(a, grid);
    }
}

// ---- host side -----------------------------------------------------------

static void stage_shape(int T, int K_, int R, int S, int Q, int Ap, int* K,
                        int* quarters, int* N) {
    *quarters = 1;
    switch (T) {
    case AP_GATE:
        *K = K_ == 2 ? R + Ap : 3 * R + Ap;
        *quarters = K_ == 2 ? 2 : 1;
        *N = 2 * R;
        break;
    case AP_RES: *K = R; *N = S + R; break;
    case AP_POST1: *K = S; *N = S; break;
    default: *K = S; *N = Q; break;
    }
}

static const void* kernel_fn(int K) {
    return K == 2 ? (const void*)ar_persistent_kernel<2>
                  : (const void*)ar_persistent_kernel<3>;
}

// Check the plan (ops/ar_kernel.py::ar_plan, as ar_plan_array lays it out)
// against the shapes and the card, and fill the stages.  0, or -1 (the grid
// cannot be co-resident), -2 (no cooperative launch), -3 (a plan that does
// not cut the stages or fit its shared memory), or a CUDA error.
static int check_plan(const int* plan, ApArgs* a, int K_, int* grid, int* smem) {
    *grid = plan[0];
    *smem = plan[1];
    a->smem_w[0] = plan[2];
    a->smem_w[1] = plan[3];
    a->smem_a = plan[4];
    a->smem_p = plan[5];
    a->smem_e = plan[6];
    const int wcap = a->smem_w[1];
    if (a->smem_w[0] != 0 || wcap < 0 || a->smem_a != 2 * wcap
        || a->smem_p < a->smem_a || a->smem_e < a->smem_p || *smem < a->smem_e
        || *grid < 1 || a->R % 16 || a->S % 16 || a->Q % 16 || a->Ap % 16
        || a->Ap < a->A)
        return -3;
    for (int T = 0; T < AP_NSTAGES; ++T) {
        ApStage& s = a->st[T];
        stage_shape(T, K_, a->R, a->S, a->Q, a->Ap, &s.K, &s.quarters, &s.N);
        s.cw = plan[7 + 3 * T];
        s.mt = plan[8 + 3 * T];
        s.ks = plan[9 + 3 * T];
        if (s.cw < 16 || s.cw % 16 || s.N % s.cw || s.mt < 1 || s.mt > AP_MT_MAX
            || s.ks < 1 || s.ks > s.K / 16)
            return -3;
        s.G = s.N / s.cw;
        s.rg = (a->Mt + s.mt - 1) / s.mt;
        s.units = s.rg * s.G;
        const long long wbytes = (long long)(s.K * s.quarters + 2) * s.cw * 2;
        const long long abytes =
            16LL * s.mt * (s.K + (K_ == 3 && T == AP_GATE ? 2 : 1) * AP_PAD) * 2;
        const long long pbytes = (long long)s.ks * 16 * s.mt * s.quarters * s.cw * 4;
        const long long ebytes = 16LL * s.mt * s.cw * 4;
        if (wbytes > wcap || abytes > a->smem_p - a->smem_a
            || pbytes > a->smem_e - a->smem_p
            || ebytes > *smem - a->smem_e)
            return -3;
    }
    int dev = 0, sms = 0, coop = 0, bps = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return -2;
    e = cudaFuncSetAttribute(kernel_fn(K_), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel_fn(K_), AP_THREADS,
                                                      *smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)bps * sms < *grid) return -1;
    return 0;
}

extern "C" {

// Runs max_n bf16 steps on `stream` in one cooperative launch.  Weights:
// w_gate, w_res, w_post1, w_post2 packed per unit by the plan, each unit's
// biases after its tiles (ops/ar_kernel.py::pack_ar_units); causal_b (R)
// f32, causal_w (K, Q, R) bf16.  ring: k = 2 (total_cap, B, 2R) bf16
// projections, k = 3 (total_cap, B, R) bf16 rows, updated in place; meta
// (L, 2) int32 on the device: each layer's ring offset and
// dilation.  Scratch, rows padded by 8 elements: xs (B, R + Ap + 8) bf16
// with columns R + A .. R + Ap - 1 zero (Ap = A rounded up to 16), gs (B,
// R + 8), sr, h1 (B, S + 8) bf16; of (B, R), skip (B, S), logits (B, Q) f32.
// ids (B, K) int32, updated in place;
// samples (B, max_n) int32.  plan: host ints of ar_plan_array.  phase:
// null, or (grid, wn_ar_phase_slots()) zeroed u64 that the run adds
// nanoseconds and counts to (AP_PH_STAGE slots per stage type: gate, res,
// post1, post2, sample; then the barrier waits and their count; thread 0,
// globaltimer).  Returns 0, a negative plan error (check_plan) or a CUDA
// error.
int wn_ar_generate_persistent(
    const void* w_gate, const void* w_res, const void* w_post1, const void* w_post2,
    const void* causal_w, const void* causal_b, const void* h_up, int h_T,
    void* ring, const void* meta, void* xs, void* of, void* skip, void* gs,
    void* sr, void* h1, void* logits, void* ids, void* samples, int B, int R,
    int S, int Q, int A, int L, int K, int T0, int max_n, int sampling,
    unsigned long long seed, const void* plan, void* phase, void* stream) {
    if (K != 2 && K != 3) return (int)cudaErrorInvalidValue;
    if (B < 1 || max_n < 1 || L < 1) return -3;
    ApArgs a;
    a.w[AP_GATE] = (const bf16*)w_gate;
    a.w[AP_RES] = (const bf16*)w_res;
    a.w[AP_POST1] = (const bf16*)w_post1;
    a.w[AP_POST2] = (const bf16*)w_post2;
    a.causal_w = (const bf16*)causal_w;
    a.causal_b = (const float*)causal_b;
    a.h_up = (const float*)h_up;
    a.ring = (bf16*)ring;
    a.meta = (const int*)meta;
    a.xs = (bf16*)xs;
    a.of = (float*)of;
    a.skip = (float*)skip;
    a.gs = (bf16*)gs;
    a.sr = (bf16*)sr;
    a.h1 = (bf16*)h1;
    a.logits = (float*)logits;
    a.ids = (int*)ids;
    a.samples = (int*)samples;
    a.B = B;
    a.Mt = (B + 15) / 16;
    a.R = R;
    a.S = S;
    a.Q = Q;
    a.A = A;
    a.Ap = (A + 15) / 16 * 16;
    a.xs_ld = R + a.Ap + AP_PAD;
    a.gs_ld = R + AP_PAD;
    a.s_ld = S + AP_PAD;
    a.L = L;
    a.h_T = h_T;
    a.T0 = T0;
    a.max_n = max_n;
    a.sampling = sampling;
    a.seed = seed;
    a.phase = (unsigned long long*)phase;
    int grid = 0, smem = 0;
    const int err = check_plan((const int*)plan, &a, K, &grid, &smem);
    if (err != 0) return err;
    void* args[] = {&a};
    cudaError_t e = cudaLaunchCooperativeKernel(kernel_fn(K), dim3(grid),
                                                dim3(AP_THREADS), args, smem,
                                                (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int wn_ar_phase_slots(void) { return AP_PH; }

}  // extern "C"
