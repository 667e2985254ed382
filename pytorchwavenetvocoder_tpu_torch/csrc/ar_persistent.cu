// The WaveNet AR sample loop in bf16 and int8 (kernel_size 2 and 3) for
// Hopper: one persistent cooperative kernel runs every step of a call.
// The mixture-of-logistics model (bf16, kernel_size 3) runs the same plan
// at its own widths in instances of its own (template MOL: a gate of half
// width G against R, scaled output and skip sums, the MoL sampler and the
// 1x1 input; ar_persistent_kernel below).
//
// Replaces pytorchwavenetvocoder_tpu/ops/ar_kernel.py::_pallas_ar_generate
// (the fused Pallas TPU kernel) in bf16 and in its int8 path
// (quantize=True) at kernel_size 2 and 3; the plain PyTorch version is
// ops/ar_kernel.py::ar_generate_reference.  Every fleet and config runs
// here: with its streamed gate this kernel was faster than a loop of
// 65-66 launches a step at every fleet measured (PERF.md).
//
// Bounds on the H100.  Each step reads the whole bf16 weight pack,
// L * R * (2kR + S + R) * 2 bytes (86.5 MB at 30 x 512 with k = 2, 118.0 MB
// with k = 3, more than the 50 MB L2): 25.8 and 35.2 us at 3.35 TB/s.  The
// step is a chain of dependent products: per layer the gate (which needs
// the layer's input) and skip/res (which needs the gate), then the post
// stack and the sample, 2L + 3 = 63 stages at L = 30.  A grid barrier
// after each (the first design: ~1.08 us each on this card,
// ops/matmul_chain.py::barrier_chain) cost ~68 us a step; the stages now
// wait on an arrival counter per stage instead (below).  At wide fleets
// the gate stage's operands bound it: a unit that holds all of K = 3R +
// aux of its rows and columns in shared memory is small (32 rows x 16
// columns at K = 1,584), so a block took several in turn, each waiting for
// its own copies, and the rows were read again for every column group.
//
// The gate stage runs one of two designs (ST, the kernel's template
// parameter; ops/ar_kernel.py::ar_plan picks, AR_STREAM_FROM_B):
//  - "units" (small fleets, where each block takes one unit at most):
//    wstage below, the units of the other stages;
//  - "stream" (gate_produce / gate_consume): a unit is 64 m rows (m = 1,
//    the two consumer warpgroups splitting its columns, or m = 2, a 64-row
//    wgmma slab each) x cw gate columns, and streams its K instead of
//    holding it: K in chunks of 128 bytes (64 bf16, 128 int8 values)
//    through a ring of 2-4 shared-memory stages, one producer warp filling
//    it (a TMA load of the chunk's A tile from a 2-D map of the stream, of
//    the raw ring's lagged slot (kernel_size 3: slot s of a layer is B
//    rows of the (total_cap * B, R) ring) or of the int8 aux rows, and a
//    bulk copy of its W tile, packed and swizzled on the host) on
//    full/empty mbarriers, two consumer warpgroups running wgmma (bf16
//    m64nNk16 into f32; int8 m64nNk32 into s32, exact, one sum per int8
//    product, and the aux product in bf16) with the sums in registers.
//    The epilogue works from the registers: the columns keep
//    pack_ar_weights' interleave by 8, so a thread holds the sigmoid and
//    the tanh of its channels (as K2's FwdGate); the ring tap, the biases,
//    the aux term, the int8 rounding (__fmul_rn / __fadd_rn) and the
//    kernel_size 2 write-over of the projection for step p + d keep
//    wstage's order.  The plan takes the cut whose units fit the grid
//    (one a block) with the fewest A and W bytes: bf16 k=3 at B=256 is 64
//    rows x 32 columns, 128 units.  The ring lies over buffer 0 and the
//    regions after it (buffer 1 holds the res stage's weights, asked for
//    during the gate stage); the other stages' generic writes to that
//    shared memory are fenced to the async proxy before the next gate.
//    No cluster is used: the A tiles of the units that share rows are
//    read once each (a cluster's TMA multicast would share them; not
//    tried).  What bounds it on an H100 (PERF.md): at B=256 the
//    gate stage takes ~10 us a layer (bf16 k=3, 128 units of ~300 KB from
//    L2 each, ~39 MB a stage, L2 bandwidth), the res stage ~8 us and the
//    63 grid barriers of the first design ~2.7 us each.
//  The two designs are separate instances: the streamed one's block has
//  a 9th warp (the producer), and ptxas gives a block of 288 threads at
//  most 168 registers a thread, under which the int8 stages spill (on one
//  shared instance the small fleets ran 5-12% slower); the units instance
//  keeps 256 threads and none of the streamed code.
//
// Design (the machinery of K4, csrc/matmul_chain.cu, shared through
// wn_hopper.cuh):
//  - one launch with cudaLaunchCooperativeKernel, one block per SM, checked
//    against the occupancy (a grid that cannot be co-resident raises; there
//    is no fallback): the waits below need every block resident;
//  - the stage plan per step: for each layer a gate stage and a res stage,
//    then post1, post2 and the sample stage.  The input conv (embed) needs
//    only the sampled ids and the aux term nothing of the chain, so neither
//    is a stage of its own: the sample stage embeds the new ids for the
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
//    (wn_hopper.cuh::gumbel_noise4), shifts the ids, and embeds them;
//  - units (the other stages, and the gate of small fleets), as in K4: a
//    row group of at most 64 rows x a column group, each taking all of K,
//    so no block needs another's sums; a block takes a
//    contiguous run of a stage's units (column group major, so consecutive
//    units share their weight slice and fetch it once), so any fleet size
//    runs (B = 16,384 takes thousands of units a stage); 8 warps split the
//    unit's column tiles and K (wmma bf16 16x16x16 from shared memory, f32
//    sums), and the sums meet in shared memory in a fixed order;
//  - operands: each unit's weight slice is one contiguous run of 16 x 16
//    tiles followed by its biases (ops/ar_kernel.py::pack_ar_units), moved
//    by one bulk copy (cp.async.bulk on an mbarrier); the next stage's run
//    of a block's first unit is asked for during this stage, into a second
//    buffer, so the weight stream overlaps the stage and the wait.  The
//    stages write their A operands (the stream with its aux column, the
//    gate, relu(skip), post1's output) in rows padded by 16 bytes, as the
//    units hold them in shared memory (wmma's 16-byte row chunks then fall
//    on distinct banks), so a unit's A rows are one bulk copy; only the
//    kernel_size 3 gate's lagged rows, row-major in the ring, go row by row.
//    The epilogue's per-row operands (ring taps, old skip sums and stream)
//    come by cp.async beside the A rows (asked for before the wait below,
//    though the unit's own block wrote most of them, they made the small
//    fleets' step 7% slower on the card: PERF.md, "K1 without grid barriers");
//  - waits (the units instance), as K4's, with one counter a stage: a
//    unit depends on the units of the stage before it (the gate of layer l
//    on the res stage of layer l - 1, or at layer 0 on the sample stage
//    that embedded the step's ids; res on the gate; post1 on the last res
//    stage; post2 on post1; the sample stage on post2).  Each stage type
//    has an arrival counter in device memory, set to AP_CTR0 per launch
//    (it wraps at its first arrival) and never reset within it: after a
//    unit's epilogue its writers fence the generic proxy to the async
//    proxy, the workers sync, and one thread adds 1 with release
//    semantics.  Before asking for a unit's A rows, one thread polls the
//    counter of the previous stage with acquire semantics until it reaches
//    that stage's units times its runs so far (a wait of 2^24 polls
//    traps), the workers sync,
//    and the unit asks for its A rows, then for the next stage's weights
//    (asked for before the poll, as they could be, they delayed the A rows
//    behind them: 3% of the step at B=32, PERF.md, "K1 without grid barriers").
//    A block with no unit in a stage does not wait: it asks for the next
//    stage's weights and goes on to its next unit.  The sample stage is
//    cut into units of AP_SROWS rows (a warp a row); the first step's embed
//    is its first run.  Each waiting thread counts its waits and those
//    whose first poll found the target reached, and adds both to the
//    launch's totals at its end (ops/ar_kernel.py::k1_waits).  The
//    streamed instance keeps a grid barrier after every stage
//    (cooperative_groups grid.sync()): there the same waits were slower
//    (ar_persistent_kernel below).  Counters per row group (a unit waiting
//    only for the units on its own rows, as K4's) tied with one a stage on
//    the card, within 2% either way at 16-160 rows (PERF.md, "K1 without
//    grid barriers");
//
// Why no buffer needs a second copy under the counter waits (K4's
// argument).  Every unit of a stage waits until every unit of the previous
// stage's run has arrived, and a unit arrives only after its last read of
// a stage operand (its A rows and epilogue operands are in shared memory
// before its products) and its last write (its epilogue, fenced).  The
// stages form one chain, so by induction every earlier stage's units are
// done: the stages are totally ordered, as under a grid barrier.  So each
// array (the stream xs / of / xq with its aux column, the gate gs / gq,
// skip, sr, h1, logits, ids and the ring) is touched by one stage at a
// time.  A block with no unit in a stage touches none of them (it asks
// only for weights, which no stage writes).  Within a block the unit
// loop's syncs order the reuse of shared memory.
//
// What the card showed (PERF.md): asking for every operand row by row
// made "asking" a third of a stage (each bulk copy costs its lane time);
// epilogue operands loaded before the A wait by plain loads stalled the
// products behind them; a second A buffer and an L2 prefetch of the ring
// rows a stage ahead did not pay, and neither did the lagged rows by
// cp.async or 4-byte epilogue stores.  What remains per stage at the main
// path's fleets is ~0.5-1.9 us asking, ~1.1-2.4 us of products (K4's wmma
// core), ~0.5-1.4 us of epilogue, and the wait for the stage before.
//
// The ring hazard.  kernel_size 2: the gate stage of layer l reads ring slot
// p mod d (the projection written d steps ago) and writes the projection
// for step p + d into the same slot: the thread that reads an element is
// the one that overwrites it, after reading.  kernel_size 3: the gate stage
// reads slots (p - d) and (p - 2d) mod 2d, the second being slot p mod 2d,
// which the layer's input row overwrites; that write happens in the res
// stage, whose units wait for every gate unit of their rows.
//
// Numbers: the products sum in f32 in another order than the plain version
// (the aux term inside the product, the biases after the ring tap), so
// values agree up to f32 summation order before each bf16 rounding.
//
// int8 (the Q8 instances; the JAX kernel's int8 path): the same stage plan
// and waits.  The gate and res stages multiply int8 by int8 into int32
// sums (exact), each product dequantized by (activation scale x column
// scale) in the epilogue; the aux term stays a bf16 product (wmma, f32
// sums) over the unit's aux rows, as in the JAX int8 path; post1, post2
// and the sample stage are the bf16 ones.  The stream is quantized by its
// producers: the sample stage's embed and each res stage write the next
// layer's int8 row at that layer's scale (round half to even, +-127), the
// gate stage writes g at 1/127.  kernel_size 2: the ring keeps the bf16
// projection of the past-tap product, written over the element just read;
// kernel_size 3: the raw ring holds int8 rows, the gate multiplies the
// rows at lag d and 2d (bulk-copied from the ring) by their own weight
// blocks, and the res stage writes the layer's int8 input row into slot
// p mod 2d.  The epilogues round with __fmul_rn / __fadd_rn in the plain
// version's order (an FMA, or another order, that flips one int8 value
// moves the rest of the row's layers by quanta).
//
// The int8 product core: mma.sync m16n8k32 (s8 x s8 -> s32) fed by
// ldmatrix.x4 from shared memory.  The A rows (the int8 stream, the gate,
// the lagged ring rows) lie in shared memory in rows padded by 16 bytes,
// a row's stride an odd number of 16-byte chunks (R a multiple of 32), so
// the 8 row addresses of each ldmatrix phase fall on distinct banks; the
// weights of a unit come packed per 32-deep k chunk and 16-column tile as
// four 128-byte matrices (8 columns x 16 k bytes each, columns n-major), so
// one ldmatrix.x4 reads the B fragments of two n8 tiles, each matrix
// contiguous.  (wmma's s8 fragments want 32-byte aligned tile bases, which
// the padded rows and the row-major ring rows do not give at odd 16-byte
// k tiles.)
#include <cooperative_groups.h>
#include <stdint.h>

#include "wn_common.cuh"
#include "wn_hopper.cuh"
#include "wn_wgmma.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

#define AP_THREADS 256   // the workers: every stage's threads (the two wgmma
                         // consumer warpgroups of the streamed gate)
#define AP_WARPS (AP_THREADS / 32)
#define AP_BLOCK (AP_THREADS + 32)   // and the streamed gate's TMA producer warp
#define AP_ACC 4          // independent sums per warp
#define AP_PAD 8          // bf16 elements of padding per A row in shared memory
#define AP_MT_MAX 4       // row tiles of a unit at most
#define AP_QPAD 16        // bytes of padding per int8 A row in shared memory

// the weighted stages; GATE and POST1 use weight buffer 0, RES and POST2
// buffer 1 (stage & 1), so consecutive weighted stages alternate
enum { AP_GATE, AP_RES, AP_POST1, AP_POST2, AP_NSTAGES };
// the sample stage (no weights): the fifth stage with arrival counters
#define AP_SAMPLE AP_NSTAGES
#define AP_SROWS AP_WARPS   // rows of a sample-stage unit: a warp each
// the arrival counters' value at a launch's start: 2^32 - 1, so that each
// wraps at its first arrival and every launch, not only a decode long
// enough to pass 2^32 arrivals, runs wn_hopper.cuh's wrap-safe wait
#define AP_CTR0 0xFFFFFFFFu

struct ApStage {
    int K, quarters, N;    // weight rows (= A row width; int8: of each
                           // segment), quarters, columns per quarter
    int cw, G, mt, rg, ks; // columns per quarter and unit, column groups, row
                           // tiles per row group, row groups, the warps' K split
    int units;             // rg * G
    int segs;              // int8 products of the stage (kernel_size 3 gate:
                           // current, lag d, lag 2d; else 1)
    int run;               // bytes of a unit's packed weights
};

// The streamed gate's cut (ops/ar_kernel.py::_stream_cut): a unit is AP_SLAB
// * m rows x cw gate columns of each quarter, its K walked in chunks of
// AP_CHUNK bytes through a ring of `stages` shared-memory stages.
#define AP_SLAB 64        // rows of a wgmma slab
#define AP_CHUNK 128      // bytes of K per ring stage: 64 bf16 or 128 int8
#define AP_RING_MAX 4

struct ApStream {
    int on;                // 1: the gate stage streams K (gate_produce/consume)
    int m;                 // slabs per unit: 1 (the two consumer warpgroups
                           // split its columns) or 2 (a slab each)
    int cw;                // gate columns of each quarter per unit
    int nw;                // columns of each consumer warpgroup (wgmma N)
    int G, rb, units;      // column groups, row blocks, units
    int stages;            // ring stages
    int ring;              // the ring's offset in dynamic shared memory
                           // (rounded up to 1024 in the kernel)
    int nx, nl, na, nc;    // K chunks: the stream's, each lag's, the int8 aux
                           // rows', all
    int a_bytes, w_bytes;  // a ring stage's A tile and W tile
    long long run;         // bytes of a unit's packed weights (nc W tiles)
};

struct ApArgs {
    // the streamed gate's A operands as TMA maps (128-byte swizzle, boxes of
    // 128 bytes x AP_SLAB * m rows): mx the stream (bf16: xs, [x | aux];
    // int8: xq), mr the raw ring as (total_cap * B) rows (kernel_size 3),
    // ma the int8 path's aux rows (xa)
    CUtensorMap mx, mr, ma;
    ApStream sg;
    // the streamed gate's epilogue operands, f32 in channel order
    // ([sigmoid R | tanh R] per layer): bf16 zb = dil_b + aux_b; int8 aux_b,
    // dil_b and the column scales of each int8 product (L, 2 or 3, 2R)
    const float* zb;
    const float* auxb;
    const float* dilb;
    const float* gsc;
    // packed per unit: [L][G] runs.  bf16: [K/16][ntu][16][16] tiles, then
    // the unit's cw f32 biases.  int8 gate and res: per segment
    // [K/32][ntu][512] bytes (unit_pack_i8), then (gate) the aux rows'
    // bf16 tiles [Ap/16][cw/16][16][16], then the f32 column scales
    // [segs][quarters * cw] and biases (gate: aux_b, dil_b; res: its own)
    const unsigned char* w[AP_NSTAGES];
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
    // int8 only: the stream at the next layer's scale and the gate at
    // 1/127, rows of q_ld bytes (R + AP_QPAD); the step's aux column (bf16,
    // rows of xa_ld elements); the activation scales and their reciprocals
    // (L), the gate's scale and its reciprocal
    signed char* xq;
    signed char* gq;
    bf16* xa;
    const float* ascale;
    const float* ainv;
    float gscale, ginv;
    int q_ld, xa_ld;
    int B, Mt, R, S, Q, A, Ap, L, h_T, T0, max_n, sampling, xs_ld, gs_ld, s_ld;
    unsigned long long seed;
    ApStage st[AP_NSTAGES];
    // shared memory: two weight buffers, the A rows, the warps' sums, the
    // epilogue's operands
    int smem_w[2], smem_a, smem_p, smem_e;
    // the arrival counters, [AP_SAMPLE + 1] from AP_CTR0: ctr[T] counts
    // stage T's units that have written their rows
    unsigned* ctr;
    // null, or two u64 the launch adds its waits and its ready waits to
    unsigned long long* waits;
    // phase times (null: off): per block AP_PH u64, see wn_ar_phase_slots
    unsigned long long* phase;
    // the gate's half width (the mu-law model: R); the MoL instances' head
    // (M logistics: logits, means and log-scales in logits' first 3M
    // columns), the output and skip scales and the log-scales' floor, and
    // null or a u64 their sampler adds its clamped draws to.  ids and
    // samples then hold float samples: ids (B, 1), samples (B, max_n)
    int G, M;
    float rscale, sscale, lsmin;
    unsigned long long* clamped;
};

// phase-time slots per block: per stage type (the four weighted ones, then
// the sample stage) asking for operands, waiting for them, the products,
// the epilogue, the stages with a unit, the units (ns sums and counts);
// then the counter waits (ns) and their count
#define AP_PH_STAGE 6
#define AP_PH (5 * AP_PH_STAGE + 2)

// One waiting thread's count of its counter waits: all, those whose first
// poll found the target reached, and (phase times on) their nanoseconds.
struct ApWaits {
    unsigned long long n, ready, ns;
};

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

// The sample stage's units: AP_SROWS rows each, a warp a row; a block
// takes a contiguous run of them, as of a weighted stage.
static __device__ __forceinline__ int sample_units(const ApArgs& a) {
    return (a.B + AP_SROWS - 1) / AP_SROWS;
}

// One thread: wait until stage T's units (AP_SAMPLE: its AP_SROWS-row
// units) have arrived from `runs` runs of the stage, counted in w.
static __device__ void wait_stage(const ApArgs& a, int T, unsigned runs, ApWaits& w) {
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    const unsigned units = T == AP_SAMPLE ? sample_units(a) : a.st[T].units;
    const unsigned polls = wait_counter(a.ctr + T, AP_CTR0 + runs * units);
    w.n += 1;
    w.ready += polls == 0;
    if (a.phase != nullptr) w.ns += now_ns() - t0;
}

// The workers after a unit of stage T: each writer's fence (the next
// stages' bulk copies read what it wrote), then one arrival.
static __device__ __forceinline__ void arrive_stage(const ApArgs& a, int T) {
    fence_proxy_async();
    consumers_sync();
    if (threadIdx.x == 0) arrive_counter(a.ctr + T);
}

// Thread 0: the weight slice of column group grp of stage T at layer l into
// buffer T & 1 (one packed run, one bulk copy).
static __device__ void fetch_w(const ApArgs& a, unsigned char* smem, ApBars& bars,
                               int T, int l, int grp) {
    const ApStage& s = a.st[T];
    const unsigned char* src = a.w[T] + ((size_t)l * s.G + grp) * s.run;
    uint64_t* bar = bars.bar + (T & 1);
    mbar_expect(bar, (unsigned)s.run);
    bulk_copy(smem + a.smem_w[T & 1], src, (unsigned)s.run, bar);
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

// clip(round_half_even(v), -127, 127): torch.round / jnp.round semantics
static __device__ __forceinline__ signed char quant_i8(float v) {
    return (signed char)max(-127, min(127, __float2int_rn(v)));
}

// Four 8 x 16-byte matrices from shared memory (lanes 8i .. 8i + 7 give
// matrix i's row addresses; register i holds matrix i).
static __device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c (16 x 8 s32) += a (16 x 32 s8, row) @ b (32 x 8 s8, col)
static __device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                              unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The embed of row b for position p from its K ids and the step's aux
// column h_up[b, p] in bf16.  bf16: out = ((causal_b + w_0) + w_1) (+ w_2)
// in f32 and bf16, the aux column after the stream (the gate's extra K).
// Q8: out = ((w_0 + w_1) (+ w_2)) + causal_b (the JAX kernel's one-hot
// product, then the bias) in f32 and as int8 at layer 0's scale, the aux
// column in its own rows.  One warp, a lane 8 channels at a time (16-byte
// loads of the embedding rows, all issued before the sums).
template <int KS, bool Q8>
static __device__ void embed_row(const ApArgs& a, int b, const int* id, int p,
                                 int lane) {
    const int R = a.R, Q = a.Q, W = a.xs_ld;
    const bf16* w[KS];
#pragma unroll
    for (int j = 0; j < KS; ++j)
        w[j] = a.causal_w + ((size_t)j * Q + ((id[j] % Q) + Q) % Q) * R;
    const float inv0 = Q8 ? __ldg(a.ainv) : 0.f;
    for (int r = 8 * lane; r < R; r += 256) {
        uint4 e[KS];
#pragma unroll
        for (int j = 0; j < KS; ++j) e[j] = __ldg((const uint4*)(w[j] + r));
        const float4 c0 = __ldg((const float4*)(a.causal_b + r));
        const float4 c1 = __ldg((const float4*)(a.causal_b + r + 4));
        const float cb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float x[KS];
#pragma unroll
            for (int j = 0; j < KS; ++j) {
                const unsigned u2 = i < 2 ? e[j].x : i < 4 ? e[j].y : i < 6 ? e[j].z : e[j].w;
                const float2 f = bits_bf2(u2);
                x[j] = i & 1 ? f.y : f.x;
            }
            if constexpr (Q8) {
                v[i] = x[0];
#pragma unroll
                for (int j = 1; j < KS; ++j) v[i] = __fadd_rn(v[i], x[j]);
                v[i] = __fadd_rn(v[i], cb[i]);
            } else {
                v[i] = cb[i];
#pragma unroll
                for (int j = 0; j < KS; ++j) v[i] += x[j];
            }
        }
        float4* of = (float4*)(a.of + (size_t)b * R + r);
        of[0] = make_float4(v[0], v[1], v[2], v[3]);
        of[1] = make_float4(v[4], v[5], v[6], v[7]);
        if constexpr (Q8) {
            unsigned q[2] = {0u, 0u};
#pragma unroll
            for (int i = 0; i < 8; ++i)
                q[i / 4] |= (unsigned)(unsigned char)quant_i8(__fmul_rn(v[i], inv0))
                            << (8 * (i % 4));
            *(uint2*)(a.xq + (size_t)b * a.q_ld + r) = make_uint2(q[0], q[1]);
        } else {
            *(uint4*)(a.xs + (size_t)b * W + r) =
                make_uint4(bf2_bits(v[0], v[1]), bf2_bits(v[2], v[3]),
                           bf2_bits(v[4], v[5]), bf2_bits(v[6], v[7]));
        }
    }
    const float* hp = a.h_up + ((size_t)b * a.h_T + p) * a.A;
    bf16* aux = Q8 ? a.xa + (size_t)b * a.xa_ld : a.xs + (size_t)b * W + R;
    for (int i = lane; i < a.A; i += 32) aux[i] = f2bf(hp[i]);
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
template <int KS, int T, bool MOL>
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
                // read of the unit precedes the workers' barrier before this
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
            float nv = v + old;
            if constexpr (MOL) {
                // the skip sum s_0, then (sum + s_l) sqrt(0.5) (r9y9's
                // legacy form); the stream (res + x) sqrt(0.5)
                if (col >= S) nv *= a.rscale;
                else if (l > 0) nv *= a.sscale;
            }
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
// unit asks for its own only where its column group changes, before its
// wait.  Under counter waits (CW) thread 0 then waits until stage Tw's
// units have arrived from `runs` runs; the workers sync, and the unit asks
// for its A rows, then (its first unit) for the block's first unit's
// weights of the next stage (Tn at layer ln; Tn < 0: none), and its
// epilogue operands.  After its epilogue the unit arrives on its stage's
// counter.  A block with no unit asks for the next stage's weights and
// waits for nothing.
template <int KS, int T, bool CW, bool MOL>
static __device__ void wstage(const ApArgs& a, ApBars& bars, int l, int p,
                              int Tn, int ln, int Tw, unsigned runs, ApWaits& w) {
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
        // the previous unit's tiles, sums and operands are consumed (the
        // workers synced after it; so did the previous stage's last unit)
        if (threadIdx.x == 0) {
            if (ph) t[0] = now_ns();
            if (fetch) fetch_w(a, smem, bars, T, l, grp);
            if constexpr (CW) {
                const unsigned long long ns = w.ns;
                wait_stage(a, Tw, runs, w);
                if (ph) t[0] += w.ns - ns;   // the wait is counted apart
            }
        }
        consumers_sync();   // every worker after the acquire
        // the A rows first: the next stage's weights are needed a stage later
        if (warp == 0) {
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
        consumers_sync();
        if (ph) t[3] = now_ns();
        epilogue<KS, T, MOL>(a, Ps, Es, eb, l, p, grp, r0, n, rows, cols, ks, s.cw);
        // the unit's tiles, sums and operands are consumed before the next
        // unit's copies land (under waits: the arrival's sync)
        if constexpr (CW) arrive_stage(a, T);
        else consumers_sync();
        if (ph) {
            t[4] = now_ns();
            for (int i = 0; i < 4; ++i) ph[i] += t[i + 1] - t[i];
            ph[5] += 1;
        }
    }
    if (ph) ph[4] += 1;
    // under grid barriers: the next stages' bulk copies read what this
    // stage wrote
    if constexpr (!CW) fence_proxy_async();
}

// ---- int8: the gate and res stages -------------------------------------

// Warp 0: ask for int8 unit u's A rows (lane 0 makes the A barrier's one
// arrival, expecting every byte, before the copies): part 0, the stage's
// int8 rows (xq or gq, q_ld bytes each) as one bulk copy; for the gate at
// kernel_size 3 part 1, the two lagged int8 ring rows of each row (rows of
// 2R + AP_QPAD bytes: lag d, then lag 2d), row by row; for the gate part
// 2, the aux rows (bf16, xa_ld elements each) as one bulk copy.
template <int KS, int T>
static __device__ void issue_a_q8(const ApArgs& a, unsigned char* smem, ApBars& bars,
                                  int l, int p, int u, int lane) {
    const ApStage& s = a.st[T];
    int grp, r0, rows, n;
    unit_rows(a, s, u, &grp, &r0, &rows, &n);
    const int R = a.R, rmax = 16 * s.mt, ld1 = 2 * R + AP_QPAD;
    unsigned bytes = (unsigned)n * a.q_ld;
    if (T == AP_GATE) bytes += (unsigned)n * a.xa_ld * 2;
    if (KS == 3 && T == AP_GATE) bytes += (unsigned)n * 2 * R;
    uint64_t* bar = bars.bar + 2;
    if (lane == 0) mbar_expect(bar, bytes);
    __syncwarp();
    unsigned char* As = smem + a.smem_a;
    unsigned char* A1 = As + (size_t)rmax * a.q_ld;
    if (lane == 0) {
        const signed char* src = T == AP_GATE ? a.xq : a.gq;
        bulk_copy(As, src + (size_t)r0 * a.q_ld, (unsigned)n * a.q_ld, bar);
        if (T == AP_GATE)
            bulk_copy(A1 + (KS == 3 ? (size_t)rmax * ld1 : 0),
                      a.xa + (size_t)r0 * a.xa_ld, (unsigned)n * a.xa_ld * 2, bar);
    }
    if constexpr (KS == 3 && T == AP_GATE) {
        const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
        const int cap = 2 * d;
        const signed char* ring = (const signed char*)a.ring;
        for (int i = lane; i < 2 * n; i += 32) {
            const int j = i / n, m = i - j * n;
            const int slot = o + ((p - (j + 1) * d) % cap + cap) % cap;
            bulk_copy(A1 + (size_t)m * ld1 + j * R,
                      ring + ((size_t)slot * a.B + r0 + m) * R, R, bar);
        }
    }
}

// The int32 sum of column col of row ml of segment seg over the warps' K
// slices (exact, any order), dequantized by sc (activation scale x column
// scale) as the plain version does: one f32 product.
static __device__ __forceinline__ float dq(const int* Ps, int seg, int ks, int rows,
                                          int cols, int ml, int col, float sc) {
    int v = 0;
    for (int k = 0; k < ks; ++k) v += Ps[((size_t)(seg * ks + k) * rows + ml) * cols + col];
    return __fmul_rn((float)v, sc);
}

// The epilogue of an int8 unit: rows [r0, r0 + n) of column group grp; the
// int32 sums in Ps ([segs][ks][rows][cols]), the gate's aux sums in Pa
// ([rows][cw] f32), the column scales sc ([segs][cols]) and biases eb after
// them, the per-row operands in Es (fetch_e).  f32 sums in the plain
// version's order (ops/ar_kernel.py::ar_step_logits), no FMA contraction.
template <int KS, int T>
static __device__ void epilogue_q8(const ApArgs& a, const int* Ps, const float* Pa,
                                   const unsigned char* Es, const float* sc,
                                   const float* eb, int l, int p, int grp, int r0,
                                   int n, int rows, int cols, int ks, int cw) {
    const int R = a.R, S = a.S;
    if constexpr (T == AP_GATE) {
        const int hc = cw / 2;
        const float as = __ldg(a.ascale + l);
        bf16* slot = nullptr;
        if constexpr (KS == 2) {
            const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
            slot = a.ring + ((size_t)o + p % d) * a.B * 2 * R;
        }
        for (int e = threadIdx.x; e < n * hc; e += AP_THREADS) {
            const int ml = e / hc, ci = e - ml * hc, jt = ci >> 3, ii = ci & 7;
            const int b = r0 + ml, c = grp * hc + ci;
            const int cs = jt * 16 + ii, ct = cs + 8;
            // za = aux product + aux_b; z = cur + ((past + za) + dil_b)
            const float za_s = __fadd_rn(Pa[(size_t)ml * cw + cs], eb[ci]);
            const float za_t = __fadd_rn(Pa[(size_t)ml * cw + ct], eb[hc + ci]);
            float ps, pt;
            if constexpr (KS == 2) {
                // the ring tap this block read before the products, then the
                // projection for step p + d over it
                const bf16* tap = (const bf16*)Es + (size_t)ml * cw;
                ps = bf2f(tap[ci]);
                pt = bf2f(tap[hc + ci]);
                bf16* rr = slot + (size_t)b * 2 * R;
                rr[c] = f2bf(dq(Ps, 0, ks, rows, cols, ml, cw + cs,
                                __fmul_rn(as, sc[cw + cs])));
                rr[R + c] = f2bf(dq(Ps, 0, ks, rows, cols, ml, cw + ct,
                                    __fmul_rn(as, sc[cw + ct])));
            } else {
                ps = __fadd_rn(dq(Ps, 1, ks, rows, cols, ml, cs, __fmul_rn(as, sc[cols + cs])),
                               dq(Ps, 2, ks, rows, cols, ml, cs, __fmul_rn(as, sc[2 * cols + cs])));
                pt = __fadd_rn(dq(Ps, 1, ks, rows, cols, ml, ct, __fmul_rn(as, sc[cols + ct])),
                               dq(Ps, 2, ks, rows, cols, ml, ct, __fmul_rn(as, sc[2 * cols + ct])));
            }
            const float zs = __fadd_rn(dq(Ps, 0, ks, rows, cols, ml, cs, __fmul_rn(as, sc[cs])),
                                       __fadd_rn(__fadd_rn(ps, za_s), eb[cw + ci]));
            const float zt = __fadd_rn(dq(Ps, 0, ks, rows, cols, ml, ct, __fmul_rn(as, sc[ct])),
                                       __fadd_rn(__fadd_rn(pt, za_t), eb[cw + hc + ci]));
            a.gq[(size_t)b * a.q_ld + c] = quant_i8(__fmul_rn(wn_gate(zs, zt), a.ginv));
        }
    } else {
        const bool last = l == a.L - 1;
        const float inv = __ldg(a.ainv + l), inv_next = last ? 0.f : __ldg(a.ainv + l + 1);
        signed char* slot = nullptr;
        if constexpr (KS == 3) {
            const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
            slot = (signed char*)a.ring + ((size_t)o + p % (2 * d)) * a.B * R;
        }
        for (int e = threadIdx.x; e < n * cw; e += AP_THREADS) {
            const int ml = e / cw, jj = e - ml * cw;
            const int b = r0 + ml, col = grp * cw + jj;
            const float v = __fadd_rn(dq(Ps, 0, ks, rows, cols, ml, jj,
                                         __fmul_rn(a.gscale, sc[jj])), eb[jj]);
            const float old = col < S && l == 0
                ? 0.f : ((const float*)Es)[(size_t)ml * cw + jj];
            const float nv = __fadd_rn(v, old);
            if (col < S) {
                a.skip[(size_t)b * S + col] = nv;
                if (last) a.sr[(size_t)b * a.s_ld + col] = f2bf(fmaxf(nv, 0.f));
            } else {
                const int j = col - S;
                a.of[(size_t)b * R + j] = nv;
                if (!last) a.xq[(size_t)b * a.q_ld + j] = quant_i8(__fmul_rn(nv, inv_next));
                // the layer's int8 input row, as its gate quantized it
                if constexpr (KS == 3) slot[(size_t)b * R + j] = quant_i8(__fmul_rn(old, inv));
            }
        }
    }
}

// One int8 weighted stage (gate or res): the run of units, the prefetch,
// the waits and the arrivals as in wstage.  Per unit, warp tasks of
// (16-column tile, segment, K slice) over the unit's row tiles, each a
// chain of mma.sync m16n8k32 on ldmatrix fragments; then (gate) the aux
// product, a task per 16 x 16 tile, by wmma bf16.
template <int KS, int T, bool CW>
static __device__ void wstage_q8(const ApArgs& a, ApBars& bars, int l, int p,
                                 int Tn, int ln, int Tw, unsigned runs, ApWaits& w) {
    extern __shared__ __align__(128) unsigned char smem[];
    const ApStage& s = a.st[T];
    constexpr int buf = T & 1;
    const int u0 = unit_begin(s.units, blockIdx.x);
    const int u1 = unit_begin(s.units, blockIdx.x + 1);
    if (u0 >= u1) {
        if (threadIdx.x == 0) prefetch(a, smem, bars, Tn, ln);
        return;
    }
    const int R = a.R, cols = s.quarters * s.cw, ntu = cols / 16, KC = s.K / 32;
    const int ks = s.ks, segs = s.segs, rmax = 16 * s.mt, ld0 = a.q_ld;
    const int ld1 = 2 * R + AP_QPAD;
    const unsigned char* As = smem + a.smem_a;
    const unsigned char* A1 = As + (size_t)rmax * ld0;
    const bf16* A2 = (const bf16*)(A1 + (KS == 3 && T == AP_GATE ? (size_t)rmax * ld1 : 0));
    const unsigned char* Ws = smem + a.smem_w[buf];
    const bf16* Wa = (const bf16*)(Ws + (size_t)segs * s.K * cols);
    const float* sc = (const float*)(T == AP_GATE ? (const unsigned char*)(Wa + (size_t)a.Ap * s.cw)
                                                  : (const unsigned char*)Wa);
    const float* eb = sc + segs * cols;
    int* Ps = (int*)(smem + a.smem_p);
    float* Pa = (float*)(Ps + (size_t)segs * ks * rmax * cols);
    unsigned char* Es = smem + a.smem_e;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned long long* ph = a.phase != nullptr && threadIdx.x == 0
        ? a.phase + (size_t)blockIdx.x * AP_PH + T * AP_PH_STAGE : nullptr;
    unsigned long long t[5] = {0, 0, 0, 0, 0};
    int have = -1;
    for (int u = u0; u < u1; ++u) {
        int grp, r0, rows, n;
        unit_rows(a, s, u, &grp, &r0, &rows, &n);
        const bool fetch = u != u0 && grp != have;
        if (threadIdx.x == 0) {
            if (ph) t[0] = now_ns();
            if (fetch) fetch_w(a, smem, bars, T, l, grp);
            if constexpr (CW) {
                const unsigned long long ns = w.ns;
                wait_stage(a, Tw, runs, w);
                if (ph) t[0] += w.ns - ns;   // the wait is counted apart
            }
        }
        consumers_sync();   // every worker after the acquire
        // the A rows first: the next stage's weights are needed a stage later
        if (warp == 0) {
            issue_a_q8<KS, T>(a, smem, bars, l, p, u, lane);
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
        // this lane's ldmatrix row: A rows lane & 15 at k byte 16 (lane >> 4);
        // B: matrix lane / 8 of the 512-byte block, row lane % 8
        const int arow = lane & 15, acol = (lane >> 4) * 16;
        for (int task = warp; task < ntu * segs * ks; task += AP_WARPS) {
            const int nt = task % ntu, rest = task / ntu;
            const int seg = rest % segs, ksi = rest / segs;
            const int cb = ksi * KC / ks, ce = (ksi + 1) * KC / ks;
            const unsigned char* Aa = seg == 0 ? As : A1 + (seg - 1) * R;
            const int lda = seg == 0 ? ld0 : ld1;
            const unsigned char* Wb = Ws + (size_t)seg * s.K * cols + nt * 512 + lane * 16;
            const unsigned char* Ap0 = Aa + (size_t)arow * lda + acol;
            int acc[AP_ACC][2][4];
#pragma unroll
            for (int h = 0; h < AP_ACC; ++h)
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[h][q][i] = 0;
            if (mtu == 1) {
                // AP_ACC independent sums, one per k chunk phase
                for (int c0 = cb; c0 < ce; c0 += AP_ACC) {
#pragma unroll
                    for (int h = 0; h < AP_ACC; ++h) {
                        const int c = c0 + h;
                        if (c < ce) {
                            unsigned b[4], fa[4];
                            ldsm_x4(b, Wb + (size_t)c * ntu * 512);
                            ldsm_x4(fa, Ap0 + c * 32);
                            mma_s8(acc[h][0], fa, b[0], b[1]);
                            mma_s8(acc[h][1], fa, b[2], b[3]);
                        }
                    }
                }
#pragma unroll
                for (int h = 1; h < AP_ACC; ++h)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int i = 0; i < 4; ++i) acc[0][q][i] += acc[h][q][i];
            } else {
#pragma unroll 2
                for (int c = cb; c < ce; ++c) {
                    unsigned b[4];
                    ldsm_x4(b, Wb + (size_t)c * ntu * 512);
#pragma unroll
                    for (int i = 0; i < AP_ACC; ++i) {
                        if (i < mtu) {
                            unsigned fa[4];
                            ldsm_x4(fa, Ap0 + (size_t)i * 16 * lda + c * 32);
                            mma_s8(acc[i][0], fa, b[0], b[1]);
                            mma_s8(acc[i][1], fa, b[2], b[3]);
                        }
                    }
                }
            }
            // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: row + 8
            int* P = Ps + (size_t)(seg * ks + ksi) * rows * cols;
            const int gr = lane >> 2, gc = 2 * (lane & 3);
#pragma unroll
            for (int i = 0; i < AP_ACC; ++i) {
                if (i < mtu) {
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        int* o = P + (size_t)(i * 16 + gr) * cols + nt * 16 + q * 8 + gc;
                        o[0] = acc[i][q][0];
                        o[1] = acc[i][q][1];
                        o[8 * cols] = acc[i][q][2];
                        o[8 * cols + 1] = acc[i][q][3];
                    }
                }
            }
        }
        if constexpr (T == AP_GATE) {
            // the aux term: [aux rows] @ [auxw] over the current tap's cw columns
            const int nta = s.cw / 16, KA = a.Ap / 16;
            for (int task = warp; task < nta * mtu; task += AP_WARPS) {
                const int nt = task % nta, i = task / nta;
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
                wmma::fill_fragment(acc, 0.f);
                for (int kt = 0; kt < KA; ++kt) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                    wmma::load_matrix_sync(bw, Wa + ((size_t)kt * nta + nt) * 256, 16);
                    wmma::load_matrix_sync(fa, A2 + (size_t)i * 16 * a.xa_ld + kt * 16, a.xa_ld);
                    wmma::mma_sync(acc, fa, bw, acc);
                }
                wmma::store_matrix_sync(Pa + (size_t)i * 16 * s.cw + nt * 16, acc, s.cw,
                                        wmma::mem_row_major);
            }
        }
        cp_async_wait();
        consumers_sync();
        if (ph) t[3] = now_ns();
        epilogue_q8<KS, T>(a, Ps, Pa, Es, sc, eb, l, p, grp, r0, n, rows, cols, ks, s.cw);
        // the unit's tiles, sums and operands are consumed before the next
        // unit's copies land (under waits: the arrival's sync)
        if constexpr (CW) arrive_stage(a, T);
        else consumers_sync();
        if (ph) {
            t[4] = now_ns();
            for (int i = 0; i < 4; ++i) ph[i] += t[i + 1] - t[i];
            ph[5] += 1;
        }
    }
    if (ph) ph[4] += 1;
    // under grid barriers: the next stages' bulk copies read what this
    // stage wrote
    if constexpr (!CW) fence_proxy_async();
}

// ---- the streamed gate stage ------------------------------------------------

// order this thread's generic-proxy accesses of shared memory before later
// async-proxy writes to it (the streamed gate's TMA into a ring that lies
// over the other stages' regions)
static __device__ __forceinline__ void fence_proxy_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a thread's place in the ring: the stage and the parity of its next use
struct ApRing {
    int stage;
    unsigned phase;
};

static __device__ __forceinline__ void ring_next(ApRing& r, int stages) {
    if (++r.stage == stages) { r.stage = 0; r.phase ^= 1; }
}

// The units block blockIdx.x takes in the streamed gate stage, and unit u's
// column group and first row (units column group major, as wstage's).
static __device__ __forceinline__ void stream_unit(const ApStream& s, int u, int* grp,
                                                   int* r0) {
    *grp = u / s.rb;
    *r0 = (u - *grp * s.rb) * AP_SLAB * s.m;
}

// The producer (one lane of the extra warp): for each of the block's units
// and each K chunk, wait for the ring stage to be free, then one TMA load
// of the chunk's A tile (the stream, a lagged ring slot, or the int8 aux
// rows) and one bulk copy of its W tile (the unit's packed run holds the
// chunks' tiles in order, swizzled as TMA would), completing on the
// stage's full barrier.
template <int KS, bool Q8>
static __device__ void gate_produce(const ApArgs& a, unsigned char* ring, uint64_t* full,
                                    uint64_t* empty, ApRing& rp, int l, int p) {
    const ApStream& s = a.sg;
    const int u0 = unit_begin(s.units, blockIdx.x), u1 = unit_begin(s.units, blockIdx.x + 1);
    int o = 0, d = 1;
    if constexpr (KS == 3) {
        o = __ldg(a.meta + 2 * l);
        d = __ldg(a.meta + 2 * l + 1);
    }
    constexpr int XE = Q8 ? AP_CHUNK : AP_CHUNK / 2;   // elements of a chunk
    const int sb = s.a_bytes + s.w_bytes;
    for (int u = u0; u < u1; ++u) {
        int grp, r0;
        stream_unit(s, u, &grp, &r0);
        const unsigned char* w = a.w[AP_GATE] + ((size_t)l * s.G + grp) * s.run;
        for (int c = 0; c < s.nc; ++c) {
            wg_wait(&empty[rp.stage], rp.phase ^ 1);
            unsigned char* st = ring + (size_t)rp.stage * sb;
            uint64_t* bar = &full[rp.stage];
            mbar_expect(bar, (unsigned)sb);
            if (c < s.nx) {
                tma_load_2d(st, &a.mx, bar, c * XE, r0);
            } else if (KS == 3 && c < s.nx + 2 * s.nl) {
                // lag j d: slot (p - j d) mod 2d of the layer, B rows from r0
                const int j = (c - s.nx) / s.nl, cc = c - s.nx - j * s.nl;
                const int slot = o + ((p - (j + 1) * d) % (2 * d) + 2 * d) % (2 * d);
                tma_load_2d(st, &a.mr, bar, cc * XE, slot * a.B + r0);
            } else {
                tma_load_2d(st, &a.ma, bar, (c - s.nx - 2 * s.nl) * (AP_CHUNK / 2), r0);
            }
            bulk_copy(st + s.a_bytes, w + (size_t)c * s.w_bytes, (unsigned)s.w_bytes, bar);
            ring_next(rp, s.stages);
        }
    }
}

template <int N>
static __device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t da,
                                                uint64_t db) {
    if constexpr (N == 16) wgmma_bf16_n16(d, da, db, 1);
    else if constexpr (N == 32) wgmma_bf16_n32(d, da, db, 1);
    else if constexpr (N == 64) wgmma_bf16_n64(d, da, db, 1);
    else wgmma_128<0, 0>(d, da, db, 1);
}

template <int N>
static __device__ __forceinline__ void mma_s8x(int (&d)[N / 2], uint64_t da, uint64_t db) {
    if constexpr (N == 16) wgmma_s8_n16(d, da, db, 1);
    else if constexpr (N == 32) wgmma_s8_n32(d, da, db, 1);
    else if constexpr (N == 64) wgmma_s8_n64(d, da, db, 1);
    else wgmma_s8_n128(d, da, db, 1);
}

// the four k steps of one 128-byte chunk: A (64 rows) and B (N rows), both
// K-major tiles of 128-byte rows in the 128-byte swizzle
template <int N>
static __device__ __forceinline__ void chunk_bf16(float (&d)[N / 2], const unsigned char* sa,
                                                  const unsigned char* sb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_bf16<N>(d, wg_operand<0>(sa, kk), wg_operand<0>(sb, kk));
}

template <int N>
static __device__ __forceinline__ void chunk_s8(int (&d)[N / 2], const unsigned char* sa,
                                                const unsigned char* sb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_s8x<N>(d, wg_operand<0>(sa, kk), wg_operand<0>(sb, kk));
}

static __device__ __forceinline__ void st_bf2(bf16* p, float lo, float hi) {
    *(uint32_t*)p = bf2_bits(lo, hi);
}

// The consumers (the two warpgroups of the workers): per unit, the K
// chunks from the ring through wgmma into registers (bf16: one f32 sum;
// int8: an s32 sum per int8 product and an f32 sum of the aux product),
// then the gate from the registers.  Accumulator d[4 j + e] of a thread is
// row (warp % 4) * 16 + lane / 4 (+ 8 for e >= 2) of its slab, column
// 8 j + 2 (lane % 4) + (e & 1) of its NW: per 16 columns 8 sigmoid then
// the same 8 channels' tanh (pack_ar_weights' interleave), so the thread
// holds both of each of its channels; at kernel_size 2 the past tap's NW/2
// columns follow the current tap's, in the same order.
template <int KS, bool Q8, int NW, bool MOL>
static __device__ void gate_consume(const ApArgs& a, unsigned char* ring, uint64_t* full,
                                    uint64_t* empty, ApRing& rp, int l, int p) {
    const ApStream& s = a.sg;
    const int u0 = unit_begin(s.units, blockIdx.x), u1 = unit_begin(s.units, blockIdx.x + 1);
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int R = a.R, sb = s.a_bytes + s.w_bytes;
    constexpr int CWP = KS == 2 ? NW / 2 : NW;   // the warpgroup's gate columns
    constexpr int NQ = CWP / 16;                 // its groups of 8 channels
    constexpr int NA = NW / 2;                   // a sum's accumulators
    const int row_in = (warp & 3) * 16 + (lane >> 2);
    unsigned long long* ph = a.phase != nullptr && threadIdx.x == 0
        ? a.phase + (size_t)blockIdx.x * AP_PH + AP_GATE * AP_PH_STAGE : nullptr;
    unsigned long long t[5] = {0, 0, 0, 0, 0};
    bf16* slot = nullptr;      // kernel_size 2: the ring slot read and written
    if constexpr (KS == 2) {
        const int o = __ldg(a.meta + 2 * l), d = __ldg(a.meta + 2 * l + 1);
        slot = a.ring + ((size_t)o + p % d) * a.B * 2 * R;
    }
    for (int u = u0; u < u1; ++u) {
        if (ph) t[0] = now_ns();
        int grp, r0;
        stream_unit(s, u, &grp, &r0);
        const int rbase = r0 + (s.m == 2 ? wg * AP_SLAB : 0) + row_in;
        // this thread's first channel: 8 q + {0, 1} on from it per group q
        const int chb = grp * (s.cw / 2) + (s.m == 1 ? wg * (s.cw / 4) : 0)
                      + 2 * (lane & 3);
        // the epilogue's operands read from device memory before the
        // products: kernel_size 2's ring taps (the projections written d
        // steps ago), bf16's biases
        uint32_t tap[NQ][2][2];
        float2 bias[NQ][2];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int ch = chb + 8 * q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int b = rbase + 8 * h;
                if (KS == 2 && b < a.B) {
                    const bf16* rr = slot + (size_t)b * 2 * R + ch;
                    tap[q][h][0] = *(const uint32_t*)rr;
                    tap[q][h][1] = *(const uint32_t*)(rr + R);
                } else {
                    tap[q][h][0] = tap[q][h][1] = 0u;
                }
            }
            if constexpr (!Q8) {
                // zb is [sigmoid | tanh] of the gate's half width
                const int GW = MOL ? a.G : R;
                bias[q][0] = __ldg((const float2*)(a.zb + (size_t)l * 2 * GW + ch));
                bias[q][1] = __ldg((const float2*)(a.zb + (size_t)l * 2 * GW + GW + ch));
            }
        }
        if (ph) t[1] = now_ns();
        // the sums: bf16 acc; int8 the current tap (and at kernel_size 3
        // the lags d, 2d) in s32, the aux product in f32
        float acc[NA];
        int q0[NA], q1[KS == 3 && Q8 ? NA : 1], q2[KS == 3 && Q8 ? NA : 1];
#pragma unroll
        for (int i = 0; i < NA; ++i) { acc[i] = 0.f; q0[i] = 0; }
        if constexpr (KS == 3 && Q8) {
#pragma unroll
            for (int i = 0; i < NA; ++i) { q1[i] = 0; q2[i] = 0; }
        }
        int prev = -1;
        for (int c = 0; c < s.nc; ++c) {
            wg_wait(&full[rp.stage], rp.phase);
            if (ph && c == 0) t[2] = now_ns();
            const unsigned char* st = ring + (size_t)rp.stage * sb;
            const unsigned char* sa = st + (s.m == 2 ? wg * AP_SLAB * AP_CHUNK : 0);
            const unsigned char* sw = st + s.a_bytes + (s.m == 1 ? wg * NW * AP_CHUNK : 0);
            wgmma_fence();
            if constexpr (!Q8) {
                chunk_bf16<NW>(acc, sa, sw);
            } else if constexpr (KS == 3) {
                if (c < s.nx) chunk_s8<NW>(q0, sa, sw);
                else if (c < s.nx + s.nl) chunk_s8<NW>(q1, sa, sw);
                else if (c < s.nx + 2 * s.nl) chunk_s8<NW>(q2, sa, sw);
                else chunk_bf16<NW>(acc, sa, sw);
            } else {
                if (c < s.nx) chunk_s8<NW>(q0, sa, sw);
                else chunk_bf16<NW>(acc, sa, sw);
            }
            wgmma_commit();
            if (prev >= 0) {
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(&empty[prev]);
            }
            prev = rp.stage;
            ring_next(rp, s.stages);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[prev]);
        if (ph) t[3] = now_ns();

        const float as = Q8 ? __ldg(a.ascale + l) : 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int ch = chb + 8 * q;
            const int js = 2 * q, jt = js + 1;       // its sigmoid and tanh columns
            const int ps_ = CWP / 8 + js, pt_ = ps_ + 1;   // kernel_size 2: the past tap's
            float2 ab[2], db[2], sc[3][2];
            if constexpr (Q8) {
                const size_t r = (size_t)l * 2 * R + ch;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    ab[e] = __ldg((const float2*)(a.auxb + r + e * R));
                    db[e] = __ldg((const float2*)(a.dilb + r + e * R));
                }
                constexpr int NSEG = KS == 2 ? 2 : 3;
#pragma unroll
                for (int g = 0; g < NSEG; ++g)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        sc[g][e] = __ldg((const float2*)(a.gsc + ((size_t)l * NSEG + g) * 2 * R
                                                         + e * R + ch));
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int b = rbase + 8 * h;
                if (b >= a.B) continue;
                float g[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int is = 4 * js + 2 * h + e, it = 4 * jt + 2 * h + e;
                    const float tps = KS == 2 ? (e ? bits_bf2(tap[q][h][0]).y
                                                   : bits_bf2(tap[q][h][0]).x) : 0.f;
                    const float tpt = KS == 2 ? (e ? bits_bf2(tap[q][h][1]).y
                                                   : bits_bf2(tap[q][h][1]).x) : 0.f;
                    if constexpr (!Q8) {
                        // (sum + ring tap) + bias, as wstage's epilogue
                        float zs = acc[is], zt = acc[it];
                        if constexpr (KS == 2) { zs += tps; zt += tpt; }
                        const float bs = e ? bias[q][0].y : bias[q][0].x;
                        const float bt = e ? bias[q][1].y : bias[q][1].x;
                        g[e] = wn_gate(zs + bs, zt + bt);
                    } else {
                        // epilogue_q8's order: za = aux + aux_b; z = cur +
                        // ((past + za) + dil_b), each product dequantized by
                        // (activation scale x column scale)
                        const float abs_ = e ? ab[0].y : ab[0].x, abt = e ? ab[1].y : ab[1].x;
                        const float dbs = e ? db[0].y : db[0].x, dbt = e ? db[1].y : db[1].x;
                        const float za_s = __fadd_rn(acc[is], abs_);
                        const float za_t = __fadd_rn(acc[it], abt);
                        float ps, pt;
                        if constexpr (KS == 2) {
                            ps = tps;
                            pt = tpt;
                        } else {
                            ps = __fadd_rn(__fmul_rn((float)q1[is], __fmul_rn(as, e ? sc[1][0].y : sc[1][0].x)),
                                           __fmul_rn((float)q2[is], __fmul_rn(as, e ? sc[2][0].y : sc[2][0].x)));
                            pt = __fadd_rn(__fmul_rn((float)q1[it], __fmul_rn(as, e ? sc[1][1].y : sc[1][1].x)),
                                           __fmul_rn((float)q2[it], __fmul_rn(as, e ? sc[2][1].y : sc[2][1].x)));
                        }
                        const float zs = __fadd_rn(__fmul_rn((float)q0[is], __fmul_rn(as, e ? sc[0][0].y : sc[0][0].x)),
                                                   __fadd_rn(__fadd_rn(ps, za_s), dbs));
                        const float zt = __fadd_rn(__fmul_rn((float)q0[it], __fmul_rn(as, e ? sc[0][1].y : sc[0][1].x)),
                                                   __fadd_rn(__fadd_rn(pt, za_t), dbt));
                        g[e] = __fmul_rn(wn_gate(zs, zt), a.ginv);
                    }
                }
                if constexpr (KS == 2) {
                    // the projection for step p + d over the tap just read
                    // (this thread read it, before the products)
                    bf16* rr = slot + (size_t)b * 2 * R + ch;
                    const int i0 = 4 * ps_ + 2 * h, i1 = 4 * pt_ + 2 * h;
                    if constexpr (!Q8) {
                        st_bf2(rr, acc[i0], acc[i0 + 1]);
                        st_bf2(rr + R, acc[i1], acc[i1 + 1]);
                    } else {
                        st_bf2(rr, __fmul_rn((float)q0[i0], __fmul_rn(as, sc[1][0].x)),
                               __fmul_rn((float)q0[i0 + 1], __fmul_rn(as, sc[1][0].y)));
                        st_bf2(rr + R, __fmul_rn((float)q0[i1], __fmul_rn(as, sc[1][1].x)),
                               __fmul_rn((float)q0[i1 + 1], __fmul_rn(as, sc[1][1].y)));
                    }
                }
                if constexpr (!Q8) {
                    st_bf2(a.gs + (size_t)b * a.gs_ld + ch, g[0], g[1]);
                } else {
                    char2 v;
                    v.x = quant_i8(g[0]);
                    v.y = quant_i8(g[1]);
                    *(char2*)(a.gq + (size_t)b * a.q_ld + ch) = v;
                }
            }
        }
        if (a.phase != nullptr) {
            consumers_sync();   // every thread's epilogue
            if (ph) {
                t[4] = now_ns();
                for (int i = 0; i < 4; ++i) ph[i] += t[i + 1] - t[i];
                ph[5] += 1;
            }
        }
    }
    if (ph && u0 < u1) ph[4] += 1;
}

// The streamed gate stage on the consumers, at the plan's warpgroup width.
template <int KS, bool Q8, bool MOL>
static __device__ void gate_consume_at(const ApArgs& a, unsigned char* ring,
                                       uint64_t* full, uint64_t* empty, ApRing& rp,
                                       int l, int p) {
    switch (a.sg.nw) {
    case 16:   // kernel_size 2 splits a warpgroup's columns between two taps
        if constexpr (KS == 3) gate_consume<KS, Q8, 16, MOL>(a, ring, full, empty, rp, l, p);
        break;
    case 32: gate_consume<KS, Q8, 32, MOL>(a, ring, full, empty, rp, l, p); break;
    case 64: gate_consume<KS, Q8, 64, MOL>(a, ring, full, empty, rp, l, p); break;
    default:   // int8 at kernel_size 3: 64 at most (check_stream)
        if constexpr (!(Q8 && KS == 3)) gate_consume<KS, Q8, 128, MOL>(a, ring, full, empty, rp, l, p);
        break;
    }
}

// The MoL model's embed of row b for position p: x = y w_in + b_in (each
// rounded, as the plain version's) in f32 and bf16, and the step's aux
// column after the stream; one warp, a lane 8 channels at a time.
static __device__ void embed_mol(const ApArgs& a, int b, float y, int p, int lane) {
    const int R = a.R, W = a.xs_ld;
    for (int r = 8 * lane; r < R; r += 256) {
        const uint4 e = __ldg((const uint4*)(a.causal_w + r));
        const float4 c0 = __ldg((const float4*)(a.causal_b + r));
        const float4 c1 = __ldg((const float4*)(a.causal_b + r + 4));
        const float cb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const unsigned u2[4] = {e.x, e.y, e.z, e.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float2 f = bits_bf2(u2[i / 2]);
            v[i] = __fadd_rn(__fmul_rn(y, i & 1 ? f.y : f.x), cb[i]);
        }
        float4* of = (float4*)(a.of + (size_t)b * R + r);
        of[0] = make_float4(v[0], v[1], v[2], v[3]);
        of[1] = make_float4(v[4], v[5], v[6], v[7]);
        *(uint4*)(a.xs + (size_t)b * W + r) =
            make_uint4(bf2_bits(v[0], v[1]), bf2_bits(v[2], v[3]),
                       bf2_bits(v[4], v[5]), bf2_bits(v[6], v[7]));
    }
    const float* hp = a.h_up + ((size_t)b * a.h_T + p) * a.A;
    bf16* aux = a.xs + (size_t)b * W + R;
    for (int i = lane; i < a.A; i += 32) aux[i] = f2bf(hp[i]);
}

// The MoL sampler's uniform j of (row, step): word j % 4 of the
// Philox4x32-10 block of the counter (j / 4, row, step, 1) under the key
// (seed's low word, its high word), as ((bits >> 9) + 0.5) 2^-23 in (0, 1),
// then 1e-5 + (1 - 2e-5) u (r9y9's interval), each operation rounded.
static __device__ __forceinline__ float mol_uniform(unsigned long long seed, int row,
                                                    int step, int j) {
    const uint4 ctr = make_uint4((unsigned)j >> 2, (unsigned)row, (unsigned)step, 1u);
    const uint4 r = philox4x32_10(ctr, make_uint2((unsigned)seed, (unsigned)(seed >> 32)));
    const unsigned w = (j & 3) == 0 ? r.x : (j & 3) == 1 ? r.y : (j & 3) == 2 ? r.z : r.w;
    const float u = ((float)(w >> 9) + 0.5f) * (1.0f / 8388608.0f);
    return __fadd_rn(__fmul_rn(u, 0.99998f), 1e-5f);
}

// One warp: the MoL sample of row b at step `step` from its 3M head outputs
// (logits, means, log-scales): lane j < M takes component j's score, its
// logit (plus the Gumbel noise -log(-log u_j) in sampling mode), the warp
// the argmax (ties to the lowest index, all-NaN scores to 0); the sample is
// the component's mean (greedy) or mu + exp(max(log_s, floor)) (log v -
// log(1 - v)) with v = u_M, clamped to [-1, 1].  Every lane returns it.
static __device__ float mol_sample_row(const ApArgs& a, int b, int step, int lane) {
    const float* lg = a.logits + (size_t)b * a.Q;
    const int M = a.M;
    float best = -INFINITY, v = 0.5f;
    int bi = 0x7fffffff;
    if (lane < M) {
        float sc = __ldcg(lg + lane);
        if (a.sampling) sc += -logf(-logf(mol_uniform(a.seed, b, step, lane)));
        if (sc > best) { best = sc; bi = lane; }
    } else if (lane == M && a.sampling) {
        v = mol_uniform(a.seed, b, step, M);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    v = __shfl_sync(0xffffffffu, v, M);
    const int c = bi < M ? bi : 0;
    float y = __ldcg(lg + M + c);
    if (a.sampling) {
        const float ls = fmaxf(__ldcg(lg + 2 * M + c), a.lsmin);
        y = y + expf(ls) * (logf(v) - logf(1.0f - v));
    }
    return fminf(fmaxf(y, -1.0f), 1.0f);
}

// One warp per row: the argmax of the logits (plus the Gumbel noise in
// sampling mode; ties to the lowest index, all-NaN logits to 0), the ids
// shifted, and, before a next step, its embed and aux column (MOL: the
// MoL sample, mol_sample_row, its clamped draws counted, and its embed).
// Under counter waits (CW), per unit thread 0 first waits until post2's
// units have arrived from step + 1 runs, and the unit then arrives on the
// sample stage's counter.
template <int KS, bool Q8, bool CW, bool MOL>
static __device__ void sample_stage(const ApArgs& a, int step, int p, ApWaits& w) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    const int units = sample_units(a);
    const int u0 = unit_begin(units, blockIdx.x), u1 = unit_begin(units, blockIdx.x + 1);
    unsigned long long waited = 0;
    for (int u = u0; u < u1; ++u) {
        if constexpr (CW) {
            if (threadIdx.x == 0) {
                const unsigned long long ns = w.ns;
                wait_stage(a, AP_POST2, (unsigned)step + 1, w);
                waited += w.ns - ns;
            }
            consumers_sync();
        }
        const int b = u * AP_SROWS + warp;
        if (MOL && b < a.B) {
            const float y = mol_sample_row(a, b, step, lane);
            __syncwarp();
            if (lane == 0) {
                ((float*)a.samples)[(size_t)b * a.max_n + step] = y;
                ((float*)a.ids)[b] = y;
                if (a.clamped != nullptr && fabsf(y) >= 1.0f) atomicAdd(a.clamped, 1ull);
            }
            if (step + 1 < a.max_n) embed_mol(a, b, y, p + 1, lane);
        } else if (b < a.B) {
            // a lane 4 classes at a time (one 16-byte load, one Philox
            // block); the result does not depend on the order
            float best = -INFINITY;
            int bi = 0x7fffffff;
            for (int j0 = 4 * lane; j0 < a.Q; j0 += 128) {
                const float4 lv = __ldcg((const float4*)(a.logits + (size_t)b * a.Q + j0));
                float v[4] = {lv.x, lv.y, lv.z, lv.w};
                if (a.sampling) {
                    float g[4];
                    gumbel_noise4(a.seed, b, step, j0, g);
#pragma unroll
                    for (int i = 0; i < 4; ++i) v[i] += g[i];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (v[i] > best || (v[i] == best && j0 + i < bi)) { best = v[i]; bi = j0 + i; }
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
            if (step + 1 < a.max_n) embed_row<KS, Q8>(a, b, id, p + 1, lane);
        }
        if constexpr (CW) arrive_stage(a, AP_SAMPLE);
    }
    if constexpr (!CW) fence_proxy_async();
    if (a.phase != nullptr && threadIdx.x == 0 && u0 < u1) {
        unsigned long long* ph = a.phase + (size_t)blockIdx.x * AP_PH
                                 + AP_NSTAGES * AP_PH_STAGE;
        ph[3] += now_ns() - t0 - waited;
        ph[4] += 1;
    }
}

// The first step's embed and aux column from the carry's ids, in the
// sample stage's units: the sample stage's first run.
template <int KS, bool Q8, bool CW, bool MOL>
static __device__ void embed_stage(const ApArgs& a) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int units = sample_units(a);
    const int u0 = unit_begin(units, blockIdx.x), u1 = unit_begin(units, blockIdx.x + 1);
    for (int u = u0; u < u1; ++u) {
        const int b = u * AP_SROWS + warp;
        if (MOL && b < a.B) {
            embed_mol(a, b, ((const float*)a.ids)[b], a.T0 - 1, lane);
        } else if (b < a.B) {
            int id[KS];
#pragma unroll
            for (int j = 0; j < KS; ++j) id[j] = a.ids[(size_t)b * KS + j];
            embed_row<KS, Q8>(a, b, id, a.T0 - 1, lane);
        }
        if constexpr (CW) arrive_stage(a, AP_SAMPLE);
    }
    if constexpr (!CW) fence_proxy_async();
}

// Thread 0's counts: its counter waits into the launch's totals (a.waits),
// and with phase times on its waits (or grid barriers) into its block's
// wait slots.
template <bool CW>
static __device__ void add_waits(const ApArgs& a, const ApWaits& w) {
    if (CW && a.waits != nullptr) {
        atomicAdd(a.waits, w.n);
        atomicAdd(a.waits + 1, w.ready);
    }
    if (a.phase != nullptr) {
        unsigned long long* ph = a.phase + (size_t)blockIdx.x * AP_PH + 5 * AP_PH_STAGE;
        atomicAdd(ph, w.ns);
        atomicAdd(ph + 1, w.n);
    }
}

// The grid barrier of the streamed instance; with phase times on, thread 0
// of each block counts it and its wait (its arrival to the last block's).
static __device__ __forceinline__ void timed_sync(const ApArgs& a, cg::grid_group& grid,
                                                  ApWaits& w) {
    const unsigned long long t0 = a.phase != nullptr ? now_ns() : 0;
    grid.sync();
    if (a.phase != nullptr && threadIdx.x == 0) {
        w.n += 1;
        w.ns += now_ns() - t0;
    }
}

// ST: the gate stage streamed (AP_BLOCK threads, the producer warp too),
// else cut into units (AP_THREADS; the instance then holds none of the
// streamed gate's code, whose registers would otherwise cap it: ptxas
// gives a block of 288 threads at most 168 registers a thread, 65,536 /
// 384, and the int8 stages then spill).
//
// How the stages wait for each other follows from the gate design (CW).
// The units instance has no grid barrier: every unit waits for the units
// of the stage before it (wait_stage) and arrives when its rows are
// written (arrive_stage).  Runs of each stage's units, counted
// from the launch's start: the sample stage's first run is the first
// step's embed (embed_stage), so step i's gate of layer 0 waits for i + 1
// sample runs, the gate of layer l > 0 for i L + l res runs, the res stage
// of layer l for i L + l + 1 gate runs, post1 for (i + 1) L res runs, post2
// and the sample stage for i + 1 runs of post1 and post2.  A block with no
// unit in a stage goes straight on to its next one (asking for its weights
// first); the waits need every block resident, which the cooperative
// launch guarantees.  The streamed instance keeps a grid barrier after
// every stage: on the same waits it ran 2-3% slower at bf16 kernel_size 3
// and 128-256 rows, and 26% at 512 (PERF.md, "K1 without grid barriers").
//
// MOL: the mixture-of-logistics model (bf16, kernel_size 3): the res
// stage's epilogue scales the stream and the skip sum, the sample stage
// runs the MoL sampler and the 1x1 input (sample_stage, embed_stage), the
// streamed gate's biases are of the gate's half width G.  The mu-law
// instances (MOL false) are the code they were.
template <int KS, bool Q8, bool ST, bool MOL>
__global__ void __launch_bounds__(ST ? AP_BLOCK : AP_THREADS, 1)
ar_persistent_kernel(const __grid_constant__ ApArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar[3];
    __shared__ __align__(8) uint64_t rbar[2 * AP_RING_MAX];   // full, then empty
    constexpr bool CW = !ST;
    cg::grid_group grid = cg::this_grid();
    ApBars bars = {bar, {0u, 0u, 0u}};
    uint64_t* full = rbar;
    uint64_t* empty = rbar + AP_RING_MAX;
    // the streamed gate's ring: 1024-aligned for the 128-byte swizzle
    unsigned char* ring = smem + ((smem_addr(smem) + a.sg.ring + 1023) & ~1023u)
                        - smem_addr(smem);
    ApRing rp = {0, 0u};
    ApWaits w = {0, 0, 0};
    if (threadIdx.x == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + i);
        if constexpr (ST) {
            for (int i = 0; i < AP_RING_MAX; ++i) {
                mbar_init_count(full + i, 1);
                mbar_init_count(empty + i, AP_WARPS);
            }
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const bool worker = !ST || threadIdx.x < AP_THREADS;
    const int L = a.L;
    if (worker) {
        if (threadIdx.x == 0 && !ST) prefetch(a, smem, bars, AP_GATE, 0);
        embed_stage<KS, Q8, CW, MOL>(a);
    }
    if constexpr (ST) timed_sync(a, grid, w);
    // the stage after which the next gate's weights are asked for: none
    // when the gate streams them itself
    const int gate_next = ST ? -1 : AP_GATE;
    for (int i = 0; i < a.max_n; ++i) {
        const int p = a.T0 - 1 + i;
        for (int l = 0; l < L; ++l) {
            const int Tn = l + 1 < L ? gate_next : AP_POST1, ln = l + 1 < L ? l + 1 : 0;
            if constexpr (ST) {
                if (threadIdx.x == AP_THREADS) {
                    gate_produce<KS, Q8>(a, ring, full, empty, rp, l, p);
                } else if (worker) {
                    if (threadIdx.x == 0) prefetch(a, smem, bars, AP_RES, l);
                    gate_consume_at<KS, Q8, MOL>(a, ring, full, empty, rp, l, p);
                    fence_proxy_async();
                }
                timed_sync(a, grid, w);
            } else {
                // the gate's input: the previous res stage, or the sample stage
                const int Tw = l > 0 ? AP_RES : AP_SAMPLE;
                const unsigned runs = l > 0 ? (unsigned)(i * L + l) : (unsigned)i + 1;
                if constexpr (Q8) wstage_q8<KS, AP_GATE, CW>(a, bars, l, p, AP_RES, l, Tw, runs, w);
                else wstage<KS, AP_GATE, CW, MOL>(a, bars, l, p, AP_RES, l, Tw, runs, w);
            }
            if (worker) {
                const unsigned gr = (unsigned)(i * L + l + 1);
                if constexpr (Q8) wstage_q8<KS, AP_RES, CW>(a, bars, l, p, Tn, ln, AP_GATE, gr, w);
                else wstage<KS, AP_RES, CW, MOL>(a, bars, l, p, Tn, ln, AP_GATE, gr, w);
                // the next gate's TMA writes over this stage's shared memory
                if constexpr (ST) fence_proxy_async_smem();
            }
            if constexpr (ST) timed_sync(a, grid, w);
        }
        if (worker)
            wstage<KS, AP_POST1, CW, MOL>(a, bars, 0, p, AP_POST2, 0, AP_RES,
                                          (unsigned)((i + 1) * L), w);
        if constexpr (ST) timed_sync(a, grid, w);
        // the next step's first gate weights: buffer 0, free since post1
        if (worker)
            wstage<KS, AP_POST2, CW, MOL>(a, bars, 0, p, i + 1 < a.max_n ? gate_next : -1, 0,
                                     AP_POST1, (unsigned)i + 1, w);
        if constexpr (ST) timed_sync(a, grid, w);
        if (worker) {
            sample_stage<KS, Q8, CW, MOL>(a, i, p, w);
            if constexpr (ST) fence_proxy_async_smem();
        }
        if (ST && i + 1 < a.max_n) timed_sync(a, grid, w);
    }
    if (threadIdx.x == 0) add_waits<CW>(a, w);
}

// ---- host side -----------------------------------------------------------

// Stage T's shape: K (weight rows; int8 products: of each segment), the
// quarters a unit spans, the columns N of each quarter and the int8
// segments (0: a bf16 stage); G the gate's half width.
static void stage_shape(int T, int K_, bool q8, int R, int S, int Q, int Ap, int G,
                        ApStage* s) {
    s->quarters = 1;
    s->segs = 0;
    switch (T) {
    case AP_GATE:
        s->K = q8 ? R : K_ == 2 ? R + Ap : 3 * R + Ap;
        s->quarters = K_ == 2 ? 2 : 1;
        s->N = 2 * G;
        if (q8) s->segs = K_ == 2 ? 1 : 3;
        break;
    case AP_RES: s->K = G; s->N = S + R; s->segs = q8 ? 1 : 0; break;
    case AP_POST1: s->K = S; s->N = S; break;
    default: s->K = S; s->N = Q; break;
    }
}

template <bool ST>
static const void* kernel_fn_(int K, bool q8, bool mol) {
    if (mol) return (const void*)ar_persistent_kernel<3, false, ST, true>;
    if (q8) return K == 2 ? (const void*)ar_persistent_kernel<2, true, ST, false>
                          : (const void*)ar_persistent_kernel<3, true, ST, false>;
    return K == 2 ? (const void*)ar_persistent_kernel<2, false, ST, false>
                  : (const void*)ar_persistent_kernel<3, false, ST, false>;
}

// the instance for the plan's gate design and the model (mol: the MoL
// instances, bf16 at kernel_size 3), and its block
static const void* kernel_fn(int K, bool q8, bool stream, bool mol) {
    return stream ? kernel_fn_<true>(K, q8, mol) : kernel_fn_<false>(K, q8, mol);
}

static int block_threads(bool stream) { return stream ? AP_BLOCK : AP_THREADS; }

// The streamed gate's cut (plan[19..27]: on, m, cw, nw, stages, ring, nx,
// nl, na) checked against the shapes and filled in; 0 or -3.  wcap: where
// buffer 0 starts, after buffer 1.
static int check_stream(const int* plan, ApArgs* a, int K_, bool q8, int wcap, int smem) {
    ApStream& s = a->sg;
    s.on = plan[19];
    if (!s.on) return 0;
    s.m = plan[20];
    s.cw = plan[21];
    s.nw = plan[22];
    s.stages = plan[23];
    s.ring = plan[24];
    s.nx = plan[25];
    s.nl = plan[26];
    s.na = plan[27];
    const int R = a->R, quarters = K_ == 2 ? 2 : 1;
    // (int8 at kernel_size 3 keeps four sums of nw / 2 registers a thread)
    const bool nw_ok = s.nw == 16 || s.nw == 32 || s.nw == 64
                    || (s.nw == 128 && !(q8 && K_ == 3));
    if ((s.m != 1 && s.m != 2) || !nw_ok || s.cw < 16 || (2 * a->G) % s.cw
        || s.nw * (s.m == 1 ? 2 : 1) != quarters * s.cw || (s.nw / quarters) % 16)
        return -3;
    const int nx = q8 ? (R + AP_CHUNK - 1) / AP_CHUNK : (R + a->Ap + 63) / 64;
    const int nl = K_ == 3 ? (q8 ? nx : (R + 63) / 64) : 0;
    const int na = q8 ? (a->Ap + 63) / 64 : 0;
    if (s.nx != nx || s.nl != nl || s.na != na) return -3;
    s.nc = nx + 2 * nl + na;
    s.G = 2 * a->G / s.cw;
    s.rb = (a->B + AP_SLAB * s.m - 1) / (AP_SLAB * s.m);
    s.units = s.G * s.rb;
    s.a_bytes = AP_SLAB * s.m * AP_CHUNK;
    s.w_bytes = quarters * s.cw * AP_CHUNK;
    s.run = (long long)s.nc * s.w_bytes;
    // the ring lies over buffer 0 and the regions after it, never over
    // buffer 1 (the res stage's weights, asked for during the gate stage)
    if (s.stages < 2 || s.stages > AP_RING_MAX || s.ring < wcap
        || (long long)s.ring + 1024 + (long long)s.stages * (s.a_bytes + s.w_bytes) > smem)
        return -3;
    return 0;
}

// Check the plan (ops/ar_kernel.py::ar_plan, as ar_plan_array lays it out)
// against the shapes and the card, and fill the stages.  0, or -1 (the grid
// cannot be co-resident), -2 (no cooperative launch), -3 (a plan that does
// not cut the stages or fit its shared memory), or a CUDA error.
static int check_plan(const int* plan, ApArgs* a, int K_, bool q8, bool mol,
                      int* grid, int* smem) {
    *grid = plan[0];
    *smem = plan[1];
    a->smem_w[0] = plan[2];
    a->smem_w[1] = plan[3];
    a->smem_a = plan[4];
    a->smem_p = plan[5];
    a->smem_e = plan[6];
    // the two weight buffers, then the A rows: 0 then 1, or with a streamed
    // gate 1 then 0 (the ring over 0 and on); cap: each buffer's bytes
    const bool stream = plan[19] != 0;
    const int lo = stream ? 1 : 0, hi = 1 - lo;
    int cap[2];
    cap[lo] = a->smem_w[hi] - a->smem_w[lo];
    cap[hi] = a->smem_a - a->smem_w[hi];
    if (a->smem_w[lo] != 0 || cap[lo] < 0 || cap[hi] < 0
        || a->smem_p < a->smem_a || a->smem_e < a->smem_p || *smem < a->smem_e
        || *grid < 1 || a->R % (q8 ? 32 : 16) || a->S % 16 || a->Q % 16
        || a->Ap % 16 || a->Ap < a->A || a->G % 16 || a->G < 16
        || (mol && (q8 || K_ != 3 || a->M < 1 || a->M > 31 || 3 * a->M > a->Q)))
        return -3;
    if (check_stream(plan, a, K_, q8, a->smem_w[0], *smem) != 0) return -3;
    for (int T = 0; T < AP_NSTAGES; ++T) {
        if (T == AP_GATE && stream) continue;
        ApStage& s = a->st[T];
        stage_shape(T, K_, q8, a->R, a->S, a->Q, a->Ap, a->G, &s);
        s.cw = plan[7 + 3 * T];
        s.mt = plan[8 + 3 * T];
        s.ks = plan[9 + 3 * T];
        const int kdepth = s.segs ? 32 : 16;
        if (s.cw < 16 || s.cw % 16 || s.N % s.cw || s.mt < 1 || s.mt > AP_MT_MAX
            || s.ks < 1 || s.ks > s.K / kdepth)
            return -3;
        s.G = s.N / s.cw;
        s.rg = (a->Mt + s.mt - 1) / s.mt;
        s.units = s.rg * s.G;
        const long long rows = 16LL * s.mt, cols = (long long)s.quarters * s.cw;
        long long wbytes, abytes, pbytes;
        if (s.segs) {
            const bool gate = T == AP_GATE;
            wbytes = s.segs * s.K * cols + (gate ? 2LL * a->Ap * s.cw : 0)
                   + 4LL * (s.segs * cols + (gate ? 2 : 1) * s.cw);
            abytes = rows * (a->q_ld + (gate ? 2LL * a->xa_ld : 0)
                             + (gate && K_ == 3 ? 2LL * a->R + AP_QPAD : 0));
            pbytes = 4LL * s.segs * s.ks * rows * cols + (gate ? 4LL * rows * s.cw : 0);
        } else {
            wbytes = (s.K * cols + 2LL * s.cw) * 2;
            abytes = rows * (s.K + (K_ == 3 && T == AP_GATE ? 2 : 1) * AP_PAD) * 2;
            pbytes = 4LL * s.ks * rows * cols;
        }
        s.run = (int)wbytes;
        const long long ebytes = rows * s.cw * 4;
        if (wbytes > cap[T & 1] || abytes > a->smem_p - a->smem_a
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
    const void* fn = kernel_fn(K_, q8, stream, mol);
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, block_threads(stream),
                                                      *smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)bps * sms < *grid) return -1;
    return 0;
}

// The streamed gate's TMA maps over this call's arrays (rows of 128-byte
// boxes, AP_SLAB * m rows each): 0 or a CUDA error.
static int stream_maps(ApArgs* a, int K_, bool q8, const void* ring, int ring_rows) {
    const int rows = AP_SLAB * a->sg.m, R = a->R;
    int e = q8 ? wg_map_2d(&a->mx, a->xq, 1, R, a->B, a->q_ld, rows)
               : wg_map_2d(&a->mx, a->xs, 2, R + a->Ap, a->B, 2LL * a->xs_ld, rows);
    if (e == 0 && K_ == 3)
        e = wg_map_2d(&a->mr, ring, q8 ? 1 : 2, R, ring_rows, (long long)R * (q8 ? 1 : 2),
                      rows);
    if (e == 0 && q8) e = wg_map_2d(&a->ma, a->xa, 2, a->Ap, a->B, 2LL * a->xa_ld, rows);
    return e;
}

extern "C" {

// Runs max_n steps on `stream` in one cooperative launch, bf16 or (q8) int8.
// Weights: w_gate, w_res, w_post1, w_post2 packed per unit by the plan
// (ops/ar_kernel.py::pack_ar_units; int8: the gate and res runs of int8
// tiles, aux tiles, column scales and biases); causal_b (R) f32, causal_w
// (K, Q, R) bf16.  ring: k = 2 (total_cap, B, 2R) bf16 projections, k = 3
// (total_cap, B, R) bf16 rows (int8 rows under q8), updated in place; meta
// (L, 2) int32 on the device: each layer's ring offset and dilation.
// Scratch, rows padded by 8 elements: xs (B, R + Ap + 8) bf16 with columns
// R + A .. R + Ap - 1 zero (Ap = A rounded up to 16; bf16 only), gs (B,
// R + 8) (bf16 only), sr, h1 (B, S + 8) bf16; of (B, R), skip (B, S),
// logits (B, Q) f32.  int8 only: xq, gq (B, R + 16) int8; xa (B, Ap + 8)
// bf16 with columns A .. Ap - 1 zero; ascale, ainv (L) f32 on the device;
// gscale, ginv the gate's scale and its reciprocal.  ids (B, K) int32,
// updated in place; samples (B, max_n) int32.  plan: host ints of
// ar_plan_array.  ctr: the arrival counters, 5 u32 (the stage types),
// which the launch sets to AP_CTR0 first.  waits: null,
// or two u64 the launch adds its counter waits and those whose first poll
// found the target reached to.  phase: null, or (grid,
// wn_ar_phase_slots()) zeroed u64 that the run adds nanoseconds and counts
// to (AP_PH_STAGE slots per stage type: gate, res, post1, post2, sample;
// then the counter waits and their count; globaltimer).  The streamed gate (plan[19] set)
// also takes ring_rows = total_cap * B (its TMA map of a kernel_size 3
// ring) and, f32 (L, 2R) in channel order, zb (bf16) or auxb, dilb and gsc
// (int8: (L, 2 or 3, 2R), the column scales of the current tap and the
// past tap, or of the current tap and the lags d and 2d).  Returns 0, a
// negative plan error (check_plan) or a CUDA error.
// mol: the mixture-of-logistics model (bf16, kernel_size 3, q8 0), with G
// the gate's half width (gs (B, G + 8), the gate stage 2G columns, the res
// stage G rows), Q the head's columns padded to 16 (logits (B, Q), the
// first 3M the head's), M the logistics, rscale and sscale the stream's and
// the skip sum's scales, lsmin the log-scales' floor, clamped null or a u64
// the sampler adds its clamped draws to; ids (B, 1) and samples (B, max_n)
// f32 samples, ids updated in place.  The mu-law model passes G = R and
// leaves M, the scales, lsmin and clamped unread.
int wn_ar_generate_persistent(
    const void* w_gate, const void* w_res, const void* w_post1, const void* w_post2,
    const void* causal_w, const void* causal_b, const void* h_up, int h_T,
    void* ring, const void* meta, void* xs, void* of, void* skip, void* gs,
    void* sr, void* h1, void* logits, void* ids, void* samples, int B, int R,
    int S, int Q, int A, int L, int K, int T0, int max_n, int sampling,
    unsigned long long seed, int q8, void* xq, void* gq, void* xa,
    const void* ascale, const void* ainv, float gscale, float ginv,
    const void* zb, const void* auxb, const void* dilb, const void* gsc,
    int ring_rows, const void* plan, void* ctr, void* waits, void* phase,
    void* stream, int mol, int G, int M, float rscale, float sscale, float lsmin,
    void* clamped) {
    if (K != 2 && K != 3) return (int)cudaErrorInvalidValue;
    if (mol && (K != 3 || q8)) return (int)cudaErrorInvalidValue;
    if (B < 1 || max_n < 1 || L < 1) return -3;
    ApArgs a{};
    a.w[AP_GATE] = (const unsigned char*)w_gate;
    a.w[AP_RES] = (const unsigned char*)w_res;
    a.w[AP_POST1] = (const unsigned char*)w_post1;
    a.w[AP_POST2] = (const unsigned char*)w_post2;
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
    a.xq = (signed char*)xq;
    a.gq = (signed char*)gq;
    a.xa = (bf16*)xa;
    a.ascale = (const float*)ascale;
    a.ainv = (const float*)ainv;
    a.gscale = gscale;
    a.ginv = ginv;
    a.zb = (const float*)zb;
    a.auxb = (const float*)auxb;
    a.dilb = (const float*)dilb;
    a.gsc = (const float*)gsc;
    a.B = B;
    a.Mt = (B + 15) / 16;
    a.R = R;
    a.S = S;
    a.Q = Q;
    a.A = A;
    a.Ap = (A + 15) / 16 * 16;
    a.xs_ld = R + a.Ap + AP_PAD;
    a.gs_ld = G + AP_PAD;
    a.G = G;
    a.M = M;
    a.rscale = rscale;
    a.sscale = sscale;
    a.lsmin = lsmin;
    a.clamped = (unsigned long long*)clamped;
    a.s_ld = S + AP_PAD;
    a.q_ld = R + AP_QPAD;
    a.xa_ld = a.Ap + AP_PAD;
    a.L = L;
    a.h_T = h_T;
    a.T0 = T0;
    a.max_n = max_n;
    a.sampling = sampling;
    a.seed = seed;
    a.phase = (unsigned long long*)phase;
    a.ctr = (unsigned*)ctr;
    a.waits = (unsigned long long*)waits;
    int grid = 0, smem = 0;
    const int err = check_plan((const int*)plan, &a, K, q8 != 0, mol != 0, &grid, &smem);
    if (err != 0) return err;
    if (ctr == nullptr) return -3;
    if (a.sg.on) {
        if ((q8 ? (!gsc || !auxb || !dilb) : !zb) || (K == 3 && ring_rows < B))
            return -3;
        const int me = stream_maps(&a, K, q8 != 0, ring, ring_rows);
        if (me != 0) return me;
    }
    void* args[] = {&a};
    const bool st = a.sg.on != 0;
    cudaError_t e = cudaMemsetAsync(ctr, 0xFF, (AP_SAMPLE + 1) * sizeof(unsigned),
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    static_assert(AP_CTR0 == 0xFFFFFFFFu, "the memset's byte");
    e = cudaLaunchCooperativeKernel(kernel_fn(K, q8 != 0, st, mol != 0), dim3(grid),
                                    dim3(block_threads(st)), args, smem,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int wn_ar_phase_slots(void) { return AP_PH; }

}  // extern "C"
