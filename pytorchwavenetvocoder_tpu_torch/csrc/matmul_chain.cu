// The serial matmul-chain probe for Hopper: one persistent kernel runs every
// step and every layer of the chain.
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
// so every stage streams its layer's weights from L2/HBM: the step's bytes
// over 3.35 TB/s (25.8 us for split's 86.5 MB) are its floor at small B.
// At wide fleets each unit also reads its rows' A operand from L2 (a
// stage of split at B = 128 reads ~20 MB of A rows to use 2 MB of
// weights), and the wait between dependent products is the term this
// probe exists to expose: it is the floor of a one-kernel AR loop
// (csrc/ar_persistent.cu, 63 grid barriers a step).
//
// Design (ops/matmul_chain.py::chain_plan cuts the work; check_plan below
// checks the cut again):
//  - one cooperative launch, one block per SM at most, 288 threads: two
//    consumer warpgroups and one producer warp.  Each product is cut into
//    units (a 64-row slab x a column group; int8's first product: the same
//    columns in each of its four R-wide quarters, so the gate, the tanh
//    half and both sink halves of a channel meet in one unit); block b
//    takes units b, b + grid, ... (one where the grid allows).  A unit
//    streams its K in chunks of 128 bytes (64 bf16 or 128 int8 values)
//    through a ring of shared-memory stages, each stage a group of 1-4
//    chunks: the producer's lane 0 asks for a group's A tiles (one TMA box
//    of a 3-D map of the carry a1 or of a2 by chunks, 128-byte swizzle) and
//    W tiles (one bulk copy of the unit's packed run, swizzled alike by
//    ops/matmul_chain.py::pack_chain_weights) on the stage's full mbarrier;
//    the consumers release it on its empty mbarrier.  Each request costs the
//    issuing lane ~0.2 us on the H100, so the plan groups as many chunks as
//    its ring holds;
//  - the epilogue's operands (the rows' old state at the unit's columns,
//    int8's column scales) come by cp.async into shared memory, asked for
//    before the unit's products; each was last written by this block (the
//    same unit, a layer earlier) or is a weight;
//  - the products: the two consumer warpgroups take alternate chunks, the
//    first half of K and the second (ring position p holds the group of
//    chunks p / 2 + (p % 2) np / 2 of the unit's np: for split, wc's rows
//    and wp's), each running wgmma m64nNk16 (bf16 into f32) or m64nNk32 (s8
//    into s32, exact) with the sums in registers; the sums meet in shared
//    memory and each warpgroup runs the epilogue of half the columns from
//    its registers (z = first half + second half, the order of out @ wc +
//    out @ wp);
//  - waits: a unit depends only on the units that wrote its own rows
//    (product 2 of layer l for rows r reads g[r, :], which product 1 of
//    layer l wrote; product 1 of layer l + 1 reads out[r, :], which product
//    2 wrote).  Each (product, row group) has an arrival counter in device
//    memory: after a unit's epilogue its writers fence the generic proxy to
//    the async proxy, the consumers sync, and one thread adds 1 with
//    release semantics.  The producer, before asking for a unit's A tiles,
//    polls only its row group's counter of the previous product with
//    acquire semantics until it reaches that product's column groups times
//    the layers done (counters grow over the call and are never reset; a
//    wait of 2^24 polls traps: wn_hopper.cuh's arrive_counter and
//    wait_counter, which K1 shares).  The first product of the first layer
//    waits for every block's part of the carry's initialisation.  A block
//    with no unit in a stage does not wait.  The weights do not depend on
//    the data: the producer asks for a unit's first ring-full of W tiles
//    before it polls.  The waits need every block resident at once, which
//    the cooperative launch guarantees (a grid it cannot hold is refused);
//  - every column the script counts is computed, the dead ones too (split's
//    z[:, R:2R], every variant's sr[:, :S], int8raw's z[:, R:2R]): their
//    sums go to a dead-column scratch, so the TFLOP/s means the script's
//    work;
//  - B is padded to 64 rows (dual: each half, so no row group straddles
//    the two); pad rows are zeros and stay zeros in every
//    variant.  The activations lie row-major; TMA swizzles them.
//
// Why no buffer is double-buffered under the counter waits.  Every unit of
// a (product, row group) waits until every unit of the previous product on
// the same rows has arrived, and a unit arrives only after its last read
// (its consumers have waited for every chunk's TMA) and its last write
// (its epilogue, fenced).  So on each row group the stages are totally
// ordered, as under a grid barrier: a1 (read by product 1's TMA, then
// read and written in place by product 2's epilogue, each element by one
// thread), a2 (written by product 1, read by product 2's TMA, written
// again by the next layer's product 1), st (product 2's epilogue, in
// place) and sink (product 1 writes it, the last layer's product 2 reads
// it, the next step's product 1 writes it again) are each touched by one
// stage of a row group at a time, and no row group reads another's rows.
// The dead-column scratch is written only.
//
// Where trouble lies, and what is done about it:
//  (1) rounding: jnp.round is half-to-even (rintf), astype(int32) from a
//      float truncates (__float2int_rz), shift_right_arithmetic is a signed
//      >>, bf16 casts round to nearest even (__float2bfloat16);
//  (2) FMA contraction: int8's z * wsc, sr * wsc + out, out * 25.4 and
//      out + 1e-20 sink use __fmul_rn/__fadd_rn, which nvcc never fuses;
//  (3) the bf16 chains leave bf16's range after tens of steps: values are
//      checked at a few steps, long runs are timed only;
//  (4) the TMA loads read (async proxy) what other blocks wrote (generic
//      proxy), so the writers fence the proxies before they arrive.
#include <cooperative_groups.h>
#include <cuda.h>
#include <stdint.h>

#include <algorithm>

#include "wn_common.cuh"
#include "wn_hopper.cuh"
#include "wn_wgmma.cuh"

namespace cg = cooperative_groups;

#define MC_L 30
#define MC_R 512
#define MC_S 256
#define MC_CONSUMERS 256
#define MC_BLOCK (MC_CONSUMERS + 32)   // and the producer warp
#define MC_SLAB 64          // rows of a unit
#define MC_CHUNK 128        // bytes of K a ring stage carries
#define MC_RING_MAX 16
#define MC_B_MAX 1024
#define MC_SMEM_MAX 232448
#define MC_SMEM_FIXED (1024 + 2 * MC_RING_MAX * 8)
#define MC_PHASES 10

enum { MC_SPLIT, MC_MERGED, MC_SPINE, MC_FULL, MC_DUAL, MC_INT8, MC_INT8RAW,
       MC_NVARIANTS };

// One product's cut (the plan's), and what follows from it
struct McProd {
    int K, N, q, cw, nw, G, nc;
    int units, w_bytes;
};

struct McArgs {
    CUtensorMap ma[2];     // the products' A operands: a1, a2 by 128-byte
                           // chunks (box: group chunks x rows)
    const bf16* x0;        // (B, R)
    const unsigned char* w[2];   // each product's weights, packed per unit
    const float* wsc;      // int8: (L, 4R + S + R) column scales
    bf16* y;               // (B, R)
    // workspace, row-major: a1 (Mp, R) the first product's A (bf16 out,
    // int8 xq / x8); a2 (Mp, K2) the second's (bf16 g / bf16(z), int8 gq /
    // g8); st (Mp, R) int8's f32 out, int8raw's int32 out; sink (Mp, R);
    // dead (Mp, R + S) the dead columns' sums
    void* a1;
    void* a2;
    void* st;
    void* sink;
    void* dead;
    unsigned* ctr;         // arrivals: [product][row group], then the init's
    int B, Mp, Mh, n_steps;
    int rows, rg, group, stages, a_bytes, stage_bytes, scratch, epi;
    McProd p[2];
    unsigned long long* phase;   // null, or per block MC_PHASES u64
};

template <int V> struct McT {
    typedef bf16 T;
    typedef float Acc;
    static constexpr bool Q8 = false;
    static constexpr int esz = 2;
};
template <> struct McT<MC_INT8> {
    typedef signed char T;
    typedef int Acc;
    static constexpr bool Q8 = true;
    static constexpr int esz = 1;
};
template <> struct McT<MC_INT8RAW> {
    typedef signed char T;
    typedef int Acc;
    static constexpr bool Q8 = true;
    static constexpr int esz = 1;
};

// the product shapes: K, N and the quarters a unit spans
static void product_shape(int V, int p, int* K, int* N, int* Q) {
    const int R = MC_R, S = MC_S;
    const bool q8 = V == MC_INT8 || V == MC_INT8RAW, wide = V == MC_FULL || V == MC_DUAL;
    if (p == 0) {
        *N = q8 ? 4 * R : 2 * R;
        *K = (V == MC_SPLIT || V == MC_MERGED) ? 2 * R : R;
        *Q = q8 ? 4 : 1;
    } else {
        *N = wide ? R : S + R;
        *K = wide ? 2 * R : R;
        *Q = 1;
    }
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

// ---- the ring ------------------------------------------------------------------
struct McRing {
    int stage;
    unsigned phase;
};

static __device__ __forceinline__ void ring_next(McRing& r, int stages) {
    if (++r.stage == stages) { r.stage = 0; r.phase ^= 1; }
}

// the K chunk at ring position p of a unit's nc: the first half of K at even
// positions, the second at odd ones
static __device__ __forceinline__ int chunk_at(int p, int nc) {
    return (p >> 1) + (p & 1) * (nc >> 1);
}

// ---- the carry from x0 -------------------------------------------------------
template <int V>
static __device__ void init_stage(const McArgs& a) {
    const int R = MC_R;
    const int total = a.Mp * R;
    for (int i = blockIdx.x * MC_BLOCK + threadIdx.x; i < total; i += gridDim.x * MC_BLOCK) {
        const int m = i / R, j = i - m * R;
        const int row = real_row(a, m, V == MC_DUAL);
        const bf16 x = row >= 0 ? a.x0[(size_t)row * R + j] : f2bf(0.f);
        if (V == MC_INT8) {
            const float o = bf2f(x);
            ((float*)a.st)[i] = o;
            ((signed char*)a.a1)[i] = q8(__fmul_rn(o, 25.4f));
        } else if (V == MC_INT8RAW) {
            const int o = __float2int_rz(bf2f(x));
            ((int*)a.st)[i] = o;
            ((signed char*)a.a1)[i] = clip8(o);
        } else {
            ((bf16*)a.a1)[i] = x;
        }
    }
}

// ---- the epilogues: one reduced element of a product ----------------------
// What an element's epilogue reads of the state, asked for by cp.async into
// the unit's epilogue region of shared memory before its products
// (epi_fetch): E0 [rows][cw], the rows' old state at the unit's columns
// (bf16 product 2: out; int8 / int8raw product 2: st; their product 1 from
// the second layer: sink), then (int8) E1 [quarters][cw], the unit's
// column scales.  An element's are E0[e] (e = its row in the unit x cw + its
// column jj) and E1[q cw + jj].
struct McEpi {
    const unsigned char* E;
    int e, jj, cw, rows;
    __device__ float e0f() const { return ((const float*)E)[e]; }
    __device__ int e0i() const { return ((const int*)E)[e]; }
    __device__ float e0bf() const { return bf2f(((const bf16*)E)[e]); }
    __device__ float scale(int q) const {
        return ((const float*)(E + (size_t)rows * cw * 4))[q * cw + jj];
    }
};

// All consumer threads: unit (rows r0.., columns c0.., cw of each quarter)
// of product P at layer l asks for its epilogue's operands.  Each was last
// written by this block (the same unit of the previous layer; the carry's
// initialisation is acquired once at the start) or is a weight.
template <int V, int P>
static __device__ void epi_fetch(const McArgs& a, unsigned char* E, int l, int r0, int rows,
                                 int c0, int cw) {
    constexpr bool wide = V == MC_FULL || V == MC_DUAL;
    const int R = MC_R, S = MC_S;
    const unsigned char* src = nullptr;
    int esz = 4;
    if constexpr (P == 1) {
        const int j0 = wide ? c0 : c0 - S;
        if (j0 >= 0) {
            if constexpr (McT<V>::Q8) {
                src = (const unsigned char*)a.st + ((size_t)r0 * R + j0) * 4;
            } else {
                src = (const unsigned char*)a.a1 + ((size_t)r0 * R + j0) * 2;
                esz = 2;
            }
        }
    } else if constexpr (McT<V>::Q8) {
        if (l > 0) src = (const unsigned char*)a.sink + ((size_t)r0 * R + c0) * 4;
    }
    if (src != nullptr) {
        const int per_row = cw * esz / 16;
        for (int i = threadIdx.x; i < rows * per_row; i += MC_CONSUMERS) {
            const int r = i / per_row, k = i - r * per_row;
            cp_async16(E + (size_t)i * 16, src + (size_t)r * R * esz + k * 16);
        }
    }
    if constexpr (V == MC_INT8) {
        constexpr int Q = P == 0 ? 4 : 1;
        const float* sc = a.wsc + (size_t)l * (4 * R + S + R) + (P == 0 ? 0 : 4 * R) + c0;
        unsigned char* E1 = E + (size_t)rows * cw * 4;
        const int per_q = cw / 4;
        for (int i = threadIdx.x; i < Q * per_q; i += MC_CONSUMERS) {
            const int q = i / per_q, k = i - q * per_q;
            cp_async16(E1 + (size_t)i * 16, sc + q * R + 4 * k);
        }
    }
    cp_async_commit();
}

// first product of split / merged / spine / full / dual at (m, c)
template <int V>
static __device__ __forceinline__ void epi1_bf16(const McArgs& a, int m, int c, float z) {
    const int R = MC_R, S = MC_S;
    if (V == MC_FULL || V == MC_DUAL) {
        ((bf16*)a.a2)[(size_t)m * 2 * R + c] = f2bf(z);
    } else if (c < R) {
        ((bf16*)a.a2)[(size_t)m * R + c] = f2bf(z);             // g
    } else {
        ((float*)a.dead)[(size_t)m * (R + S) + c - R] = z;      // dead z[:, R:]
    }
}

// second product of the bf16 variants at (m, c): out = bf16(sr) + out
template <int V>
static __device__ __forceinline__ void epi2_bf16(const McArgs& a, int m, int c, float sr,
                                                 bool final_, const McEpi& x) {
    const int R = MC_R, S = MC_S;
    const int j = (V == MC_FULL || V == MC_DUAL) ? c : c - S;
    if (j < 0) {                                                // dead sr[:, :S]
        ((float*)a.dead)[(size_t)m * (R + S) + R + c] = sr;
        return;
    }
    const bf16 o = f2bf(__fadd_rn(bf_round(sr), x.e0bf()));
    ((bf16*)a.a1)[(size_t)m * R + j] = o;
    if (final_) {
        const int row = real_row(a, m, V == MC_DUAL);
        if (row >= 0) a.y[(size_t)row * R + j] = o;
    }
}

// int8's first product at (m, j): z of the four quarters
static __device__ __forceinline__ void epi1_int8(const McArgs& a, int l, int m, int j,
                                                 const int z[4], const McEpi& x) {
    const int R = MC_R;
    float zf[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) zf[q] = __fmul_rn((float)z[q], x.scale(q));
    const float gate = __fmul_rn(wn_sigmoid(zf[0]), tanhf(zf[1]));
    ((signed char*)a.a2)[(size_t)m * R + j] = q8(__fmul_rn(gate, 127.f));
    const float prev = l == 0 ? 0.f : x.e0f();
    ((float*)a.sink)[(size_t)m * R + j] = __fadd_rn(__fadd_rn(prev, zf[2]), zf[3]);
}

// int8raw's first product at (m, j)
static __device__ __forceinline__ void epi1_int8raw(const McArgs& a, int l, int m, int j,
                                                    const int z[4], const McEpi& x) {
    const int R = MC_R, S = MC_S;
    ((signed char*)a.a2)[(size_t)m * R + j] = clip8(z[0] >> 9);
    ((int*)a.dead)[(size_t)m * (R + S) + j] = z[1];            // dead z[:, R:2R]
    const int prev = l == 0 ? 0 : x.e0i();
    ((int*)a.sink)[(size_t)m * R + j] = wadd(wadd(prev, z[2]), z[3]);
}

// int8's second product at (m, c)
static __device__ __forceinline__ void epi2_int8(const McArgs& a, int m, int c, int sr,
                                                 bool last, bool final_, const McEpi& x) {
    const int R = MC_R, S = MC_S;
    const float srf = __fmul_rn((float)sr, x.scale(0));
    if (c < S) {
        ((float*)a.dead)[(size_t)m * (R + S) + R + c] = srf;
        return;
    }
    const int j = c - S;
    const size_t i = (size_t)m * R + j;
    float o = __fadd_rn(srf, x.e0f());
    if (last) {   // the step's carry: bf16(out + 1e-20 sink), back to f32
        const bf16 acc = f2bf(__fadd_rn(o, __fmul_rn(1e-20f, __ldcg((float*)a.sink + i))));
        o = bf2f(acc);
        if (final_ && m < a.B) a.y[(size_t)m * R + j] = acc;
    }
    ((float*)a.st)[i] = o;
    ((signed char*)a.a1)[i] = q8(__fmul_rn(o, 25.4f));
}

// int8raw's second product at (m, c)
static __device__ __forceinline__ void epi2_int8raw(const McArgs& a, int m, int c, int sr,
                                                    bool last, bool final_, const McEpi& x) {
    const int R = MC_R, S = MC_S;
    if (c < S) {
        ((int*)a.dead)[(size_t)m * (R + S) + R + c] = sr;
        return;
    }
    const int j = c - S;
    const size_t i = (size_t)m * R + j;
    int o = wadd(sr >> 9, x.e0i());
    if (last) {   // the step's carry: bf16(out + (sink >> 30)), truncated back
        const bf16 acc = f2bf((float)wadd(o, __ldcg((int*)a.sink + i) >> 30));
        o = __float2int_rz(bf2f(acc));
        if (final_ && m < a.B) a.y[(size_t)m * R + j] = acc;
    }
    ((int*)a.st)[i] = o;
    ((signed char*)a.a1)[i] = clip8(o);
}

// product P's element (m, c): v holds the sums of the quarters the unit
// spans (int8's first product: 4, else 1); x its operands in shared memory
template <int V, int P>
static __device__ __forceinline__ void epilogue_at(const McArgs& a, int l, int m, int c,
                                                   const typename McT<V>::Acc* v, bool last,
                                                   bool final_, const McEpi& x) {
    if constexpr (P == 0 && McT<V>::Q8) {
        const int z[4] = {(int)v[0], (int)v[1], (int)v[2], (int)v[3]};
        if constexpr (V == MC_INT8) epi1_int8(a, l, m, c, z, x);
        else epi1_int8raw(a, l, m, c, z, x);
    } else if constexpr (V == MC_INT8) {
        epi2_int8(a, m, c, (int)v[0], last, final_, x);
    } else if constexpr (V == MC_INT8RAW) {
        epi2_int8raw(a, m, c, (int)v[0], last, final_, x);
    } else if constexpr (P == 0) {
        epi1_bf16<V>(a, m, c, (float)v[0]);
    } else {
        epi2_bf16<V>(a, m, c, (float)v[0], final_, x);
    }
}

// ---- the producer ------------------------------------------------------------
// Lane 0 of the producer warp: for each of the block's units, its first
// ring-full of W tiles (the weights do not depend on the data), then the
// poll of its rows' counter, then the A tiles and the rest of the chunks.
// Phase slots:
// 0 asking (the unit's issue time less its poll), 5 the polls' time, 6 the
// units, 7 the polls, 9 the issue time after the poll.
template <int V>
static __device__ void produce(const McArgs& a, unsigned char* ring, uint64_t* full,
                               uint64_t* empty) {
    constexpr int depth = MC_CHUNK / McT<V>::esz;   // K values of a chunk
    unsigned long long* ph = a.phase != nullptr ? a.phase + (size_t)blockIdx.x * MC_PHASES
                                                : nullptr;
    for (int P = 0; P < 2; ++P)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&a.ma[P]) : "memory");
    McRing rp = {0, 0u};
    for (int s = 0; s < a.n_steps; ++s) {
        for (int l = 0; l < MC_L; ++l) {
            for (int P = 0; P < 2; ++P) {
                const McProd& pr = a.p[P];
                const CUtensorMap* map = &a.ma[P];
                const unsigned k = (unsigned)(s * MC_L + l);
                for (int u = blockIdx.x; u < pr.units; u += gridDim.x) {
                    const int rgi = u / pr.G, g = u - rgi * pr.G;
                    const unsigned long long t0 = ph ? now_ns() : 0;
                    const unsigned char* w = a.w[P] + ((size_t)l * pr.G + g) * pr.nc
                                                      * pr.w_bytes;
                    const int np = pr.nc / a.group;                // ring positions
                    const unsigned wb = (unsigned)(pr.w_bytes * a.group);
                    const int npre = min(a.stages, np);
                    const McRing r0 = rp;
                    for (int p = 0; p < npre; ++p) {
                        wg_wait(&empty[rp.stage], rp.phase ^ 1);
                        unsigned char* st = ring + (size_t)rp.stage * a.stage_bytes;
                        mbar_expect(&full[rp.stage], (unsigned)a.a_bytes + wb);
                        bulk_copy(st + a.a_bytes, w + (size_t)chunk_at(p, np) * wb, wb,
                                  &full[rp.stage]);
                        ring_next(rp, a.stages);
                    }
                    // the previous product's arrivals on these rows
                    const unsigned* ctr;
                    unsigned target;
                    if (k == 0 && P == 0) {
                        ctr = a.ctr + 2 * a.rg;
                        target = gridDim.x;
                    } else if (P == 1) {
                        ctr = a.ctr + rgi;
                        target = (k + 1) * (unsigned)a.p[0].G;
                    } else {
                        ctr = a.ctr + a.rg + rgi;
                        target = k * (unsigned)a.p[1].G;
                    }
                    const unsigned long long tw0 = ph ? now_ns() : 0;
                    const unsigned polls = wait_counter(ctr, target);
                    const unsigned long long tw1 = ph ? now_ns() : 0;
                    McRing ra = r0;
                    for (int p = 0; p < np; ++p) {
                        McRing at = ra;
                        if (p < npre) {
                            ring_next(ra, a.stages);
                        } else {
                            at = rp;
                            wg_wait(&empty[rp.stage], rp.phase ^ 1);
                            unsigned char* st = ring + (size_t)rp.stage * a.stage_bytes;
                            mbar_expect(&full[rp.stage], (unsigned)a.a_bytes + wb);
                            bulk_copy(st + a.a_bytes, w + (size_t)chunk_at(p, np) * wb, wb,
                                      &full[rp.stage]);
                            ring_next(rp, a.stages);
                        }
                        // the group's chunks of the A rows (one box of `group`
                        // 128-byte tiles): split and merged read [out | out]
                        int c0 = chunk_at(p, np) * a.group;
                        if (P == 0) c0 %= MC_R / depth;
                        tma_load_3d(ring + (size_t)at.stage * a.stage_bytes, map,
                                    &full[at.stage], 0, rgi * a.rows, c0);
                    }
                    if (ph) {
                        const unsigned long long t1 = now_ns();
                        ph[0] += (t1 - t0) - (tw1 - tw0);
                        ph[5] += tw1 - tw0;
                        ph[6] += 1;
                        ph[7] += polls;
                        ph[9] += t1 - tw1;
                    }
                }
            }
        }
    }
}

// ---- the unit ------------------------------------------------------------------
template <int V, int NW>
static __device__ __forceinline__ void chunk_wg(typename McT<V>::Acc (&d)[NW / 2],
                                                const unsigned char* sa,
                                                const unsigned char* sb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg_operand<0>(sa, kk), db = wg_operand<0>(sb, kk);
        if constexpr (McT<V>::Q8) {
            if constexpr (NW == 16) wgmma_s8_n16(d, da, db, 1);
            else if constexpr (NW == 32) wgmma_s8_n32(d, da, db, 1);
            else if constexpr (NW == 64) wgmma_s8_n64(d, da, db, 1);
            else wgmma_s8_n128(d, da, db, 1);
        } else {
            if constexpr (NW == 16) wgmma_bf16_n16(d, da, db, 1);
            else if constexpr (NW == 32) wgmma_bf16_n32(d, da, db, 1);
            else if constexpr (NW == 64) wgmma_bf16_n64(d, da, db, 1);
            else wgmma_128<0, 0>(d, da, db, 1);
        }
    }
}

// Unit (rgi, g) of product P on a 64-row slab: warpgroup wg runs the chunks
// at positions p = wg mod 2, their sums meet in shared memory, and each
// runs the epilogue of half the unit's columns.  Accumulator d[4 j + e] of a thread
// is row (warp % 4) * 16 + lane / 4 (+ 8 for e >= 2) of the slab, column
// 8 j + 2 (lane % 4) + (e & 1) of the unit's NW; int8's first product has
// its four quarters' cw = NW / 4 columns one after the other, so a thread
// holds all four of each of its channels.  t[1]: the first chunk's
// arrival, t[2]: the products' end (thread 0).
template <int V, int P, int NW>
static __device__ void unit_wgmma(const McArgs& a, unsigned char* ring, uint64_t* full,
                                  uint64_t* empty, McRing& rp, unsigned char* scratch,
                                  unsigned char* E, int l, bool last, bool final_, int rgi,
                                  int g, unsigned long long* t) {
    typedef typename McT<V>::Acc Acc;
    constexpr int Q = (P == 0 && McT<V>::Q8) ? 4 : 1;
    constexpr int CW = NW / Q;
    const McProd& pr = a.p[P];
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
    epi_fetch<V, P>(a, E, l, rgi * a.rows, a.rows, g * CW, CW);
    Acc acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
    int prev = -1;
    const int np = pr.nc / a.group;
    for (int p = 0; p < np; ++p) {
        if ((p & 1) == wg) {
            wg_wait(&full[rp.stage], rp.phase);
            if (t) t[3] = t[p == 0 ? 1 : 3] = now_ns();
            const unsigned char* st = ring + (size_t)rp.stage * a.stage_bytes;
            wgmma_fence();
            for (int i = 0; i < a.group; ++i)
                chunk_wg<V, NW>(acc, st + i * MC_SLAB * MC_CHUNK,
                                st + a.a_bytes + i * NW * MC_CHUNK);
            wgmma_commit();
            if (prev >= 0) {
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(&empty[prev]);
            }
            prev = rp.stage;
        }
        ring_next(rp, a.stages);
    }
    wgmma_wait<0>();
    if (lane == 0 && prev >= 0) mbar_arrive(&empty[prev]);
    // the two warpgroups' sums meet in shared memory: each finishes half the
    // unit's 8-column groups (all of them the first, where there is one),
    // z = the first half of K's sum + the second's
    constexpr int NJ = CW / 8, HALF = NJ >= 2 ? NJ / 2 : NJ;
    const int j0 = wg == 0 ? 0 : HALF, j1 = wg == 0 ? HALF : NJ;
    Acc* sc = (Acc*)scratch;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        if (j < j0 || j >= j1) {
#pragma unroll
            for (int q = 0; q < Q; ++q)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = 4 * (j + q * NJ) + k;
                    sc[i * 128 + tid] = acc[i];
                }
        }
    }
    cp_async_wait();
    consumers_sync();
    if (t) t[2] = now_ns();
    const int ml0 = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        if (j < j0 || j >= j1) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                Acc v[Q];
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const int i = 4 * (j + q * NJ) + 2 * h + e;
                    v[q] = wg == 0 ? acc[i] + sc[i * 128 + tid] : sc[i * 128 + tid] + acc[i];
                }
                const int ml = ml0 + 8 * h, jj = 8 * j + 2 * (lane & 3) + e;
                const McEpi x = {E, ml * CW + jj, jj, CW, a.rows};
                epilogue_at<V, P>(a, l, rgi * a.rows + ml, g * CW + jj, v, last, final_, x);
            }
        }
    }
}

// ---- the consumers -------------------------------------------------------------
template <int V, int P>
static __device__ void unit(const McArgs& a, unsigned char* ring, uint64_t* full,
                            uint64_t* empty, McRing& rp, unsigned char* scratch, unsigned char* E,
                            int l, bool last, bool final_, int rgi, int g,
                            unsigned long long* t) {
    constexpr bool QC = P == 0 && McT<V>::Q8;   // four quarters: 32 wide at least
    switch (a.p[P].nw) {
    case 16:
        if constexpr (!QC)
            unit_wgmma<V, P, 16>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g,
                                 t);
        break;
    case 32:
        unit_wgmma<V, P, 32>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g, t);
        break;
    case 64:
        unit_wgmma<V, P, 64>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g, t);
        break;
    default:
        unit_wgmma<V, P, 128>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g, t);
        break;
    }
}

// The two consumer warpgroups: every stage's units of this block, each
// followed by its arrival on its rows' counter (the writers' proxy fence,
// the consumers' sync, one release add).  Phase slots (thread 0): 1 the
// wait for a unit's first chunk, 2 its products, 3 its epilogue to the
// arrival, 4 the units, 8 its first chunk's arrival to its last one's.
template <int V>
static __device__ void consume(const McArgs& a, unsigned char* ring, uint64_t* full,
                               uint64_t* empty, unsigned char* scratch) {
    unsigned char* E = scratch + a.scratch;   // the units' epilogue operands
    // every block's part of the carry's initialisation, before the first
    // epilogue operands are asked for
    if (threadIdx.x == 0) wait_counter(a.ctr + 2 * a.rg, gridDim.x);
    consumers_sync();
    unsigned long long* ph = a.phase != nullptr && threadIdx.x == 0
        ? a.phase + (size_t)blockIdx.x * MC_PHASES : nullptr;
    McRing rp = {0, 0u};
    for (int s = 0; s < a.n_steps; ++s) {
        for (int l = 0; l < MC_L; ++l) {
            const bool last = l == MC_L - 1, final_ = last && s == a.n_steps - 1;
#pragma unroll
            for (int P = 0; P < 2; ++P) {
                const McProd& pr = a.p[P];
                for (int u = blockIdx.x; u < pr.units; u += gridDim.x) {
                    const int rgi = u / pr.G, g = u - rgi * pr.G;
                    unsigned long long t[4] = {0, 0, 0, 0};
                    if (ph) t[0] = now_ns();
                    if (P == 0)
                        unit<V, 0>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g,
                                   ph ? t : nullptr);
                    else
                        unit<V, 1>(a, ring, full, empty, rp, scratch, E, l, last, final_, rgi, g,
                                   ph ? t : nullptr);
                    // the next product's TMA loads read what this unit wrote
                    fence_proxy_async();
                    consumers_sync();
                    if (threadIdx.x == 0) arrive_counter(a.ctr + P * a.rg + rgi);
                    if (ph) {
                        const unsigned long long t3 = now_ns();
                        ph[1] += t[1] - t[0];
                        ph[2] += t[2] - t[1];
                        ph[3] += t3 - t[2];
                        ph[4] += 1;
                        ph[8] += t[3] - t[1];
                    }
                }
            }
        }
    }
}

template <int V>
__global__ void __launch_bounds__(MC_BLOCK, 1) matmul_chain_kernel(const __grid_constant__ McArgs a) {
    extern __shared__ unsigned char mc_smem_raw[];
    unsigned char* ring = (unsigned char*)(((uintptr_t)mc_smem_raw + 1023) & ~(uintptr_t)1023);
    uint64_t* full = (uint64_t*)(ring + (size_t)a.stages * a.stage_bytes);
    uint64_t* empty = full + MC_RING_MAX;
    unsigned char* scratch = (unsigned char*)(empty + MC_RING_MAX);
    if (threadIdx.x == 0) {
        for (int i = 0; i < a.stages; ++i) {
            mbar_init_count(full + i, 1);
            mbar_init_count(empty + i, 4);   // the warps of the warpgroup that consumed it
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    init_stage<V>(a);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) arrive_counter(a.ctr + 2 * a.rg);
    if (threadIdx.x >= MC_CONSUMERS) {
        if (threadIdx.x == MC_CONSUMERS) produce<V>(a, ring, full, empty);
        __syncwarp();
    } else {
        consume<V>(a, ring, full, empty, scratch);
    }
}

// ---- the waits alone (barrier_chain) -------------------------------------------
// 60 grid barriers a step, one block per SM (the chain's earlier design)
__global__ void __launch_bounds__(MC_CONSUMERS) matmul_chain_sync_kernel(int n_steps) {
    cg::grid_group grid = cg::this_grid();
    for (int s = 0; s < n_steps; ++s)
        for (int i = 0; i < 2 * MC_L; ++i) grid.sync();
}

// the plan's units, each waiting for its rows' counter and arriving on its
// own, with nothing between (one thread a block)
__global__ void __launch_bounds__(32) matmul_chain_counter_kernel(const __grid_constant__ McArgs a) {
    if (threadIdx.x != 0) return;
    for (int s = 0; s < a.n_steps; ++s) {
        for (int l = 0; l < MC_L; ++l) {
            const unsigned k = (unsigned)(s * MC_L + l);
            for (int P = 0; P < 2; ++P) {
                const McProd& pr = a.p[P];
                for (int u = blockIdx.x; u < pr.units; u += gridDim.x) {
                    const int rgi = u / pr.G;
                    if (P == 1) wait_counter(a.ctr + rgi, (k + 1) * (unsigned)a.p[0].G);
                    else if (k > 0) wait_counter(a.ctr + a.rg + rgi, k * (unsigned)a.p[1].G);
                    arrive_counter(a.ctr + P * a.rg + rgi);
                }
            }
        }
    }
}

// ---- host side -----------------------------------------------------------
static const void* chain_fn(int V) {
    switch (V) {
    case MC_SPLIT: return (const void*)matmul_chain_kernel<MC_SPLIT>;
    case MC_MERGED: return (const void*)matmul_chain_kernel<MC_MERGED>;
    case MC_SPINE: return (const void*)matmul_chain_kernel<MC_SPINE>;
    case MC_FULL: return (const void*)matmul_chain_kernel<MC_FULL>;
    case MC_DUAL: return (const void*)matmul_chain_kernel<MC_DUAL>;
    case MC_INT8: return (const void*)matmul_chain_kernel<MC_INT8>;
    default: return (const void*)matmul_chain_kernel<MC_INT8RAW>;
    }
}

static int sm_count(int* sms, int* coop) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
    return (int)e;
}

// Blocks of fn (block threads, smem bytes) the card holds co-resident: 0 or
// a CUDA error.
static int capacity(const void* fn, int block, int smem, int sms, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int bps = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, block, smem);
    *blocks = bps * sms;
    return (int)e;
}

// Check the plan (ops/matmul_chain.py::plan_array) against the variant's
// shapes and the card, and fill the arguments: 0, -1 (the grid cannot be
// co-resident), -2 (no cooperative launch), -3 (a plan that does not cut
// the products or fit shared memory), or a CUDA error.
static int check_plan(const int* p, int V, int B, McArgs* a, int* grid, int* smem) {
    const int Mp = p[0], Mh = p[1], rows = p[2], rg = p[3], group = p[5];
    *grid = p[4];
    *smem = p[11];
    const bool q8 = V == MC_INT8 || V == MC_INT8RAW, dual = V == MC_DUAL;
    const int esz = q8 ? 1 : 2;
    if (V < 0 || V >= MC_NVARIANTS || B < 1 || B > MC_B_MAX || (dual && B < 2)
        || rows != MC_SLAB || rg < 1 || rows * rg != Mp || Mp < B || Mp > MC_B_MAX
        || (dual ? (Mp != 2 * Mh || Mh < B - B / 2 || Mh % rows) : Mh != 0) || *grid < 1
        || (group != 1 && group != 2 && group != 4) || (MC_R * esz / MC_CHUNK) % group)
        return -3;
    a->Mp = Mp;
    a->Mh = Mh;
    a->rows = rows;
    a->rg = rg;
    a->group = group;
    a->stages = p[6];
    a->a_bytes = p[7];
    a->stage_bytes = p[8];
    a->scratch = p[9];
    a->epi = p[10];
    int wmax = 0, nwmax = 0, epi = 0;
    for (int i = 0; i < 2; ++i) {
        McProd& pr = a->p[i];
        const int* q = p + 18 + 7 * i;
        int K, N, Q;
        product_shape(V, i, &K, &N, &Q);
        pr.K = q[0];
        pr.N = q[1];
        pr.q = q[2];
        pr.cw = q[3];
        pr.nw = q[4];
        pr.G = q[5];
        pr.nc = q[6];
        // cw a power of two from 8: a unit's columns all dead or all live
        if (pr.K != K || pr.N != N || pr.q != Q || pr.cw < 8 || (pr.cw & (pr.cw - 1))
            || N % (Q * pr.cw) || pr.G != N / (Q * pr.cw) || pr.nc != K * esz / MC_CHUNK
            || pr.nc % (2 * group) || pr.nw != Q * pr.cw
            || (pr.nw != 16 && pr.nw != 32 && pr.nw != 64 && pr.nw != 128))
            return -3;
        nwmax = std::max(nwmax, pr.nw);
        pr.units = rg * pr.G;
        pr.w_bytes = Q * pr.cw * MC_CHUNK;
        epi = std::max(epi, rows * pr.cw * 4 + (V == MC_INT8 ? 4 * Q * pr.cw : 0));
        wmax = std::max(wmax, pr.w_bytes);
    }
    if (a->a_bytes != rows * MC_CHUNK * group || a->stage_bytes < a->a_bytes + wmax * group
        || a->stage_bytes % 1024 || a->stages < 2 || a->stages > MC_RING_MAX
        || a->scratch < 256 * nwmax || a->scratch % 16 || a->epi < epi
        || *smem < MC_SMEM_FIXED + a->stages * a->stage_bytes + a->scratch + a->epi
        || *smem > MC_SMEM_MAX)
        return -3;
    // the workspace: a1, a2, st, sink, dead, total (bytes, 256-aligned)
    const long long R = MC_R, S = MC_S;
    const long long need[5] = {Mp * R * esz, Mp * a->p[1].K * esz, Mp * R * 4, Mp * R * 4,
                               Mp * (R + S) * 4};
    for (int i = 0; i < 5; ++i)
        if (p[12 + i] % 256 || (long long)p[12 + i] + need[i] > p[13 + i]) return -3;
    int sms = 0, coop = 0, blocks = 0;
    int e = sm_count(&sms, &coop);
    if (e != 0) return e;
    if (!coop) return -2;
    e = capacity(chain_fn(V), MC_BLOCK, *smem, sms, &blocks);
    if (e != 0) return e;
    if (blocks < *grid) return -1;
    return 0;
}

// A row-major (rows, K) operand of `elem`-byte values as a 3-D TMA map of
// its 128-byte chunks: (values of a chunk, rows, chunks), the chunks 128
// bytes apart; a box is `group` chunks of box_rows rows, laid out in shared
// memory as `group` tiles of box_rows x 128 bytes, each in the 128-byte
// swizzle.  0 or a CUDA error.
static int chunk_map(CUtensorMap* m, const void* ptr, int elem, long long K, long long rows,
                     int box_rows, int group) {
    wg_encode_fn enc = wg_encoder();
    if (!enc) return (int)cudaErrorNotSupported;
    const long long depth = MC_CHUNK / elem;
    if ((elem != 1 && elem != 2) || K % depth || ((uintptr_t)ptr & 15) != 0 || box_rows < 1
        || box_rows > 256)
        return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[3] = {(cuuint64_t)depth, (cuuint64_t)rows, (cuuint64_t)(K / depth)};
    const cuuint64_t strides[2] = {(cuuint64_t)(K * elem), (cuuint64_t)MC_CHUNK};
    const cuuint32_t box[3] = {(cuuint32_t)depth, (cuuint32_t)box_rows, (cuuint32_t)group};
    const cuuint32_t estr[3] = {1u, 1u, 1u};
    const CUresult r = enc(m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                           3, (void*)ptr, dims, strides, box, estr,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" {

// What the plan needs from the card: info = SMs, cooperative launch (0/1),
// the blocks of the chain kernel (288 threads, at the full 227 KB of shared
// memory) the card holds co-resident.  0 or a CUDA error.
int wn_matmul_chain_plan(long long* info) {
    int sms = 0, coop = 0, blocks = 0;
    int e = sm_count(&sms, &coop);
    if (e == 0) e = capacity(chain_fn(MC_SPLIT), MC_BLOCK, MC_SMEM_MAX, sms, &blocks);
    if (e != 0) return e;
    info[0] = sms;
    info[1] = coop;
    info[2] = blocks;
    return 0;
}

// x0 (B, R) bf16; w1, w2: each product's weights packed per unit as the plan
// cuts them (ops/matmul_chain.py::pack_chain_weights); wsc: int8's column
// scales; y (B, R) bf16; ws: the plan's workspace; ctr: the plan's
// counters, zeroed int32; phase: null, or (grid, MC_PHASES) zeroed u64 that
// the run adds to, per block: asking for operands (the producer's issue
// time, its polls excluded), a unit's wait for its first chunk, its
// products, its epilogue to the arrival (ns), the units, the producer's
// polling time (ns), its units and polls, the unit's first chunk to its
// last (ns), the producer's issue time after its polls (ns); plan: host int32,
// ops/matmul_chain.py::plan_array.  0, a negative plan error or a CUDA
// error.
int wn_matmul_chain(const void* x0, const void* w1, const void* w2, const void* wsc, void* y,
                    void* ws, void* ctr, void* phase, const void* plan, int variant, int B,
                    int n_steps, void* stream) {
    if (n_steps < 1) return -3;
    McArgs a{};
    int grid = 0, smem = 0;
    const int* p = (const int*)plan;
    int err = check_plan(p, variant, B, &a, &grid, &smem);
    if (err != 0) return err;
    unsigned char* base = (unsigned char*)ws;
    a.a1 = base + p[12];
    a.a2 = base + p[13];
    a.st = base + p[14];
    a.sink = base + p[15];
    a.dead = base + p[16];
    a.x0 = (const bf16*)x0;
    a.w[0] = (const unsigned char*)w1;
    a.w[1] = (const unsigned char*)w2;
    a.wsc = (const float*)wsc;
    a.y = (bf16*)y;
    a.ctr = (unsigned*)ctr;
    a.B = B;
    a.n_steps = n_steps;
    a.phase = (unsigned long long*)phase;
    const int esz = (variant == MC_INT8 || variant == MC_INT8RAW) ? 1 : 2;
    err = chunk_map(&a.ma[0], a.a1, esz, MC_R, a.Mp, a.rows, a.group);
    if (err == 0) err = chunk_map(&a.ma[1], a.a2, esz, a.p[1].K, a.Mp, a.rows, a.group);
    if (err != 0) return err;
    void* args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(chain_fn(variant), dim3(grid),
                                                      dim3(MC_BLOCK), args, smem,
                                                      (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

const char* wn_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The waits alone, n_steps steps: mode 0, 60 grid.sync() a step on one
// block per SM (cooperative); mode 1, the plan's units of `variant` at B
// rows with their counter waits and arrivals (ctr zeroed).  0, a negative
// plan error or a CUDA error.
int wn_matmul_chain_barrier(int mode, int variant, int B, const void* plan, void* ctr,
                            int n_steps, void* stream) {
    int sms = 0, coop = 0;
    int e = sm_count(&sms, &coop);
    if (e != 0) return e;
    if (!coop) return -2;
    if (mode == 0) {
        void* args[] = {&n_steps};
        e = (int)cudaLaunchCooperativeKernel((const void*)matmul_chain_sync_kernel, dim3(sms),
                                             dim3(MC_CONSUMERS), args, 0, (cudaStream_t)stream);
        if (e != 0) return e;
        return (int)cudaGetLastError();
    }
    McArgs a{};
    int grid = 0, smem = 0;
    e = check_plan((const int*)plan, variant, B, &a, &grid, &smem);
    if (e != 0) return e;
    if (grid > sms) return -3;
    a.ctr = (unsigned*)ctr;
    a.n_steps = n_steps;
    void* args[] = {&a};
    e = (int)cudaLaunchCooperativeKernel((const void*)matmul_chain_counter_kernel, dim3(grid),
                                         dim3(32), args, 0, (cudaStream_t)stream);
    if (e != 0) return e;
    return (int)cudaGetLastError();
}

}  // extern "C"
