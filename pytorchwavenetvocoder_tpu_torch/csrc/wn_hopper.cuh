// Hopper helpers shared by the persistent kernels (csrc/matmul_chain.cu,
// csrc/ar_persistent.cu): bulk copies into shared memory completing on
// mbarriers, the proxy fence their writers need, 16-byte cp.async copies,
// the arrival counters the kernels' stages wait on in place of a grid
// barrier, and the counter-based Philox4x32-10 Gumbel noise of the AR
// sampler.
#pragma once

#include <stdint.h>

#include "wn_common.cuh"

// the global nanosecond timer (phase times of the persistent kernels)
static __device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}

// ---- bulk copies -----------------------------------------------------------
static __device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// one thread: the barrier's one arrival, expecting `bytes`, then the copies
static __device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                                 unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile("{\n .reg .pred done;\n"
                 "MC_WAIT_%=:\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 " @!done bra MC_WAIT_%=;\n}\n"
                 ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// 16 bytes global -> shared by cp.async (L2 only), completing in the
// thread's current group
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every cp.async group of this thread
static __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// order this thread's generic-proxy writes to global memory before later
// async-proxy reads of them (the bulk copies of the next stage, after the
// barrier); the readers need no fence of their own
static __device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- arrival counters --------------------------------------------------------
// A stage's units add 1 to a counter in device memory once their writes are
// done (the writers fence the proxies, the block syncs, one thread adds with
// release semantics); a unit of the next stage polls it with acquire
// semantics until it reaches its target.  Counters grow over a launch and
// are never reset within it; they are u32 and wrap (a long decode passes
// 2^32 arrivals on one counter), so a counter has reached its target when
// (counter - target) read as signed is not negative, both mod 2^32: no
// counter runs 2^31 past or behind a unit that waits on it (it gains at
// most one run of its stage beyond the run the waiter needs).

// polls before a wait gives up: no healthy wait lasts a millisecond, and a
// fault in a plan then surfaces as a launch error, not a hung card
#define WN_POLL_MAX (1u << 24)

static __device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

static __device__ __forceinline__ void arrive_counter(unsigned* p) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(1u) : "memory");
}

// poll *p until it reaches target (mod 2^32, above); traps after
// WN_POLL_MAX polls; returns the polls before the one that found it reached
// (0: the first did)
static __device__ __forceinline__ unsigned wait_counter(const unsigned* p, unsigned target) {
    for (unsigned i = 0;; ++i) {
        if ((int)(ld_acquire(p) - target) >= 0) return i;
        if (i > WN_POLL_MAX) __trap();
    }
}

// ---- Philox ----------------------------------------------------------------
static __device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
    const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    unsigned hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    unsigned hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

static __device__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        if (i) { k.x += 0x9E3779B9u; k.y += 0xBB67AE85u; }
        c = philox_round(c, k);
    }
    return c;
}

// Gumbel noise for (row, step, class) of classes cls4 .. cls4 + 3 (cls4 a
// multiple of 4): the four words of the Philox block of counter (class / 4,
// row, step, 0) under the key (seed's low word, its high word), word class
// % 4 for each class; the uniform is ((bits >> 9) + 0.5) * 2^-23, which lies
// in the open interval (0, 1) and is exact in f32.
static __device__ void gumbel_noise4(unsigned long long seed, int row, int step,
                                     int cls4, float g[4]) {
    uint4 ctr = make_uint4((unsigned)cls4 >> 2, (unsigned)row, (unsigned)step, 0u);
    uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
    uint4 r = philox4x32_10(ctr, key);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float u = ((float)(w[i] >> 9) + 0.5f) * (1.0f / 8388608.0f);
        g[i] = -logf(-logf(u));
    }
}
