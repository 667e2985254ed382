// Helpers shared by the WaveNet kernels (bf16 rounding, the gate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

static __device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

static __device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// value rounded to bf16 and back: what a bf16 cast does to an f32
static __device__ __forceinline__ float bf_round(float v) { return bf2f(f2bf(v)); }

static __device__ __forceinline__ float wn_sigmoid(float s) {
    return 1.0f / (1.0f + expf(-s));
}

// sigmoid(s) * tanh(t) in f32: the WaveNet gate
static __device__ __forceinline__ float wn_gate(float s, float t) {
    return wn_sigmoid(s) * tanhf(t);
}
