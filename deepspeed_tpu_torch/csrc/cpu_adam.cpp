// Host-side vectorized Adam/AdamW for ZeRO-Offload.
//
// TPU-native counterpart of reference csrc/adam/cpu_adam_impl.cpp (AVX via
// csrc/includes/simd.h, claimed 5-7x over torch CPU Adam). Here the SIMD comes
// from `#pragma omp simd` over 64-bit-aligned float buffers plus OpenMP thread
// parallelism — the compiler emits AVX2/AVX-512 for -march=native, without
// hand-written intrinsics (and therefore without per-ISA source variants like
// the reference's AVX256/AVX512 paths).
//
// Exposed via ctypes (extern "C"): the Python wrapper owns the numpy buffers;
// everything here updates in place. All math is fp32 (master weights); the
// caller handles lp-precision casts.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// One fused Adam step over a flat parameter shard.
//   p, g, m, v : fp32 buffers of length n (updated in place except g)
//   grad_scale : multiply grads by this (loss-scale unscale), 1.0 = none
//   clip_coef  : multiply grads by this (global-norm clip), 1.0 = none
//   step       : 1-based step count (for bias correction)
//   adamw      : nonzero = decoupled weight decay, else L2-into-gradient
void ds_adam_step(float* p, const float* g, float* m, float* v, int64_t n,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int64_t step, int adamw,
                  int bias_correction, float grad_scale, float clip_coef) {
    const float bc1 = bias_correction ? 1.0f - std::pow(beta1, (float)step) : 1.0f;
    const float bc2 = bias_correction ? 1.0f - std::pow(beta2, (float)step) : 1.0f;
    const float gmul = grad_scale * clip_coef;
    const float b1 = beta1, b2 = beta2;

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i] * gmul;
        if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
        float m_ = b1 * m[i] + (1.0f - b1) * grad;
        float v_ = b2 * v[i] + (1.0f - b2) * grad * grad;
        m[i] = m_;
        v[i] = v_;
        float denom = std::sqrt(v_ / bc2) + eps;
        float update = (m_ / bc1) / denom;
        float newp = p[i] - lr * update;
        if (adamw && weight_decay != 0.0f) newp -= lr * weight_decay * p[i];
        p[i] = newp;
    }
}

// Adagrad step (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(float* p, const float* g, float* v, int64_t n, float lr,
                     float eps, float weight_decay, float grad_scale) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i] * grad_scale + weight_decay * p[i];
        float v_ = v[i] + grad * grad;
        v[i] = v_;
        p[i] -= lr * grad / (std::sqrt(v_) + eps);
    }
}

// Lion step (reference csrc/lion).
void ds_lion_step(float* p, const float* g, float* m, int64_t n, float lr,
                  float beta1, float beta2, float weight_decay, float grad_scale) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i] * grad_scale;
        float c = beta1 * m[i] + (1.0f - beta1) * grad;
        float sign = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
        p[i] = p[i] * (1.0f - lr * weight_decay) - lr * sign;
        m[i] = beta2 * m[i] + (1.0f - beta2) * grad;
    }
}

// fp32 -> bf16 (round-to-nearest-even) for pushing updated lp weights back.
void ds_f32_to_bf16(uint16_t* dst, const float* src, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, &src[i], 4);
        uint32_t lsb = (bits >> 16) & 1u;
        bits += 0x7fffu + lsb;  // RNE
        dst[i] = (uint16_t)(bits >> 16);
    }
}

// squared L2 norm of a gradient buffer (for host-side global-norm clipping)
double ds_sq_norm(const float* g, int64_t n, float grad_scale) {
    double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double x = (double)g[i] * grad_scale;
        acc += x * x;
    }
    return acc;
}

}  // extern "C"
