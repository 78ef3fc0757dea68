// Native coefficient-table builder for libiqo_tpu_torch (the port's copy of
// libiqo_tpu/native/iqo_tables.cpp; the code is the same).
//
// The reference constructs coefficient tables in C++ at resizer-construction
// time (ref: src/IQOLanczosResizerImpl_Generic.cpp:291-339); its benchmark
// protocol rebuilds the resizer every cycle (ref: benchmark/benchmark.cpp:
// 1019-1031), making table construction a hot path.  This module is the
// port's equivalent native layer: it builds all phase tables for
// one axis in a single C call, bit-identical to the pure-NumPy engine in
// coeffs/engine.py (strict IEEE float/double arithmetic; compile WITHOUT
// fast-math).
//
// Exposed via a plain C ABI, loaded through ctypes (coeffs/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

double sinc(double x) {
    double pi_x = 3.14159265358979 * x;
    return std::sin(pi_x) / pi_x;
}

double lanczos_window(int degree, double x) {
    double ax = std::fabs(x);
    if (std::fmod(ax, 1.0) < 1e-5) {
        return ax < 1e-5 ? 1.0 : 0.0;
    }
    if (degree <= ax) {
        return 0.0;
    }
    return sinc(x) * sinc(x / degree);
}

// float32 taps for one Lanczos phase + sequential float32 sum
float set_lanczos_table(int degree, int64_t src_len, int64_t dst_len,
                        int64_t dst_offset, int64_t px_scale,
                        int64_t num_coefs, float* table) {
    double begin_x;
    int64_t step_src_len, step_px_scale;
    if (src_len > dst_len) {
        int64_t deg_factor = px_scale / degree;
        if (deg_factor < 1) deg_factor = 1;
        begin_x = -(double)degree * (double)deg_factor
                  - 0.5 * (double)px_scale
                  + 0.5 * (double)dst_len * (double)px_scale / (double)src_len
                  + (double)((dst_len - dst_offset * src_len % dst_len)
                             * px_scale % src_len) / (double)src_len;
        step_src_len = src_len;
        step_px_scale = px_scale;
    } else {
        double src_offset =
            std::fmod((double)(dst_offset * src_len) / (double)dst_len, 1.0);
        begin_x = -(double)degree + 1.0 - src_offset;
        step_src_len = dst_len;
        step_px_scale = 1;
    }
    float sum = 0.0f;
    for (int64_t i = 0; i < num_coefs; ++i) {
        double x = begin_x
                   + (double)(i * dst_len * step_px_scale) / (double)step_src_len;
        float v = (float)lanczos_window(degree, x);
        table[i] = v;
        sum += v;
    }
    return sum;
}

float set_area_table(int64_t src_len, int64_t dst_len, int64_t dst_offset,
                     int64_t num_coefs, float* table) {
    double src_begin = (double)(dst_offset * src_len) / (double)dst_len;
    double src_end = (double)((dst_offset + 1) * src_len) / (double)dst_len;
    double src_x = src_begin;
    float sum = 0.0f;
    for (int64_t i = 0; i < num_coefs; ++i) {
        double next = std::floor(src_x) + 1.0;
        if (src_end < next) next = src_end;
        float v = (float)(next - src_x);
        table[i] = v;
        sum += v;
        src_x = next;
    }
    return sum;
}

// exact-sum quantization with 16-bit storage wrap
// (ref: src/IQOLanczosResizerImpl_Generic.cpp:341-367 and the int16_t
// narrowing gcc applies when pathological phases overflow)
void adjust_coefs(float* taps, float f_sum, int64_t n, int64_t bias,
                  int is_signed, int32_t* out) {
    int64_t dst_sum = 0;
    for (int64_t i = 0; i < n; ++i) {
        float v = (float)(taps[i] * (float)bias) / f_sum;
        float r = std::floor(v + 0.5f);
        int64_t q = (int64_t)r;  // trunc (r is integral)
        if (is_signed) {
            q = ((q + 32768) & 65535) - 32768;
        } else {
            q &= 65535;
        }
        out[i] = (int32_t)q;
        dst_sum += q;
    }
    while (dst_sum < bias) {
        int64_t arg = 0;
        for (int64_t i = 1; i < n; ++i) {
            if (taps[i] > taps[arg]) arg = i;
        }
        out[arg] += 1;
        taps[arg] = 0.0f;
        dst_sum += 1;
    }
    while (dst_sum > bias) {
        int64_t arg = 0;
        for (int64_t i = 1; i < n; ++i) {
            if (taps[i] > taps[arg]) arg = i;
        }
        out[arg] -= 1;
        taps[arg] = 0.0f;
        dst_sum -= 1;
    }
    if (is_signed) {
        for (int64_t i = 0; i < n; ++i) {
            out[i] = (int32_t)((((int64_t)out[i] + 32768) & 65535) - 32768);
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            out[i] = (int32_t)((int64_t)out[i] & 65535);
        }
    }
}

}  // namespace

extern "C" {

// Build all r_dst Lanczos phase tables, quantized.  out: [r_dst * num_coefs]
int iqo_lanczos_tables(int degree, int64_t r_src, int64_t r_dst,
                       int64_t px_scale, int64_t num_coefs, int64_t bias,
                       int32_t* out) {
    if (num_coefs <= 0 || num_coefs > 4096) return 1;
    float taps[4096];
    for (int64_t d = 0; d < r_dst; ++d) {
        float sum = set_lanczos_table(degree, r_src, r_dst, d, px_scale,
                                      num_coefs, taps);
        adjust_coefs(taps, sum, num_coefs, bias, /*is_signed=*/1,
                     out + d * num_coefs);
    }
    return 0;
}

int iqo_area_tables(int64_t r_src, int64_t r_dst, int64_t num_coefs,
                    int64_t bias, int32_t* out) {
    if (num_coefs <= 0 || num_coefs > 4096) return 1;
    float taps[4096];
    for (int64_t d = 0; d < r_dst; ++d) {
        float sum = set_area_table(r_src, r_dst, d, num_coefs, taps);
        adjust_coefs(taps, sum, num_coefs, bias, /*is_signed=*/0,
                     out + d * num_coefs);
    }
    return 0;
}

// Linear 2-tap tables (ref: src/IQOLinearResizerImpl_Generic.cpp:29-69,
// 193-208).  out: [r_dst * 2]
int iqo_linear_tables(int64_t r_src, int64_t r_dst, int64_t bias,
                      int32_t* out) {
    for (int64_t i = 0; i < r_dst; ++i) {
        double ipart;
        double frac = std::modf(((double)i + 0.5) * (double)r_src
                                / (double)r_dst + 0.5, &ipart);
        float coef1 = (float)frac;
        float coef0f = 1.0f - coef1;
        float v = std::floor((float)(coef0f * (float)bias) + 0.5f);
        int64_t c0 = (int64_t)v;
        out[i * 2 + 0] = (int32_t)c0;
        out[i * 2 + 1] = (int32_t)(bias - c0);
    }
    return 0;
}

}  // extern "C"
