// Fused OTA matched-filter combine with in-kernel channel generation,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// src/repro/kernels/fused_mac.py (wrapper `fused_mac`).  It computes
//
//   y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
//                   * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])
//
// with h = amp[b,u] * g, g ~ CN(0, sigma_h2) and z ~ CN(0, sigma_z2)
// drawn inside the kernel from a threefry2x32 counter PRNG, so no
// [U, K, N] channel tensor ever exists.  Draws are the reference's,
// bit for bit in their uint32 words:
//   channel: key (s0 + rx*GOLDEN, s1 + 1*STREAM),
//            counter ((u + u_base)*Kstride + k, n + n_base)
//   noise:   key (s0 + rx*GOLDEN, s1 + 2*STREAM), counter (k, n + n_base)
// with rx = rx_base + b and Kstride = roundup(K, 128); each word pair
// feeds Box-Muller on its top 24 bits.
//
// What bounds it on this card: operations, not bytes.  Every one of the
// B*U*K*N + B*K*N complex draws costs one threefry2x32 block (about 75
// int32 add/rotate/xor operations) plus a log, a sqrt, a sin and a cos;
// the only bytes moved are t, amp, w (read) and y (written).
//
// Design: the TPU kernel walks its U grid axis in order and carries the
// received signal r and matched filter mf in VMEM scratch.  Hopper
// blocks run in no order, so that sequential axis becomes a loop inside
// each thread instead: one block per (32 symbols, rx station), 8 thread
// rows over the antennas.  A thread owns the (b, k, n) cells
// k = ty, ty+8, ...; for each it starts r at z and mf at 0, loops over u
// in ascending order keeping both in registers, and adds conj(mf) * r to
// its running sum.  A fixed-order sum over the 8 rows in shared memory
// gives y[b, n].  No atomics and no device buffer besides y, so every
// launch gives the same bits.  Precise libm (no fast math): logf, sqrtf
// and sincosf match the plain PyTorch version to a few ULP.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 32;   // symbols per block (one warp row)
constexpr int kTK = 8;    // antenna rows per block

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kStream = 0x85EBCA77u;
constexpr float kU24 = 5.9604644775390625e-08f;      // 2^-24
constexpr float kTwoPi = 6.2831854820251465f;        // float32(2*pi)

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry2x32 (jax.random's block cipher), in place on (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r); \
  x1 ^= x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_EVEN
#undef TF_ODD
#undef TF_ROUND
}

// Two words -> sigma * (two independent N(0, 1) draws).
__device__ __forceinline__ void cx_normal(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1,
                                          float sigma, float& re,
                                          float& im) {
  threefry2x32(k0, k1, x0, x1);
  const float u1 = 1.0f - static_cast<float>(x0 >> 8) * kU24;  // (0, 1]
  const float u2 = static_cast<float>(x1 >> 8) * kU24;         // [0, 1)
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  re = sigma * (r * c);
  im = sigma * (r * s);
}

__global__ void __launch_bounds__(kTN * kTK)
fused_mac_kernel(const uint32_t* __restrict__ words,
                 const float* __restrict__ t_re,
                 const float* __restrict__ t_im,
                 const float* __restrict__ amp,
                 const float* __restrict__ w,
                 float* __restrict__ y_re, float* __restrict__ y_im,
                 int U, int K, int N, uint32_t kstride, float sigma_h,
                 float sigma_z) {
  __shared__ float s_re[kTK][kTN];
  __shared__ float s_im[kTK][kTN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kTN + tx;

  const uint32_t rx = words[2] + static_cast<uint32_t>(b);
  const uint32_t u_base = words[3];
  const uint32_t key0 = words[0] + rx * kGolden;
  const uint32_t chan_key1 = words[1] + 1u * kStream;
  const uint32_t noise_key1 = words[1] + 2u * kStream;

  float acc_re = 0.0f, acc_im = 0.0f;
  if (n < N) {
    const uint32_t nn = static_cast<uint32_t>(n) + words[4];
    const float* amp_b = amp + static_cast<size_t>(b) * U;
    const float* w_b = w + static_cast<size_t>(b) * U;
    for (int k = ty; k < K; k += kTK) {
      float r_re, r_im;
      cx_normal(key0, noise_key1, static_cast<uint32_t>(k), nn, sigma_z,
                r_re, r_im);
      float mf_re = 0.0f, mf_im = 0.0f;
      for (int u = 0; u < U; ++u) {
        const uint32_t x0 =
            (static_cast<uint32_t>(u) + u_base) * kstride +
            static_cast<uint32_t>(k);
        float g_re, g_im;
        cx_normal(key0, chan_key1, x0, nn, sigma_h, g_re, g_im);
        const float a = amp_b[u];
        const float wa = w_b[u] * a;
        const float h_re = a * g_re;
        const float h_im = a * g_im;
        const float tr = t_re[static_cast<size_t>(u) * N + n];
        const float ti = t_im[static_cast<size_t>(u) * N + n];
        r_re += h_re * tr - h_im * ti;
        r_im += h_re * ti + h_im * tr;
        mf_re += wa * g_re;
        mf_im += wa * g_im;
      }
      acc_re += mf_re * r_re + mf_im * r_im;
      acc_im += mf_re * r_im - mf_im * r_re;
    }
  }
  s_re[ty][tx] = acc_re;
  s_im[ty][tx] = acc_im;
  __syncthreads();
  if (ty == 0 && n < N) {
    float yr = 0.0f, yi = 0.0f;
    for (int j = 0; j < kTK; ++j) {
      yr += s_re[j][tx];
      yi += s_im[j][tx];
    }
    y_re[static_cast<size_t>(b) * N + n] = yr;
    y_im[static_cast<size_t>(b) * N + n] = yi;
  }
}

}  // namespace

// words: uint32 [8] on the device = (s0, s1, rx_base, u_base, n_base, 0,
// 0, 0); t_re, t_im: float32 [U, N]; amp, w: float32 [B, U]; y_re, y_im:
// float32 [B, N].  All contiguous.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() as an int.
extern "C" int fused_mac_launch(const void* words, const void* t_re,
                                const void* t_im, const void* amp,
                                const void* w, void* y_re, void* y_im,
                                int B, int U, int K, int N, float sigma_h,
                                float sigma_z, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const uint32_t kstride =
      static_cast<uint32_t>((K + 127) / 128 * 128);
  const dim3 block(kTN, kTK);
  const dim3 grid((N + kTN - 1) / kTN, B);
  fused_mac_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(t_re),
      static_cast<const float*>(t_im), static_cast<const float*>(amp),
      static_cast<const float*>(w), static_cast<float*>(y_re),
      static_cast<float*>(y_im), U, K, N, kstride, sigma_h, sigma_z);
  return static_cast<int>(cudaGetLastError());
}
