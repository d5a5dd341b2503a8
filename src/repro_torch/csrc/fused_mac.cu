// Fused OTA matched-filter combine with in-kernel channel generation,
// for Hopper (sm_90a): the full combine, its per-u-block partial sums,
// and the pinned-order fold of those partial sums.
//
// `fused_mac_kernel` replaces the Pallas TPU kernel `_fused_kernel` of
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
// `fused_partials_kernel` replaces the Pallas TPU kernel
// `_fused_partial_kernel` (wrapper `fused_mac_partials`): per u-block g
// of `block_u` users it writes the block's pre-contraction sums
//   pr[b,g,k,n] = sum_{u in g} h[b,u,k,n] t[u,n]
//   pm[b,g,k,n] = sum_{u in g} w[b,u] h[b,u,k,n]
// with no noise.  `fused_reduce_kernel` is the JAX package's jnp helper
// `fused_partials_reduce`: it draws z, folds the blocks g = 0..G-1 into
// r = z + sum pr and mf = sum pm in ascending order and contracts over
// k.  A caller that owns only a tile of the user axis (the u-sharded
// cluster hop) emits its blocks with `fused_partials_kernel`, and the
// fold of every tile's blocks in global block order gives `fused_mac`'s
// y bit for bit: all three kernels share the per-block sum
// (`block_sums`), the noise draw and the finalize (`add_conj_product`,
// `store_row_sum`), each written with explicit round-to-nearest
// intrinsics so that nvcc cannot contract a product and a sum into an
// FMA in one kernel and not in another.  `fused_mac_kernel` folds its
// own blocks in the same order: r starts at z, mf at 0, and each
// block's sum (from 0, u ascending) is added to them in turn.
//
// What bounds them on this card: operations, not bytes.  Every one of
// the B*U*K*N (+ B*K*N noise) complex draws issues one threefry2x32
// block (rotates, xors and adds), Box-Muller's polynomial log and
// sincos, one reciprocal square root and the sums: about 190
// instructions on the u loop, the ALU pipe's share the largest
// (`python -m repro_torch.kernels.sass` counts them by pipe).  The
// bytes moved are t, amp, w (read) and y or the partial sums
// (written).  The fold is bound by bytes: it reads the 4 x B*G*K*N
// partial sums once and draws only B*K*N noise values.
//
// Design: the TPU kernels walk their U grid axis in order and carry the
// received signal r and matched filter mf in VMEM scratch.  Hopper
// blocks run in no order, so that sequential axis becomes a loop inside
// each thread instead: one block per (32 symbols, rx station) with 8
// thread rows over the antennas for the combine and the fold, and one
// block per (32 symbols, u-block, rx station) with up to 8 rows for the
// partial sums.  A thread owns the cells k = ty, ty+8, ... and keeps its
// sums in registers; the combine and the fold add conj(mf) * r to a
// running sum, and a fixed-order sum over the 8 rows in shared memory
// gives y[b, n].  Every output cell is written by exactly one thread:
// no atomics and no device buffer besides the outputs, so every launch
// gives the same bits.  Precise libm (no fast math): logf, sqrtf and
// sincosf match the plain PyTorch version to a few ULP.
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
  const float u1 = __fsub_rn(                                  // (0, 1]
      1.0f, __fmul_rn(static_cast<float>(x0 >> 8), kU24));
  const float u2 = __fmul_rn(static_cast<float>(x1 >> 8), kU24);  // [0, 1)
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincosf(__fmul_rn(kTwoPi, u2), &s, &c);
  re = __fmul_rn(sigma, __fmul_rn(r, c));
  im = __fmul_rn(sigma, __fmul_rn(r, s));
}

// The threefry keys of rx station rx_base + b: (s0 + rx*GOLDEN) and the
// channel and noise streams' second words.
struct Keys {
  uint32_t k0, chan, noise;
};

__device__ __forceinline__ Keys stream_keys(const uint32_t* words, int b) {
  const uint32_t rx = words[2] + static_cast<uint32_t>(b);
  return {words[0] + rx * kGolden, words[1] + 1u * kStream,
          words[1] + 2u * kStream};
}

// One u-block's sums at one (rx, k, n) cell, each from 0 over the
// users u0 <= u < u1 in ascending order: pr = sum h t, pm = sum w h.
struct Sums {
  float pr_re, pr_im, pm_re, pm_im;
};

// Each user advances the channel counter by `kstride` and the symbol
// pointers by one row of N.
__device__ __forceinline__ Sums block_sums(
    const Keys& key, uint32_t kstride, uint32_t u_base, int k, uint32_t nn,
    int n, int N, int u0, int u1, const float* __restrict__ amp_b,
    const float* __restrict__ w_b, const float* __restrict__ t_re,
    const float* __restrict__ t_im, float sigma_h) {
  Sums s = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t x0 = (static_cast<uint32_t>(u0) + u_base) * kstride +
                static_cast<uint32_t>(k);
  const float* tr_u = t_re + static_cast<size_t>(u0) * N + n;
  const float* ti_u = t_im + static_cast<size_t>(u0) * N + n;
  for (int u = u0; u < u1; ++u) {
    float g_re, g_im;
    cx_normal(key.k0, key.chan, x0, nn, sigma_h, g_re, g_im);
    const float a = amp_b[u];
    const float wa = __fmul_rn(w_b[u], a);
    const float h_re = __fmul_rn(a, g_re);
    const float h_im = __fmul_rn(a, g_im);
    const float tr = *tr_u;
    const float ti = *ti_u;
    s.pr_re = __fadd_rn(s.pr_re,
                        __fsub_rn(__fmul_rn(h_re, tr), __fmul_rn(h_im, ti)));
    s.pr_im = __fadd_rn(s.pr_im,
                        __fadd_rn(__fmul_rn(h_re, ti), __fmul_rn(h_im, tr)));
    s.pm_re = __fadd_rn(s.pm_re, __fmul_rn(wa, g_re));
    s.pm_im = __fadd_rn(s.pm_im, __fmul_rn(wa, g_im));
    x0 += kstride;
    tr_u += N;
    ti_u += N;
  }
  return s;
}

// acc += conj(mf) * r for one antenna row.
__device__ __forceinline__ void add_conj_product(float& acc_re,
                                                 float& acc_im, float mf_re,
                                                 float mf_im, float r_re,
                                                 float r_im) {
  acc_re = __fadd_rn(acc_re,
                     __fadd_rn(__fmul_rn(mf_re, r_re), __fmul_rn(mf_im, r_im)));
  acc_im = __fadd_rn(acc_im,
                     __fsub_rn(__fmul_rn(mf_re, r_im), __fmul_rn(mf_im, r_re)));
}

// y[n] = the sum of the block's kTK thread rows' running sums, in row
// order, through shared memory.  Every thread of the block calls it.
__device__ __forceinline__ void store_row_sum(float acc_re, float acc_im,
                                              int n, int N,
                                              float* __restrict__ y_re,
                                              float* __restrict__ y_im) {
  __shared__ float s_re[kTK][kTN];
  __shared__ float s_im[kTK][kTN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  s_re[ty][tx] = acc_re;
  s_im[ty][tx] = acc_im;
  __syncthreads();
  if (ty == 0 && n < N) {
    float yr = 0.0f, yi = 0.0f;
    for (int j = 0; j < kTK; ++j) {
      yr = __fadd_rn(yr, s_re[j][tx]);
      yi = __fadd_rn(yi, s_im[j][tx]);
    }
    y_re[n] = yr;
    y_im[n] = yi;
  }
}

// Six blocks per SM: without the bound ptxas takes 48 registers (five
// blocks) and the combine runs slower at the main path's shapes; with
// it, 40 registers and a few local-memory words per k row, none on the
// u loop.
//
// Seed batching: blockIdx.z is the seed s.  Seed s reads its own words
// (words + 8 s), transmit symbols (t + s * seed_t) and gains (amp, w +
// s * seed_g; a stride of 0 shares one [B, U] block) and writes y[s];
// every (s, b, n) cell runs exactly the arithmetic of an unbatched
// launch with seed s's words, so a batched launch equals S unbatched
// ones bit for bit.
__global__ void __launch_bounds__(kTN * kTK, 6)
fused_mac_kernel(const uint32_t* __restrict__ words,
                 const float* __restrict__ t_re,
                 const float* __restrict__ t_im,
                 const float* __restrict__ amp,
                 const float* __restrict__ w,
                 float* __restrict__ y_re, float* __restrict__ y_im,
                 int U, int K, int N, int block_u, uint32_t kstride,
                 float sigma_h, float sigma_z, long long seed_t,
                 long long seed_g) {
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int n = blockIdx.x * kTN + threadIdx.x;
  words += 8 * s;
  t_re += s * seed_t;
  t_im += s * seed_t;
  const Keys key = stream_keys(words, b);
  float acc_re = 0.0f, acc_im = 0.0f;
  if (n < N) {
    const uint32_t nn = static_cast<uint32_t>(n) + words[4];
    const float* amp_b = amp + s * seed_g + static_cast<size_t>(b) * U;
    const float* w_b = w + s * seed_g + static_cast<size_t>(b) * U;
    for (int k = threadIdx.y; k < K; k += kTK) {
      float r_re, r_im;
      cx_normal(key.k0, key.noise, static_cast<uint32_t>(k), nn, sigma_z,
                r_re, r_im);
      float mf_re = 0.0f, mf_im = 0.0f;
      for (int u0 = 0; u0 < U; u0 += block_u) {
        const Sums s = block_sums(key, kstride, words[3], k, nn, n, N, u0,
                                  min(u0 + block_u, U), amp_b, w_b, t_re,
                                  t_im, sigma_h);
        r_re = __fadd_rn(r_re, s.pr_re);
        r_im = __fadd_rn(r_im, s.pr_im);
        mf_re = __fadd_rn(mf_re, s.pm_re);
        mf_im = __fadd_rn(mf_im, s.pm_im);
      }
      add_conj_product(acc_re, acc_im, mf_re, mf_im, r_re, r_im);
    }
  }
  const size_t row = (static_cast<size_t>(s) * gridDim.y + b) * N;
  store_row_sum(acc_re, acc_im, n, N, y_re + row, y_im + row);
}

// Grid (N / 32, G, B); blockDim.y = min(8, K) rows over the antennas.
__global__ void __launch_bounds__(kTN * kTK)
fused_partials_kernel(const uint32_t* __restrict__ words,
                      const float* __restrict__ t_re,
                      const float* __restrict__ t_im,
                      const float* __restrict__ amp,
                      const float* __restrict__ w,
                      float* __restrict__ pr_re, float* __restrict__ pr_im,
                      float* __restrict__ pm_re, float* __restrict__ pm_im,
                      int U, int K, int N, int block_u, uint32_t kstride,
                      float sigma_h) {
  const int n = blockIdx.x * kTN + threadIdx.x;
  if (n >= N) return;
  const int g = blockIdx.y;
  const int G = gridDim.y;
  const int b = blockIdx.z;
  const Keys key = stream_keys(words, b);
  const uint32_t nn = static_cast<uint32_t>(n) + words[4];
  const float* amp_b = amp + static_cast<size_t>(b) * U;
  const float* w_b = w + static_cast<size_t>(b) * U;
  const int u0 = g * block_u;
  for (int k = threadIdx.y; k < K; k += blockDim.y) {
    const Sums s = block_sums(key, kstride, words[3], k, nn, n, N, u0,
                              u0 + block_u, amp_b, w_b, t_re, t_im, sigma_h);
    const size_t o =
        ((static_cast<size_t>(b) * G + g) * K + k) * static_cast<size_t>(N) +
        n;
    pr_re[o] = s.pr_re;
    pr_im[o] = s.pr_im;
    pm_re[o] = s.pm_re;
    pm_im[o] = s.pm_im;
  }
}

// Grid (N / 32, B), 8 rows over the antennas, as `fused_mac_kernel`.
__global__ void __launch_bounds__(kTN * kTK)
fused_reduce_kernel(const uint32_t* __restrict__ words,
                    const float* __restrict__ pr_re,
                    const float* __restrict__ pr_im,
                    const float* __restrict__ pm_re,
                    const float* __restrict__ pm_im,
                    float* __restrict__ y_re, float* __restrict__ y_im,
                    int G, int K, int N, float sigma_z) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kTN + threadIdx.x;
  const Keys key = stream_keys(words, b);
  float acc_re = 0.0f, acc_im = 0.0f;
  if (n < N) {
    const uint32_t nn = static_cast<uint32_t>(n) + words[4];
    for (int k = threadIdx.y; k < K; k += kTK) {
      float r_re, r_im;
      cx_normal(key.k0, key.noise, static_cast<uint32_t>(k), nn, sigma_z,
                r_re, r_im);
      float mf_re = 0.0f, mf_im = 0.0f;
      for (int g = 0; g < G; ++g) {
        const size_t o = ((static_cast<size_t>(b) * G + g) * K + k) *
                             static_cast<size_t>(N) + n;
        r_re = __fadd_rn(r_re, pr_re[o]);
        r_im = __fadd_rn(r_im, pr_im[o]);
        mf_re = __fadd_rn(mf_re, pm_re[o]);
        mf_im = __fadd_rn(mf_im, pm_im[o]);
      }
      add_conj_product(acc_re, acc_im, mf_re, mf_im, r_re, r_im);
    }
  }
  store_row_sum(acc_re, acc_im, n, N, y_re + static_cast<size_t>(b) * N,
                y_im + static_cast<size_t>(b) * N);
}

uint32_t k_stride(int K) {
  return static_cast<uint32_t>((K + 127) / 128 * 128);
}

}  // namespace

// The entry points below take device pointers to contiguous tensors and
// `words`, uint32 [8] on the device = (s0, s1, rx_base, u_base, n_base,
// 0, 0, 0) (`fused_mac_launch`: [S, 8], one row a seed).  Each launches
// on `stream`, does not synchronise, and returns cudaGetLastError() as an
// int.

// S seeds in one launch: t_re, t_im: float32 [S, U, N], seed s's block
// at s * seed_t; amp, w: float32 [S, B, U], seed s's at s * seed_g (0:
// one block for all seeds); y_re, y_im: float32 [S, B, N], contiguous.
// block_u >= 1, S <= 65535.
extern "C" int fused_mac_launch(const void* words, const void* t_re,
                                const void* t_im, const void* amp,
                                const void* w, void* y_re, void* y_im,
                                int S, int B, int U, int K, int N,
                                int block_u, long long seed_t,
                                long long seed_g, float sigma_h,
                                float sigma_z, void* stream) {
  if (S <= 0 || B <= 0 || N <= 0) return 0;
  const dim3 block(kTN, kTK);
  const dim3 grid((N + kTN - 1) / kTN, B, S);
  fused_mac_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(t_re),
      static_cast<const float*>(t_im), static_cast<const float*>(amp),
      static_cast<const float*>(w), static_cast<float*>(y_re),
      static_cast<float*>(y_im), U, K, N, block_u, k_stride(K), sigma_h,
      sigma_z, seed_t, seed_g);
  return static_cast<int>(cudaGetLastError());
}

// t_re, t_im: float32 [U, N]; amp, w: float32 [B, U]; pr_re, pr_im,
// pm_re, pm_im: float32 [B, U / block_u, K, N].  U % block_u == 0.
extern "C" int fused_mac_partials_launch(
    const void* words, const void* t_re, const void* t_im, const void* amp,
    const void* w, void* pr_re, void* pr_im, void* pm_re, void* pm_im, int B,
    int U, int K, int N, int block_u, float sigma_h, void* stream) {
  const int G = U / block_u;
  if (B <= 0 || N <= 0 || G <= 0) return 0;
  const dim3 block(kTN, K < kTK ? K : kTK);
  const dim3 grid((N + kTN - 1) / kTN, G, B);
  fused_partials_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(t_re),
      static_cast<const float*>(t_im), static_cast<const float*>(amp),
      static_cast<const float*>(w), static_cast<float*>(pr_re),
      static_cast<float*>(pr_im), static_cast<float*>(pm_re),
      static_cast<float*>(pm_im), U, K, N, block_u, k_stride(K), sigma_h);
  return static_cast<int>(cudaGetLastError());
}

// pr_re, pr_im, pm_re, pm_im: float32 [B, G, K, N]; y_re, y_im: float32
// [B, N].
extern "C" int fused_partials_reduce_launch(
    const void* words, const void* pr_re, const void* pr_im,
    const void* pm_re, const void* pm_im, void* y_re, void* y_im, int B,
    int G, int K, int N, float sigma_z, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 block(kTN, kTK);
  const dim3 grid((N + kTN - 1) / kTN, B);
  fused_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const float*>(pr_re), static_cast<const float*>(pr_im),
      static_cast<const float*>(pm_re), static_cast<const float*>(pm_im),
      static_cast<float*>(y_re), static_cast<float*>(y_im), G, K, N,
      sigma_z);
  return static_cast<int>(cudaGetLastError());
}
