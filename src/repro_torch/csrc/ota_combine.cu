// OTA matched-filter combine over a materialized channel slab, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ota_combine.py:
// `_combine_kernel_batched` (wrapper `ota_combine_batched`) and
// `_combine_kernel` (wrapper `ota_combine`), which runs here as B = 1.
// It computes
//
//   y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
//                   * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])
//
// on interleaved complex64 (float2) tensors, un-rescaled.
//
// What bounds it on this card: bytes.  The slab h is read once
// (8*B*U*K*N bytes) and dominates everything else; the arithmetic is
// about 12 float32 operations per h element, some 14x under the time
// HBM needs to deliver it.
//
// Design: the TPU kernel pads K and N to its (bk=8, bn=512) tile with
// copies of the slab, folds U unrolled inside the tile and revisits the
// output across an "arbitrary" K grid axis.  Hopper blocks run in no
// order, so here one block owns (32 symbols, rx station) with kTK thread
// rows over the antennas, and nothing is padded: the ragged N edge is
// bounds-checked and the k loop stops at K.  A thread owns the (b, k, n)
// cells k = ty, ty + kTK, ...; for each it starts r at z and mf at 0 and
// walks u in ascending order, keeping both in registers, then adds
// conj(mf) * r to its running sum.  The 32 threads of a warp read 32
// neighbouring symbols of one (b, u, k) row: 256 contiguous bytes.  A
// fixed-order sum over the kTK rows in shared memory gives y[b, n].  No
// atomics and no scratch in device memory, so two launches give the
// same bits.
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 32;   // symbols per block (one warp row)
constexpr int kTK = 16;   // antenna rows per block

__global__ void __launch_bounds__(kTN * kTK)
ota_combine_kernel(const float2* __restrict__ h,
                   const float2* __restrict__ t,
                   const float2* __restrict__ z,
                   const float* __restrict__ w, float2* __restrict__ y,
                   int U, int K, int N) {
  __shared__ float s_re[kTK][kTN];
  __shared__ float s_im[kTK][kTN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kTN + tx;

  float acc_re = 0.0f, acc_im = 0.0f;
  if (n < N) {
    const size_t kn = static_cast<size_t>(K) * N;
    const float2* h_b = h + static_cast<size_t>(b) * U * kn;
    const float2* z_b = z + static_cast<size_t>(b) * kn;
    const float* w_b = w + static_cast<size_t>(b) * U;
    const float2* t_n = t + n;
    for (int k = ty; k < K; k += kTK) {
      const size_t off = static_cast<size_t>(k) * N + n;
      const float2 zz = z_b[off];
      const float2* h_k = h_b + off;
      float r_re = zz.x, r_im = zz.y;
      float mf_re = 0.0f, mf_im = 0.0f;
#pragma unroll 4
      for (int u = 0; u < U; ++u) {
        const float2 hh = h_k[static_cast<size_t>(u) * kn];
        const float2 tt = t_n[static_cast<size_t>(u) * N];
        const float wu = w_b[u];
        r_re += hh.x * tt.x - hh.y * tt.y;
        r_im += hh.x * tt.y + hh.y * tt.x;
        mf_re += wu * hh.x;
        mf_im += wu * hh.y;
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
    y[static_cast<size_t>(b) * N + n] = make_float2(yr, yi);
  }
}

}  // namespace

// h: complex64 [B, U, K, N]; t: complex64 [U, N]; z: complex64
// [B, K, N]; w: float32 [B, U]; y: complex64 [B, N].  Complex tensors
// are interleaved (re, im) float pairs; all contiguous.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() as an
// int.
extern "C" int ota_combine_launch(const void* h, const void* t,
                                  const void* z, const void* w, void* y,
                                  int B, int U, int K, int N,
                                  void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 block(kTN, kTK);
  const dim3 grid((N + kTN - 1) / kTN, B);
  ota_combine_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(t),
      static_cast<const float2*>(z), static_cast<const float*>(w),
      static_cast<float2*>(y), U, K, N);
  return static_cast<int>(cudaGetLastError());
}
