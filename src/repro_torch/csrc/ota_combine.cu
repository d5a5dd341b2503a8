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
// order, so here a thread-block cluster of R blocks owns (32 symbols,
// rx station), each block with kTK = 8 thread rows over the antennas,
// and nothing is padded: the ragged N edge is bounds-checked and the k
// loop stops at K.  Thread (ty, tx) of cluster rank c owns the (b, k, n)
// cells k = c * kTK + ty, + R * kTK, ...; for each it starts r at z and
// mf at 0 and walks u in ascending order, kUnroll users a pass, keeping
// both in registers, then adds conj(mf) * r to its running sum.  The 32
// threads of a warp read 32 neighbouring symbols of one (b, u, k) row:
// 256 contiguous bytes.  Each block sums its kTK rows in shared memory
// in ascending row order; after a cluster barrier rank 0 reads the
// other blocks' sums through distributed shared memory and adds them in
// ascending rank order.  No atomics and no scratch in device memory, so
// two launches give the same bits.
//
// What the design does about the bytes: a thread's u loop is a chain of
// dependent passes, so the rate is set by the loads in flight.  Each
// pass issues kUnroll slab loads before it uses them, and 256-thread
// blocks of at most 64 registers let 8 blocks share an SM.  At B = 1 the
// grid would have only ceil(N / 32) blocks (123 at N = 3925), too few to
// keep the SMs' loads in flight, so `cluster_size` splits the antennas
// over R <= 8 blocks until the grid would fill every SM's 2,048
// threads; where B x ceil(N / 32) already gives two blocks an SM it
// keeps R = 1 (splitting those as well measured slower: more blocks, no
// more loads in flight).  These constants were chosen by timing
// variants in turns on an H100 (PERF.md, section 6).
#include <cooperative_groups.h>
#include <cstddef>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTN = 32;          // symbols per block (one warp row)
constexpr int kTK = 8;           // antenna rows per block
constexpr int kUnroll = 8;       // users per pass of the u loop
constexpr int kMinBlocks = 4;    // resident blocks an SM: <= 64 registers
// blocks an SM a split grid aims at: an SM's 2,048 threads
constexpr int kClusterFill = 2048 / (kTN * kTK);
constexpr int kSplitBelow = 2;   // split only grids of fewer blocks an SM
constexpr int kMaxCluster = 8;   // the portable cluster size

//
// Seed batching (kSeeded): blockIdx.z is the seed s, which reads h, t, z
// and w at s times their seed strides (a stride of 0 shares one block
// among the seeds) and writes row s * B + b of y.  The cluster size
// follows one seed's B, and the u loop is the unbatched kernel's, so
// every (s, b, n) cell is summed exactly as in an unbatched launch with
// seed s's operands: a batched launch equals S unbatched ones bit for
// bit.  A single seed runs the instance without the seed offsets, the
// unbatched kernel as it was: one kernel taking the offsets at every
// launch ran 5-15% slower at the main path's single-seed shapes, timed
// in turns against it on an H100 (`python -m repro_torch.kernels.ab`,
// PERF.md section 6).
template <bool kSeeded>
__global__ void __launch_bounds__(kTN * kTK, kMinBlocks)
ota_combine_kernel(const float2* __restrict__ h,
                   const float2* __restrict__ t,
                   const float2* __restrict__ z,
                   const float* __restrict__ w, float2* __restrict__ y,
                   int U, int K, int N, long long seed_h, long long seed_t,
                   long long seed_z, long long seed_w) {
  __shared__ float s_re[kTK][kTN];
  __shared__ float s_im[kTK][kTN];
  __shared__ float2 s_sum[kTN];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.y;
  const int n = blockIdx.x / R * kTN + tx;
  if (kSeeded) {
    const long long s = blockIdx.z;
    h += s * seed_h;
    t += s * seed_t;
    z += s * seed_z;
    w += s * seed_w;
    y += s * gridDim.y * static_cast<long long>(N);
  }

  float acc_re = 0.0f, acc_im = 0.0f;
  if (n < N) {
    const size_t kn = static_cast<size_t>(K) * N;
    const float2* h_b = h + static_cast<size_t>(b) * U * kn;
    const float2* z_b = z + static_cast<size_t>(b) * kn;
    const float* w_b = w + static_cast<size_t>(b) * U;
    const float2* t_n = t + n;
    for (int k = rank * kTK + ty; k < K; k += R * kTK) {
      const size_t off = static_cast<size_t>(k) * N + n;
      const float2 zz = z_b[off];
      const float2* h_k = h_b + off;
      float r_re = zz.x, r_im = zz.y;
      float mf_re = 0.0f, mf_im = 0.0f;
#pragma unroll kUnroll
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
  if (ty == 0) {
    float yr = 0.0f, yi = 0.0f;
    for (int j = 0; j < kTK; ++j) {
      yr += s_re[j][tx];
      yi += s_im[j][tx];
    }
    s_sum[tx] = make_float2(yr, yi);
  }
  cluster.sync();
  if (rank == 0 && ty == 0 && n < N) {
    float yr = 0.0f, yi = 0.0f;
    for (int c = 0; c < R; ++c) {
      const float2 part = cluster.map_shared_rank(s_sum, c)[tx];
      yr += part.x;
      yi += part.y;
    }
    y[static_cast<size_t>(b) * N + n] = make_float2(yr, yi);
  }
  cluster.sync();          // every block's sums stay until rank 0 has read
}

// Blocks per cluster for a (B, K, N) call: 1 where the grid already
// holds kSplitBelow blocks an SM, else enough to give kClusterFill (an
// SM's 2,048 threads), at most kMaxCluster and at most one per group of
// kTK antenna rows.
int cluster_size(int B, int K, int N) {
  static const int sms = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  const long long blocks = static_cast<long long>((N + kTN - 1) / kTN) * B;
  if (blocks >= 1LL * kSplitBelow * sms) return 1;
  const long long want = (1LL * kClusterFill * sms + blocks - 1) / blocks;
  const long long groups = (K + kTK - 1) / kTK;
  const long long r = want < groups ? want : groups;
  return static_cast<int>(r < kMaxCluster ? (r > 1 ? r : 1) : kMaxCluster);
}

}  // namespace

// The cluster size the launch below uses for B rx stations a seed,
// whatever the number of seeds.
extern "C" int ota_combine_cluster_size(int B, int K, int N) {
  return B > 0 && N > 0 && K > 0 ? cluster_size(B, K, N) : 1;
}

// S seeds in one launch: h: complex64 [S, B, U, K, N]; t: complex64
// [S, U, N]; z: complex64 [S, B, K, N]; w: float32 [S, B, U]; y:
// complex64 [S, B, N].  Complex tensors are interleaved (re, im) float
// pairs.  Each operand is contiguous past its seed axis, and seed s's
// block starts s * seed_x elements in (0: one block for all seeds); y is
// contiguous.  B, S <= 65535.  Launches on `stream` as clusters of
// `ota_combine_cluster_size(B, K, N)` blocks, does not synchronise, and
// returns cudaGetLastError() as an int.
extern "C" int ota_combine_launch(const void* h, const void* t,
                                  const void* z, const void* w, void* y,
                                  int S, int B, int U, int K, int N,
                                  long long seed_h, long long seed_t,
                                  long long seed_z, long long seed_w,
                                  void* stream) {
  if (S <= 0 || B <= 0 || N <= 0) return 0;
  const int R = cluster_size(B, K, N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + kTN - 1) / kTN) * R, B, S);
  cfg.blockDim = dim3(kTN, kTK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*const kernel)(const float2*, const float2*, const float2*,
                       const float*, float2*, int, int, int, long long,
                       long long, long long, long long) =
      S > 1 ? &ota_combine_kernel<true> : &ota_combine_kernel<false>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float2*>(h),
      static_cast<const float2*>(t), static_cast<const float2*>(z),
      static_cast<const float*>(w), static_cast<float2*>(y), U, K, N,
      seed_h, seed_t, seed_z, seed_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
