// What the tensor-core flash kernels (csrc/flash_attn_wgmma.cu and
// csrc/flash_attn_tf32.cu) share: the model's constants, shared-memory
// addressing with the 128-, 64- or 32-byte swizzle, the exponential, the
// mbarrier ring's waits and arrivals, TMA loads, wgmma's descriptors and
// fences, the exact skip of key tiles outside a block's positions (its
// causal end and its sliding window) and the per-element mask, and the
// run-time lookup of cuTensorMapEncodeTiled.  Included by both;
// kernels/build.py hashes it with each source that includes it.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMinDenominator = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of one operand; the head_dim stride is 1.
struct Layout {
  long long b, row, head;
};

// -- shared memory, barriers, TMA --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A swizzle span SW of 128, 64 or 32 bytes (TMA's CU_TENSOR_MAP_SWIZZLE_
// 128B, _64B, _32B; wgmma's layout types 1, 2, 3): a block of SW-byte
// rows in which the 16-byte chunk c of row r is stored at chunk c ^ ((r *
// SW / 128) mod (SW / 16)), the pattern repeating every 8 rows (1024,
// 512 or 256 bytes, to which the block is aligned).
template <int SW>
struct Swizzle {
  static_assert(SW == 128 || SW == 64 || SW == 32, "swizzle span");
  static constexpr int kShift = SW == 128 ? 0 : SW == 64 ? 1 : 2;
  static constexpr uint64_t kLayout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// Byte offset of 16-byte chunk `chunk` (0 .. SW / 16 - 1) of row `row` in
// a block of SW-byte rows stored with the SW-byte swizzle.
template <int SW>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * SW +
         ((chunk ^ ((row >> Swizzle<SW>::kShift) & (SW / 16 - 1))) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Waits for the phase of parity `parity` of `bar` to complete.  A wait
// that has not ended after kWaitLimit SM clocks (seconds: no tile takes
// that long) traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
constexpr long long kWaitLimit = 1LL << 35;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One box of a 3-D or 4-D tensor map into shared memory at `dst`,
// completing on `bar`; coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// 2^x on the MUFU pipe, ex2.approx.ftz.f32: exp2f issues the same
// instruction plus a fix-up for results below 2^-126 (three more
// instructions an exponential), which this flushes to 0.  A softmax
// weight that small is lost against the row's largest weight, 2^0, in
// every float32 sum it enters; on the card the kernels' outputs kept
// their bits at every timed shape (PERF.md, section 6).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// -- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor with the SW-byte swizzle: start
// address, leading byte offset `lbo` (an MN-major operand's step between
// SW-byte column blocks; unused K-major) and the stride byte offset
// between 8-row groups, 8 * SW, each in 16-byte units.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * SW >> 4) << 32) |
         (Swizzle<SW>::kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's accumulator operands: eight registers from d[i], and the
// operand lists of 8, 16, 32 and 64 of them
#define WG_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16                                     \
  WG_R8 ", "                                       \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32                                     \
  WG_R16 ", "                                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "       \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64                                     \
  WG_R32 ", "                                      \
  "%32, %33, %34, %35, %36, %37, %38, %39, "       \
  "%40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, "       \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// -- the exact tile skip -------------------------------------------------

// The positions of the block of folded rows [r0, r0 + QB): the smallest
// and the largest, or q_offset and q_offset + L - 1 when the block
// straddles two fold groups (its positions wrap to q_offset there).  Row
// r sits at position q_offset + r % L: a rank that holds query rows
// [q_offset, q_offset + L) of a longer sequence (sequence-parallel
// attention) against all S keys.
struct PosRange {
  int min_pos, max_pos;
};

template <int QB>
__device__ __forceinline__ PosRange block_positions(int r0, int rows, int L,
                                                    int q_offset) {
  const int r_last = min(r0 + QB, rows) - 1;
  if (r0 / L != r_last / L) return {q_offset, q_offset + L - 1};
  return {q_offset + r0 % L, q_offset + r_last % L};
}

// Key tiles [first, end) of KB keys that the block of folded rows
// [r0, r0 + QB) (at positions q_offset + r % L) needs: all of them;
// when causal none past the block's largest position; with a sliding
// window of `window` > 0 keys (key j kept for position p when |p - j| <
// window) none that ends before the smallest position's window starts
// and, when bidirectional, none that starts after the largest
// position's window ends.  The exact test on
// the block's own positions (the Pallas kernel's first_q_pos + QB - 1
// is conservative when a block straddles two fold groups).  The
// producer and the consumers call it alike, so both walk one range.
struct TileRange {
  int first, end;
};

template <int QB, int KB>
__device__ __forceinline__ TileRange key_tiles(int r0, int rows, int L,
                                               int S, int causal,
                                               int window, int q_offset) {
  const int all_tiles = (S + KB - 1) / KB;
  const PosRange p = block_positions<QB>(r0, rows, L, q_offset);
  TileRange t{0, all_tiles};
  if (causal) t.end = min(all_tiles, p.max_pos / KB + 1);
  if (window > 0) {
    t.first = max(0, p.min_pos - window + 1) / KB;
    if (!causal) {
      const long long last = min(static_cast<long long>(S),
                                 static_cast<long long>(p.max_pos) + window);
      t.end = min(all_tiles, static_cast<int>((last + KB - 1) / KB));
    }
  }
  return t;
}

// Whether the tile of keys [j0, j0 + KB) needs the per-element mask for
// a warpgroup whose rows hold positions min_pos .. max_pos (q_offset and
// q_offset + L - 1 when they straddle two fold groups): it reaches past
// S, past the smallest position when causal, or across an edge of some
// row's window.
template <int KB>
__device__ __forceinline__ bool tile_masked(int j0, int S, int causal,
                                            int window, int min_pos,
                                            int max_pos) {
  if (j0 + KB > S || (causal && j0 + KB - 1 > min_pos)) return true;
  return window > 0 &&
         (max_pos - j0 >= window ||
          (!causal && j0 + KB - 1 - min_pos >= window));
}

// Whether key j is masked for position pos: past S, after pos when
// causal, or |pos - j| >= window (window > 0).
__device__ __forceinline__ bool key_masked(int j, int pos, int S,
                                           int causal, int window) {
  return j >= S || (causal && j > pos) ||
         (window > 0 && (pos - j >= window || j - pos >= window));
}

// -- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint*), so the library needs no link against
// libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace
