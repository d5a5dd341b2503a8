// Causal or bidirectional online-softmax attention (flash attention) with
// grouped KV heads, bfloat16 at head_dim 16, 32, 64, 112 or 128, on
// Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py:
// `_flash_kernel` (wrapper `flash_mha`, GQA wrapper `flash_attention`),
// for bfloat16 inputs; csrc/flash_attn_tf32.cu takes float32.  For every
// (batch b, KV head kv) pair n and every query row r of the folded row
// axis (r = g * L + l: the G = H / KV query heads of kv folded over the
// L positions), at position p = q_offset + r mod L (q_offset 0 but for
// a rank's rows of a longer sequence under sequence-parallel attention):
//
//   s[j]  = (q[r] . k[j]) * scale,        scale = 1 / sqrt(head_dim)
//   s[j]  = NEG_INF (-1e30) where causal and j > p, or where a sliding
//           window of W > 0 keys is set and |p - j| >= W
//   o[r]  = sum_j softmax(s)[j] v[j]
//
// through the online-softmax recurrence over key tiles in ascending
// order: m_new = max(m, max_j s), corr = exp(m - m_new), l = l corr +
// sum_j p[j], acc = acc corr + sum_j p[j] v[j] with p[j] = exp(s[j] -
// m_new), and at the end o = acc / max(l, 1e-30), rounded once to
// bfloat16.  Scores, the running max, the denominator and the
// accumulator are float32; the exponentials are 2^x on the MUFU pipe
// (`exp2_ftz`) of scores prescaled by log2(e) (one FMUL each, as the
// scale was); no other fast math.
//
// What bounds it on this card: operations.  A causal prefill does
// 4 * head_dim flops per kept (query, key) pair against 2 bytes per
// element of q, k, v and o read or written once: about 1,800 flops per
// byte at qwen2-0.5b's B 4 x L 4096, six times the ratio (~295) above
// which the dense bf16 tensor-core rate, not HBM, is the limit.  So the
// products run on the tensor cores, and the design keeps them fed.  At
// head_dim 16 and 32 (the serving example's reduced model) the products
// shrink with the width but the softmax does not: one exp2 per kept pair
// on the MUFU pipe (16 a clock per SM) takes about twice the tensor-core
// bound at hd 32, so there the exponentials, not the products, are the
// floor.
//
// Each row of a Q, K or V tile is head_dim bf16 stored in column blocks
// of SW bytes, each with TMA's and wgmma's SW-byte swizzle (`Cfg`): one
// 128-byte block at hd 64, two at hd 128, one 64-byte block at hd 32 and
// one 32-byte block at hd 16.  hd 16 and 32 are instances of their own,
// not hd 64 zero-padded: the narrow swizzle keeps every product the
// width of the data.  hd 112 (zamba2-7b's shared attention) runs the
// hd-128 instance with COLS = 112: the TMA maps declare a head extent of
// 112, so the second 64-column box of each K and V row is zero-filled
// past column 112 (a 224-byte row pitch is a multiple of 16, as TMA
// needs); Q's columns 112 .. 127 load as zeros and o's are not stored.
// Zero columns add +0 to every score and leave o's first 112 columns
// as they are; the scale is 1 / sqrt(112).  It costs 8/7 of the
// products, one instance fewer to build and tune.
//
// - one block per (pair n, tile of QB = 128 folded query rows), three
//   warpgroups: WG0 the producer, WG1 and WG2 the consumers, 64 query
//   rows each (wgmma's M).  The producer drops to 40 registers
//   (setmaxnreg) and one thread of it keeps TMA loads of K and V tiles
//   (KB = 128 keys) in flight into a ring of STAGES slots (2 at hd 128,
//   4 below), each with a "full" mbarrier (TMA's transaction bytes)
//   and an "empty" one (one arrival per consumer warp once its products
//   on the slot have completed); the consumers rise to 232 registers
//   for their accumulators: S (64 x KB f32, 64 a thread) and O (64 x hd
//   f32, hd / 2 a thread);
// - K and V come by TMA over a 4-D map of [B, S, KV, hd] (or the folded
//   [N, S, hd]) with the SW-byte swizzle, one box per column block (the
//   box's inner extent may not pass the swizzle span); keys past S
//   arrive as zeros and are masked to NEG_INF;
// - Q is loaded once by the consumers, 16 bytes a thread, into the
//   swizzled layout wgmma reads: not by TMA, since a 128-row tile can
//   straddle two fold groups (two heads, at positions that wrap back)
//   when L is not a multiple of 128;
// - S = Q K^T is hd / 16 wgmma m64n128k16 with both operands in shared
//   memory (K-major; a k16 step is 32 bytes of a swizzled row).  bf16
//   products are exact in f32, so this is the TPU kernel's f32 dot of
//   the upcast inputs up to summation order;
// - the softmax runs in the accumulator's registers: a row's scores sit
//   on a quad of lanes, so its max and sum take two xor shuffles each,
//   which give every lane the same bits; the per-element mask runs
//   only on tiles that reach past the warpgroup's smallest position or
//   past S, or across an edge of one of its rows' windows
//   (`tile_masked`): a branch, uniform over the warpgroup, so the other
//   tiles run no test at all (predicated per element, as before the
//   window, the test cost every tile; the branch took the unwindowed
//   kernel from 0.73 to 0.50 ms at qwen2-0.5b's prefill shape, the same
//   bits, PERF.md; ptxas now spills 52 and 160 bytes at hd 64 and 128);
//   a key tile outside every row's range (past the block's largest
//   position when causal; before the smallest position's window or,
//   bidirectional, after the largest one's) is never loaded: the block
//   walks the key tiles [first, end) of `key_tiles`, producer and
//   consumers alike;
// - a sliding window: the block's first tile may be wholly masked for
//   some of its rows (rows of one 128-row block start their windows at
//   different keys).  Such a row's running max stays NEG_INF, finite,
//   so each masked key adds p = 2^0 = 1 to l and v to acc; at the row's
//   first kept key m_new is a real score and corr = 2^(NEG_INF - m_new)
//   is exactly 0 (`exp2_ftz` of -1e30), which wipes l and acc, and each
//   later masked key gets p = 0.  Every row keeps its own key, so l > 0
//   at the end.  A fully masked tile after the first kept key leaves
//   (m, l, acc) unchanged (corr = 1, p = 0), so the skip gives the bits
//   of visiting every tile; with W >= max(L, S) the range and the mask
//   are those of W = 0, the same bits;
// - P V keeps p at about 2^-17 relative: p is split into bf16 hi =
//   bf16(p) and lo = bf16(p - hi), and two register-A wgmmas
//   (m64n{hd}k16, V as an MN-major B operand with the SW-byte swizzle,
//   transposed) add hi V and lo V into one f32 accumulator.  Rounding p
//   once to bf16 (cuDNN's and FA3's choice) errs by up to 2^-9 per
//   weight, past this port's gates; the split costs a second product,
//   6 * hd flops per kept pair where the function needs 4 * hd, so the
//   kernel reaches at most 2/3 of the tensor-core bound;
// - the epilogue divides, rounds once to bf16, stages the warpgroup's
//   64 rows in its own Q slot and stores 16 bytes a thread through the
//   strides (a straddling tile's rows go to two heads: no TMA store);
// - fixed summation order, no atomics, no split over keys: two launches
//   give the same bits.
//
// Later work: ping-pong of the two consumer warpgroups (one's softmax
// under the other's products), a persistent grid.
#include <cuda_bf16.h>

#include "hopper_common.cuh"

namespace {

constexpr int kQB = 128;                // query rows per block
constexpr int kKB = 128;                // keys per tile
constexpr int kThreads = 384;           // three warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWgRows = 64;             // query rows per consumer warpgroup

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 2 * HD;  // swizzle span, bytes
  static constexpr int CB = 2 * HD / SW;              // column blocks
  static constexpr int CPB = SW / 16;     // 16-byte chunks of a block's row
  static constexpr int STAGES = HD == 128 ? 2 : 4;
  static constexpr int WG_Q_BYTES = kWgRows * HD * 2;
  static constexpr int TILE_BYTES = kKB * HD * 2;       // one K or V tile
  static constexpr int Q_BYTES = 2 * WG_Q_BYTES;
  // + 1024: the dynamic window is aligned up to the swizzle atom
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * TILE_BYTES + 1024;
};

// -- wgmma (the shared helpers: hopper_common.cuh) ----------------------

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]^T, both K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set); N = 16, 32, 64 or
// 128, the head_dim.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_R8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// -- the kernel ---------------------------------------------------------

// HD: the instance's width; COLS: the columns of q, k, v and o (HD, or
// 112 on the hd-128 instance: columns past COLS read as zeros and are
// not stored).
template <int HD, int COLS>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                   const __grid_constant__ CUtensorMap tmap_v,
                   const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ o, int KV, int G, int L,
                   int S, Layout lq, Layout lo, float scale, int causal,
                   int window, int q_offset) {
  static_assert(COLS == HD || (HD == 128 && COLS == 112), "columns");
  using C = Cfg<HD>;
  constexpr int STAGES = C::STAGES;
  constexpr int SW = C::SW, CPB = C::CPB;
  constexpr int CPR = HD / 8;            // 16-byte chunks per row
  constexpr int OUT_CPR = COLS / 8;      // 16-byte chunks per q or o row
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // Q slot of consumer warpgroup w at w * WG_Q_BYTES; K tile of stage st
  // at k_tile(st), V at k_tile(st) + TILE_BYTES; column block cb of a
  // tile of R rows at + cb * R * SW
  auto k_tile = [&](int st) {
    return base + C::Q_BYTES + st * 2 * C::TILE_BYTES;
  };

  const int rows = G * L;
  // longest blocks (the last rows, when causal) first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int consumers = r0 + kWgRows < rows ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(smem_addr(&full_bar[st]), 1);
      mbar_init(smem_addr(&empty_bar[st]), 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each role computes what it needs after its setmaxnreg: a value live
  // across it would be spilled
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const TileRange tr = key_tiles<kQB, kKB>(r0, rows, L, S, causal,
                                               window, q_offset);
      const int b = blockIdx.y / KV, kv = blockIdx.y % KV;
      // visit i (tile first + i) uses stage i % STAGES
      for (int t = tr.first, i = 0; t < tr.end; ++t, ++i) {
        const int st = i % STAGES;
        const uint32_t full = smem_addr(&full_bar[st]);
        mbar_wait(smem_addr(&empty_bar[st]), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::TILE_BYTES);
#pragma unroll
        for (int cb = 0; cb < C::CB; ++cb) {
          const uint32_t off = cb * kKB * SW;
          tma_load(k_tile(st) + off, &tmap_k, full, cb * SW / 2, kv, t * kKB,
                   b);
          tma_load(k_tile(st) + C::TILE_BYTES + off, &tmap_v, full,
                   cb * SW / 2, kv, t * kKB, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    const int w = wg - 1;
    const int wg_r0 = r0 + w * kWgRows;
    if (wg_r0 >= rows) return;           // the block's last rows are fewer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const TileRange tr = key_tiles<kQB, kKB>(r0, rows, L, S, causal, window,
                                             q_offset);
    const int b = blockIdx.y / KV, kv = blockIdx.y % KV;
    const int tid = threadIdx.x % 128;
    const uint32_t q_slot = base + w * C::WG_Q_BYTES;
    uint8_t* q_smem = smem + w * C::WG_Q_BYTES;

    // Q once: 16 bytes a thread, zeros past the last row and past
    // column COLS
    for (int i = tid; i < kWgRows * CPR; i += 128) {
      const int row = i / CPR, ch = i % CPR, r = wg_r0 + row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && (COLS == HD || ch < OUT_CPR)) {
        const int l_r = r % L, h = kv * G + r / L;
        val = *reinterpret_cast<const uint4*>(
            q + b * lq.b + l_r * lq.row + h * lq.head + ch * 8);
      }
      *reinterpret_cast<uint4*>(q_smem + (ch / CPB) * kWgRows * SW +
                                swizzled<SW>(row, ch % CPB)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + w);

    // this thread's two rows (the accumulator layout): warp * 16 + g
    // and that + 8, and its columns 8 * j + 2 * quad + {0, 1}
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    int pos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(wg_r0 + warp * 16 + lane / 4 + 8 * h, rows - 1);
      pos[h] = q_offset + r % L;
    }
    const PosRange wp = block_positions<kWgRows>(wg_r0, rows, L,
                                                       q_offset);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    // scores, and the running max m, in log2 units: p = 2^(s - m)
    const float scale_log2 = scale * kLog2e;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    for (int t = tr.first, i = 0; t < tr.end; ++t, ++i) {
      const int st = i % STAGES;
      const int j0 = t * kKB;
      mbar_wait(smem_addr(&full_bar[st]), (i / STAGES) & 1);

      // S = Q K^T: k16 step kk is 32 bytes into column block kk / SPB
      constexpr int SPB = SW / 32;
      float s[kKB / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / SPB) * kWgRows * SW + (kk % SPB) * 32;
        const uint32_t koff = (kk / SPB) * kKB * SW + (kk % SPB) * 32;
        wgmma_ss_n128(s, make_desc<SW>(q_slot + off, 16),
                      make_desc<SW>(k_tile(st) + koff, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask, and the online softmax in registers
      const bool masked = tile_masked<kKB>(j0, S, causal, window,
                                           wp.min_pos, wp.max_pos);
      float mx[2] = {kNegInf, kNegInf};
      if (masked) {
#pragma unroll
        for (int e = 0; e < kKB / 2; ++e) {
          const int h = (e / 2) % 2;
          const int j = j0 + 8 * (e / 4) + 2 * quad + e % 2;
          float x = s[e] * scale_log2;
          if (key_masked(j, pos[h], S, causal, window)) x = kNegInf;
          s[e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kKB / 2; ++e) {
          const int h = (e / 2) % 2;
          const float x = s[e] * scale_log2;
          s[e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2_ftz(m[h] - m_new);
        m[h] = m_new;
      }
      // p, split into bf16 hi and lo: A fragments of the P V product,
      // key step kk = registers 8 kk .. 8 kk + 7 of S
      uint32_t p_hi[kKB / 16][4], p_lo[kKB / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int e = 8 * kk + 2 * a, h = a % 2;
          const float p0 = exp2_ftz(s[e] - m[h]);
          const float p1 = exp2_ftz(s[e + 1] - m[h]);
          sum[h] += p0;
          sum[h] += p1;
          const uint32_t hi = pack_bf16(p0, p1);
          p_hi[kk][a] = hi;
          p_lo[kk][a] = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] *= corr[(e / 2) % 2];

      // acc += p_hi V + p_lo V: V's k16 step kk is its rows 16 kk ..
      // 16 kk + 15, column blocks kKB * SW bytes apart
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
        const uint64_t dv = make_desc<SW>(
            k_tile(st) + C::TILE_BYTES + kk * 16 * SW, kKB * SW);
        wgmma_rs(acc, p_hi[kk], dv);
        wgmma_rs(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));
    }

    // epilogue: divide, round once, stage in the Q slot, 16-byte stores
    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], kMinDenominator);
    named_barrier(1 + w);                // every product on Q has completed
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + lane / 4 + 8 * h;
        const uint32_t v = pack_bf16(acc[4 * jn + 2 * h] / den[h],
                                     acc[4 * jn + 2 * h + 1] / den[h]);
        *reinterpret_cast<uint32_t*>(
            q_smem + (jn / CPB) * kWgRows * SW +
            swizzled<SW>(row, jn % CPB) + 4 * quad) = v;
      }
    }
    named_barrier(1 + w);
    for (int i = tid; i < kWgRows * OUT_CPR; i += 128) {
      const int row = i / OUT_CPR, ch = i % OUT_CPR, r = wg_r0 + row;
      if (r >= rows) break;
      const int l_r = r % L, h = kv * G + r / L;
      *reinterpret_cast<uint4*>(o + b * lo.b + l_r * lo.row + h * lo.head +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(
              q_smem + (ch / CPB) * kWgRows * SW +
              swizzled<SW>(row, ch % CPB));
    }
  }
}

// -- host side ----------------------------------------------------------

// A map of keys (or values) as the 4-D bf16 tensor (hd, KV, S, B),
// innermost first, with element strides (1, head, row, batch); boxes of
// (SW / 2, 1, KB, 1), one column block, with the SW-byte swizzle, zeros
// past S and past column hd (hd 112 in a 128-wide instance).
template <int SW>
int make_map(CUtensorMap* map, const void* base, int hd, int KV, int S,
             int B, long long head, long long row, long long batch) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a single KV head's stride is never stepped; give it a legal one
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(KV > 1 ? head : hd) * 2,
      static_cast<cuuint64_t>(row) * 2, static_cast<cuuint64_t>(batch) * 2};
  const cuuint32_t box[4] = {SW / 2, 1, kKB, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int HD, int COLS = HD>
int launch(const void* q, const void* k, const void* v, void* o, int causal,
           int window, int q_offset, int NB, int KV, int G, int L, int S,
           const long long* st, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const long long rows = static_cast<long long>(G) * L;
  const long long tiles = (rows + kQB - 1) / kQB;
  if (tiles > 0x7FFFFFFFLL || rows > 0x7FFFFFFFLL || NB > 65535 || NB % KV)
    return cudaErrorInvalidValue;
  CUtensorMap tmap_k, tmap_v;
  int err = make_map<C::SW>(&tmap_k, k, COLS, KV, S, NB / KV, st[5], st[4],
                            st[3]);
  if (err == 0)
    err = make_map<C::SW>(&tmap_v, v, COLS, KV, S, NB / KV, st[8], st[7],
                          st[6]);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const Layout lq{st[0], st[1], st[2]}, lo{st[9], st[10], st[11]};
  flash_wgmma_kernel<HD, COLS><<<dim3(static_cast<unsigned>(tiles), NB),
                                 kThreads, C::SMEM, stream>>>(
      tmap_k, tmap_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), KV, G, L, S, lq, lo, scale, causal,
      window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: NB * G * L query rows; k, v: NB * S keys; bfloat16 (dtype 1, the
// wrapper's code; csrc/flash_attn_tf32.cu's entry point, which shares
// this signature but for its scratch, takes float32, 0), head_dim `hd`
// of 16, 32, 64, 112 or 128; `window` > 0 a sliding window of that many
// keys (key j kept for position p when |p - j| < window), 0 none.
// Query row l of the L sits at position p = q_offset + l (q_offset >= 0;
// 0 when the rows are the whole sequence, the first of the rank's rows
// under sequence-parallel attention); a window needs q_offset + L < S +
// window, so that every row keeps a key.  Pair
// n = b * KV + kv reads query row r = g * L + l at
//   q + b * st[0] + l * st[1] + (kv * G + g) * st[2]
// and key j at k + b * st[3] + j * st[4] + kv * st[5] (v: st[6..8]),
// and writes o + b * st[9] + l * st[10] + (kv * G + g) * st[11]; strides
// in elements, head_dim contiguous, every row 16-byte aligned.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() as
// an int: cudaErrorInvalidValue for a shape it does not take, 10000 +
// the CUresult where cuTensorMapEncodeTiled refuses a map.
extern "C" int flash_attn_wgmma_launch(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int hd, int causal, int window,
                                       int q_offset, int NB, int KV, int G,
                                       int L, int S, const long long* strides,
                                       float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  if (NB <= 0 || G <= 0 || L <= 0) return 0;
  if (S <= 0 || KV <= 0 || window < 0 || q_offset < 0 ||
      static_cast<long long>(q_offset) + L > 0x7FFFFFFFLL ||
      (window > 0 && static_cast<long long>(q_offset) + L >=
                         static_cast<long long>(S) + window))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 16)
    return launch<16>(q, k, v, o, causal, window, q_offset, NB, KV, G, L, S,
                      strides, scale, st);
  if (hd == 32)
    return launch<32>(q, k, v, o, causal, window, q_offset, NB, KV, G, L, S,
                      strides, scale, st);
  if (hd == 64)
    return launch<64>(q, k, v, o, causal, window, q_offset, NB, KV, G, L, S,
                      strides, scale, st);
  if (hd == 112)
    return launch<128, 112>(q, k, v, o, causal, window, q_offset, NB, KV, G,
                            L, S, strides, scale, st);
  if (hd == 128)
    return launch<128>(q, k, v, o, causal, window, q_offset, NB, KV, G, L, S,
                       strides, scale, st);
  return cudaErrorInvalidValue;
}
