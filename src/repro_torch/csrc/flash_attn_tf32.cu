// Causal or bidirectional online-softmax attention (flash attention) with
// grouped KV heads, float32 at head_dim 16, 32, 64, 112 or 128, on
// Hopper's tensor cores (sm_90a) through a 3xTF32 split.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py:
// `_flash_kernel` (wrapper `flash_mha`, GQA wrapper `flash_attention`),
// for float32 inputs: head_dim 64 (qwen2-0.5b's float32 prefill), 128
// (qwen2-1.5b's), 32 (the serving example's reduced model) and 16 (the
// JAX package's test shapes); csrc/flash_attn_wgmma.cu takes bfloat16.
// For every (batch b, KV head kv) pair n and every query row r of the
// folded row axis (r = g * L + l: the G = H / KV query heads of kv folded
// over the L positions), at position p = q_offset + r mod L (q_offset 0
// but for a rank's rows of a longer sequence under sequence-parallel
// attention):
//
//   s[j]  = (q[r] . k[j]) * scale,        scale = 1 / sqrt(head_dim)
//   s[j]  = NEG_INF (-1e30) where causal and j > p, or where a sliding
//           window of W > 0 keys is set and |p - j| >= W
//   o[r]  = sum_j softmax(s)[j] v[j]
//
// through the online-softmax recurrence over key tiles in ascending
// order (m, l and acc in float32, 2^x on the MUFU pipe, `exp2_ftz`, of
// scores prescaled by log2(e); no other fast math), and at the end o =
// acc / max(l, 1e-30), in float32.
//
// What bounds it on this card: operations.  A causal prefill does
// 4 * head_dim flops per kept (query, key) pair against 4 bytes per
// element of q, k, v and o: about 900 flops per byte at qwen2-0.5b's
// B 4 x L 4096, far above the ratio where HBM would be the limit.  The
// CUDA cores give 67 TFLOP/s of float32; the tensor cores 495 TFLOP/s of
// TF32, whose 10-bit mantissa alone (2^-11 relative) misses this port's
// float32 gate (1e-5 of max |o|).  So every product is split (3xTF32):
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away (cvt.rna, never the tensor core's truncation),
// and x y ~ hi_x hi_y + hi_x lo_y + lo_x hi_y, dropping lo lo (~2^-22
// relative).  Both products, S = Q K^T and P V, are split: 12 * hd
// flops of tensor work per kept pair, at most 1/3 of the TF32 peak.
//
// Design (the warp roles, ring and softmax of csrc/flash_attn_wgmma.cu;
// the helpers both share are in hopper_common.cuh):
//
// - a pre-pass of two small kernels, launched by the same entry point
//   before the attention kernel (three launches a call), writes K_hi,
//   K_lo [N, S_pad, hdp] and V^T_hi, V^T_lo [N, hdp, S_pad] (S_pad = S
//   rounded up to 64 keys, zeros past S; hdp = max(hd, 32), zeros past
//   hd) into the caller's scratch.  The scratch is a torch tensor the
//   wrapper passes in (4 * N * S_pad * hdp floats), so torch's allocator
//   accounts for it.  Why V transposed:
//   wgmma takes its transpose bit only for 16-bit types, so a tf32 B
//   operand must be K-major, i.e. keys contiguous for P V.  Why its keys
//   permuted: the S accumulator gives lane t of a quad keys {2t, 2t+1}
//   of each group of 8, and the tf32 register A fragment wants columns
//   {t, t+4}; storing each group of 8 keys of V^T in the order [0, 2, 4,
//   6, 1, 3, 5, 7] makes column c of the k8 step key 2c (c < 4) or
//   2(c - 4) + 1, so p goes from the accumulator's registers into the A
//   fragment unmoved;
// - one block per (pair n, tile of QB = 128 folded query rows), three
//   warpgroups: WG0 the producer (40 registers, setmaxnreg), one thread
//   of which keeps TMA loads in flight into two rings, one of K hi/lo
//   tiles and one of V^T hi/lo tiles (KB keys, KB * hd * 8 bytes a
//   stage), each
//   stage with a "full" (TMA's transaction bytes) and an "empty" (one
//   arrival per consumer warp) mbarrier; WG1 and WG2 the consumers (232
//   registers), 64 query rows each.  A K stage is freed as soon as S has
//   been computed from it, a V^T stage once P V has.  Shared memory, Q
//   hi and lo of both consumers and the rings:
//   - hd 64: KB = 64, 3 K and 2 V^T stages: 64 + 160 KB (a third K
//     stage took 5% off the time at qwen2-0.5b's prefill shape; PERF.md,
//     section 6);
//   - hd 128: KB = 32, 2 K stages and 1 V^T stage: 128 + 96 KB, of the
//     227 KB a block may use.  V^T tile t + 1 then loads while S and
//     the softmax of tile t + 1 run.  Keeping Q lo in registers instead
//     (as the A fragments of the S product, 64 a thread) left room for
//     2 V^T stages, but ptxas spilled it (204 bytes at the consumers'
//     232 registers; PERF.md, section 6);
//   - hd 32: KB = 64, 4 K and 4 V^T stages: 32 + 128 KB.  A row of 32
//     floats is one 128-byte swizzled column block, so Q, K and V^T keep
//     the wider instances' layout with one block;
//   - hd 16 runs the hd-32 instance zero-padded: the pre-pass writes K
//     and V^T with 32 columns or rows, zeros past 16, the consumers load
//     Q with zero columns 16 .. 31 and store 16 columns of o.  Zero
//     columns add +0 to every dot product, so the scores are unchanged;
//     no model runs hd 16, so it takes the width's products twice over
//     rather than a 64-byte-swizzle instance of its own;
//   - hd 112 (zamba2-7b's shared attention) runs the hd-128 instance the
//     same way: the pre-pass writes 128 columns of K and rows of V^T,
//     zeros past 112, and q and o have 112 columns (8/7 of the
//     products);
// - Q is loaded once by the consumers, 16 bytes a thread, split into hi
//   and lo and stored in the 128-byte-swizzled layout wgmma reads (not
//   by TMA: a 128-row tile can straddle two fold groups);
// - S = Q K^T is 3 x hd / 8 wgmma m64n{KB}k8 (tf32 inputs, f32
//   accumulator), K-major operands: a row of 32 floats is one 128-byte
//   swizzled column block, and a k8 step is 32 bytes, so the
//   descriptors step as the bf16 kernel's k16 ones do;
// - the mask and the online softmax run in the accumulator's registers;
//   a row's max and sum take two xor shuffles each; the block walks the
//   key tiles [first, end) of `key_tiles` (producer and consumers
//   alike), so tiles past S, wholly past the block's largest position
//   when causal, or outside every row's sliding window are never
//   loaded; the per-element mask runs only on the tiles `tile_masked`
//   names, behind a branch uniform over the warpgroup, as in
//   csrc/flash_attn_wgmma.cu.  A window's first tile may be wholly
//   masked for some rows:
//   as in csrc/flash_attn_wgmma.cu, their running max stays NEG_INF
//   (finite), each masked key adds p = 1, and corr = 2^(NEG_INF -
//   m_new) = 0 at the row's first kept key wipes l and the folded acc
//   exactly (acc corr + pv: a product by 0, then the fresh tile's pv);
//   every row keeps its own key, so l > 0 at the end;
// - P V is 3 x KB / 8 register-A wgmma m64n{PN}k8 per PN = min(hd, 64)
//   output columns:
//   p split into tf32 hi and lo in registers, V^T hi and lo from the
//   ring, summed into a fresh accumulator per tile and folded into acc
//   in float32 (acc = acc corr + pv, each rounded to nearest).  The
//   tensor core's float32 accumulation drops low bits when it adds into
//   a large running sum: carrying acc through the products missed the
//   gate, 3.3e-5 of max |o| from a float64 truth at (4, 4096, 14, 2, 64)
//   bidirectional, against 2.5e-6 with the fold (PERF.md, section 6),
//   for 10% more time.  At hd 128 the two 64-column halves run one
//   after the other, so the fresh accumulator stays 32 registers;
// - the epilogue divides, stages the warpgroup's 64 rows in its Q hi
//   slot and stores 16 bytes a thread through the strides (a straddling
//   tile's rows go to two heads: no TMA store);
// - fixed summation order, no atomics, no split over keys: two launches
//   give the same bits.
#include "hopper_common.cuh"

namespace {

constexpr int kQB = 128;                // query rows per block
constexpr int kThreads = 384;           // three warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWgRows = 64;             // query rows per consumer warpgroup
// the scratch's keys are padded to a multiple of this (every width's KB
// divides it)
constexpr int kKeyPad = 64;
// every operand row is 32 floats, one 128-byte swizzled column block
constexpr int kSW = 128;
// one 32-float column block of a 64-row Q operand
constexpr int kQBlockBytes = kWgRows * kSW;
// the narrowest instance: smaller head dims run it zero-padded
constexpr int kMinHD = 32;

template <int HD>
struct Cfg {
  static constexpr int KB = HD == 128 ? 32 : 64;        // keys per tile
  static constexpr int K_STAGES = HD == 64 ? 3 : HD == 128 ? 2 : 4;
  static constexpr int V_STAGES = HD == 64 ? 2 : HD == 128 ? 1 : 4;
  static constexpr int PN = HD < 64 ? HD : 64;  // output columns a P V pass
  static constexpr int OP_BYTES = KB * HD * 4;          // K or V^T, hi or lo
  static constexpr int K_BLOCK = KB * kSW;              // K: HD / 32 blocks
  static constexpr int V_BLOCK = HD * kSW;              // V^T: KB / 32
  static constexpr int STAGE_BYTES = 2 * OP_BYTES;      // hi and lo
  static constexpr int Q_PART_BYTES = kWgRows * HD * 4; // Q hi or Q lo
  static constexpr int WG_Q_BYTES = 2 * Q_PART_BYTES;
  static constexpr int K_RING = 2 * WG_Q_BYTES;         // offsets from base
  static constexpr int V_RING = K_RING + K_STAGES * STAGE_BYTES;
  // + 1024: the dynamic window is aligned up to the swizzle atom
  static constexpr int SMEM = V_RING + V_STAGES * STAGE_BYTES + 1024;
};

// -- tf32 ----------------------------------------------------------------

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// -- wgmma (the shared helpers: hopper_common.cuh) ----------------------

// A K-major operand's k8 step kk: column block kk / 4 (`block` bytes
// apart), 32 bytes per step inside the 128-byte row, 8-row groups 1024
// bytes apart.
__device__ __forceinline__ uint64_t operand(uint32_t tile, int block,
                                            int kk) {
  return make_desc<kSW>(tile + (kk / 4) * block + (kk % 4) * 32, 16);
}

// d[64 x N] (+)= A[64 x 8] B[8 x N], tf32, both K-major in shared
// memory; scale_d = 0 overwrites d.  N = 32 or 64 (KB).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R16
      "}, %16, %17, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R32
      "}, %32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] (+)= A[64 x 8] B[8 x N], tf32, A in registers (the k8
// fragment: rows g and g + 8 of the warp's 16, columns t and t + 4, in
// the order (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), B K-major
// in shared memory; scale_d = 0 overwrites d.  N = 32 or 64 (PN).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// -- the pre-pass -------------------------------------------------------

// K [N, S, hd] (through strides) -> K_hi, K_lo [N, S_pad, hdp] at ks and
// ks + N * S_pad * hdp; zeros past S and past column hd.  One float4 a
// thread.
__global__ void __launch_bounds__(256)
tf32_split_k_kernel(const float* __restrict__ k, float* __restrict__ ks,
                    int NB, int KV, int S, int S_pad, int hd, int hdp,
                    Layout lk) {
  const int cpr = hdp / 4;               // float4 chunks per row
  const long long total = static_cast<long long>(NB) * S_pad * cpr;
  float4* hi = reinterpret_cast<float4*>(ks);
  float4* lo = hi + total;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c = static_cast<int>(i % cpr);
    const long long nj = i / cpr;
    const int j = static_cast<int>(nj % S_pad);
    const int n = static_cast<int>(nj / S_pad);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < S && 4 * c < hd)
      x = *reinterpret_cast<const float4*>(k + (n / KV) * lk.b + j * lk.row +
                                           (n % KV) * lk.head + 4 * c);
    float4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// Stored position p (0..7) of a group of 8 keys holds key perm(p): the
// k8 A fragment's column order (see the header).
__device__ __forceinline__ int key_at(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// V [N, S, hd] (through strides) -> V^T_hi, V^T_lo [N, hdp, S_pad] at
// vts and vts + N * hdp * S_pad, keys permuted within each group of 8;
// zeros past S and past row hd.  A 32-key x 32-dim tile a block,
// transposed in shared memory.
__global__ void __launch_bounds__(256)
tf32_split_vt_kernel(const float* __restrict__ v, float* __restrict__ vts,
                     int NB, int KV, int S, int S_pad, int hd, int hdp,
                     Layout lv) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z, j0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* v_n = v + (n / KV) * lv.b + (n % KV) * lv.head + d0 + tx;
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    tile[r][tx] = j < S && d0 + tx < hd ? v_n[j * lv.row] : 0.0f;
  }
  __syncthreads();
  const int key = (tx & ~7) + key_at(tx & 7);
  float* hi = vts + static_cast<long long>(n) * hdp * S_pad + j0 + tx;
  float* lo = hi + static_cast<long long>(NB) * hdp * S_pad;
  for (int r = ty; r < 32; r += 8) {
    float h, l;
    split(tile[key][r], h, l);
    const long long off = static_cast<long long>(d0 + r) * S_pad;
    hi[off] = h;
    lo[off] = l;
  }
}

// -- the kernel ---------------------------------------------------------

// HD: the instance's width (32, 64 or 128); COLS: the columns of q and o
// (HD, or 16 on the hd-32 instance, or 112 on the hd-128 one: Q's
// columns past COLS load as zeros and o's are not stored).
template <int HD, int COLS>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const float* __restrict__ q, float* __restrict__ o,
                  int NB, int KV, int G, int L, int S, Layout lq, Layout lout,
                  float scale, int causal, int window,
                  int q_offset) {
  static_assert(COLS == HD || (HD == kMinHD && COLS == 16) ||
                    (HD == 128 && COLS == 112),
                "columns");
  using C = Cfg<HD>;
  constexpr int KB = C::KB, PN = C::PN;
  constexpr int CPR = HD / 4;            // 16-byte chunks per operand row
  constexpr int OUT_CPR = COLS / 4;      // 16-byte chunks per q or o row
  constexpr int KS = C::K_STAGES, VS = C::V_STAGES;
  // a ring of K tiles and one of V^T tiles, each with "full" and "empty"
  // barriers per stage
  __shared__ __align__(8) uint64_t k_full[KS], k_empty[KS];
  __shared__ __align__(8) uint64_t v_full[VS], v_empty[VS];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // consumer w's Q hi at w * WG_Q_BYTES, its Q lo a Q_PART_BYTES later;
  // the hi and lo of K stage st at k_stage(st) (+ OP_BYTES), of V^T
  // stage st at v_stage(st)
  auto k_stage = [&](int st) { return base + C::K_RING + st * C::STAGE_BYTES; };
  auto v_stage = [&](int st) { return base + C::V_RING + st * C::STAGE_BYTES; };

  const int rows = G * L;
  // longest blocks (the last rows, when causal) first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int consumers = r0 + kWgRows < rows ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < KS; ++st) {
      mbar_init(smem_addr(&k_full[st]), 1);
      mbar_init(smem_addr(&k_empty[st]), 4 * consumers);
    }
    for (int st = 0; st < VS; ++st) {
      mbar_init(smem_addr(&v_full[st]), 1);
      mbar_init(smem_addr(&v_empty[st]), 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each role computes what it needs after its setmaxnreg: a value live
  // across it would be spilled
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps both rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const TileRange tr = key_tiles<kQB, KB>(r0, rows, L, S, causal,
                                              window, q_offset);
      const int n = blockIdx.y;
      // K tile t, then V^T tile t, each once its stage has been freed;
      // visit i (tile first + i) uses stages i % KS and i % VS
      for (int t = tr.first, i = 0; t < tr.end; ++t, ++i) {
        const int ks = i % KS, vs = i % VS;
        mbar_wait(smem_addr(&k_empty[ks]), ((i / KS) & 1) ^ 1);
        const uint32_t kf = smem_addr(&k_full[ks]);
        mbar_expect_tx(kf, C::STAGE_BYTES);
#pragma unroll
        for (int part = 0; part < 2; ++part)         // hi, lo
#pragma unroll
          for (int cb = 0; cb < HD / 32; ++cb)
            tma_load(k_stage(ks) + part * C::OP_BYTES + cb * C::K_BLOCK,
                     &tmap_k, kf, cb * 32, t * KB, part * NB + n);
        mbar_wait(smem_addr(&v_empty[vs]), ((i / VS) & 1) ^ 1);
        const uint32_t vf = smem_addr(&v_full[vs]);
        mbar_expect_tx(vf, C::STAGE_BYTES);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int cb = 0; cb < KB / 32; ++cb)
            tma_load(v_stage(vs) + part * C::OP_BYTES + cb * C::V_BLOCK,
                     &tmap_v, vf, t * KB + cb * 32, 0, part * NB + n);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    const int w = wg - 1;
    const int wg_r0 = r0 + w * kWgRows;
    if (wg_r0 >= rows) return;           // the block's last rows are fewer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const TileRange tr = key_tiles<kQB, KB>(r0, rows, L, S, causal, window,
                                            q_offset);
    const int b = blockIdx.y / KV, kv = blockIdx.y % KV;
    const int tid = threadIdx.x % 128;
    const uint32_t q_hi = base + w * C::WG_Q_BYTES;
    const uint32_t q_lo = q_hi + C::Q_PART_BYTES;
    uint8_t* q_smem = smem + w * C::WG_Q_BYTES;

    // Q once: 16 bytes a thread, split into hi and lo, zeros past the
    // last row and past column COLS
    for (int i = tid; i < kWgRows * CPR; i += 128) {
      const int row = i / CPR, ch = i % CPR, r = wg_r0 + row;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && (COLS == HD || ch < OUT_CPR)) {
        const int l_r = r % L, h = kv * G + r / L;
        x = *reinterpret_cast<const float4*>(
            q + b * lq.b + l_r * lq.row + h * lq.head + ch * 4);
      }
      float4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      const uint32_t off =
          (ch / 8) * kQBlockBytes + swizzled<kSW>(row, ch % 8);
      *reinterpret_cast<float4*>(q_smem + off) = hi;
      *reinterpret_cast<float4*>(q_smem + C::Q_PART_BYTES + off) = lo;
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
      const int ks = i % KS, vs = i % VS;
      const int j0 = t * KB;
      const uint32_t k_hi = k_stage(ks), k_lo = k_hi + C::OP_BYTES;
      const uint32_t v_hi = v_stage(vs), v_lo = v_hi + C::OP_BYTES;
      mbar_wait(smem_addr(&k_full[ks]), (i / KS) & 1);

      // S = Q K^T, split: hi hi + hi lo + lo hi
      float s[KB / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint64_t dq = operand(q_hi, kQBlockBytes, kk);
        const uint64_t dk_hi = operand(k_hi, C::K_BLOCK, kk);
        wgmma_ss(s, dq, dk_hi, kk > 0);
        wgmma_ss(s, dq, operand(k_lo, C::K_BLOCK, kk), 1);
        wgmma_ss(s, operand(q_lo, kQBlockBytes, kk), dk_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (lane == 0) mbar_arrive(smem_addr(&k_empty[ks]));

      // scale, mask, and the online softmax in registers
      const bool masked = tile_masked<KB>(j0, S, causal, window, wp.min_pos,
                                          wp.max_pos);
      float mx[2] = {kNegInf, kNegInf};
      if (masked) {
#pragma unroll
        for (int e = 0; e < KB / 2; ++e) {
          const int h = (e / 2) % 2;
          const int j = j0 + 8 * (e / 4) + 2 * quad + e % 2;
          float x = s[e] * scale_log2;
          if (key_masked(j, pos[h], S, causal, window)) x = kNegInf;
          s[e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      } else {
#pragma unroll
        for (int e = 0; e < KB / 2; ++e) {
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
      // p, split into tf32 hi and lo: A fragments of the P V product.
      // Key group kk is registers 4 kk .. 4 kk + 3 of S: (row g, key
      // 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); the fragment
      // wants (g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4), and
      // V^T's permuted keys make col t key 2t and col t + 4 key 2t + 1.
      uint32_t p_hi[KB / 8][4], p_lo[KB / 8][4];
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;           // register 4 kk + e: row g + 8 h
          const float p = exp2_ftz(s[4 * kk + e] - m[h]);
          sum[h] += p;                   // l sums the float32 p
          float hi, lo;
          split(p, hi, lo);
          const int a = e == 1 ? 2 : e == 2 ? 1 : e;   // fragment slot
          p_hi[kk][a] = __float_as_uint(hi);
          p_lo[kk][a] = __float_as_uint(lo);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }
      // per PN output columns nh: pv = p_hi V_hi + p_hi V_lo + p_lo V_hi,
      // then acc = acc corr + pv
      mbar_wait(smem_addr(&v_full[vs]), (i / VS) & 1);
#pragma unroll
      for (int nh = 0; nh < HD / PN; ++nh) {
        const uint32_t rows_nh = nh * PN * kSW;                // V^T's
        float pv[PN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 8; ++kk) {
          const uint64_t dv_hi = operand(v_hi + rows_nh, C::V_BLOCK, kk);
          wgmma_rs(pv, p_hi[kk], dv_hi, kk > 0);
          wgmma_rs(pv, p_hi[kk], operand(v_lo + rows_nh, C::V_BLOCK, kk), 1);
          wgmma_rs(pv, p_lo[kk], dv_hi, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pv);
#pragma unroll
        for (int e = 0; e < PN / 2; ++e)
          acc[PN / 2 * nh + e] = __fadd_rn(
              __fmul_rn(acc[PN / 2 * nh + e], corr[(e / 2) % 2]), pv[e]);
      }
      if (lane == 0) mbar_arrive(smem_addr(&v_empty[vs]));
    }

    // epilogue: divide, stage in the Q hi slot, 16-byte stores
    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], kMinDenominator);
    named_barrier(1 + w);                // every product on Q has completed
    const int row_g = warp * 16 + lane / 4;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
      // columns 8 jn + 2 quad + {0, 1}: chunk 2 jn + quad / 2, 8 bytes in
      const int ch = 2 * jn + quad / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(
            q_smem + (ch / 8) * kQBlockBytes +
            swizzled<kSW>(row_g + 8 * h, ch % 8) + 8 * (quad % 2)) =
            make_float2(acc[4 * jn + 2 * h] / den[h],
                        acc[4 * jn + 2 * h + 1] / den[h]);
      }
    }
    named_barrier(1 + w);
    for (int i = tid; i < kWgRows * OUT_CPR; i += 128) {
      const int row = i / OUT_CPR, ch = i % OUT_CPR, r = wg_r0 + row;
      if (r >= rows) break;
      const int l_r = r % L, h = kv * G + r / L;
      *reinterpret_cast<float4*>(o + b * lout.b + l_r * lout.row +
                                 h * lout.head + ch * 4) =
          *reinterpret_cast<const float4*>(
              q_smem + (ch / 8) * kQBlockBytes + swizzled<kSW>(row, ch % 8));
    }
  }
}

// -- host side ----------------------------------------------------------

// A map of the contiguous 3-D float32 tensor (d0, d1, d2), innermost
// first, in boxes of (32, box1, 1) with the 128-byte swizzle.
int make_map(CUtensorMap* map, const float* base, long long d0, long long d1,
             long long d2, int box1) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 4,
                                 static_cast<cuuint64_t>(d0 * d1) * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

// The attention kernel on the pre-pass's output (K split at ks, V^T
// split at vts, both HD wide).
template <int HD, int COLS>
int launch(const float* ks, const float* vts, const void* q, void* o,
           int causal, int window, int q_offset, int NB, int KV, int G,
           int L, int S, long long S_pad,
           long long tiles, const Layout& lq, const Layout& lout,
           float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tmap_k, tmap_v;
  int map_err = make_map(&tmap_k, ks, HD, S_pad, 2LL * NB, C::KB);
  if (map_err == 0) map_err = make_map(&tmap_v, vts, S_pad, HD, 2LL * NB, HD);
  if (map_err != 0) return map_err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tf32_kernel<HD, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  flash_tf32_kernel<HD, COLS><<<dim3(static_cast<unsigned>(tiles), NB),
                                kThreads, C::SMEM, stream>>>(
      tmap_k, tmap_v, static_cast<const float*>(q), static_cast<float*>(o),
      NB, KV, G, L, S, lq, lout, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: NB * G * L query rows; k, v: NB * S keys; float32 (dtype 0, the
// wrapper's code; any other dtype is refused), head_dim `hd` 16, 32, 64,
// 112 or 128 (any other is refused); `window` > 0 a sliding window of
// that many keys (key j kept for position p when |p - j| < window), 0
// none.  Query row l of the L sits at position p = q_offset + l
// (q_offset >= 0; 0 when the rows are the whole sequence); a window
// needs q_offset + L < S + window, so that every row keeps a key.
// Pair n = b * KV + kv reads query row r = g * L + l at
//   q + b * st[0] + l * st[1] + (kv * G + g) * st[2]
// and key j at k + b * st[3] + j * st[4] + kv * st[5] (v: st[6..8]),
// and writes o + b * st[9] + l * st[10] + (kv * G + g) * st[11]; strides
// in elements, head_dim contiguous, every row 16-byte aligned.
// `scratch`: 4 * NB * S_pad * hdp floats (hdp the instance's width: hd,
// 32 for hd 16, 128 for hd 112), 16-byte aligned, S_pad
// = S rounded up to a multiple of 64; the pre-pass overwrites it.  Launches
// the pre-pass's two kernels and the attention kernel on `stream`, does
// not synchronise, and returns the first cudaGetLastError() that is not
// 0, as an int: cudaErrorInvalidValue for a shape it does not take,
// 10000 + the CUresult where cuTensorMapEncodeTiled refuses a map.
extern "C" int flash_attn_tf32_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int hd, int causal, int window,
                                      int q_offset, int NB, int KV, int G,
                                      int L, int S, const long long* strides,
                                      float scale, void* scratch,
                                      void* stream) {
  if (dtype != 0 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 112 && hd != 128))
    return cudaErrorInvalidValue;
  if (NB <= 0 || G <= 0 || L <= 0) return 0;
  if (S <= 0 || KV <= 0 || NB % KV || NB > 65535 || window < 0 ||
      q_offset < 0 || static_cast<long long>(q_offset) + L > 0x7FFFFFFFLL ||
      (window > 0 && static_cast<long long>(q_offset) + L >=
                         static_cast<long long>(S) + window))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(G) * L;
  const long long tiles = (rows + kQB - 1) / kQB;
  const long long S_pad = (S + kKeyPad - 1LL) / kKeyPad * kKeyPad;
  if (rows > 0x7FFFFFFFLL || S_pad > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout lq{strides[0], strides[1], strides[2]};
  const Layout lk{strides[3], strides[4], strides[5]};
  const Layout lv{strides[6], strides[7], strides[8]};
  const Layout lout{strides[9], strides[10], strides[11]};
  // the scratch's width: the instance's
  const int hdp = hd < kMinHD ? kMinHD : hd == 112 ? 128 : hd;
  float* ks = static_cast<float*>(scratch);
  float* vts = ks + 2LL * NB * S_pad * hdp;

  const long long chunks = static_cast<long long>(NB) * S_pad * (hdp / 4);
  const unsigned split_blocks =
      static_cast<unsigned>((chunks + 255) / 256 < 8192 ? (chunks + 255) / 256
                                                        : 8192);
  tf32_split_k_kernel<<<split_blocks, 256, 0, st>>>(
      static_cast<const float*>(k), ks, NB, KV, S, static_cast<int>(S_pad),
      hd, hdp, lk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tf32_split_vt_kernel<<<dim3(static_cast<unsigned>(S_pad / 32), hdp / 32,
                              NB),
                         256, 0, st>>>(static_cast<const float*>(v), vts, NB,
                                       KV, S, static_cast<int>(S_pad), hd,
                                       hdp, lv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (hd) {
    case 16:
      return launch<32, 16>(ks, vts, q, o, causal, window, q_offset, NB,
                            KV, G, L, S, S_pad, tiles, lq, lout, scale,
                            st);
    case 32:
      return launch<32, 32>(ks, vts, q, o, causal, window, q_offset, NB,
                            KV, G, L, S, S_pad, tiles, lq, lout, scale,
                            st);
    case 64:
      return launch<64, 64>(ks, vts, q, o, causal, window, q_offset, NB,
                            KV, G, L, S, S_pad, tiles, lq, lout, scale,
                            st);
    case 112:
      return launch<128, 112>(ks, vts, q, o, causal, window, q_offset, NB,
                              KV, G, L, S, S_pad, tiles, lq, lout, scale,
                              st);
    case 128:
      return launch<128, 128>(ks, vts, q, o, causal, window, q_offset, NB,
                              KV, G, L, S, S_pad, tiles, lq, lout, scale,
                              st);
  }
  return cudaErrorInvalidValue;
}
