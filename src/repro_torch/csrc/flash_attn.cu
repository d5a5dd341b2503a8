// Causal or bidirectional online-softmax attention (flash attention) with
// grouped KV heads, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py:
// `_flash_kernel` (wrapper `flash_mha`, GQA wrapper `flash_attention`),
// at head dims 16 and 32, float32 or bfloat16; at 64 and 128 (the
// serving path's prefills) bfloat16 runs on the tensor cores in
// csrc/flash_attn_wgmma.cu, and float32 on them in 3xTF32 in
// csrc/flash_attn_tf32.cu.
// For every (batch b, KV head kv) pair n and every query row r of the
// folded row axis (r = g * L + l: the G = H / KV query heads of kv
// folded over the L positions), with position l = r mod L:
//
//   s[j]  = (q[r] . k[j]) * scale,        scale = 1 / sqrt(head_dim)
//   s[j]  = NEG_INF (-1e30) where causal and j > l
//   o[r]  = sum_j softmax(s)[j] v[j]
//
// through the online-softmax recurrence over key tiles in ascending
// order: m_new = max(m, max_j s), corr = exp(m - m_new),
// l = l corr + sum_j exp(s - m_new), acc = acc corr + sum_j exp(s -
// m_new) v[j], and at the end o = acc / max(l, 1e-30), rounded once to
// the output's type.  Inputs are float32 or bfloat16, upcast to float32;
// every score, the running max, the denominator and the accumulator are
// float32 (precise expf, no fast math).
//
// What bounds it on this card: operations.  A causal prefill does
// 4 * head_dim flops per kept (query, key) pair against 4 bytes per
// float32 element of q, k, v and o read or written once: about 900
// flops per byte at qwen2-0.5b's B 4 x L 4096.  Here everything runs on
// the CUDA cores (67 TFLOP/s of float32 on an H100 SXM at 700 W,
// NVIDIA's data sheet): the head dims the tensor-core kernels do not
// take, 16 and 32, narrower than their column blocks.
//
// Design.  The TPU kernel walks a sequential (N, q tile, k tile) grid
// and carries (acc, m, l) in VMEM scratch across the k axis.  Here one
// thread block owns (n, a tile of QB query rows) and loops over the key
// tiles itself:
// - each query row belongs to one lane, which holds its q and its
//   accumulator (head_dim floats each) in registers;
// - the K and V tiles (KB keys) are staged in shared memory as float32,
//   loaded 16 bytes per thread; every lane of a warp reads the same key
//   (a broadcast);
// - the KB scores of a row live in registers only: no score ever
//   reaches device memory;
// - a key tile whose first key lies past the block's largest query
//   position is never loaded: the exact test, where the TPU kernel's
//   (first position + QB - 1) is conservative across fold groups.  Both
//   give the same bits: a fully masked tile leaves (m, l, acc)
//   unchanged once key 0, kept by every row, has been seen in tile 0;
// - ragged row and key counts are bounds-checked (out-of-range keys
//   read as zeros and score NEG_INF); nothing is padded in memory;
// - q, k, v and o are read and written through strides, so the model's
//   [B, L, H, head_dim] layout needs no folded copy;
// - fixed summation order, no atomics: two launches give the same bits.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMinDenominator = 1e-30f;
constexpr int kThreads = 128;

template <int HD>
struct Tile {
  static constexpr int QB = kThreads;            // query rows per block
  static constexpr int KB = 64;                  // keys per tile
  static constexpr int CH = HD / 4;              // 16-byte chunks per row
};

// Element strides of one operand; the head_dim stride is 1.
struct Layout {
  long long b, row, head;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T at p (aligned), as float32 into dst[0 .. 16/sizeof(T)).
__device__ __forceinline__ void unpack16(const uint4& w, float* dst,
                                         const float*) {
  dst[0] = __uint_as_float(w.x);
  dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z);
  dst[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float* dst,
                                         const __nv_bfloat16*) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(words[i] << 16);
    dst[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int KV, int G,
                  int L, int S, Layout lq, Layout lk, Layout lv, Layout lo,
                  float scale, int causal) {
  using C = Tile<HD>;
  constexpr int VEC = 16 / sizeof(T);                   // elements per load
  constexpr int LOADS = C::KB * HD / VEC / kThreads;    // per thread, tile
  __shared__ __align__(16) float ks[C::KB][HD];
  __shared__ __align__(16) float vs[C::KB][HD];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int b = n / KV, kv = n % KV;
  const int rows = G * L;
  const int r0 = blockIdx.x * C::QB;
  const int r = r0 + tid;
  const bool active = r < rows;
  const int rr = active ? r : rows - 1;  // idle lanes shadow the last row
  const int pos = rr % L;
  const int h = kv * G + rr / L;

  // the block's largest query position: its last row's, unless the
  // block straddles two fold groups
  const int r_last = min(r0 + C::QB, rows) - 1;
  const int max_pos = (r0 / L == r_last / L) ? r_last % L : L - 1;
  const int all_tiles = (S + C::KB - 1) / C::KB;
  const int n_tiles = causal ? min(all_tiles, max_pos / C::KB + 1)
                             : all_tiles;

  float qr[HD];
  const T* qp = q + b * lq.b + pos * lq.row + h * lq.head;
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qr[4 * c + e] = to_f32(qp[4 * c + e]);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const T* kb = k + b * lk.b + kv * lk.head;
  const T* vb = v + b * lv.b + kv * lv.head;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * C::KB;
    __syncthreads();  // every lane is done with the previous tile
    uint4 kw[LOADS], vw[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = (tid + i * kThreads) * VEC;
      const int jj = j0 + e / HD, d = e % HD;
      kw[i] = make_uint4(0u, 0u, 0u, 0u);
      vw[i] = kw[i];
      if (jj < S) {
        kw[i] = *reinterpret_cast<const uint4*>(kb + jj * lk.row + d);
        vw[i] = *reinterpret_cast<const uint4*>(vb + jj * lv.row + d);
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = (tid + i * kThreads) * VEC;
      unpack16(kw[i], &ks[e / HD][e % HD], static_cast<const T*>(nullptr));
      unpack16(vw[i], &vs[e / HD][e % HD], static_cast<const T*>(nullptr));
    }
    __syncthreads();

    float s[C::KB];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll
      for (int c = 0; c < C::CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(
            &ks[j][4 * c]);
        d0 = fmaf(qr[4 * c], kk.x, d0);
        d1 = fmaf(qr[4 * c + 1], kk.y, d1);
        d2 = fmaf(qr[4 * c + 2], kk.z, d2);
        d3 = fmaf(qr[4 * c + 3], kk.w, d3);
      }
      const float dot = (d0 + d1) + (d2 + d3);
      const int jj = j0 + j;
      const float sj = (jj >= S || (causal && jj > pos)) ? kNegInf
                                                         : dot * scale;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
    float pv[HD];
#pragma unroll
    for (int i = 0; i < HD; ++i) pv[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
#pragma unroll
      for (int c = 0; c < C::CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &vs[j][4 * c]);
        pv[4 * c] = fmaf(p, vv.x, pv[4 * c]);
        pv[4 * c + 1] = fmaf(p, vv.y, pv[4 * c + 1]);
        pv[4 * c + 2] = fmaf(p, vv.z, pv[4 * c + 2]);
        pv[4 * c + 3] = fmaf(p, vv.w, pv[4 * c + 3]);
      }
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] = acc[i] * corr + pv[i];
  }

  if (active) {
    const float den = fmaxf(l, kMinDenominator);
    T* op = o + b * lo.b + pos * lo.row + h * lo.head;
#pragma unroll
    for (int c = 0; c < C::CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(op + 4 * c + e, acc[4 * c + e] / den);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int causal,
           int NB, int KV, int G, int L, int S, const long long* st,
           float scale, cudaStream_t stream) {
  using C = Tile<HD>;
  const long long rows = static_cast<long long>(G) * L;
  const long long tiles = (rows + C::QB - 1) / C::QB;
  if (tiles > 0x7FFFFFFFLL || NB > 65535) return cudaErrorInvalidValue;
  const Layout lq{st[0], st[1], st[2]}, lk{st[3], st[4], st[5]},
      lv{st[6], st[7], st[8]}, lo{st[9], st[10], st[11]};
  flash_attn_kernel<HD, T><<<dim3(static_cast<unsigned>(tiles), NB),
                             kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), KV, G, L, S, lq, lk, lv,
      lo, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int causal, int NB, int KV, int G, int L, int S,
              const long long* st, float scale, cudaStream_t stream) {
  // hd 64 and 128 run on the tensor cores (csrc/flash_attn_wgmma.cu,
  // csrc/flash_attn_tf32.cu): no instance here
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, o, causal, NB, KV, G, L, S, st, scale,
                           stream);
    case 32:
      return launch<32, T>(q, k, v, o, causal, NB, KV, G, L, S, st, scale,
                           stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: NB * G * L query rows; k, v: NB * S keys; all of head_dim `hd`
// 16 or 32, float32 (dtype 0) or bfloat16 (dtype 1).  Pair n = b * KV +
// kv reads query row r = g * L + l at
//   q + b * st[0] + l * st[1] + (kv * G + g) * st[2]
// and key j at k + b * st[3] + j * st[4] + kv * st[5] (v: st[6..8]),
// and writes o + b * st[9] + l * st[10] + (kv * G + g) * st[11]; strides
// in elements, head_dim contiguous, every row 16-byte aligned.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() as
// an int (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int hd, int causal,
                                 int NB, int KV, int G, int L, int S,
                                 const long long* strides, float scale,
                                 void* stream) {
  if (NB <= 0 || G <= 0 || L <= 0) return 0;
  if (S <= 0 || KV <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, causal, NB, KV, G, L, S, strides,
                            scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, causal, NB, KV, G, L, S,
                                    strides, scale, st);
  return cudaErrorInvalidValue;
}
