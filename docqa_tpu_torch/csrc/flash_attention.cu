// Flash attention forward for Hopper (sm_90a), with a plain C interface
// that docqa_tpu_torch/ops/attention.py binds through ctypes.
//
// Replaces the Pallas TPU kernel docqa_tpu/ops/attention.py::_flash_kernel
// (pl.pallas_call in flash_attention).  Same function on every path:
// blockwise attention with an online softmax whose running max, sum and
// accumulator stay in float32; GQA maps kv head = q head / groups; mask
// kv < lengths[b], and when causal kv <= q_abs (q_abs = row + q_offset[b])
// and, with a window W, kv > q_abs - W; a fully masked row outputs 0; the
// output takes q's dtype.  All paths read [b, s, h, d] tensors through
// their strides (the decoder's KV cache in place) and skip dead kv tiles.
//
// Three paths, chosen by the wrapper from dtype and shapes alone:
//
//   decode  (bf16, sq <= 16; flash_decode.cuh): split-kv over mma.sync.
//     Bound on an H100 SXM by bytes: q, out and the live K/V rows once
//     over 3.35 TB/s (a 4K-row Mistral verify: ~5 us).  PR 1's kernel lost
//     this case four ways; what the design does about each:
//       1. one block per (b * q head, q tile) gave 32 blocks for 132 SMs:
//          blocks are now (split, kv head, batch), the split count sized
//          from skv, heads and the SM count (static shapes: no host sync,
//          capturable in a CUDA graph), and a combine kernel merges the
//          splits with log-sum-exp weights;
//       2. each q head re-read its kv head's K/V: the block packs all
//          groups * sq rows of its kv head into one 16-row mma tile, so K/V
//          are read once per kv head;
//       3. one tile in flight: K/V tiles stream through a 3-stage cp.async
//          ring, two tiles in flight while the third is computed;
//       4. float32 FMA: S = Q K^T and P V run on bf16 tensor cores with
//          f32 accumulation, P rounded to bf16 as the TPU's MXU does.
//     Not wgmma: at 1-16 rows a 64-row wgmma tile is >= 75 % padding, and
//     the path is memory-bound, so mma.sync's 16-row tile is the fit.
//     Paged mode (entry docqa_flash_decode_paged): the same kernels read
//     K/V rows of a flat block pool through a block table, one lookup per
//     row in the cp.async producer — the batcher's decode and verify
//     steps.  It replaces the reference's gather_paged_kv + K1 route on
//     the TPU and is bound the same way: the live K/V rows once.
//
//   prefill (bf16, sq > 16; flash_prefill.cuh): wgmma fed by TMA.  Bound by
//     operations at long prompts: 4 * d * hq * live pairs over 989 TFLOP/s
//     (a 4K-token Mistral prefill: ~139 us).  One or two consumer
//     warpgroups of 64 q rows issue wgmma over 128-row kv tiles (S from
//     shared memory, P V with P in registers and V as an MN-major
//     operand), S_j overlapped with P_{j-1} V_{j-1}; a producer keeps K/V
//     tiles in flight by TMA into an mbarrier-guarded ring (the four
//     causes above: enough blocks at long prompts, no per-thread loads,
//     a 2-3 stage ring, tensor cores).  The mask is applied on edge tiles
//     only.  What limits it at 4K tokens is the softmax between the two
//     products (exp and row reductions on the SFU and ALUs), not the
//     tensor cores: its reductions run as independent partials so the
//     warps are not left waiting on latency.
//
//   simt    (float32; below): PR 1's kernel, unchanged.  TF32 tensor cores
//     keep ~3 decimal digits and cannot meet the f32 tolerance of 5e-5;
//     f32 serves only the tiny card-vs-CPU check and the tests.
//
// SIMT path design: one CUDA block per (batch * q head, q tile); a loop over
// kv tiles inside the block takes the place of the TPU's sequential grid
// axis and its VMEM scratch carry; loop bounds from lengths[b], the causal
// frontier and the window start skip dead tiles (the TPU's block_live);
// templated on head_dim (32, 64, 128), element type and q-tile rows (16 for
// decode / verify, 64 otherwise); 16-byte vector loads; float32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_decode.cuh"
#include "flash_prefill.cuh"

namespace {

constexpr int kThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kBlockKV = 32;    // kv rows per tile
constexpr float kNegInf = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;   // [batch] valid kv rows
  const int* q_offset;  // [batch] absolute position of q row 0
  int sq, skv, hq, hkv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal;
  int window;  // 0 = no sliding window
  float scale;
};

// Global loads are 16-byte vectors (8 bf16 or 4 float); the wrapper
// checks that base pointers and row/head/batch strides keep them aligned.
template <typename T>
constexpr int kVecElems = 16 / (int)sizeof(T);

__device__ __forceinline__ uint4 load_vec(const void* p) {
  return *static_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BKV][D+1], sV [BKV][D], sP [BQ][BKV+1]; the +1
  // pitches keep the column-wise reads free of bank conflicts
  return sizeof(float) * (BQ * (D + 1) + kBlockKV * (D + 1) + kBlockKV * D +
                          BQ * (kBlockKV + 1));
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams p) {
  constexpr int R = BQ / 8;           // q rows per thread
  constexpr int CS = kBlockKV / 16;   // score columns per thread
  constexpr int CO = D / 16;          // output columns per thread
  constexpr int QP = D + 1;
  constexpr int KP = D + 1;
  constexpr int PP = kBlockKV + 1;

  extern __shared__ float smem[];
  float* sQ = smem;                  // q tile, f32, pre-scaled
  float* sK = sQ + BQ * QP;
  float* sV = sK + kBlockKV * KP;
  float* sP = sV + kBlockKV * D;     // probabilities of the current tile

  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const int kvh = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*R .. ty*R+R-1
  const int tx = tid & 15;  // column lane: columns tx + 16*j

  const int kv_len = min(p.lengths[b], p.skv);
  const int q_off = p.q_offset[b];
  const int q_rows = min(BQ, p.sq - q0);

  // live kv range of this q tile: [kv_lo, kv_hi)
  int kv_lo = 0;
  int kv_hi = kv_len;
  if (p.causal) {
    kv_hi = min(kv_hi, q_off + q0 + q_rows);  // last row's q_abs + 1
    if (p.window > 0) kv_lo = max(0, q_off + q0 - p.window + 1);
  }

  constexpr int EV = kVecElems<T>;  // elements per 16-byte vector
  constexpr int VPR = D / EV;        // vectors per row
  constexpr int KV_ITERS = kBlockKV * VPR / kThreads;
  static_assert(kBlockKV * VPR % kThreads == 0, "tile must split evenly");

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int vi = tid; vi < BQ * VPR; vi += kThreads) {
    const int r = vi / VPR;
    const int c = (vi - r * VPR) * EV;
    float x[EV];
    if (r < q_rows) {
      unpack(load_vec(qg + (int64_t)(q0 + r) * p.q_ss + c), x, qg);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) sQ[r * QP + c + e] = x[e] * p.scale;
  }

  float m[R], l[R], acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;
  }

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBlockKV) {
    // issue all of this thread's K/V loads for the tile before any
    // shared-memory store, so their latencies overlap; the barrier after
    // them makes sure sQ is written (first tile) and the previous tile's
    // sK/sV/sP reads are finished before the overwrite
    uint4 kraw[KV_ITERS], vraw[KV_ITERS];
#pragma unroll
    for (int it = 0; it < KV_ITERS; ++it) {
      const int vi = tid + it * kThreads;
      const int r = vi / VPR;
      const int c = (vi - r * VPR) * EV;
      const int kv = t0 + r;
      kraw[it] = make_uint4(0u, 0u, 0u, 0u);  // zero bits == 0.0 in bf16/f32
      vraw[it] = kraw[it];
      if (kv < kv_hi) {
        kraw[it] = load_vec(kg + (int64_t)kv * p.k_ss + c);
        vraw[it] = load_vec(vg + (int64_t)kv * p.v_ss + c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < KV_ITERS; ++it) {
      const int vi = tid + it * kThreads;
      const int r = vi / VPR;
      const int c = (vi - r * VPR) * EV;
      float kx[EV], vx[EV];
      unpack(kraw[it], kx, kg);
      unpack(vraw[it], vx, vg);
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        sK[r * KP + c + e] = kx[e];
        sV[r * D + c + e] = vx[e];
      }
    }
    __syncthreads();

    // S = (q * scale) K^T for this thread's R x CS cells
    float s[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[R], kx[CS];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = sQ[(ty * R + i) * QP + c];
#pragma unroll
      for (int j = 0; j < CS; ++j) kx[j] = sK[(tx + 16 * j) * KP + c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv[i], kx[j], s[i][j]);
    }

    // mask + online softmax; a row's 16 column lanes are one half-warp,
    // so its max and sum reduce with shuffles over xor offsets < 16
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const int q_abs = q_off + q0 + r;
      bool live[CS];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int kv = t0 + tx + 16 * j;
        bool ok = kv < kv_len;
        if (p.causal) {
          ok = ok && kv <= q_abs;
          if (p.window > 0) ok = ok && kv > q_abs - p.window;
        }
        live[j] = ok;
        if (ok) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        // explicit re-mask: with every cell masked m_new == kNegInf and
        // exp(s - m_new) would be 1, not 0
        const float pj = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[r * PP + tx + 16 * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[i][j] *= alpha;
    }
    // each row's P is written and read by the same half-warp
    __syncwarp();

    // acc += P V
#pragma unroll 8
    for (int c = 0; c < kBlockKV; ++c) {
      float pv[R], vx[CO];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = sP[(ty * R + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CO; ++j) vx[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CO; ++j) acc[i][j] = fmaf(pv[i], vx[j], acc[i][j]);
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    if (r < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);  // fully masked row -> 0
#pragma unroll
      for (int j = 0; j < CO; ++j)
        store_f32(og + (int64_t)(q0 + r) * p.o_ss + tx + 16 * j,
                  acc[i][j] / denom);
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.hq, (p.sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D, BQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BQ>
cudaError_t launch_d(const FlashParams& p, int batch, int head_dim,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32, BQ>(p, batch, stream);
    case 64: return launch<T, 64, BQ>(p, batch, stream);
    case 128: return launch<T, 128, BQ>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

enum { kPathSimt = 0, kPathDecode = 1, kPathPrefill = 2 };

namespace {

flash::DecodeParams decode_params(const void* q, const void* k, const void* v,
                                  void* o, const void* lengths,
                                  const void* q_offset, const long long* st,
                                  int sq, int skv, int hq, int hkv, int causal,
                                  int window, float scale, int num_splits,
                                  int split_tiles, void* part_o, void* part_ml) {
  flash::DecodeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lengths = static_cast<const int*>(lengths);
  p.q_offset = static_cast<const int*>(q_offset);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.sq = sq; p.skv = skv; p.hq = hq; p.hkv = hkv;
  p.groups = hq / hkv;
  p.rows = p.groups * sq;
  p.num_splits = num_splits;
  p.split_tiles = split_tiles;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * flash::kLog2e;
  p.block_table = nullptr;
  p.nb = p.block_size = p.pool_rows = 0;
  return p;
}

int launch_decode_d(const flash::DecodeParams& p, int batch, int head_dim,
                    cudaStream_t s) {
  switch (head_dim) {
    case 32: return (int)flash::launch_decode_mt<32>(p, batch, s);
    case 64: return (int)flash::launch_decode_mt<64>(p, batch, s);
    case 128: return (int)flash::launch_decode_mt<128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1's split-kv decode path in paged mode (bf16, causal): q [batch, sq, hq,
// D] read through strides[0..2], K/V rows from the flat pools k_pool /
// v_pool [pool_rows, hkv, D] (strides[3..8]: batch stride 0, row, head)
// through block_tables [batch, nb] int32, out through strides[9..11].
// skv = nb * block_size; num_splits / split_tiles as the contiguous path.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int docqa_flash_decode_paged(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const void* lengths, const void* q_offset, const void* block_tables,
    const void* strides, int batch, int sq, int nb, int block_size,
    int pool_rows, int hq, int hkv, int head_dim, int window, float scale,
    int num_splits, int split_tiles, void* part_o, void* part_ml,
    void* stream) {
  if (batch <= 0 || sq <= 0 || nb <= 0 || block_size <= 0 || pool_rows <= 0 ||
      hq <= 0 || hkv <= 0 || hq % hkv != 0 || num_splits <= 0 ||
      split_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  flash::DecodeParams p = decode_params(
      q, k_pool, v_pool, o, lengths, q_offset,
      static_cast<const long long*>(strides), sq, nb * block_size, hq, hkv,
      /*causal=*/1, window, scale, num_splits, split_tiles, part_o, part_ml);
  p.block_table = static_cast<const int*>(block_tables);
  p.nb = nb;
  p.block_size = block_size;
  p.pool_rows = pool_rows;
  return launch_decode_d(p, batch, head_dim, static_cast<cudaStream_t>(stream));
}

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in that
// order; the head_dim stride must be 1.  path: 0 simt, 1 decode (split-kv;
// num_splits splits of split_tiles tiles, partials in part_o / part_ml when
// num_splits > 1), 2 prefill (wgmma; prefill_groups consumer warpgroups).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int docqa_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* lengths, const void* q_offset, const void* strides,
    int batch, int sq, int skv, int hq, int hkv, int head_dim, int causal,
    int window, float scale, int is_bf16, int path, int num_splits,
    int split_tiles, int prefill_groups, void* part_o, void* part_ml,
    void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathDecode) {
    if (!is_bf16 || num_splits <= 0 || split_tiles <= 0) return (int)cudaErrorInvalidValue;
    const flash::DecodeParams p = decode_params(
        q, k, v, o, lengths, q_offset, st, sq, skv, hq, hkv, causal, window,
        scale, num_splits, split_tiles, part_o, part_ml);
    return launch_decode_d(p, batch, head_dim, s);
  }
  if (path == kPathPrefill) {
    if (!is_bf16 || (prefill_groups != 1 && prefill_groups != 2))
      return (int)cudaErrorInvalidValue;
    CUtensorMap qm, km, vm;
    cudaError_t err = flash::make_map(&qm, q, head_dim, batch, sq, hq, st[0], st[1], st[2], 64);
    if (err == cudaSuccess)
      err = flash::make_map(&km, k, head_dim, batch, skv, hkv, st[3], st[4], st[5], flash::kPreKV);
    if (err == cudaSuccess)
      err = flash::make_map(&vm, v, head_dim, batch, skv, hkv, st[6], st[7], st[8], flash::kPreKV);
    if (err != cudaSuccess) return (int)err;
    flash::PrefillParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lengths = static_cast<const int*>(lengths);
    p.q_offset = static_cast<const int*>(q_offset);
    p.sq = sq; p.skv = skv; p.hq = hq; p.hkv = hkv;
    p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
    p.causal = causal;
    p.window = window;
    p.scale_log2 = scale * flash::kLog2e;
#define FLASH_PREFILL(D)                                                   \
  return (int)(prefill_groups == 2                                         \
                   ? flash::launch_prefill<D, 2>(qm, km, vm, p, batch, s)  \
                   : flash::launch_prefill<D, 1>(qm, km, vm, p, batch, s))
    switch (head_dim) {
      case 32: FLASH_PREFILL(32);
      case 64: FLASH_PREFILL(64);
      case 128: FLASH_PREFILL(128);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FLASH_PREFILL
  }
  if (path != kPathSimt) return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lengths = static_cast<const int*>(lengths);
  p.q_offset = static_cast<const int*>(q_offset);
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  // 16-row q tiles for decode / verify, 64 otherwise
  const int block_q = sq <= 16 ? 16 : 64;
  cudaError_t err;
  if (block_q == 16) {
    err = is_bf16 ? launch_d<__nv_bfloat16, 16>(p, batch, head_dim, s)
                  : launch_d<float, 16>(p, batch, head_dim, s);
  } else {
    err = is_bf16 ? launch_d<__nv_bfloat16, 64>(p, batch, head_dim, s)
                  : launch_d<float, 64>(p, batch, head_dim, s);
  }
  return (int)err;
}
