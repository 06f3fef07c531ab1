// Split-kv decode / speculative-verify path (bf16, sq <= 16): mma.sync
// tensor cores over a cp.async ring, GQA-packed queries, and a combine
// kernel that merges the splits with log-sum-exp weights.
//
// Grid: one block per (split, kv head, batch).  The block's query tile packs
// the groups * sq rows that share its kv head (packed row p = s * groups + j
// is q row s of q head kvh * groups + j), so each live K/V row is read from
// device memory once per kv head, not once per q head.  MT m-tiles of 16
// packed rows cover them (Mistral verify: 4 heads x 4 rows = one m-tile;
// at D = 128 the 4-m-tile instance, 64 packed rows, spills about 1 KB of
// registers, and no /ask shape launches it).
// The split bounds are a static tiling of [0, skv) into `split_tiles`
// tiles of kDecKV rows: they depend on shapes only, never on lengths, so
// the launch needs no host sync.  A split wholly outside the live range
// writes the empty state (m = -inf, l = 0).
//
// In the block, warp w owns kv rows 16w..16w+15 of every tile and keeps its
// own online-softmax state; the four states merge through shared memory at
// the end.  Scores live in the log2 domain (scale * log2 e folded in).
//
// Paged mode (block_table != nullptr; the continuous batcher's decode and
// verify steps): K/V live in one flat pool [pool_rows, hkv, D] shared by
// every lane, and lane b's kv position p is pool row
// min(table[b, p / block_size] * block_size + p % block_size, pool_rows - 1)
// — the reference's gather_paged_kv, computed per row in the cp.async
// producer, so the gather is never materialised.  Hole entries (ids past
// the pool) clamp and are masked by lengths; skv = NB * block_size, so the
// split plan stays a function of shapes alone.

#pragma once

#include "flash_common.cuh"

namespace flash {

constexpr int kDecThreads = 128;  // four warps
constexpr int kDecKV = 64;        // kv rows per tile: 16 per warp
constexpr int kDecStages = 3;     // cp.async ring depth

struct DecodeParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* lengths;
  const int* q_offset;
  float* part_o;   // [b, hkv, splits, rows, D] unnormalised partial outputs
  float* part_ml;  // [b, hkv, splits, rows, 2] running max (log2) and sum
  int sq, skv, hq, hkv, groups, rows;  // rows = groups * sq
  int num_splits, split_tiles;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal, window;
  float scale_log2;
  // paged mode: [batch, nb] block ids (nullptr = contiguous [b, s, h, d])
  const int* block_table;
  int nb, block_size, pool_rows;
};

// the row of K/V that kv position `kv` of lane `b` reads
__device__ __forceinline__ int64_t decode_kv_row(const DecodeParams& p, int b,
                                                 int kv) {
  if (p.block_table == nullptr) return kv;
  const int64_t blk = p.block_table[(int64_t)b * p.nb + kv / p.block_size];
  const int64_t row = blk * p.block_size + kv % p.block_size;
  return row < 0 ? 0 : (row < p.pool_rows ? row : (int64_t)p.pool_rows - 1);
}

template <int D, int MT>
constexpr size_t decode_smem_bytes() {
  // Q tile and the K/V ring, rows padded by 8 bf16 (16 bytes) so ldmatrix
  // rows fall in distinct banks; the f32 merge area reuses the ring
  constexpr size_t ring = sizeof(__nv_bfloat16) *
                          (MT * 16 * (D + 8) + kDecStages * 2 * kDecKV * (D + 8));
  constexpr size_t merge = sizeof(float) * 4 * MT * 16 * (D + 2);
  return ring > merge ? ring : merge;
}

template <int D, int MT>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const DecodeParams p) {
  constexpr int P = D + 8;  // smem row pitch in elements
  constexpr int R = MT * 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = sQ + R * P;  // stage s: K at 2s, V at 2s+1

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int kv_len = min(p.lengths[b], p.skv);
  const int q_off = p.q_offset[b];
  int live_lo = 0, live_hi = kv_len;
  if (p.causal) {
    live_hi = min(live_hi, q_off + p.sq);  // last q row's q_abs + 1
    if (p.window > 0) live_lo = max(0, q_off - p.window + 1);
  }
  const int split_lo = split * p.split_tiles * kDecKV;
  const int split_hi = min(p.skv, split_lo + p.split_tiles * kDecKV);
  const int lo = max(live_lo, split_lo);
  const int hi = min(live_hi, split_hi);
  const int64_t part = ((int64_t)(b * p.hkv + kvh) * p.num_splits + split) * p.rows;

  if (lo >= hi) {  // nothing live in this split: the empty state
    if (p.num_splits > 1) {
      for (int r = tid; r < p.rows; r += kDecThreads) {
        p.part_ml[(part + r) * 2] = -INFINITY;
        p.part_ml[(part + r) * 2 + 1] = 0.f;
      }
    } else {
      for (int i = tid; i < p.rows * D; i += kDecThreads) {
        const int r = i / D, c = i - r * D;
        const int s = r / p.groups, h = kvh * p.groups + r % p.groups;
        p.o[b * p.o_sb + s * p.o_ss + h * p.o_sh + c] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  constexpr int VPR = D / 8;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  const int tile0 = lo / kDecKV;
  const int n_tiles = (hi - 1) / kDecKV - tile0 + 1;

  // rows >= hi are zero-filled, so padding never feeds a NaN into P V
  auto load_tile = [&](int it) {
    if (it < n_tiles) {
      __nv_bfloat16* sK = ring + (it % kDecStages) * 2 * kDecKV * P;
      __nv_bfloat16* sV = sK + kDecKV * P;
      const int kv0 = (tile0 + it) * kDecKV;
#pragma unroll
      for (int i = tid; i < kDecKV * VPR; i += kDecThreads) {
        const int r = i / VPR, c = (i - r * VPR) * 8;
        const int kv = kv0 + r;
        const bool ok = kv < hi;
        const int64_t row = ok ? decode_kv_row(p, b, kv) : 0;
        cp_async_16(sK + r * P + c, kg + row * p.k_ss + c, ok ? 16 : 0);
        cp_async_16(sV + r * P + c, vg + row * p.v_ss + c, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) load_tile(s);

  // packed Q tile (tiny: plain 16-byte loads), zero past the real rows;
  // packed row r is q row r / groups of q head kvh * groups + r % groups
  for (int i = tid; i < R * VPR; i += kDecThreads) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.rows) {
      const int s = r / p.groups, h = kvh * p.groups + r % p.groups;
      val = *reinterpret_cast<const uint4*>(p.q + b * p.q_sb + s * p.q_ss +
                                            h * p.q_sh + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * P + c) = val;
  }

  float m[MT][2], l[MT][2];
  float acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      m[mt][h2] = -INFINITY;
      l[mt][h2] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }

  // q_abs of this thread's rows (g and g + 8 of each m-tile)
  int q_abs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      q_abs[mt][h2] = q_off + (mt * 16 + g + 8 * h2) / p.groups;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile `it` landed for all; tile it-1's reads are done
    load_tile(it + kDecStages - 1);

    const __nv_bfloat16* sK = ring + (it % kDecStages) * 2 * kDecKV * P;
    const __nv_bfloat16* sV = sK + kDecKV * P;
    const __nv_bfloat16* wK = sK + warp * 16 * P;
    const __nv_bfloat16* wV = sV + warp * 16 * P;

    // S = Q K^T over this warp's 16 kv rows: [MT*16 x 16]
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];  // b0, b1 of kv rows 0-7, then of kv rows 8-15
      const int mi = lane >> 3;
      ldmatrix_x4(kb, wK + ((mi >> 1) * 8 + (lane & 7)) * P + kk * 16 + (mi & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldmatrix_x4(qa, sQ + (mt * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
        mma_16816(s[mt][0], qa, kb[0], kb[1]);
        mma_16816(s[mt][1], qa, kb[2], kb[3]);
      }
    }

    // mask, online softmax (log2 domain), P to bf16 fragments
    const int kv_base = (tile0 + it) * kDecKV + warp * 16 + 2 * t;
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kv = kv_base + nb * 8 + e;
            const int qa = q_abs[mt][h2];
            bool ok = kv >= lo && kv < hi;
            if (p.causal) {
              ok = ok && kv <= qa;
              if (p.window > 0) ok = ok && kv > qa - p.window;
            }
            float x = s[mt][nb][2 * h2 + e] * p.scale_log2;
            x = ok ? x : -INFINITY;
            s[mt][nb][2 * h2 + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h2], mx);
        // a row with nothing live yet keeps exponent base 0: exp2(-inf) = 0
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[mt][h2] - base);
        float rs = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = exp2f(s[mt][nb][2 * h2 + e] - base);
            s[mt][nb][2 * h2 + e] = pv;
            rs += pv;
          }
        l[mt][h2] = l[mt][h2] * alpha + rs;  // per-thread partial row sum
        m[mt][h2] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[mt][j][2 * h2] *= alpha;
          acc[mt][j][2 * h2 + 1] *= alpha;
        }
      }
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }

    // acc += P V over this warp's 16 kv rows
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];  // b0, b1 of d cols 0-7, then of d cols 8-15
      const int mi = lane >> 3;
      ldmatrix_x4_trans(vb, wV + ((mi & 1) * 8 + (lane & 7)) * P + dp * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
        mma_16816(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the merge area

  // merge the four warps' states: sM/sL [4][R], sO [4][R][D]
  float* sM = reinterpret_cast<float*>(smem_raw);
  float* sL = sM + 4 * R;
  float* sO = sL + 4 * R;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float ls = l[mt][h2];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      const int r = mt * 16 + g + 8 * h2;
      if (t == 0) {
        sM[warp * R + r] = m[mt][h2];
        sL[warp * R + r] = ls;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float* dst = sO + ((size_t)warp * R + r) * D + j * 8 + 2 * t;
        dst[0] = acc[mt][j][2 * h2];
        dst[1] = acc[mt][j][2 * h2 + 1];
      }
    }
  __syncthreads();

  for (int i = tid; i < p.rows * D; i += kDecThreads) {
    const int r = i / D, c = i - r * D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, sM[w * R + r]);
    float ls = 0.f, os = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = sM[w * R + r];
        if (mw == -INFINITY) continue;
        const float wt = exp2f(mw - mm);
        ls += wt * sL[w * R + r];
        os += wt * sO[((size_t)w * R + r) * D + c];
      }
    }
    if (p.num_splits > 1) {
      p.part_o[(part + r) * D + c] = os;
      if (c == 0) {
        p.part_ml[(part + r) * 2] = mm;
        p.part_ml[(part + r) * 2 + 1] = ls;
      }
    } else {
      const int s = r / p.groups, h = kvh * p.groups + r % p.groups;
      p.o[b * p.o_sb + s * p.o_ss + h * p.o_sh + c] =
          __float2bfloat16(ls > 0.f ? os / ls : 0.f);  // nothing live -> 0
    }
  }
}

// out = sum_i 2^(m_i - M) o_i / sum_i 2^(m_i - M) l_i over the splits whose
// m_i is finite; a row with no live kv anywhere outputs 0.
// Grid: one block of D threads per (packed row, kv head, batch); the split
// weights are computed once per row into shared memory, then each thread
// sums its output column over the splits.
template <int D>
__global__ void __launch_bounds__(D)
flash_combine_kernel(const DecodeParams p) {
  constexpr int kWarps = D / 32;
  extern __shared__ float s_w[];  // [num_splits] weights
  __shared__ float s_red[kWarps];
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)(b * p.hkv + kvh) * p.num_splits;
  const float* ml = p.part_ml + (base * p.rows + r) * 2;  // split sp at sp*rows*2

  float mm = -INFINITY;
  for (int sp = tid; sp < p.num_splits; sp += D)
    mm = fmaxf(mm, ml[(int64_t)sp * p.rows * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
  if ((tid & 31) == 0) s_red[tid >> 5] = mm;
  __syncthreads();
  mm = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, s_red[w]);
  __syncthreads();  // s_red is reused below

  float ls = 0.f;
  for (int sp = tid; sp < p.num_splits; sp += D) {
    const float mi = ml[(int64_t)sp * p.rows * 2];
    // an empty split (m = -inf) weighs 0 and its o is never read
    const float wt = mi == -INFINITY ? 0.f : exp2f(mi - mm);
    s_w[sp] = wt;
    ls += wt * ml[(int64_t)sp * p.rows * 2 + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
  if ((tid & 31) == 0) s_red[tid >> 5] = ls;
  __syncthreads();
  ls = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) ls += s_red[w];

  const float* po = p.part_o + (base * p.rows + r) * D + tid;
  float os = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < p.num_splits; ++sp) {
    const float wt = s_w[sp];
    if (wt != 0.f) os += wt * po[(int64_t)sp * p.rows * D];
  }
  const int s = r / p.groups, h = kvh * p.groups + r % p.groups;
  p.o[b * p.o_sb + s * p.o_ss + h * p.o_sh + tid] =
      __float2bfloat16(ls > 0.f ? os / ls : 0.f);
}

template <int D, int MT>
cudaError_t launch_decode(const DecodeParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<D, MT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<D, MT><<<dim3(p.num_splits, p.hkv, batch), kDecThreads,
                               smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.num_splits == 1) return err;
  flash_combine_kernel<D><<<dim3(p.rows, p.hkv, batch), D,
                            p.num_splits * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode_mt(const DecodeParams& p, int batch,
                             cudaStream_t stream) {
  const int mt = (p.rows + 15) / 16;
  if (mt <= 1) return launch_decode<D, 1>(p, batch, stream);
  if (mt <= 2) return launch_decode<D, 2>(p, batch, stream);
  if (mt <= 4) return launch_decode<D, 4>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
