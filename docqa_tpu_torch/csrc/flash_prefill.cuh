// Prefill / encoder path (bf16, sq > 16): wgmma tensor cores fed by TMA.
//
// Block: NWG consumer warpgroups, each owning 64 q rows, then the producer
// (one warp; with two consumer groups a whole warpgroup, which hands its
// registers to the consumers by setmaxnreg: 232 each, 40 for itself).
// The producer's lane 0 loads the q tile once and keeps K/V tiles of
// kPreKV rows in flight through a ring of stages in shared memory; each
// stage has a "full" mbarrier (TMA transaction bytes) and an "empty" one
// (one arrival per consumer warp once its wgmmas have read the stage).
// Consumers issue S = Q K^T as wgmma m64n128k16 with both operands K-major
// in shared memory, apply the mask only on edge tiles, run the online
// softmax in registers (log2 domain), round P to bf16 and issue O += P V
// as wgmma m64nDk16 with P from registers and V from shared memory as an
// MN-major (transposed) operand.  Within a warpgroup the two products are
// software-pipelined: S_j and P_{j-1} V_{j-1} are issued together, and the
// softmax of S_j runs while the tensor cores still accumulate P_{j-1} V_{j-1};
// O is rescaled once that product has landed.
//
// Tensor maps are 4-D over [b, s, h, d] through the caller's strides
// (dims innermost first: d, h, s, b), so the decoder's KV cache is read in
// place.  A box is one head's kPreKV (or 64 q) rows by PW = min(D, 64)
// columns: 128-byte rows with the 128B swizzle for D = 64 and 128 (two
// panels at D = 128), 64-byte rows with the 64B swizzle for D = 32.  Rows
// past the tensor's end arrive as zeros.

#pragma once

#include "flash_common.cuh"

namespace flash {

// kv rows per tile: S tiles of 64 x 128 keep the shared-memory reads of an
// SS wgmma below the tensor rate and pay the per-tile costs (O rescale,
// barriers, row shuffles) once per 128 columns
constexpr int kPreKV = 128;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

struct PrefillParams {
  __nv_bfloat16* o;
  const int* lengths;
  const int* q_offset;
  int sq, skv, hq, hkv;
  int64_t o_sb, o_ss, o_sh;
  int causal, window;
  float scale_log2;
};

template <int D, int NWG>
struct PrefillLayout {
  // one producer warp beside one consumer group; beside two, a producer
  // warpgroup, so that setmaxnreg can move its registers to the consumers
  static constexpr int THREADS = NWG == 2 ? 3 * 128 : 128 + 32;
  static constexpr int PW = D < 64 ? D : 64;  // panel width (elements)
  static constexpr int NP = D / PW;            // panels per row
  static constexpr int QPANEL = 64 * PW;       // elements of a 64-row q panel
  static constexpr int KVPANEL = kPreKV * PW;  // elements of a K or V panel
  static constexpr int MODE = PW == 64 ? 1 : 2;  // wgmma swizzle: 128B / 64B
  static constexpr uint32_t ROW8 = 8 * PW * 2;   // bytes of 8 panel rows
  static constexpr size_t Q_BYTES = (size_t)NWG * NP * QPANEL * 2;
  static constexpr size_t STAGE_BYTES = (size_t)2 * NP * KVPANEL * 2;  // K + V
  static constexpr size_t FIXED = 1024 /* alignment slack */ + Q_BYTES;
  static constexpr int STAGES = FIXED + 3 * STAGE_BYTES + 8 * 7 <= kMaxSmem ? 3 : 2;
  static constexpr size_t BYTES = FIXED + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

template <int D, int NWG>
__global__ void __launch_bounds__(PrefillLayout<D, NWG>::THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const PrefillParams p) {
  using L = PrefillLayout<D, NWG>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle patterns are functions of the address: panels sit on 1 KB
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(base + L::Q_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + L::Q_BYTES + L::STAGES * L::STAGE_BYTES);
  uint64_t* empty = full + L::STAGES;
  uint64_t* q_bar = empty + L::STAGES;
  // stage s: K panels at (2s) * NP, V panels at (2s + 1) * NP
  auto panel = [&](int stage, int is_v, int pn) {
    return sKV + ((2 * stage + is_v) * L::NP + pn) * L::KVPANEL;
  };

  // the largest causal q tiles first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q0 = qt * 64 * NWG;
  const int q_rows = min(64 * NWG, p.sq - q0);
  const int kv_len = min(p.lengths[b], p.skv);
  const int q_off = p.q_offset[b];
  int kv_lo = 0, kv_hi = kv_len;  // live kv rows of the block's q rows
  if (p.causal) {
    kv_hi = min(kv_hi, q_off + q0 + q_rows);
    if (p.window > 0) kv_lo = max(0, q_off + q0 - p.window + 1);
  }
  const int t_begin = kv_lo / kPreKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - 1) / kPreKV - t_begin + 1 : 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    if (warp == NWG * 4 && lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_bar, (uint32_t)L::Q_BYTES);
      for (int wg = 0; wg < NWG; ++wg)
        for (int pn = 0; pn < L::NP; ++pn)
          tma_load_4d(sQ + (wg * L::NP + pn) * L::QPANEL, &q_map, q_bar,
                      pn * L::PW, h, q0 + 64 * wg, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::STAGES;
        if (it >= L::STAGES) mbar_wait(&empty[st], (it / L::STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[st], (uint32_t)L::STAGE_BYTES);
        const int kv0 = (t_begin + it) * kPreKV;
        for (int pn = 0; pn < L::NP; ++pn) {
          tma_load_4d(panel(st, 0, pn), &k_map, &full[st], pn * L::PW, kvh, kv0, b);
          tma_load_4d(panel(st, 1, pn), &v_map, &full[st], pn * L::PW, kvh, kv0, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int wiw = warp & 3;  // warp in its group: rows 16 * wiw ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int wg_rows = min(64, p.sq - r0);  // may be <= 0 on the last tile
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    int w_lo = 0, w_hi = wg_rows > 0 ? kv_len : 0;  // this group's live kv
    if (p.causal && wg_rows > 0) {
      w_hi = min(w_hi, q_off + r0 + wg_rows);
      if (p.window > 0) w_lo = max(0, q_off + r0 - p.window + 1);
    }
    const int qa_min = q_off + r0;
    const int qa_max = q_off + r0 + wg_rows - 1;
    int q_abs[2];
    q_abs[0] = q_off + r0 + 16 * wiw + g;
    q_abs[1] = q_abs[0] + 8;

    float s_acc[kPreKV / 2];
#pragma unroll
    for (int i = 0; i < kPreKV / 2; ++i) s_acc[i] = 0.f;
    uint32_t pa[kPreKV / 16][4];
    mbar_wait(q_bar, 0);

    // this group's live tiles form [ta, te) of the block's n_tiles
    const int ta = min(n_tiles, max(0, w_lo / kPreKV - t_begin));
    const int te = w_hi > w_lo ? max(ta, min(n_tiles, (w_hi - 1) / kPreKV + 1 - t_begin)) : ta;
    auto stage_of = [&](int it) { return it % L::STAGES; };
    auto wait_full = [&](int it) { mbar_wait(&full[stage_of(it)], (it / L::STAGES) & 1); };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage_of(it)]);
    };
    auto issue_s = [&](int it) {  // S = Q K^T; inside a panel a k-step is +32 bytes
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk * 16 / L::PW, off = kk * 16 % L::PW;
        const uint64_t da = wgmma_desc(sQ + (wg * L::NP + pn) * L::QPANEL + off,
                                       16, L::ROW8, L::MODE);
        const uint64_t db = wgmma_desc(panel(stage_of(it), 0, pn) + off, 16,
                                       L::ROW8, L::MODE);
        wgmma_64x128_ss(s_acc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int it) {  // O += P V, V MN-major: 16 kv rows a k-step
#pragma unroll
      for (int kk = 0; kk < kPreKV / 16; ++kk) {
        const uint64_t db = wgmma_desc(panel(stage_of(it), 1, 0) + kk * 16 * L::PW,
                                       L::KVPANEL * 2, L::ROW8, L::MODE);
        wgmma_rs(o_acc, pa[kk], db);
      }
      wgmma_commit();
    };
    // mask (edge tiles only), running max, exponentials in place, row
    // sums; returns the rescale factors of O for the two rows.  The max is
    // taken over raw scores; scale and max meet in one FFMA before ex2.
    // Max and sum run as four independent partials per row, both rows
    // interleaved: a 32-long dependent chain would leave the warp waiting
    // on latency, with only two warps per scheduler to cover it.
    auto softmax = [&](int it, float (&alpha)[2]) {
      constexpr int NC = kPreKV / 8;  // accumulator columns per row: 2 NC
      const int kv0 = (t_begin + it) * kPreKV;
      const bool edge =
          !(kv0 + kPreKV <= kv_len &&
            (!p.causal || (kv0 + kPreKV - 1 <= qa_min &&
                           (p.window <= 0 || kv0 > qa_max - p.window))));
      if (edge) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kv = kv0 + 8 * j + 2 * t + (e & 1);
            const int qa = q_abs[e >> 1];
            bool ok = kv < kv_len;
            if (p.causal) {
              ok = ok && kv <= qa;
              if (p.window > 0) ok = ok && kv > qa - p.window;
            }
            if (!ok) s_acc[4 * j + e] = -INFINITY;
          }
      }
      float mx[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mx[e >> 1][(e & 1)] = s_acc[e];
        mx[e >> 1][2 + (e & 1)] = s_acc[4 + e];
      }
#pragma unroll
      for (int j = 2; j < NC; j += 2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[e >> 1][(e & 1)] = fmaxf(mx[e >> 1][(e & 1)], s_acc[4 * j + e]);
          mx[e >> 1][2 + (e & 1)] = fmaxf(mx[e >> 1][2 + (e & 1)], s_acc[4 * j + 4 + e]);
        }
      float base_e[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float r = fmaxf(fmaxf(mx[h2][0], mx[h2][1]), fmaxf(mx[h2][2], mx[h2][3]));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        // m is kept in the log2 domain (raw max * scale * log2 e)
        const float m_new = fmaxf(m[h2], r * p.scale_log2);
        // a row with nothing live yet keeps exponent base 0: 2^-inf = 0
        base_e[h2] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h2] = fast_exp2(m[h2] - base_e[h2]);
        m[h2] = m_new;
      }
      float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s_acc[4 * j + e];
          x = fast_exp2(fmaf(x, p.scale_log2, -base_e[e >> 1]));
          rs[e >> 1][(e & 1) + 2 * (j & 1)] += x;
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        l[h2] = l[h2] * alpha[h2] + ((rs[h2][0] + rs[h2][1]) + (rs[h2][2] + rs[h2][3]));
    };
    auto pack_p = [&]() {  // P's accumulator layout is the A-fragment layout
#pragma unroll
      for (int kk = 0; kk < kPreKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
    };

    for (int it = 0; it < ta; ++it) {  // dead for this group: pass them on
      wait_full(it);
      release(it);
    }
    if (ta < te) {
      float alpha[2];
      wait_full(ta);
      wgmma_fence();
      issue_s(ta);
      wgmma_wait<0>();
      reg_fence(s_acc);
      softmax(ta, alpha);  // O is still 0: nothing to rescale
      pack_p();
      for (int it = ta + 1; it < te; ++it) {
        wait_full(it);
        wgmma_fence();
        issue_s(it);
        issue_pv(it - 1);
        wgmma_wait<1>();  // S_it has landed; P V of it-1 may still run
        reg_fence(s_acc);
        softmax(it, alpha);
        wgmma_wait<0>();
        reg_fence(o_acc);
        reg_fence(pa);
        release(it - 1);
        // once the row maxima settle, alpha is 1 and the rescale is skipped
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o_acc[4 * j + e] *= alpha[e >> 1];
        }
        pack_p();
      }
      wgmma_fence();
      issue_pv(te - 1);
      wgmma_wait<0>();
      reg_fence(o_acc);
      reg_fence(pa);
      release(te - 1);
    }
    for (int it = te; it < n_tiles; ++it) {
      wait_full(it);
      release(it);
    }
  }

  // normalise (a row with nothing live has l = 0 and outputs 0) and store
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float ls = l[h2];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const float inv = ls > 0.f ? 1.f / ls : 0.f;
    const int row = 16 * wiw + g + 8 * h2;
    if (row < wg_rows) {
      __nv_bfloat16* orow = og + (int64_t)(r0 + row) * p.o_ss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o_acc[4 * j + 2 * h2] * inv, o_acc[4 * j + 2 * h2 + 1] * inv);
    }
  }
}

// ---- host side --------------------------------------------------------------

// 4-D map over a [batch, seq, heads, D] bf16 tensor with element strides
// (sb, ss, sh) and unit stride on D; one box = one head's `rows` rows.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int batch,
                            int seq, int heads, int64_t sb, int64_t ss,
                            int64_t sh, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int pw = D < 64 ? D : 64;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int NWG>
cudaError_t launch_prefill(const CUtensorMap& qm, const CUtensorMap& km,
                           const CUtensorMap& vm, const PrefillParams& p,
                           int batch, cudaStream_t stream) {
  constexpr size_t smem = PrefillLayout<D, NWG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + 64 * NWG - 1) / (64 * NWG), p.hq, batch);
  flash_prefill_kernel<D, NWG><<<grid, PrefillLayout<D, NWG>::THREADS, smem, stream>>>(
      qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace flash
