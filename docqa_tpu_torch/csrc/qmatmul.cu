// K4: the weight-only quantised matmul for Hopper (sm_90a), with a plain C
// interface that docqa_tpu_torch/ops/qmatmul.py binds through ctypes.
//
// Replaces no Pallas kernel: the reference's dequantising product
// (docqa_tpu/models/decoder.py::_qmatmul) is XLA, which fuses the
// convert-and-scale into the dot's operand read so the dequantised tree
// never reaches HBM (docqa_tpu/models/quant.py).  A plain dequantise then
// torch.matmul would write the whole bf16 tree back out on every forward;
// this kernel dequantises on the way from shared memory to the tensor cores.
//
//   y[m, N] = x[m, K] . W~[K, N],  x bf16, sums float32, y bf16
//   int8:  W~[k, n] = bf16(bf16(q[k, n]) * bf16(scale[n]))
//   int4:  W~[k, n] = bf16(bf16(q[k, n]) * bf16(scale[k / gs, n]))
//
// W~ is rounded exactly as the reference's `w.astype(dtype) * scale.astype
// (dtype)`: bf16(q) is exact, and one mul.rn.bf16x2 rounds the product once.
// Layouts (ops/qmatmul.py documents them for the host side): int8 q is
// [K, N] row-major; int4 q is packed two values a byte along K, byte
// [k / 2, n] holding row k (k even) in its low nibble and row k + 1 in its
// high one, as two's-complement 4-bit values.  gs is even (the wrapper pads
// an odd group with a zero row of q and a zero column of x).
//
// Three modes, chosen by ops/qmatmul.py::plan_qmatmul from static shapes:
//
// ring (m <= 64: decode and the batcher's verify).  Bound by bytes: ~2m
//   operations a weight byte, far under the ~295 at which the tensor cores
//   become the limit (Mistral-7B's w_gate in int8: 58.7 MB, 17.5 us at
//   3.35 TB/s).  A block owns 128 output columns and one K split: one
//   producer warp keeps a ring of 4 stages in flight, each stage the raw,
//   still-quantised 8 KB weight tile (TMA, 128B swizzle, completing on the
//   stage's mbarrier as transaction bytes), the x rows (cp.async, zero past
//   m and K) and the scale row (cp.async); 2-4 blocks an SM keep 64-128 KB
//   in flight, well past what HBM's latency needs (~25 KB an SM).  Four
//   consumer warps of 32 columns each build mma.sync B fragments in
//   registers straight from the raw bytes: a thread reads one 32-bit word
//   (4 columns) of a k row and owns fragment column g of 4 n8 tiles, so no
//   bf16 weight tile exists.  int8 pairs rows (k, k+1) by a byte permute
//   and takes x fragments by ldmatrix from padded rows; an int4 byte
//   already holds the pair, and the int4 mode permutes k inside each
//   16-step so that one 64-bit load holds an x fragment's two k pairs.
//   Measured on the card: the time grows with the weight bytes at
//   ~2.2 TB/s over a fixed ~10 us that cuBLAS pays too, so int4 is ~1.4x
//   int8 on the large projections.
//
// wgmma (m > 64: prefill).  Bound by operations (2 m K N / 989 TFLOP/s).
//   A and B swapped: y^T = W~^T x^T, so the output columns fill wgmma's
//   64-row M and the x rows its N (256, or 128 where 256 would leave SMs
//   idle).  Persistent: one block an SM walks (row block, column block,
//   split) units of 128 columns by N rows.  A producer warp keeps 3-4
//   stages of raw weight tile + x tile (both TMA, 128B swizzle) + scale row
//   (a bulk copy) in flight across unit boundaries, so one unit's epilogue
//   overlaps the next one's loads.  Two consumer warpgroups (64 columns
//   each) dequantise their A fragments from the raw tile straight into
//   registers (as the ring does for mma.sync) and issue register-A
//   m64nNk16 wgmmas against the x tile; the next stage is dequantised
//   while these run.  No bf16 weight tile exists: each dequantised weight
//   serves N rows, and nothing but the stage barriers orders the two
//   warpgroups.  The output goes out through a padded tile in shared
//   memory, a row at a time.  (A first version dequantised each stage into
//   a swizzled bf16 tile that both warpgroups read as wgmma's B: that
//   stage, its proxy fence and its barriers cost as much as the MMAs.)
//
// simple (any shape the TMA rules refuse: rows not 16-byte aligned, odd
//   N, int4 groups that split a stage).  The first K4: 16-byte loads into
//   registers one tile ahead, a dequantised bf16 tile in shared memory,
//   ldmatrix and mma.sync; every edge masked.
//
// Dequantisation needs no conversion instruction (those run at a quarter
// of the integer rate and bounded the first K4): int8 bytes are permuted
// into the mantissa of the float 2^23 + (q + 128), one subtraction leaves q
// exactly and its upper half is bf16(q); an int4 nibble goes into the
// mantissa of the bf16 128 + (q + 8) and one bf16x2 fma takes 136 off.
//
// Split K, in every mode: when the column blocks cannot fill the card
// (wk / wv have 8 for 132 SMs) the K axis is split; each split writes its
// float32 partials, and the last block of a tile to finish (an integer
// counter) sums them in split order and writes bf16, keeping several
// partial loads in flight a thread (that sum is the tail of the launch).
// One launch a product, no float atomics: a product repeats bit for bit
// run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBN = 128;  // output columns a block (a TMA box of weight bytes)
constexpr int kStages = 4;

struct QParams {
  const __nv_bfloat16* x;  // [m, K], row stride ldx elements
  const uint8_t* w;        // int8 [K, N]; int4 packed [K / 2, N]
  const float* scale;      // int8 [N]; int4 [K / gs, N]
  __nv_bfloat16* out;      // [m, N]
  float* part;             // [splits, m, N] float32 partials (splits > 1)
  int* counters;           // a zeroed int a tile (splits > 1), left zeroed
  long long ldx;
  int m, K, N, gs, splits, tiles, tiles_per_split, mb, nb;
};

// ---- dequantisation -----------------------------------------------------------

// Four biased bytes (q + bias each, as unsigned) -> the bf16 values of q,
// as two bf16x2 words (bytes 0-1, then 2-3).  Each byte becomes the float
// 2^23 + byte (a byte permute into 0x4B000000), one subtraction leaves q
// exactly, and q (|q| <= 127) keeps every bit in the upper half of the
// float, which is its bf16.
template <int BIAS>
__device__ __forceinline__ void biased_to_bf16(uint32_t u, uint32_t& lo, uint32_t& hi) {
  constexpr float kMagic = 8388608.f + BIAS;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)) - kMagic;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// bf16x2 product rounded once to nearest even: bf16(q) * bf16(scale) as the
// reference's dtype(q) * dtype(scale)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two nibbles, placed by the caller in bits 0-3 and 16-19 of v (any bits
// elsewhere), as the bf16x2 of their two's-complement values: the mantissa
// of 128 + (q + 8) (0x4300 | (nibble ^ 8)), then an exact fma takes 136 off.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t b = (v & 0x000F000Fu) ^ 0x43084308u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1.0 - 136.0
  return d;
}

// the bf16 scales s, s of one column, as the pair a fragment register needs
__device__ __forceinline__ uint32_t dup_bf16(float s) { return pack_bf16(s, s); }

// ---- split K: the last block of a tile sums the partials ---------------------

// Called by the N threads that wrote the tile's partials, after writing
// them: the last of the tile's `splits` blocks to arrive (an integer
// counter) sums rows [r0, r0 + rows) x columns [c0, c0 + cols) in split
// order, writes bf16 and re-zeroes the counter for the next product.  A
// thread keeps E items of W columns by Z splits of loads in flight: the
// ring's 16- and 32-row tiles give a thread few items and many splits
// (E = 2, Z = 4), its 64-row tiles and the wgmma mode's many items and few
// splits (E = 8 and 4, Z = 1), the simple mode's single floats many of
// both (E = 4, Z = 8).  W = 4 reads float4 quads (cols a multiple of 16,
// the TMA modes); W = 1 reads single floats, for the simple mode's ragged
// N.  One form a kernel: two inlined forms made the smaller kernels
// spill.
template <int N, int E, int Z, int W = 4>
__device__ __forceinline__ void reduce_splits(const QParams& p, int tile, int r0,
                                              int rows, int c0, int cols, int tid) {
  static_assert(W == 1 || W == 4, "a quad or a single float an item");
  __shared__ int last;
  __threadfence();  // this thread's partials, before the counter moves
  named_bar_sync(1, N);
  if (tid == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  named_bar_sync(1, N);
  if (!last) return;
  __threadfence();
  const int per_row = cols / W;
  const int n_items = rows * per_row;
  const size_t plane = (size_t)p.m * p.N;
  for (int i0 = tid; i0 < n_items; i0 += N * E) {
    size_t off[E];
    float s[E][W];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = min(i0 + e * N, n_items - 1);  // past the tile: a repeat, unwritten
      off[e] = (size_t)(r0 + i / per_row) * p.N + c0 + W * (i % per_row);
#pragma unroll
      for (int j = 0; j < W; ++j) s[e][j] = 0.f;
    }
    for (int z0 = 0; z0 < p.splits; z0 += Z) {
      float v[E][Z][W];
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < Z; ++u)
          if (z0 + u < p.splits) {
            const float* src = p.part + (z0 + u) * plane + off[e];
            if constexpr (W == 4) {
              const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
              v[e][u][0] = q.x;
              v[e][u][1] = q.y;
              v[e][u][2] = q.z;
              v[e][u][3] = q.w;
            } else {
              v[e][u][0] = __ldcg(src);
            }
          }
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < Z; ++u)
          if (z0 + u < p.splits)
#pragma unroll
            for (int j = 0; j < W; ++j) s[e][j] += v[e][u][j];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (i0 + e * N >= n_items) continue;
      if constexpr (W == 4)
        *reinterpret_cast<uint2*>(p.out + off[e]) =
            make_uint2(pack_bf16(s[e][0], s[e][1]), pack_bf16(s[e][2], s[e][3]));
      else
        p.out[off[e]] = __float2bfloat16_rn(s[e][0]);
    }
  }
  if (tid == 0) p.counters[tile] = 0;
}

// ---- ring: m <= 64 -------------------------------------------------------------

template <int MT, bool INT4>
struct Ring {
  static constexpr int THREADS = 160;              // 4 consumer warps + the producer
  static constexpr int BM = 16 * MT;               // x rows (m padded to 16, 32, 64)
  static constexpr int BK = INT4 ? 128 : 64;       // contraction rows a stage
  static constexpr int RAW = 64 * kBN;             // weight bytes a stage (64 byte rows)
  static constexpr int XS = BK * 2 + (INT4 ? 32 : 16);  // padded x row, bytes
  static constexpr int XB = BM * XS;
  static constexpr int XCH = BK / 8;               // 16-byte chunks of a row a stage
  static constexpr int SC = kBN * 4;
  static constexpr size_t BYTES = 1024 + kStages * (RAW + XB + SC) + 16 * kStages;
  // blocks an SM: as many as its 228 KB of shared memory holds (1 KB of it
  // reserved a block), at most 4 (five would cap a thread at 80 registers)
  static constexpr int RESIDENT = 233472 / (BYTES + 1024) < 4 ? 233472 / (BYTES + 1024) : 4;
};

template <int MT, bool INT4>
__global__ void __launch_bounds__(160, Ring<MT, INT4>::RESIDENT)
    qmatmul_ring_kernel(const __grid_constant__ CUtensorMap wmap, const QParams p) {
  using L = Ring<MT, INT4>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the 128B swizzle is a function of the address: raw tiles sit on 1 KB
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* raw0 = base;
  unsigned char* xs0 = base + kStages * L::RAW;
  float* sc0 = reinterpret_cast<float*>(xs0 + kStages * L::XB);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc0 + kStages * kBN);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int t_begin = blockIdx.y * p.tiles_per_split;
  const int n_tiles = max(0, min(p.tiles, t_begin + p.tiles_per_split) - t_begin);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx + the producer's 32 lanes
      mbar_init(&empty[s], 4);      // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: lane 0 the weight tile, every lane x and scales ----
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
      const int tile = t_begin + it;
      unsigned char* raw = raw0 + st * L::RAW;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], L::RAW);
        if (INT4) {  // two 32-row boxes (the map's box serves the wgmma mode too)
          tma_load_2d(raw, &wmap, &full[st], n0, tile * 64);
          tma_load_2d(raw + L::RAW / 2, &wmap, &full[st], n0, tile * 64 + 32);
        } else {
          tma_load_2d(raw, &wmap, &full[st], n0, tile * 64);
        }
      }
      const int k0 = tile * L::BK;
      unsigned char* xd = xs0 + st * L::XB;
      for (int i = lane; i < L::BM * L::XCH; i += 32) {
        const int r = i / L::XCH, c = i - r * L::XCH;
        const int k = k0 + 8 * c;
        const bool ok = r < p.m && k < p.K;  // K % 8 == 0: whole chunks
        cp_async_16(xd + r * L::XS + 16 * c, p.x + (ok ? r * p.ldx + k : 0), ok ? 16 : 0);
      }
      {
        const int col = n0 + 4 * lane;
        const bool ok = col < p.N;  // N % 16 == 0
        const size_t row = INT4 ? (size_t)(k0 / p.gs) * p.N : 0;
        cp_async_16(sc0 + st * kBN + 4 * lane, p.scale + (ok ? row + col : 0), ok ? 16 : 0);
      }
      cp_async_mbar_arrive(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warp w owns columns [32 w, 32 w + 32) of the block ----
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp * 32 + 4 * g;          // this thread's 4 columns; n8 tile j
  const int chunk = cw >> 4, inner = cw & 15;  // holds column cw + j at fragment column g
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* raw = raw0 + st * L::RAW;
    const unsigned char* xr = xs0 + st * L::XB;
    const float4 s4 = *reinterpret_cast<const float4*>(sc0 + st * kBN + cw);
    const uint32_t sc2[4] = {dup_bf16(s4.x), dup_bf16(s4.y), dup_bf16(s4.z),
                             dup_bf16(s4.w)};
    // the 32-bit word of 4 columns at byte row r (128B swizzle: chunk c of
    // row r lives at chunk c ^ (r & 7))
    auto wword = [&](int r) {
      return *reinterpret_cast<const uint32_t*>(raw + r * kBN +
                                                ((chunk ^ (r & 7)) << 4) + inner);
    };
#pragma unroll
    for (int ks = 0; ks < L::BK / 16; ++ks) {
      uint32_t b[4][2];
      uint32_t a[MT][4];
      if constexpr (!INT4) {
        // b0 = k rows (2t, 2t + 1), b1 = (2t + 8, 2t + 9); the 4 rows a
        // quarter-warp reads sit in 8 distinct swizzled chunks
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ks * 16 + 2 * t + 8 * h;
          const uint32_t u0 = wword(r) ^ 0x80808080u, u1 = wword(r + 1) ^ 0x80808080u;
          uint32_t q0, q1, q2, q3;
          biased_to_bf16<128>(__byte_perm(u0, u1, 0x5140), q0, q1);  // columns 0, 1
          biased_to_bf16<128>(__byte_perm(u0, u1, 0x7362), q2, q3);  // columns 2, 3
          b[0][h] = bf16x2_mul(q0, sc2[0]);
          b[1][h] = bf16x2_mul(q1, sc2[1]);
          b[2][h] = bf16x2_mul(q2, sc2[2]);
          b[3][h] = bf16x2_mul(q3, sc2[3]);
        }
        // x in the natural k order: one ldmatrix a 16 x 16 fragment (lane l
        // gives row l % 8 of matrix l / 8; the padded rows, 9 chunks apart,
        // meet no bank twice)
        const int mi = lane >> 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], xr + (mt * 16 + (mi & 1) * 8 + (lane & 7)) * L::XS +
                                 2 * (ks * 16 + (mi >> 1) * 8));
      } else {
        // k permuted inside a 16-step: fragment k pair (2t, 2t + 1) is
        // physical k (4t, 4t + 1) = byte row 2t, pair (2t + 8, 2t + 9) is
        // (4t + 2, 4t + 3) = byte row 2t + 1; x follows, so one 64-bit load
        // holds a row's two pairs
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = wword(ks * 8 + 2 * t + h), y = w >> 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // byte j's low nibble into bits 0-3, its high one into 16-19
            const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
            b[j][h] = bf16x2_mul(nibbles_to_bf16x2(__byte_perm(w, y, sel)), sc2[j]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* row = xr + (mt * 16 + g) * L::XS + 2 * (ks * 16 + 4 * t);
          const uint2 v0 = *reinterpret_cast<const uint2*>(row);
          const uint2 v1 = *reinterpret_cast<const uint2*>(row + 8 * L::XS);
          a[mt][0] = v0.x;
          a[mt][1] = v1.x;
          a[mt][2] = v0.y;
          a[mt][3] = v1.y;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[mt][j], a[mt], b[j][0], b[j][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // fragment column 2t (2t + 1) of n8 tile j is column 8t + j (8t + 4 + j) of
  // the warp: a thread holds 8 consecutive columns of rows g and g + 8
  const int col = n0 + warp * 32 + 8 * t;
  const bool split = p.splits > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      if (row >= p.m || col >= p.N) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h];
        v[4 + j] = acc[mt][j][2 * h + 1];
      }
      if (split) {
        float* dst = p.part + ((size_t)blockIdx.y * p.m + row) * p.N + col;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(p.out + (size_t)row * p.N + col) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
    }
  if (split)
    reduce_splits<128, MT == 4 ? 8 : 2, MT == 4 ? 1 : 4>(p, blockIdx.x, 0, min(L::BM, p.m), n0,
                                                         min(kBN, p.N - n0), tid);
}

// ---- wgmma: m > 64 ---------------------------------------------------------------

// A unit: 128 output columns (two consumer warpgroups of 64) by NX rows of
// x (wgmma's N: 128 or 256), K in 64-row stages.
template <bool INT4, int NX>
struct Wg {
  static constexpr int THREADS = 384;  // two consumer warpgroups + the producer's
  static constexpr int BK = 64;
  static constexpr int RB = INT4 ? 32 : 64;  // weight byte rows a stage
  static constexpr int RAW = RB * kBN;       // one TMA box
  static constexpr int XT = NX * BK * 2;     // x tile: NX rows of 128 B
  static constexpr int SC = kBN * 4;
  static constexpr int ES = kBN * 2 + 16;    // a padded row of the output tile
  static constexpr int EPI = NX * ES;        // the unit's bf16 output, staged
  static constexpr int STAGES =
      1024 + 4 * (RAW + XT + SC) + EPI + 64 <= 232448 ? 4 : 3;
  static constexpr size_t BYTES = 1024 + STAGES * (RAW + XT + SC) + EPI + 16 * STAGES;
};

// a unit is (row block, column block, split), row block fastest, so the
// units in flight together share their weight tiles through L2
struct Walk {
  int unit, kt, kend, mi, ni;
};

__device__ __forceinline__ bool walk_to(Walk& w, int unit, const QParams& p, int units) {
  w.unit = unit;
  if (unit >= units) return false;
  const int split = unit / (p.mb * p.nb);
  w.mi = unit % p.mb;
  w.ni = (unit / p.mb) % p.nb;
  w.kt = split * p.tiles_per_split;
  w.kend = min(p.tiles, w.kt + p.tiles_per_split);
  return true;
}

__device__ __forceinline__ bool walk_next(Walk& w, const QParams& p, int units) {
  if (++w.kt < w.kend) return true;
  return walk_to(w, w.unit + gridDim.x, p, units);
}

template <bool INT4, int NX>
__global__ void __launch_bounds__(384, 1)
    qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap, const QParams p) {
  using L = Wg<INT4, NX>;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs0 = base;
  unsigned char* raw0 = xs0 + S * L::XT;
  float* sc0 = reinterpret_cast<float*>(raw0 + S * L::RAW);
  unsigned char* epi = reinterpret_cast<unsigned char*>(sc0 + S * kBN);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + L::EPI);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = p.mb * p.nb * p.splits;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<40>();
    if (tid == 256) {
      Walk w;
      bool more = walk_to(w, blockIdx.x, p, units);
      for (int f = 0; more; ++f) {
        const int st = f % S;
        if (f >= S) mbar_wait(&empty[st], (f / S - 1) & 1);
        const int n0 = w.ni * kBN;
        const uint32_t sc_bytes = 4 * min(kBN, p.N - n0);  // a multiple of 64
        mbar_arrive_expect_tx(&full[st], L::RAW + L::XT + sc_bytes);
        tma_load_2d(raw0 + st * L::RAW, &wmap, &full[st], n0, w.kt * L::RB);
        tma_load_2d(xs0 + st * L::XT, &xmap, &full[st], w.kt * L::BK, w.mi * NX);
        const size_t srow = INT4 ? (size_t)(w.kt * L::BK / p.gs) * p.N : 0;
        bulk_load(sc0 + st * kBN, p.scale + srow + n0, sc_bytes, &full[st]);
        more = walk_next(w, p, units);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output columns [64 wg, 64 wg + 64) of
  // a unit, its warp wi the 16 from 16 (4 wg + wi).  The weights are
  // wgmma's A, dequantised from the raw tile straight into fragment
  // registers; x is its B, K-major in shared memory.  Fragment row r of a
  // warp is column 2r (r < 8) or 2 (r - 8) + 1 of its 16: a thread's two
  // rows, g and g + 8, are the adjacent columns 2g, 2g + 1, one 16-bit load
  // of a raw row. ----
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int col = 64 * wg + 16 * wi + 2 * g;  // this thread's columns col, col + 1
  const int chunk = col >> 4, inner = col & 15;

  // the 16 fragment registers of a stage's four k steps
  auto dequant = [&](int st, uint32_t (&a)[4][4]) {
    const unsigned char* raw = raw0 + st * L::RAW;
    const float2 s = *reinterpret_cast<const float2*>(sc0 + st * kBN + col);
    const uint32_t s0 = dup_bf16(s.x), s1 = dup_bf16(s.y);
    auto half = [&](int r) {  // columns col, col + 1 of byte row r (128B swizzle)
      return (uint32_t) * reinterpret_cast<const uint16_t*>(
          raw + r * kBN + ((chunk ^ (r & 7)) << 4) + inner);
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // k pair (2t, 2t + 1), then (2t + 8, 2t + 9)
        uint32_t lo, hi;
        if constexpr (!INT4) {
          const int r = ks * 16 + 2 * t + 8 * h;
          biased_to_bf16<128>(__byte_perm(half(r), half(r + 1), 0x5140) ^ 0x80808080u, lo, hi);
        } else {
          const uint32_t w = half(ks * 8 + t + 4 * h), y = w >> 4;
          lo = nibbles_to_bf16x2(__byte_perm(w, y, 0x4400));  // byte 0: column col
          hi = nibbles_to_bf16x2(__byte_perm(w, y, 0x5511));  // byte 1: col + 1
        }
        a[ks][2 * h] = bf16x2_mul(lo, s0);
        a[ks][2 * h + 1] = bf16x2_mul(hi, s1);
      }
    }
  };
  auto release = [&](int f) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[f % S]);
  };

  Walk cur;
  if (!walk_to(cur, blockIdx.x, p, units)) return;
  float acc[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4] = {}, a1[4][4] = {};
  int f = 0, first = cur.kt;  // the unit's first k tile: its wgmmas overwrite acc
  bool more = true;
  // one stage: its fragments into `a` while the previous stage's wgmmas
  // (reading `prev`) still run, then its own wgmmas; one stage stays in
  // flight, and the tensor cores drain only at a unit's last k tile
  auto step = [&](uint32_t (&a)[4][4], uint32_t (&prev)[4][4]) {
    const int st = f % S;
    mbar_wait(&full[st], (f / S) & 1);
    dequant(st, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // x rows of 128 bytes, +32 bytes a k step, 8-row groups 1 KB apart
      const uint64_t db = wgmma_desc(xs0 + st * L::XT + 32 * kk, 16, 1024, 1);
      wgmma_rs_kb(acc, a[kk], db, kk > 0 || cur.kt != first);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas are done
    reg_fence(prev);
    if (cur.kt != first) release(f - 1);
    Walk nxt = cur;
    more = walk_next(nxt, p, units);
    if (cur.kt == cur.kend - 1) {
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(a);
      release(f);
      // acc[4j + e]: fragment row g + 8 (e >= 2) -> column col + (e >= 2),
      // x row 8j + 2t + (e & 1)
      const int m0 = cur.mi * NX, n0 = cur.ni * kBN;
      if (p.splits > 1) {
        const int split = cur.unit / (p.mb * p.nb);
#pragma unroll
        for (int j = 0; j < NX / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = m0 + 8 * j + 2 * t + c;
            if (row < p.m && n0 + col < p.N)
              *reinterpret_cast<float2*>(p.part + ((size_t)split * p.m + row) * p.N + n0 +
                                         col) = make_float2(acc[4 * j + c], acc[4 * j + 2 + c]);
          }
        reduce_splits<256, 4, 1>(p, cur.mi * p.nb + cur.ni, m0, min(NX, p.m - m0), n0,
                                 min(kBN, p.N - n0), tid);
      } else {
        // through a padded bf16 tile, so the stores to y are whole rows
#pragma unroll
        for (int j = 0; j < NX / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *reinterpret_cast<uint32_t*>(epi + (8 * j + 2 * t + c) * L::ES + 2 * col) =
                pack_bf16(acc[4 * j + c], acc[4 * j + 2 + c]);
        named_bar_sync(1, 256);
        const int rows = min(NX, p.m - m0);
        for (int i = tid; i < rows * 16; i += 256) {
          const int r = i >> 4, c16 = i & 15;
          if (n0 + 8 * c16 < p.N)
            *reinterpret_cast<uint4*>(p.out + (size_t)(m0 + r) * p.N + n0 + 8 * c16) =
                *reinterpret_cast<const uint4*>(epi + r * L::ES + 16 * c16);
        }
        named_bar_sync(1, 256);
      }
      first = nxt.kt;
    }
    cur = nxt;
    ++f;
  };
  while (more) {
    step(a0, a1);
    if (!more) break;
    step(a1, a0);
  }
}

// ---- simple: any shape ------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBK = 64;  // K rows a tile

// the bf16 scales of 16 columns from col (0 past N) as 8 bf16x2 words
__device__ __forceinline__ void load_scales(const float* row, int col, int N,
                                            uint32_t (&sc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = col + 2 * j < N ? __ldg(row + col + 2 * j) : 0.f;
    const float b = col + 2 * j + 1 < N ? __ldg(row + col + 2 * j + 1) : 0.f;
    sc[j] = pack_bf16(a, b);
  }
}

// 16 bytes of a [rows, N] byte matrix at (r, col); zero past the edges
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const uint8_t* w, int r, int rows,
                                          int col, int N) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= rows || col >= N) return v;
  const uint8_t* src = w + (size_t)r * N + col;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(src));
  uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < N) b[j] = __ldg(src + j);
  return v;
}

// 8 bf16 of x at (row, k); zero past the edges
template <bool VEC>
__device__ __forceinline__ uint4 load_x8(const QParams& p, int row, int k) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row >= p.m || k >= p.K) return v;
  const __nv_bfloat16* src = p.x + (size_t)row * p.ldx + k;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(src));
  uint16_t* h = reinterpret_cast<uint16_t*>(&v);
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k + j < p.K) h[j] = __ldg(s + j);
  return v;
}

// 16 dequantised bf16 (8 words) -> two 16-byte chunks of a bf16
// shared-memory row (chunk c of row r lives at chunk c ^ (r & 7))
__device__ __forceinline__ void store_row16(__nv_bfloat16* ws, int r, int c0,
                                            const uint32_t (&v)[8]) {
  *reinterpret_cast<uint4*>(ws + r * kBN + ((c0 ^ (r & 7)) * 8)) =
      make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(ws + r * kBN + (((c0 + 1) ^ (r & 7)) * 8)) =
      make_uint4(v[4], v[5], v[6], v[7]);
}

// MT 16-row mma tiles a warp; WM warp rows a block (WM = 2 shares each
// dequantised weight tile between 128 rows of x at prefill).  A block owns
// 128 columns and grid.z is the split.
template <int MT, int WM, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads * WM)
    qmatmul_simple_kernel(const QParams p) {
  constexpr int T = kThreads * WM;
  constexpr int BM = 16 * MT * WM;
  constexpr int WCH = (INT4 ? 256 : 512) / T;  // 16-byte weight chunks a thread a tile
  __shared__ __align__(128) __nv_bfloat16 xs[BM * kBK];
  __shared__ __align__(128) __nv_bfloat16 ws[kBK * kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2;  // warp column (32 wide), warp row
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int t_begin = blockIdx.z * p.tiles_per_split;
  const int t_end = min(p.tiles, t_begin + p.tiles_per_split);

  // every tile, this thread loads and dequantises the weight columns
  // [wc, wc + 16) of the block, byte rows (tid >> 3) + (T / 8) i
  const int wc = (tid & 7) * 16;
  const int gcol = n0 + wc;
  const int wrows = INT4 ? p.K / 2 : p.K;  // byte rows of q
  uint32_t sc[8];
  int sc_group = -1;
  if (INT4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0u;
  } else {
    load_scales(p.scale, gcol, p.N, sc);
  }

  uint4 wreg[WCH];
  uint4 xreg[MT];
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto load_tile = [&](int t) {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int r = (tid >> 3) + (T / 8) * i + t * (INT4 ? kBK / 2 : kBK);
      wreg[i] = load_w16<VEC>(p.w, r, wrows, gcol, p.N);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = tid + T * i;
      xreg[i] = load_x8<VEC>(p, m0 + (c >> 3), t * kBK + (c & 7) * 8);
    }
  };

  auto store_tile = [&](int t) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = tid + T * i;
      const int r = c >> 3, kc = c & 7;
      *reinterpret_cast<uint4*>(xs + r * kBK + ((kc ^ (r & 7)) * 8)) = xreg[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const uint32_t* wv = reinterpret_cast<const uint32_t*>(&wreg[i]);
      const int r = (tid >> 3) + (T / 8) * i;  // row (int8) or byte row (int4) in the tile
      uint32_t v[8];
      if (!INT4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t lo, hi;
          biased_to_bf16<128>(wv[j] ^ 0x80808080u, lo, hi);
          v[2 * j] = bf16x2_mul(lo, sc[2 * j]);
          v[2 * j + 1] = bf16x2_mul(hi, sc[2 * j + 1]);
        }
        store_row16(ws, r, wc / 8, v);
      } else {
        const int grow = t * (kBK / 2) + r;  // byte row of q
        if (grow < wrows) {
          const int group = (2 * grow) / p.gs;
          if (group != sc_group) {
            load_scales(p.scale + (size_t)group * p.N, gcol, p.N, sc);
            sc_group = group;
          }
        }
        // past the edges the bytes are 0: q = 0, and 0 * scale = 0
        uint32_t u[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t lo, hi;
          biased_to_bf16<8>((wv[j] & 0x0F0F0F0Fu) ^ 0x08080808u, lo, hi);
          v[2 * j] = bf16x2_mul(lo, sc[2 * j]);
          v[2 * j + 1] = bf16x2_mul(hi, sc[2 * j + 1]);
          biased_to_bf16<8>(((wv[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, lo, hi);
          u[2 * j] = bf16x2_mul(lo, sc[2 * j]);
          u[2 * j + 1] = bf16x2_mul(hi, sc[2 * j + 1]);
        }
        store_row16(ws, 2 * r, wc / 8, v);
        store_row16(ws, 2 * r + 1, wc / 8, u);
      }
    }
  };

  if (t_begin < t_end) load_tile(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    store_tile(t);
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1);  // in flight while this tile multiplies
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int mi = lane >> 3;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (wm * MT + mt) * 16 + (mi & 1) * 8 + (lane & 7);
        const int kc = ks * 2 + (mi >> 1);
        ldmatrix_x4(a[mt], xs + r * kBK + ((kc ^ (r & 7)) * 8));
      }
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int k = ks * 16 + (mi & 1) * 8 + (lane & 7);
        const int nc = (wn * 32 + np * 16) / 8 + (mi >> 1);
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, ws + k * kBN + ((nc ^ (k & 7)) * 8));
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();
  }

  // every (row, column) of the tile is written, by every split
  const int g = lane >> 2, tq = lane & 3;
  const bool pairs = (p.N & 1) == 0;
  const bool split = p.splits > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + mt) * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + 2 * tq;
        if (row >= p.m || col >= p.N) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (split) {
          float* dst = p.part + ((size_t)blockIdx.z * p.m + row) * p.N + col;
          dst[0] = v0;
          if (col + 1 < p.N) dst[1] = v1;
        } else {
          __nv_bfloat16* dst = p.out + (size_t)row * p.N + col;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (col + 1 < p.N) dst[1] = __float2bfloat16_rn(v1);
          }
        }
      }
  if (split)
    reduce_splits<T, 4, 8, 1>(p, blockIdx.y * gridDim.x + blockIdx.x, m0, min(BM, p.m - m0), n0,
                              min(kBN, p.N - n0), tid);
}

// ---- host side ---------------------------------------------------------------------

// the kernel's dynamic shared-memory ceiling, raised once a device (`done`
// is the launcher's own: every instantiation of a kernel has one type)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int MT, bool INT4>
cudaError_t launch_ring(const CUtensorMap& wmap, const QParams& p, cudaStream_t s) {
  using L = Ring<MT, INT4>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(qmatmul_ring_kernel<MT, INT4>, L::BYTES, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, p.splits);
  qmatmul_ring_kernel<MT, INT4><<<grid, L::THREADS, L::BYTES, s>>>(wmap, p);
  return cudaGetLastError();
}

template <bool INT4, int NX>
cudaError_t launch_wgmma(const CUtensorMap& wmap, const CUtensorMap& xmap, QParams p,
                         int grid, cudaStream_t s) {
  using L = Wg<INT4, NX>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(qmatmul_wgmma_kernel<INT4, NX>, L::BYTES, done);
  if (err != cudaSuccess) return err;
  p.mb = (p.m + NX - 1) / NX;
  p.nb = (p.N + kBN - 1) / kBN;
  qmatmul_wgmma_kernel<INT4, NX><<<grid, L::THREADS, L::BYTES, s>>>(wmap, xmap, p);
  return cudaGetLastError();
}

template <int MT, int WM>
cudaError_t launch_simple(const QParams& p, bool int4, bool vec, cudaStream_t s) {
  const int bm = 16 * MT * WM;
  const dim3 grid((p.m + bm - 1) / bm, (p.N + kBN - 1) / kBN, p.splits);
  const int threads = kThreads * WM;
  if (int4 && vec)
    qmatmul_simple_kernel<MT, WM, true, true><<<grid, threads, 0, s>>>(p);
  else if (int4)
    qmatmul_simple_kernel<MT, WM, true, false><<<grid, threads, 0, s>>>(p);
  else if (vec)
    qmatmul_simple_kernel<MT, WM, false, true><<<grid, threads, 0, s>>>(p);
  else
    qmatmul_simple_kernel<MT, WM, false, false><<<grid, threads, 0, s>>>(p);
  return cudaGetLastError();
}

// a 2-D map, dims and box innermost first, 128B swizzle, zeros past the edges
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                      uint64_t inner, uint64_t outer, uint64_t row_bytes,
                      uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The tensor map of a quantised weight (`rows` byte rows of N bytes, 16-byte
// aligned, N % 16 == 0), encoded once a leaf and copied into `map_out` (128
// bytes): boxes of 128 columns by 64 byte rows (int8) or 32 (int4).
extern "C" int docqa_qmatmul_weight_map(void* map_out, const void* w, long long rows,
                                        int N, int int4) {
  CUtensorMap map;
  const cudaError_t err = encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, (uint64_t)N,
                                    (uint64_t)rows, (uint64_t)N, kBN, int4 ? 32 : 64);
  if (err == cudaSuccess) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(err);
}

// A leaf's launch at one row count, built once by ops/qmatmul.py (its
// _Launch mirrors this field for field).  kernel: 0 simple, 1 ring, 2
// wgmma.  K is the contraction the kernel walks (int4: the padded one),
// tiles the K tiles of the mode's stage (64 rows; the int4 ring 128) and
// tiles_per_split those a split.  wmap is the weight's tensor map (ring,
// wgmma); grid the wgmma mode's persistent blocks and rows its units' x
// rows (128 or 256).
struct QLaunch {
  const void* w;
  const void* wmap;
  const void* scale;
  int K, N, int4, gs, kernel, splits, tiles, tiles_per_split, grid, rows;
};

// y = x . dequant(w, scale) for the launch `L` at m rows.  splits > 1 sums
// float32 partials in `part` ([splits, m, N]) through `counters` (zeroed,
// one int a tile; left zeroed).  vec (simple) is 1 when x's rows, q's rows
// and both base pointers are 16-byte aligned.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int docqa_qmatmul(const QLaunch* L, const void* x, void* out, void* part,
                             void* counters, long long ldx, int m, int vec, void* stream) {
  QParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(L->w);
  p.scale = static_cast<const float*>(L->scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.ldx = ldx;
  p.m = m;
  p.K = L->K;
  p.N = L->N;
  p.gs = L->gs;
  p.splits = L->splits;
  p.tiles = L->tiles;
  p.tiles_per_split = L->tiles_per_split;
  p.mb = p.nb = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q4 = L->int4 != 0;
  cudaError_t err = cudaErrorInvalidValue;
  CUtensorMap wm;  // the wrapper's copy need not sit on 64 bytes
  if (L->kernel != 0) memcpy(&wm, L->wmap, sizeof(wm));
  if (L->kernel == 1) {
    if (m <= 16)
      err = q4 ? launch_ring<1, true>(wm, p, s) : launch_ring<1, false>(wm, p, s);
    else if (m <= 32)
      err = q4 ? launch_ring<2, true>(wm, p, s) : launch_ring<2, false>(wm, p, s);
    else
      err = q4 ? launch_ring<4, true>(wm, p, s) : launch_ring<4, false>(wm, p, s);
  } else if (L->kernel == 2) {
    CUtensorMap xm;  // x moves every call: its map is encoded here
    err = encode_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, (uint64_t)p.K, (uint64_t)m,
                    (uint64_t)ldx * 2, 64, L->rows);
    if (err == cudaSuccess) {
      if (L->rows == 256)
        err = q4 ? launch_wgmma<true, 256>(wm, xm, p, L->grid, s)
                 : launch_wgmma<false, 256>(wm, xm, p, L->grid, s);
      else
        err = q4 ? launch_wgmma<true, 128>(wm, xm, p, L->grid, s)
                 : launch_wgmma<false, 128>(wm, xm, p, L->grid, s);
    }
  } else {
    const bool v = vec != 0;
    // block rows: 16, 32 or 64 (one warp row), 128 past 64 rows
    if (m <= 16)
      err = launch_simple<1, 1>(p, q4, v, s);
    else if (m <= 32)
      err = launch_simple<2, 1>(p, q4, v, s);
    else if (m <= 64)
      err = launch_simple<4, 1>(p, q4, v, s);
    else
      err = launch_simple<4, 2>(p, q4, v, s);
  }
  return static_cast<int>(err);
}
