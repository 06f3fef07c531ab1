// K4: the weight-only quantised matmul for Hopper (sm_90a), with a plain C
// interface that docqa_tpu_torch/ops/qmatmul.py binds through ctypes.
//
// Replaces no Pallas kernel: the reference's dequantising product
// (docqa_tpu/models/decoder.py::_qmatmul) is XLA, which fuses the
// convert-and-scale into the dot's operand read so the dequantised tree
// never reaches HBM (docqa_tpu/models/quant.py).  A plain dequantise then
// torch.matmul would write the whole bf16 tree back out on every forward
// and read more bytes than the unquantised engine; this kernel keeps the
// dequantised tile in shared memory instead.
//
//   y[m, N] = x[m, K] . W~[K, N],  x bf16, sums float32, y bf16
//   int8:  W~[k, n] = bf16(bf16(q[k, n]) * bf16(scale[n]))
//   int4:  W~[k, n] = bf16(bf16(q[k, n]) * bf16(scale[k / gs, n]))
//
// W~ is rounded exactly as the reference's `w.astype(dtype) * scale.astype
// (dtype)`: bf16(q) and bf16(scale) are exact in float32, so is their
// product, and one round to bf16 follows.
//
// Layouts (ops/qmatmul.py documents them for the host side): int8 q is
// [K, N] row-major; int4 q is packed two values a byte along K, byte
// [k / 2, n] holding row k (k even) in its low nibble and row k + 1 in its
// high one, as two's-complement 4-bit values.  gs is even (the wrapper pads
// an odd group with a zero row of q and a zero column of x), so both rows
// of a byte share one scale row.
//
// Bound: at decode (m <= 64) the product does ~2m operations a weight byte,
// far under the ~295 at which the tensor cores become the limit, so the
// kernel is bound by bytes: the packed weights and scales once over
// 3.35 TB/s (Mistral-7B's w_gate in int8: 58.7 MB, 17.5 us).  At prefill
// (m in the thousands) it is bound by operations, 2 m K N / 989 TFLOP/s.
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
//   * a block owns 128 output columns and 16, 32 or 64 rows of x (MT
//     16-row mma tiles, 4 warps of 32 columns each); past 64 rows (prefill)
//     two warp rows share each dequantised weight tile over 128 rows;
//   * K is walked in 64-row tiles.  Each thread loads its 16-byte chunks
//     of the next tile's weights and x into registers while the current
//     tile is multiplied (one tile of loads in flight a block, several
//     blocks an SM);
//   * dequantisation without conversion instructions (those run at a
//     quarter of the integer rate and bounded the first version): a byte
//     permute makes each biased int8 / int4 value a float 2^23 + byte, one
//     subtraction leaves q exactly, its upper half is bf16(q), and one
//     mul.rn.bf16x2 by the bf16 scales rounds the product once, as the
//     reference does.  The tile goes to shared memory as bf16 (16-byte
//     chunks XOR-swizzled by row) and is read as mma.sync B fragments with
//     ldmatrix.trans; x tiles take ldmatrix; m16n8k16 bf16 mma.sync with
//     float32 accumulators;
//   * grid fill: wk / wv have 1,024 columns (8 blocks for 132 SMs), so K
//     is split across blocks (grid.z) when the m x N grid is small, each
//     split writing every float32 partial of its tile (no atomics: tokens
//     stay reproducible run to run, and no scratch is read unwritten); a
//     second kernel sums the splits in order and rounds to bf16;
//   * grid.x walks m, so the blocks sharing a weight tile at prefill run
//     together and read it once from HBM, the rest from L2;
//   * ragged edges (m, K, N not multiples of the tiles) are masked: loads
//     zero-fill, stores are guarded.  VEC = 0 takes every element alone
//     for shapes whose rows are not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_16816;

constexpr int kThreads = 128;
constexpr int kBK = 64;   // K rows a tile
constexpr int kBN = 128;  // output columns a block

struct QParams {
  const __nv_bfloat16* x;  // [m, K], row stride ldx elements
  const uint8_t* w;        // int8 [K, N]; int4 packed [K / 2, N]
  const float* scale;      // int8 [N]; int4 [K / gs, N]
  __nv_bfloat16* out;      // [m, N]: written when part is null
  float* part;             // [splits, m, N] float32 partials, or null
  long long ldx;
  int m, K, N, gs, tiles_per_split;
};

// the bf16 scales of 16 columns from col (0 past N) as 8 bf16x2 words
__device__ __forceinline__ void load_scales(const float* row, int col, int N,
                                            uint32_t (&sc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = col + 2 * j < N ? __ldg(row + col + 2 * j) : 0.f;
    const float b = col + 2 * j + 1 < N ? __ldg(row + col + 2 * j + 1) : 0.f;
    sc[j] = flash::pack_bf16(a, b);
  }
}

// Four biased bytes (q + bias each, as unsigned) -> the bf16 values of q,
// as two bf16x2 words (bytes 0-1, then 2-3).  No conversion instruction:
// each byte becomes the float 2^23 + byte (a byte permute into 0x4B000000),
// one subtraction leaves q exactly, and q (|q| <= 127) keeps every bit in
// the upper half of the float, which is its bf16.
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
// dequantised weight tile between 128 rows of x at prefill)
template <int MT, int WM, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads * WM)
    qmatmul_kernel(const QParams p) {
  constexpr int T = kThreads * WM;
  constexpr int BM = 16 * MT * WM;
  constexpr int WCH = (INT4 ? 256 : 512) / T;  // 16-byte weight chunks a thread a tile
  __shared__ __align__(128) __nv_bfloat16 xs[BM * kBK];
  __shared__ __align__(128) __nv_bfloat16 ws[kBK * kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2;  // warp column (32 wide), warp row
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int ntiles = (p.K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * p.tiles_per_split;
  const int t_end = min(ntiles, t_begin + p.tiles_per_split);

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
        if (p.part) {
          float* dst = p.part + ((size_t)blockIdx.z * p.m + row) * p.N + col;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (col + 1 < p.N) dst[1] = v1;
          }
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
}

// out[i] = bf16(sum over splits, in split order, of part[split][i])
__global__ void qmatmul_reduce_kernel(const float* __restrict__ part,
                                      __nv_bfloat16* __restrict__ out,
                                      long long n, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

template <int MT, int WM, bool INT4>
void launch(const QParams& p, dim3 grid, bool vec, cudaStream_t stream) {
  if (vec)
    qmatmul_kernel<MT, WM, INT4, true><<<grid, kThreads * WM, 0, stream>>>(p);
  else
    qmatmul_kernel<MT, WM, INT4, false><<<grid, kThreads * WM, 0, stream>>>(p);
}

template <int MT, int WM>
void launch_mode(const QParams& p, dim3 grid, bool int4, bool vec,
                 cudaStream_t stream) {
  if (int4)
    launch<MT, WM, true>(p, grid, vec, stream);
  else
    launch<MT, WM, false>(p, grid, vec, stream);
}

}  // namespace

// y = x . dequant(w, scale).  splits > 1 writes float32 partials to part
// ([splits, m, N]) and sums them into out; tiles_per_split 64-row K tiles
// a split.  vec = 1 when x's rows, q's rows and both base pointers are
// 16-byte aligned.  Returns the launch's cudaError_t (0 on success).
extern "C" int docqa_qmatmul(const void* x, const void* w, const void* scale,
                             void* out, void* part, long long ldx, int m,
                             int K, int N, int int4, int gs, int splits,
                             int tiles_per_split, int vec, void* stream) {
  QParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.ldx = ldx;
  p.m = m;
  p.K = K;
  p.N = N;
  p.gs = gs;
  p.tiles_per_split = tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // block rows: 16, 32 or 64 at decode (one warp row), 128 past 64 rows
  const int bm = m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 128;
  dim3 grid((m + bm - 1) / bm, (N + kBN - 1) / kBN, splits);
  if (bm == 16)
    launch_mode<1, 1>(p, grid, int4 != 0, vec != 0, s);
  else if (bm == 32)
    launch_mode<2, 1>(p, grid, int4 != 0, vec != 0, s);
  else if (bm == 64)
    launch_mode<4, 1>(p, grid, int4 != 0, vec != 0, s);
  else
    launch_mode<4, 2>(p, grid, int4 != 0, vec != 0, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long n = (long long)m * N;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  qmatmul_reduce_kernel<<<blocks, 256, 0, s>>>(p.part, p.out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
