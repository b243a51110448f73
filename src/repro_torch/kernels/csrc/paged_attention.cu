// Fused multi-request GQA paged attention for Hopper, sm_90a.  Plain C
// interface, loaded with ctypes by src/repro_torch/kernels/build.py;
// wrapper in kernels/paged_attention.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//
//   paged_attention   <- paged_attention_batched_pallas  (:229, pallas_call
//                        :271), and its C = 1 decode view
//                        paged_attention_pallas (:284)
//
// What it computes is the oracle paged_attention_batched_ref (:104): slot
// b's query c (of q (B, C, H, hd)) sits at position start[b] + c and
// attends, through the page table row table[b, :M], every position
// p <= start[b] + c of the pool pages k/v (NP, P, kvH, hd), and with a
// sliding window only those p > start[b] + c - window; scores are
// q.k / sqrt(hd), masked ones -1e30, softmax over positions, then p.v.
// The output is float32 (B, C, H, hd).  Rows c >= q_lens[b] are garbage
// by contract (the engine never reads them): the kernel computes nothing
// for them and writes 0.  Pages and queries come in float32 or bf16 and
// are widened to float32 as they are read; all arithmetic is float32.
//
// Design.  One block per (slot, kv head, tile of up to 16 query rows);
// a query row is one (c, g) pair, g the query head within the kv head's
// group (H = G kvH), and one warp works one row.  The block walks the
// slot's positions in tiles of 64 tokens: its threads stage the tile's
// K and V rows of its kv head (page table lookups per token, 16-byte
// loads) in shared memory as float32, then each warp updates its row's
// online softmax (m, l, acc) in registers: a lane scores two tokens
// (a full dot product against the staged K row, which is padded so the
// lanes hit distinct banks), the warp takes the tile's max and sum by
// shuffles, and for p.v each lane owns two of the 64 head dims.  The
// walk covers only [the first position the block's rows can attend, the
// last valid query's position]: a tile wholly outside a row's mask adds
// exactly nothing once a valid tile has been seen (its corr is
// exp(-1e30 - m) = 0), as in the Pallas body, so skipping it is exact.
// With -1e30, not -inf, an all-masked tile gives p = 1 rows that the
// first valid tile's corr = 0 erases, never exp(-inf + inf) = NaN.  The
// final division is acc / max(l, 1e-30), as at :210.
//
// Split context.  A decode pass has one query row per (slot, head): 16
// slots x 8 kv heads make 128 blocks of 4 warps, too few to fill 132 SMs
// or hide a load.  So when the blocks are few the launcher splits each
// block's walk into `splits` contiguous runs of tiles, one block each;
// each writes its rows' partial (acc, m, l) to a workspace, and a second
// kernel of the same call merges them: m = max m_s, l = sum l_s
// exp(m_s - m), acc = sum acc_s exp(m_s - m).  A run with no valid
// position gives m_s = -1e30 and weighs exactly 0 beside a valid one.
//
// Bound on this card.  A decode pass (C = 1) reads each slot's live K
// and V once per kv head and does 4 H ctx hd flops a slot: memory-bound
// (B = 16, 2,048 tokens, kvH = 8, hd = 64, bf16: 67.1 MB, 0.020 ms at
// 3.35 TB/s).  A chunked-prefill pass does 4 rows ctx hd flops for its
// valid rows on CUDA cores in float32: bound by operations at 67 TFLOP/s.
// This first kernel is plain SIMT float32 and loads a tile before it
// computes on it (no double buffering), so it sits above both bounds.
//
// The host build of the tests compiles this file with a stub header that
// makes one thread play the whole grid: PA_LANES 1 (a warp of one lane,
// which then holds all 64 tokens of a tile) and PA_ROWS_PER_WARP 16 (one
// warp works every row of a block).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifndef PA_LANES
#define PA_LANES 32
#endif
#ifndef PA_ROWS_PER_WARP
#define PA_ROWS_PER_WARP 1
#endif

namespace {

constexpr int kLanes = PA_LANES;          // threads of a warp
constexpr int kRowsPerWarp = PA_ROWS_PER_WARP;
constexpr int kRows = 16;                 // query rows of a block, at most
constexpr int kTile = 64;                 // tokens a tile
constexpr int kHd = 64;                   // head dims, at most
constexpr int kTpl = kTile / kLanes;      // tokens a lane scores
constexpr int kDpl = kHd / kLanes;        // head dims a lane owns
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct alignas(16) Vec16 {
  uint32_t w[4];
};

__device__ __forceinline__ float bits_to_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

__device__ __forceinline__ float to_float(float x) { return x; }
// bf16 is the upper half of a float32
__device__ __forceinline__ float to_float(uint16_t x) {
  return bits_to_float((uint32_t)x << 16);
}

// Widen one 16-byte vector of T into out[0 .. 16 / sizeof(T)).
__device__ __forceinline__ void unpack(const Vec16& v, float* out, float) {
  for (int i = 0; i < 4; ++i) out[i] = bits_to_float(v.w[i]);
}
__device__ __forceinline__ void unpack(const Vec16& v, float* out,
                                       uint16_t) {
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = bits_to_float(v.w[i] << 16);
    out[2 * i + 1] = bits_to_float(v.w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

// VEC: 16-byte loads of K/V (hd a multiple of 16 / sizeof(TKV), the pool
// 16-byte aligned); else one element a load.
template <typename TQ, typename TKV, bool VEC>
__global__ void __launch_bounds__(kRows * kLanes) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens,
    float* __restrict__ out, float* __restrict__ ws, int C, int H, int kvh,
    int hd, int P, int M, int window, float sqrt_hd, int rows,
    int units_per_head, int splits, long long units, long long rows_total) {
  __shared__ float ks[kTile][kHd + 1];   // +1: lanes on distinct banks
  __shared__ float vs[kTile][kHd];
  __shared__ float qs[kRows][kHd];
  constexpr int kVw = VEC ? (int)(16 / sizeof(TKV)) : 1;
  const int G = H / kvh;
  const int nwarps = (int)blockDim.x / kLanes;
  const int warp = (int)threadIdx.x / kLanes;
  const int lane = (int)threadIdx.x % kLanes;
  const int vec_row = hd / kVw;
  const int tile_vecs = kTile * vec_row;

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int split = (int)(unit % splits);
    const long long cell = unit / splits;
    const int tile_r = (int)(cell % units_per_head);
    const int h = (int)((cell / units_per_head) % kvh);
    const int b = (int)(cell / ((long long)units_per_head * kvh));
    const int r0 = tile_r * rows;
    const int nrows = rows < C * G - r0 ? rows : C * G - r0;
    const long long s0 = start[b];
    const int c_lo = r0 / G;
    const int c_hi = (r0 + nrows - 1) / G;
    const int c_last = c_hi < q_lens[b] - 1 ? c_hi : q_lens[b] - 1;
    // the positions some valid row of the block attends: [kv_lo, kv_hi)
    long long kv_lo = 0, kv_hi = 0;
    if (c_last >= c_lo) {
      kv_hi = s0 + c_last + 1;
      if (kv_hi > (long long)M * P) kv_hi = (long long)M * P;
      if (window > 0 && s0 + c_lo - window + 1 > 0)
        kv_lo = s0 + c_lo - window + 1;
    }

    __syncthreads();                     // the last unit is done with qs
    for (int e = (int)threadIdx.x; e < nrows * hd; e += (int)blockDim.x) {
      const int r = e / hd, d = e % hd;
      const int c = (r0 + r) / G, g = (r0 + r) % G;
      qs[r][d] = to_float(q[(((long long)b * C + c) * H + h * G + g) * hd
                            + d]);
    }

    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = kMasked;
      l[i] = 0.0f;
      for (int k = 0; k < kDpl; ++k) acc[i][k] = 0.0f;
    }

    // this block's run of the walk's tiles
    const long long t_first = kv_lo - kv_lo % kTile;
    const long long n_tiles =
        kv_hi > t_first ? (kv_hi - t_first + kTile - 1) / kTile : 0;
    const long long per = (n_tiles + splits - 1) / splits;
    const long long t_begin = t_first + split * per * kTile;
    long long t_end = t_first + (split + 1) * per * kTile;
    if (t_end > kv_hi) t_end = kv_hi;
    for (long long t0 = t_begin; t0 < t_end; t0 += kTile) {
      __syncthreads();                   // the last tile has been read
      for (int e = (int)threadIdx.x; e < 2 * tile_vecs;
           e += (int)blockDim.x) {
        const bool is_v = e >= tile_vecs;
        const int rem = is_v ? e - tile_vecs : e;
        const int j = rem / vec_row, d0 = (rem % vec_row) * kVw;
        const long long pos = t0 + j;
        float vals[kVw];
        if (pos >= kv_lo && pos < kv_hi) {
          const long long page = table[(long long)b * M + pos / P];
          const long long src =
              ((page * P + pos % P) * kvh + h) * hd + d0;
          const TKV* base = is_v ? vp : kp;
          if constexpr (VEC) {
            unpack(*reinterpret_cast<const Vec16*>(base + src), vals,
                   TKV());
          } else {
            for (int i = 0; i < kVw; ++i) vals[i] = to_float(base[src + i]);
          }
        } else {
          for (int i = 0; i < kVw; ++i) vals[i] = 0.0f;
        }
        float* dst = is_v ? &vs[j][d0] : &ks[j][d0];
        for (int i = 0; i < kVw; ++i) dst[i] = vals[i];
      }
      __syncthreads();

      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * nwarps;
        if (r >= nrows) break;
        const int c = (r0 + r) / G;
        if (c > c_last) continue;        // garbage row: written 0 below
        const long long qpos = s0 + c;
        float s[kTpl];
        for (int t = 0; t < kTpl; ++t) s[t] = 0.0f;
        // the lane's tokens side by side: independent sums
        for (int d = 0; d < hd; ++d) {
          const float qd = qs[r][d];
          for (int t = 0; t < kTpl; ++t)
            s[t] = s[t] + qd * ks[lane + t * kLanes][d];
        }
        float tmax = kMasked;
        for (int t = 0; t < kTpl; ++t) {
          const long long pos = t0 + lane + t * kLanes;
          const bool valid = pos <= qpos && pos < kv_hi &&
                             (window <= 0 || pos > qpos - window);
          s[t] = valid ? s[t] / sqrt_hd : kMasked;
          tmax = fmaxf(tmax, s[t]);
        }
        tmax = warp_max(tmax);
        const float m_new = fmaxf(m[i], tmax);
        const float corr = expf(m[i] - m_new);
        float psum = 0.0f;
        for (int t = 0; t < kTpl; ++t) {
          s[t] = expf(s[t] - m_new);
          psum = psum + s[t];
        }
        psum = warp_sum(psum);
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
        for (int k = 0; k < kDpl; ++k) acc[i][k] = acc[i][k] * corr;
        for (int t = 0; t < kTpl; ++t) {
          for (int src = 0; src < kLanes; ++src) {
            const float p = __shfl_sync(kFull, s[t], src);
            const int j = src + t * kLanes;
            for (int k = 0; k < kDpl; ++k) {
              const int d = lane + k * kLanes;
              if (d < hd) acc[i][k] = acc[i][k] + p * vs[j][d];
            }
          }
        }
      }
    }

    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * nwarps;
      if (r >= nrows) break;
      const int c = (r0 + r) / G, g = (r0 + r) % G;
      const bool valid = c <= c_last;
      const long long row = ((long long)b * C + c) * H + h * G + g;
      if (splits == 1) {
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        for (int k = 0; k < kDpl; ++k) {
          const int d = lane + k * kLanes;
          if (d < hd) out[row * hd + d] = valid ? acc[i][k] * inv : 0.0f;
        }
      } else {
        // the partial (acc, m, l); a garbage row's is (0, -1e30, 0)
        float* w = ws + ((long long)split * rows_total + row) * (hd + 2);
        for (int k = 0; k < kDpl; ++k) {
          const int d = lane + k * kLanes;
          if (d < hd) w[d] = valid ? acc[i][k] : 0.0f;
        }
        if (lane == 0) {
          w[hd] = valid ? m[i] : kMasked;
          w[hd + 1] = valid ? l[i] : 0.0f;
        }
      }
    }
  }
}

// out[row, d] from the `splits` partials of every row.
__global__ void __launch_bounds__(256) paged_attention_merge_kernel(
    const float* __restrict__ ws, float* __restrict__ out,
    long long rows_total, int hd, int splits) {
  const long long n = rows_total * hd;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / hd;
    const int d = (int)(e % hd);
    float m = kMasked;
    for (int s = 0; s < splits; ++s)
      m = fmaxf(m, ws[((long long)s * rows_total + row) * (hd + 2) + hd]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* w = ws + ((long long)s * rows_total + row) * (hd + 2);
      const float f = expf(w[hd] - m);
      l = l + w[hd + 1] * f;
      a = a + w[d] * f;
    }
    out[e] = a / fmaxf(l, 1e-30f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks of one launch without a split, and the split that brings a
// launch with few blocks to about 8 blocks an SM (each run at least two
// tiles of the table's width, at most 32 runs).
long long units_of(long long B, long long C, long long H, long long kvh) {
  const long long cg = C * (H / kvh);
  const long long rows = cg < kRows ? cg : kRows;
  return B * kvh * ((cg + rows - 1) / rows);
}

int splits_for(long long units, long long P, long long M) {
  const long long target = 132 * 8;
  if (units <= 0 || units * 2 >= target) return 1;
  long long s = (target + units - 1) / units;
  const long long by_ctx = (M * P) / (2 * kTile);
  if (s > by_ctx) s = by_ctx;
  if (s > 32) s = 32;
  return s < 1 ? 1 : (int)s;
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* start, const int* q_lens, float* out, float* ws,
           long long B, long long C, long long H, long long kvh, long long hd,
           long long P, long long M, long long window, int splits,
           cudaStream_t s) {
  const long long cg = C * (H / kvh);
  const int rows = (int)(cg < kRows ? cg : kRows);
  const long long units_per_head = (cg + rows - 1) / rows;
  const long long units = B * kvh * units_per_head * splits;
  const long long rows_total = B * C * H;
  const int threads = rows * kLanes;
  const float sqrt_hd = sqrtf((float)hd);
  const bool vec = hd % (long long)(16 / sizeof(TKV)) == 0 &&
                   aligned16(k) && aligned16(v);
  const auto* qq = static_cast<const TQ*>(q);
  const auto* kk = static_cast<const TKV*>(k);
  const auto* vv = static_cast<const TKV*>(v);
  if (vec) {
    paged_attention_kernel<TQ, TKV, true><<<(unsigned)units, threads, 0, s>>>(
        qq, kk, vv, table, start, q_lens, out, ws, (int)C, (int)H, (int)kvh,
        (int)hd, (int)P, (int)M, (int)window, sqrt_hd, rows,
        (int)units_per_head, splits, units, rows_total);
  } else {
    paged_attention_kernel<TQ, TKV, false><<<(unsigned)units, threads, 0, s>>>(
        qq, kk, vv, table, start, q_lens, out, ws, (int)C, (int)H, (int)kvh,
        (int)hd, (int)P, (int)M, (int)window, sqrt_hd, rows,
        (int)units_per_head, splits, units, rows_total);
  }
  if (splits > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    long long blocks = (rows_total * hd + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    paged_attention_merge_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        ws, out, rows_total, (int)hd, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of runs paged_attention splits each block's walk into;
// with more than one it needs a float32 workspace of splits x B C H x
// (hd + 2).
int paged_attention_splits(long long B, long long C, long long H,
                           long long kvh, long long P, long long M) {
  return splits_for(units_of(B, C, H, kvh), P, M);
}

// q (B, C, H, hd) float32 or bf16 (q_bf16), k/v pages (NP, P, kvH, hd)
// float32 or bf16 (kv_bf16), table (B, M) / start (B,) / q_lens (B,)
// int32, out (B, C, H, hd) float32, ws the workspace (unused with one
// split); window <= 0 means none.  hd <= 64 and H a multiple of kvH (the
// wrapper checks).  Returns cudaGetLastError() after the launches (0 =
// ok); `stream` is a cudaStream_t.
int paged_attention(const void* q, int q_bf16, const void* k, const void* v,
                    int kv_bf16, const int* table, const int* start,
                    const int* q_lens, float* out, float* ws, long long B,
                    long long C, long long H, long long kvh, long long hd,
                    long long P, long long M, long long window, int splits,
                    void* stream) {
  if (B * C * H == 0) return 0;
  if (splits < 1) splits = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<uint16_t, uint16_t>(q, k, v, table, start, q_lens, out, ws,
                                      B, C, H, kvh, hd, P, M, window, splits,
                                      s);
  if (q_bf16)
    return launch<uint16_t, float>(q, k, v, table, start, q_lens, out, ws, B,
                                   C, H, kvh, hd, P, M, window, splits, s);
  if (kv_bf16)
    return launch<float, uint16_t>(q, k, v, table, start, q_lens, out, ws, B,
                                   C, H, kvh, hd, P, M, window, splits, s);
  return launch<float, float>(q, k, v, table, start, q_lens, out, ws, B, C,
                              H, kvh, hd, P, M, window, splits, s);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
