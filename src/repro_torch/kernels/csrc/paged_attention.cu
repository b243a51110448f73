// Fused multi-request GQA paged attention for Hopper, sm_90a, on the bf16
// tensor cores.  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/build.py; wrapper in kernels/paged_attention.py.
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
// for them and writes 0.  q and the pages come in float32 or bf16.
//
// Design (tensor_tiles.cuh has the fragments and the precision rules).
// One block per (slot, kv head, tile of up to 64 query rows): a query row
// is one (c, g) pair, g the query head within the kv head's group
// (H = G kvH), rows in (c, g) order, so at granite's G = 4 a block holds
// 16 positions x 4 heads and reads each K/V tile once for 64 rows.  Each
// warp owns 16 rows (an m16 tile; a decode block of G = 4 rows pads one)
// and keeps their output (16 x hd float32) and online-softmax state
// (m, l) in registers.  The block walks the slot's positions in tiles of
// 64 tokens, double-buffered: while the warps work on one tile, cp.async
// brings the next tile's K and V rows (a page-table lookup per token,
// 16-byte copies, zeros outside the walk and past hd) into the other
// stage, bf16 pages as bf16 and float32 pages as float32, never widened.
// Per tile a warp computes S = Q K^T with m16n8k16 MMAs (hd padded to a
// multiple of 16 with zeros), masks and scales it, runs the online
// softmax on the accumulator fragments (row max and sum by shuffles in
// each row's lane quad), and accumulates P V with the probabilities
// taken straight from the score fragments.  Terms: bf16 q and pages go in
// as they are; float32 q or pages enter as three bf16 terms; p always
// enters as three terms (granite's bf16 path: 1 MMA a score tile, 3 a p.v
// tile).  The walk covers only [the first position the block's rows can
// attend, the last valid query's position]: a tile wholly outside a row's
// mask adds exactly nothing once a valid tile has been seen (its rescale
// is exp(-1e30 - m) = 0), as in the Pallas body, so skipping it is exact;
// a warp whose 16 rows are all past q_lens skips its MMAs.  The final
// division is acc / max(l, 1e-30), as at :210.
//
// Split context.  A decode pass has G query rows per (slot, kv head): 16
// slots x 8 kv heads make 128 one-warp blocks, too few for 132 SMs.  So
// when the blocks are few the launcher splits each block's walk into
// `splits` contiguous runs of tiles, one block each; each writes its rows'
// partial (acc, m, l) to a workspace, and a second kernel of the same
// call merges them: m = max m_s, l = sum l_s exp(m_s - m),
// acc = sum acc_s exp(m_s - m).  A run with no valid position gives
// m_s = -1e30 and weighs exactly 0 beside a valid one.
//
// Bound on this card.  A chunked-prefill pass (C = 256, 16 slots of 2,048
// tokens, 32 heads, 8 kv heads, hd 64, bf16) moves about 84 MB (each
// slot's live K/V once per kv head, q, the float32 output): 0.025 ms at
// 3.35 TB/s; its 4 rows ctx hd flops take 0.016 ms at the 989 TFLOP/s of
// the bf16 tensor cores, so it is bound by bytes.  A decode pass (C = 1)
// reads the same K/V for one row per head: bound by bytes.  The three
// terms of p triple the p.v MMAs; the bf16 path stays bound by bytes.
//
// Measured (chip_smoke.py, phase paged-kernel, NVIDIA H100 80GB HBM3,
// 700 W): the largest error against the float32 plain version 2.0e-6 at
// C = 256 and 2.2e-7 at C = 1, inside rtol 1e-4 / atol 1e-5 with three
// terms for every float32 operand; times in PERF.md.  Fewer terms, built
// with kTerms edited and run through the same phases: two hold that
// tolerance on the card (1.7e-6 and 4.1e-7, 9% faster at C = 256) but
// not the host tests' 1e-5 (8 of their 160 cases fail); one does not
// hold it (8.4e-4).  So three are kept.
//
// The host build of the tests compiles this file with a stub header that
// makes one thread play the whole grid (one warp of one lane that works
// every row tile of its block) and defines TC_HOST_FRAGMENTS.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tensor_tiles.cuh"

namespace {

using namespace tc;

constexpr int kTile = 64;                 // tokens a K/V tile
constexpr int kRows = 64;                 // query rows of a block, at most
constexpr int kHd = 64;                   // head dims, at most
constexpr int kTokTiles = kTile / 8;      // n8 tiles of a score tile
constexpr int kHdTiles = kHd / 8;         // n8 tiles of the output

// Bytes of the block's shared query tile (a multiple of 16).
__host__ __device__ __forceinline__ size_t q_bytes(int rows, int ldq,
                                                   size_t elem) {
  return (size_t)rows * ldq * elem;
}

// The tile of positions [t0, t0 + kTile) of kv head h into ks / vs, its
// pool rows from tile_rows: positions outside the walk (row -1) and dims
// past hd are zeros.  VEC: 16-byte asynchronous copies (hd a multiple of
// 16 / sizeof(TKV), the pool 16-byte aligned); else one element a load.
template <typename TKV, bool VEC>
__device__ __forceinline__ void load_kv_tile(
    TKV* ks, TKV* vs, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const int* rows, int kvh, int h, int hd, int hd16, int ld) {
  constexpr int kVw = VEC ? (int)(16 / sizeof(TKV)) : 1;
  const int per_row = hd16 / kVw;
  for (int e = (int)threadIdx.x; e < kTile * per_row;
       e += (int)blockDim.x) {
    const int j = e / per_row, d0 = (e - j * per_row) * kVw;
    const int tok = rows[j];
    const bool valid = tok >= 0 && d0 < hd;
    const long long off = valid ? ((long long)tok * kvh + h) * hd + d0 : 0;
    const int at = tile_at<TKV>(j, d0, ld);
    if constexpr (VEC) {
      cp_async16(ks + at, kp + off, valid);
      cp_async16(vs + at, vp + off, valid);
    } else {
      ks[at] = valid ? kp[off] : TKV(0);
      vs[at] = valid ? vp[off] : TKV(0);
    }
  }
}

template <typename TQ, typename TKV, bool VEC>
__global__ void __launch_bounds__(kRows * 2) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens,
    float* __restrict__ out, float* __restrict__ ws, int C, int H, int kvh,
    int hd, int P, int M, int window, float scale2, int rows,
    int units_per_head, int splits, long long units, long long rows_total,
    bool qvec) {
  constexpr int kQTerms = Terms<TQ>::n, kKVTerms = Terms<TKV>::n;
  const int G = H / kvh;
  const int hd16 = (hd + 15) & ~15;
  const int ldq = tile_ld<TQ>(hd16), ldkv = tile_ld<TKV>(hd16);
  unsigned char* smem = dyn_smem();
  TQ* q_s = reinterpret_cast<TQ*>(smem);
  TKV* kv_s = reinterpret_cast<TKV*>(smem + q_bytes(rows, ldq, sizeof(TQ)));
  int* tok_s = reinterpret_cast<int*>(kv_s + 4 * kTile * ldkv);  // 2 tiles
  const int row_tiles = rows / 16;
  const int warp = warp_id(), nwarps = num_warps();

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int split = (int)(unit % splits);
    const long long cell = unit / splits;
    // a (slot, kv head)'s last row tiles, whose walks are longest, first
    const int tile_r = units_per_head - 1 - (int)(cell % units_per_head);
    const int h = (int)((cell / units_per_head) % kvh);
    const int b = (int)(cell / ((long long)units_per_head * kvh));
    const int r0 = tile_r * rows;
    const int nrows = rows < C * G - r0 ? rows : C * G - r0;
    const int s0 = start[b];
    const int c_lo = r0 / G;
    const int c_hi = (r0 + nrows - 1) / G;
    const int c_last = c_hi < q_lens[b] - 1 ? c_hi : q_lens[b] - 1;
    // the positions some valid row of the block attends: [kv_lo, kv_hi)
    int kv_lo = 0, kv_hi = 0;
    if (c_last >= c_lo) {
      kv_hi = s0 + c_last + 1;
      if (kv_hi > M * P) kv_hi = M * P;
      if (window > 0 && s0 + c_lo - window + 1 > 0)
        kv_lo = s0 + c_lo - window + 1;
    }
    const int* table_b = table + (long long)b * M;

    __syncthreads();                     // the last unit is done with smem

    FragC o[kTasksPerWarp][kHdTiles];
    float m[kTasksPerWarp][kSlots], l[kTasksPerWarp][kSlots];
#pragma unroll
    for (int i = 0; i < kTasksPerWarp; ++i) {
      zero(o[i]);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        m[i][s] = kMasked;
        l[i][s] = 0.0f;
      }
    }

    // this block's run of the walk's tiles
    const int t_first = kv_lo - kv_lo % kTile;
    const int n_tiles = kv_hi > t_first ? (kv_hi - t_first + kTile - 1) / kTile
                                        : 0;
    const int per = (n_tiles + splits - 1) / splits;
    const int t_begin = t_first + split * per * kTile;
    int t_end = t_first + (split + 1) * per * kTile;
    if (t_end > kv_hi) t_end = kv_hi;
    // the query rows and the first tile in one group of copies; pool rows
    // one tile ahead of the copies, copies one tile ahead of the MMAs
    if (t_begin < t_end) {
      const auto q_row = [&](int r) {
        const int c = (r0 + r) / G, g = (r0 + r) % G;
        return q + (((long long)b * C + c) * H + h * G + g) * hd;
      };
      if (qvec)
        stage_rows<true>(q_s, ldq, rows, hd16, nrows, hd, q_row);
      else
        stage_rows<false>(q_s, ldq, rows, hd16, nrows, hd, q_row);
      tile_rows(tok_s, table_b, t_begin, kTile, kv_lo, kv_hi, P);
      __syncthreads();
      load_kv_tile<TKV, VEC>(kv_s, kv_s + kTile * ldkv, kp, vp, tok_s, kvh,
                             h, hd, hd16, ldkv);
      cp_async_commit();
      if (t_begin + kTile < t_end)
        tile_rows(tok_s + kTile, table_b, t_begin + kTile, kTile, kv_lo,
                  kv_hi, P);
    }
    int stage = 0;
    for (int t0 = t_begin; t0 < t_end; t0 += kTile, stage ^= 1) {
      cp_async_wait_all();
      __syncthreads();   // the tile landed; the other stage is free
      if (t0 + kTile < t_end) {
        TKV* nk = kv_s + 2 * (stage ^ 1) * kTile * ldkv;
        load_kv_tile<TKV, VEC>(nk, nk + kTile * ldkv, kp, vp,
                               tok_s + (stage ^ 1) * kTile, kvh, h, hd, hd16,
                               ldkv);
        cp_async_commit();
      }
      if (t0 + 2 * kTile < t_end)
        tile_rows(tok_s + stage * kTile, table_b, t0 + 2 * kTile, kTile,
                  kv_lo, kv_hi, P);
      const TKV* ks = kv_s + 2 * stage * kTile * ldkv;
      const TKV* vs = ks + kTile * ldkv;
#pragma unroll
      for (int i = 0; i < kTasksPerWarp; ++i) {
        const int rt = warp + i * nwarps;
        if (rt >= row_tiles) break;
        if ((r0 + rt * 16) / G > c_last) continue;   // no valid row
        FragC s[kTokTiles];
        zero(s);
#pragma unroll
        for (int k0 = 0; k0 < kHd; k0 += 16) {
          if (k0 >= hd16) break;
          FragA a[kQTerms];
          load_a(a, q_s, ldq, rt * 16, k0);
          FragB b[kTokTiles][kKVTerms];
#pragma unroll
          for (int np = 0; np < kTokTiles / 2; ++np)
            load_b2(b[2 * np], b[2 * np + 1], ks, ldkv, np * 16, k0);
          mma_tiles(s, a, b);
        }
        // the live rows' first and last positions: a tile they all see
        // whole needs no mask (rows past q_lens or nrows are never read)
        const int last = (r0 + rt * 16 + 15 < r0 + nrows
                              ? r0 + rt * 16 + 15 : r0 + nrows - 1) / G;
        const int q_first = s0 + (r0 + rt * 16) / G;
        const int q_last = s0 + (last < c_last ? last : c_last);
        if (t0 + kTile - 1 <= q_first && t0 + kTile <= kv_hi &&
            (window <= 0 || t0 > q_last - window)) {
#pragma unroll
          for (int j = 0; j < kTokTiles; ++j)
#pragma unroll
            for (int e = 0; e < kCElems; ++e) s[j].x[e] = s[j].x[e] * scale2;
        } else {
          int qpos[kSlots];
          bool live[kSlots];
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) {
            const int row = rt * 16 + slot_row(sl);
            const int c = (r0 + row) / G;
            live[sl] = row < nrows && c <= c_last;
            qpos[sl] = s0 + c;
          }
#pragma unroll
          for (int j = 0; j < kTokTiles; ++j)
#pragma unroll
            for (int e = 0; e < kCElems; ++e) {
              const int sl = c_slot(e);
              const int pos = t0 + j * 8 + c_col(e);
              const bool valid = live[sl] && pos <= qpos[sl] &&
                                 pos < kv_hi &&
                                 (window <= 0 || pos > qpos[sl] - window);
              s[j].x[e] = valid ? s[j].x[e] * scale2 : kMasked;
            }
        }
        online_softmax(s, m[i], l[i], o[i]);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          FragA pa[kTerms];
          a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
          FragB b[kHdTiles][kKVTerms];
#pragma unroll
          for (int np = 0; np < kHdTiles / 2; ++np)
            if (np * 16 < hd16)
              load_bt2(b[2 * np], b[2 * np + 1], vs, ldkv, np * 16, kk * 16);
          mma_tiles(o[i], pa, b, hd16 / 8);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTasksPerWarp; ++i) {
      const int rt = warp + i * nwarps;
      if (rt >= row_tiles) break;
#pragma unroll
      for (int j = 0; j < kHdTiles; ++j) {
        if (j * 8 >= hd16) break;
#pragma unroll
        for (int e = 0; e < kCElems; ++e) {
          const int row = rt * 16 + c_row(e), d = j * 8 + c_col(e);
          if (row >= nrows || d >= hd) continue;
          const int c = (r0 + row) / G, g = (r0 + row) % G;
          const bool valid = c <= c_last;
          const long long orow = ((long long)b * C + c) * H + h * G + g;
          const float a = o[i][j].x[e];
          if (splits == 1) {
            out[orow * hd + d] =
                valid ? a / fmaxf(l[i][c_slot(e)], 1e-30f) : 0.0f;
          } else {
            // the partial (acc, m, l); a garbage row's is (0, -1e30, 0)
            ws[((long long)split * rows_total + orow) * (hd + 2) + d] =
                valid ? a : 0.0f;
          }
        }
      }
      if (splits > 1) {
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int row = rt * 16 + slot_row(sl);
          if (row >= nrows || !slot_leader()) continue;
          const int c = (r0 + row) / G, g = (r0 + row) % G;
          const bool valid = c <= c_last;
          const long long orow = ((long long)b * C + c) * H + h * G + g;
          float* w = ws + ((long long)split * rows_total + orow) * (hd + 2);
          w[hd] = valid ? m[i][sl] : kMasked;
          w[hd + 1] = valid ? l[i][sl] : 0.0f;
        }
      }
    }
  }
}

// out[row, d] from the `splits` partials of every row (m in base 2).
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
      const float f = exp2f(w[hd] - m);
      l = l + w[hd + 1] * f;
      a = a + w[d] * f;
    }
    out[e] = a / fmaxf(l, 1e-30f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The rows of a block: the (c, g) rows of a (slot, kv head), rounded up
// to whole m16 tiles, at most kRows.
long long block_rows(long long C, long long H, long long kvh) {
  const long long cg = C * (H / kvh);
  const long long r16 = (cg + 15) / 16 * 16;
  return r16 < kRows ? r16 : kRows;
}

// Blocks of one launch without a split, and the split that brings a
// launch with few blocks to about 8 blocks an SM (each run at least two
// tiles of the table's width, at most 32 runs).
long long units_of(long long B, long long C, long long H, long long kvh) {
  const long long cg = C * (H / kvh);
  const long long rows = block_rows(C, H, kvh);
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

template <typename TQ, typename TKV, bool VEC>
int launch_one(const TQ* q, const TKV* k, const TKV* v, const int* table,
               const int* start, const int* q_lens, float* out, float* ws,
               long long C, long long H, long long kvh, long long hd,
               long long P, long long M, long long window, int rows,
               long long units_per_head, int splits, long long units,
               long long rows_total, cudaStream_t s) {
  const int hd16 = (int)(hd + 15) / 16 * 16;
  const size_t smem =
      q_bytes(rows, tile_ld<TQ>(hd16), sizeof(TQ)) +
      (size_t)4 * kTile * tile_ld<TKV>(hd16) * sizeof(TKV) +
      2 * kTile * sizeof(int);
  static size_t opted_in = 48 << 10;     // per instantiation
  if (smem > opted_in) {
    const int err = (int)cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    opted_in = smem;
  }
  const int threads = rows / 16 * 32;
  // scores in base 2: q.k / sqrt(hd) log2(e)
  const float scale2 = (float)(kLog2e / sqrt((double)hd));
  paged_attention_kernel<TQ, TKV, VEC><<<(unsigned)units, threads, smem, s>>>(
      q, k, v, table, start, q_lens, out, ws, (int)C, (int)H, (int)kvh,
      (int)hd, (int)P, (int)M, (int)window, scale2, rows,
      (int)units_per_head, splits, units, rows_total,
      hd % (long long)(16 / sizeof(TQ)) == 0 && aligned16(q));
  return 0;
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* start, const int* q_lens, float* out, float* ws,
           long long B, long long C, long long H, long long kvh, long long hd,
           long long P, long long M, long long window, int splits,
           cudaStream_t s) {
  const long long cg = C * (H / kvh);
  const int rows = (int)block_rows(C, H, kvh);
  const long long units_per_head = (cg + rows - 1) / rows;
  const long long units = B * kvh * units_per_head * splits;
  const long long rows_total = B * C * H;
  const bool vec = hd % (long long)(16 / sizeof(TKV)) == 0 &&
                   aligned16(k) && aligned16(v);
  const auto* qq = static_cast<const TQ*>(q);
  const auto* kk = static_cast<const TKV*>(k);
  const auto* vv = static_cast<const TKV*>(v);
  const int err =
      vec ? launch_one<TQ, TKV, true>(qq, kk, vv, table, start, q_lens, out,
                                      ws, C, H, kvh, hd, P, M, window, rows,
                                      units_per_head, splits, units,
                                      rows_total, s)
          : launch_one<TQ, TKV, false>(qq, kk, vv, table, start, q_lens, out,
                                       ws, C, H, kvh, hd, P, M, window, rows,
                                       units_per_head, splits, units,
                                       rows_total, s);
  if (err != 0) return err;
  if (splits > 1) {
    const int launched = (int)cudaGetLastError();
    if (launched != 0) return launched;
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
  if (hd < 1 || hd > kHd || kvh < 1 || H % kvh)
    return (int)cudaErrorInvalidValue;
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
