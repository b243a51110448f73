// Absorbed-form paged MLA attention for Hopper, sm_90a, on the bf16
// tensor cores.  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/build.py; wrapper in kernels/paged_attention.py
// (paged_mla_attention).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//
//   paged_mla_attention  <- paged_mla_attention_pallas  (:354, pallas_call
//                           :393)
//
// What it computes is the oracle paged_mla_attention_ref (:146): slot b's
// query row (c, h) -- q_abs (B, C, H, r), the nope query with W_uk folded
// in, and q_rope (B, C, H, rope) -- sits at position start[b] + c and
// attends, through the page table row table[b, :M], every position
// p <= start[b] + c of the latent pages c_kv (NP, P, r) and k_rope
// (NP, P, rope), and with a sliding window only those
// p > start[b] + c - window.  Scores are (q_abs.c_kv + q_rope.k_rope) *
// scale, masked ones -1e30, softmax over positions, then p.c_kv: the
// output is the latent (B, C, H, r) in float32, to which the caller
// applies W_uv.  Rows c >= q_lens[b] are garbage by contract (the engine
// never reads them): the kernel writes 0 there.  q_abs is float32;
// q_rope and the pages come in float32 or bf16.
//
// Design (tensor_tiles.cuh has the fragments and the precision rules).
// Every head reads the same latent rows, so the work is an MQA: C H query
// rows of width r + rope against one key of that width and a value of
// width r per position.  One block serves up to 64 consecutive (c, h)
// rows of one slot (at H = 16, four query positions), so each latent tile
// is read once for 64 rows.  Its 16-row tiles are split over warps by
// latent dims: two warps a row tile, one for dims [0, 256) and one for
// [256, 512), each holding its 16 x 256 float32 accumulator in registers
// (128 a lane).  The block keeps its rows' q_abs in shared memory as
// float32 and q_rope in its own type, and walks the slot's positions in
// tiles of 32 tokens, double-buffered: while the warps work on one tile,
// cp.async brings the next tile's [c_kv | k_rope] rows (a page-table
// lookup per token, 16-byte copies, zeros outside the walk and in the
// padding to multiples of 16) into the other stage, bf16 pages as bf16,
// never widened.  Per tile:
//   1. each warp computes its half of the scores' k dimension (its 256
//      c_kv dims and every other 16 of rope) with m16n8k16 MMAs and puts
//      the partial 16 x 32 scores in shared memory;
//   2. after a barrier both warps of a row tile add the two partials in
//      the same order, mask and scale them, run the same online softmax
//      on the fragments (row max and sum by shuffles in each lane quad),
//      and accumulate p.c_kv into their own 256 dims, the probabilities
//      taken straight from the score fragments.
// Terms: q_abs is float32 and enters as three bf16 terms, split as its
// fragments are loaded; bf16 q_rope and pages go in as they are, float32
// ones as three terms; p always as three (deepseek's path: 3 MMAs a score
// tile of c_kv, 1 of rope, 3 a p.c_kv tile).  The walk covers only [the
// first position the block's rows can attend, the last valid query's
// position]: a tile wholly outside a row's mask adds exactly nothing once
// a valid tile has been seen (its rescale is exp(-1e30 - m) = 0), as in
// the Pallas body, so skipping it is exact; a row tile whose rows are all
// past q_lens skips its MMAs.  The final division is acc / max(l, 1e-30),
// as at :348.  At r = 512, rope = 64, bf16, 64 rows: 131,072 bytes of
// q_abs, 8,192 of q_rope, 73,728 of latent stages, 16,384 of partial
// scores and 256 of the two tiles' page rows, 229,632 bytes of dynamic
// shared memory (opted in with cudaFuncSetAttribute; one block an SM).
// Where a type pair needs more than the 232,448 bytes a block may have
// (float32 pages at r = 512), the launcher takes fewer rows a block.
//
// Split context.  A decode pass has H rows a slot: 16 slots make 16
// blocks of one row tile, far too few for 132 SMs.  So when the blocks
// are few the launcher splits each block's walk into `splits` contiguous
// runs of tiles, one block each; each writes its rows' partial
// (acc, m, l) to a workspace, and a second kernel of the same call merges
// them: m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s
// exp(m_s - m).  A run with no valid position gives m_s = -1e30 and
// weighs exactly 0 beside a valid one.
//
// Bound on this card.  Per (valid row, attended position) the work is
// (r + rope) multiply-adds for the score and r for p.c_kv: 2,176
// operations at r = 512, rope = 64.  A chunked-prefill pass (C = 256,
// 16 slots of 2,048 tokens, 16 heads) moves about 296 MB (the float32
// q_abs and latent output dominate): 0.088 ms at 3.35 TB/s; its operations
// take 0.071 ms at the 989 TFLOP/s of the bf16 tensor cores, and with the
// terms three times the MMAs.  A decode pass reads each slot's live
// latent rows once (1,152 bytes a token in bf16): bound by bytes.
//
// Measured (chip_smoke.py, phase paged-mla-kernel, NVIDIA H100 80GB
// HBM3, 700 W): the largest error against the float32 plain version
// 3.1e-6 at C = 256 (4.4e-6 with a window) and 6.0e-7 at C = 1, inside
// rtol 1e-4 / atol 1e-5 with three terms for every float32 operand
// (q_abs and p); times in PERF.md.  Fewer terms for both, built with
// kTerms edited and run through the same phases: two hold that tolerance
// on the card (4.8e-6 and 1.1e-6, 14% faster at C = 256) but not the
// host tests' 1e-5 (32 of their 160 cases fail); one does not hold it
// (2.6e-3).  So three are kept.
//
// The host build of the tests compiles this file with a stub header that
// makes one thread play the whole grid (one warp of one lane that works
// every (row tile, half) of its block) and defines TC_HOST_FRAGMENTS.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tensor_tiles.cuh"

namespace {

using namespace tc;

constexpr int kTile = 32;                  // tokens a latent tile
constexpr int kRows = 64;                  // query rows of a block, at most
constexpr int kMaxRank = 512;              // r, at most
constexpr int kHalfTiles = kMaxRank / 16;  // n8 output tiles of a warp
constexpr int kTokTiles = kTile / 8;       // n8 tiles of a score tile
constexpr size_t kMaxShared = 232448;      // dynamic shared memory a block

// The block's shared-memory layout, in bytes from its start.
struct Layout {
  int r16, rr16, ldqa, ldqr, ldl;
  size_t qr, lat, sx, tok, total;
};

template <typename TQR, typename TKV>
__host__ __device__ __forceinline__ Layout layout(int rows, int rank,
                                                  int rope) {
  Layout s;
  s.r16 = (rank + 15) / 16 * 16;
  s.rr16 = (rope + 15) / 16 * 16;
  s.ldqa = tile_ld<float>(s.r16);
  s.ldqr = tile_ld<TQR>(s.rr16);
  s.ldl = tile_ld<TKV>(s.r16 + s.rr16);
  s.qr = (size_t)rows * s.ldqa * sizeof(float);
  s.lat = s.qr + (size_t)rows * s.ldqr * sizeof(TQR);
  s.sx = s.lat + (size_t)2 * kTile * s.ldl * sizeof(TKV);
  s.tok = s.sx + (size_t)rows * 2 * kTile * sizeof(float);
  s.total = s.tok + (size_t)2 * kTile * sizeof(int);
  return s;
}

// The tile of positions [t0, t0 + kTile) into dst, rows [c_kv | k_rope],
// its pool rows from tile_rows: positions outside the walk (row -1) and
// the padding of each part to a multiple of 16 are zeros.  VEC: 16-byte
// asynchronous copies (r and rope multiples of 16 / sizeof(TKV), both
// pools 16-byte aligned); else one element a load.
template <typename TKV, bool VEC>
__device__ __forceinline__ void load_latent_tile(
    TKV* dst, const TKV* __restrict__ ckv, const TKV* __restrict__ kr,
    const int* rows, int rank, int rope, int r16, int rr16, int ld) {
  constexpr int kVw = VEC ? (int)(16 / sizeof(TKV)) : 1;
  const int per_row = (r16 + rr16) / kVw;
  for (int e = (int)threadIdx.x; e < kTile * per_row;
       e += (int)blockDim.x) {
    const int j = e / per_row, d0 = (e - j * per_row) * kVw;
    const int tok = rows[j];
    const bool in_rope = d0 >= r16;
    const int d = in_rope ? d0 - r16 : d0;
    const bool valid = tok >= 0 && d < (in_rope ? rope : rank);
    const TKV* src = !valid ? ckv
                     : in_rope ? kr + (long long)tok * rope + d
                               : ckv + (long long)tok * rank + d;
    TKV* to = dst + tile_at<TKV>(j, d0, ld);
    if constexpr (VEC) {
      cp_async16(to, src, valid);
    } else {
      *to = valid ? *src : TKV(0);
    }
  }
}

template <typename TQR, typename TKV, bool VEC>
__global__ void __launch_bounds__(kRows * 4, 1) paged_mla_kernel(
    const float* __restrict__ qa, const TQR* __restrict__ qr,
    const TKV* __restrict__ ckv, const TKV* __restrict__ kr,
    const int* __restrict__ table, const int* __restrict__ start,
    const int* __restrict__ q_lens, float* __restrict__ out,
    float* __restrict__ ws, int C, int H, int rank, int rope, int P, int M,
    int window, float scale2, int rows, int units_per_slot, int splits,
    long long units, long long rows_total, bool qvec) {
  constexpr int kQRTerms = Terms<TQR>::n, kKVTerms = Terms<TKV>::n;
  const Layout ly = layout<TQR, TKV>(rows, rank, rope);
  const int r16 = ly.r16, rr16 = ly.rr16, ldl = ly.ldl;
  unsigned char* smem = dyn_smem();
  float* qa_s = reinterpret_cast<float*>(smem);
  TQR* qr_s = reinterpret_cast<TQR*>(smem + ly.qr);
  TKV* lat_s = reinterpret_cast<TKV*>(smem + ly.lat);
  float* sx = reinterpret_cast<float*>(smem + ly.sx);
  int* tok_s = reinterpret_cast<int*>(smem + ly.tok);   // 2 tiles
  const int row_tiles = rows / 16;
  const int warp = warp_id(), nwarps = num_warps();
  // the k steps of the scores' c_kv part, halved between the two warps of
  // a row tile; the output's n8 tiles, 32 a warp
  const int nks = r16 / 16, ks_half = (nks + 1) / 2;
  const int nrs = rr16 / 16, n_out = r16 / 8;

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int split = (int)(unit % splits);
    const long long cell = unit / splits;
    // a slot's last row tiles, whose walks are longest, first
    const int tile_r = units_per_slot - 1 - (int)(cell % units_per_slot);
    const int b = (int)(cell / units_per_slot);
    const int r0 = tile_r * rows;
    const int nrows = rows < C * H - r0 ? rows : C * H - r0;
    const int s0 = start[b];
    const int c_lo = r0 / H;
    const int c_hi = (r0 + nrows - 1) / H;
    const int c_last = c_hi < q_lens[b] - 1 ? c_hi : q_lens[b] - 1;
    // the positions some valid row of the block attends: [kv_lo, kv_hi)
    int kv_lo = 0, kv_hi = 0;
    if (c_last >= c_lo) {
      kv_hi = s0 + c_last + 1;
      if (kv_hi > M * P) kv_hi = M * P;
      if (window > 0 && s0 + c_lo - window + 1 > 0)
        kv_lo = s0 + c_lo - window + 1;
    }
    const long long row0 = (long long)b * C * H + r0;   // (b, c, h) rows
    const int* table_b = table + (long long)b * M;

    __syncthreads();                     // the last unit is done with smem

    FragC o[kTasksPerWarp][kHalfTiles];
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
      const auto qa_row = [&](int i) { return qa + (row0 + i) * rank; };
      const auto qr_row = [&](int i) { return qr + (row0 + i) * rope; };
      if (qvec) {
        stage_rows<true>(qa_s, ly.ldqa, rows, r16, nrows, rank, qa_row);
        stage_rows<true>(qr_s, ly.ldqr, rows, rr16, nrows, rope, qr_row);
      } else {
        stage_rows<false>(qa_s, ly.ldqa, rows, r16, nrows, rank, qa_row);
        stage_rows<false>(qr_s, ly.ldqr, rows, rr16, nrows, rope, qr_row);
      }
      tile_rows(tok_s, table_b, t_begin, kTile, kv_lo, kv_hi, P);
      __syncthreads();
      load_latent_tile<TKV, VEC>(lat_s, ckv, kr, tok_s, rank, rope, r16, rr16,
                                 ldl);
      cp_async_commit();
      if (t_begin + kTile < t_end)
        tile_rows(tok_s + kTile, table_b, t_begin + kTile, kTile, kv_lo,
                  kv_hi, P);
    }
    int stage = 0;
    for (int t0 = t_begin; t0 < t_end; t0 += kTile, stage ^= 1) {
      cp_async_wait_all();
      __syncthreads();   // the tile landed; the other stage and sx are free
      if (t0 + kTile < t_end) {
        load_latent_tile<TKV, VEC>(lat_s + (stage ^ 1) * kTile * ldl, ckv,
                                   kr, tok_s + (stage ^ 1) * kTile, rank,
                                   rope, r16, rr16, ldl);
        cp_async_commit();
      }
      if (t0 + 2 * kTile < t_end)
        tile_rows(tok_s + stage * kTile, table_b, t0 + 2 * kTile, kTile,
                  kv_lo, kv_hi, P);
      const TKV* lat = lat_s + stage * kTile * ldl;

      // 1. each warp's half of the scores' k dimension
#pragma unroll
      for (int i = 0; i < kTasksPerWarp; ++i) {
        const int task = warp + i * nwarps;
        if (task >= 2 * row_tiles) break;
        const int rt = task >> 1, half = task & 1;
        if ((r0 + rt * 16) / H > c_last) continue;   // no valid row
        FragC sp[kTokTiles];
        zero(sp);
        const int ks_end = (half + 1) * ks_half < nks ? (half + 1) * ks_half
                                                      : nks;
        // not unrolled: unrolling spills the 128 accumulator registers
#pragma unroll 1
        for (int ks = half * ks_half; ks < ks_end; ++ks) {
          FragA a[kTerms];
          load_a(a, qa_s, ly.ldqa, rt * 16, ks * 16);
          FragB b[kTokTiles][kKVTerms];
#pragma unroll
          for (int np = 0; np < kTokTiles / 2; ++np)
            load_b2(b[2 * np], b[2 * np + 1], lat, ldl, np * 16, ks * 16);
          mma_tiles(sp, a, b);
        }
        for (int ks = half; ks < nrs; ks += 2) {
          FragA a[kQRTerms];
          load_a(a, qr_s, ly.ldqr, rt * 16, ks * 16);
          FragB b[kTokTiles][kKVTerms];
#pragma unroll
          for (int np = 0; np < kTokTiles / 2; ++np)
            load_b2(b[2 * np], b[2 * np + 1], lat, ldl, np * 16,
                    r16 + ks * 16);
          mma_tiles(sp, a, b);
        }
        float* mine = sx + (rt * 2 + half) * 16 * kTile;
#pragma unroll
        for (int j = 0; j < kTokTiles; ++j)
#pragma unroll
          for (int e = 0; e < kCElems; ++e)
            mine[tile_at<float>(c_row(e), j * 8 + c_col(e), kTile)] =
                sp[j].x[e];
      }
      __syncthreads();

      // 2. the row tile's scores, its softmax, and p.c_kv into the warp's
      // latent dims
#pragma unroll
      for (int i = 0; i < kTasksPerWarp; ++i) {
        const int task = warp + i * nwarps;
        if (task >= 2 * row_tiles) break;
        const int rt = task >> 1, half = task & 1;
        if ((r0 + rt * 16) / H > c_last) continue;
        const float* s_lo = sx + rt * 2 * 16 * kTile;
        const float* s_hi = s_lo + 16 * kTile;
        FragC s[kTokTiles];
#pragma unroll
        for (int j = 0; j < kTokTiles; ++j)
#pragma unroll
          for (int e = 0; e < kCElems; ++e) {
            const int at = tile_at<float>(c_row(e), j * 8 + c_col(e), kTile);
            s[j].x[e] = (s_lo[at] + s_hi[at]) * scale2;
          }
        // the live rows' first and last positions: a tile they all see
        // whole needs no mask (rows past q_lens or nrows are never read)
        const int last = (r0 + rt * 16 + 15 < r0 + nrows
                              ? r0 + rt * 16 + 15 : r0 + nrows - 1) / H;
        const int q_first = s0 + (r0 + rt * 16) / H;
        const int q_last = s0 + (last < c_last ? last : c_last);
        if (!(t0 + kTile - 1 <= q_first && t0 + kTile <= kv_hi &&
              (window <= 0 || t0 > q_last - window))) {
          int qpos[kSlots];
          bool live[kSlots];
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) {
            const int row = rt * 16 + slot_row(sl);
            const int c = (r0 + row) / H;
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
              if (!valid) s[j].x[e] = kMasked;
            }
        }
        online_softmax(s, m[i], l[i], o[i]);
        const int n0 = half * kHalfTiles;
        const int n_mine = n_out - n0 < kHalfTiles ? n_out - n0 : kHalfTiles;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          FragA pa[kTerms];
          a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
          // four output tiles at a time: 12 MMAs, 4 independent a round
#pragma unroll
          for (int nq = 0; nq < kHalfTiles / 4; ++nq) {
            if (4 * nq >= n_mine) break;
            FragB b[4][kKVTerms];
            load_bt2(b[0], b[1], lat, ldl, (n0 + 4 * nq) * 8, kk * 16);
            load_bt2(b[2], b[3], lat, ldl, (n0 + 4 * nq + 2) * 8, kk * 16);
            mma_tiles(o[i] + 4 * nq, pa, b, n_mine - 4 * nq);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTasksPerWarp; ++i) {
      const int task = warp + i * nwarps;
      if (task >= 2 * row_tiles) break;
      const int rt = task >> 1, half = task & 1;
      const int n0 = half * kHalfTiles;
#pragma unroll
      for (int j = 0; j < kHalfTiles; ++j) {
        if (n0 + j >= n_out) break;
#pragma unroll
        for (int e = 0; e < kCElems; ++e) {
          const int row = rt * 16 + c_row(e), d = (n0 + j) * 8 + c_col(e);
          if (row >= nrows || d >= rank) continue;
          const bool valid = (r0 + row) / H <= c_last;
          const long long orow = row0 + row;
          const float a = o[i][j].x[e];
          if (splits == 1) {
            out[orow * rank + d] =
                valid ? a / fmaxf(l[i][c_slot(e)], 1e-30f) : 0.0f;
          } else {
            // the partial (acc, m, l); a garbage row's is (0, -1e30, 0)
            ws[((long long)split * rows_total + orow) * (rank + 2) + d] =
                valid ? a : 0.0f;
          }
        }
      }
      if (splits > 1 && half == 0) {
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int row = rt * 16 + slot_row(sl);
          if (row >= nrows || !slot_leader()) continue;
          const bool valid = (r0 + row) / H <= c_last;
          float* w = ws + ((long long)split * rows_total + row0 + row) *
                              (rank + 2);
          w[rank] = valid ? m[i][sl] : kMasked;
          w[rank + 1] = valid ? l[i][sl] : 0.0f;
        }
      }
    }
  }
}

// out[row, d] from the `splits` partials of every row (m in base 2).
__global__ void __launch_bounds__(256) paged_mla_merge_kernel(
    const float* __restrict__ ws, float* __restrict__ out,
    long long rows_total, int r, int splits) {
  const long long n = rows_total * r;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / r;
    const int d = (int)(e % r);
    float m = kMasked;
    for (int s = 0; s < splits; ++s)
      m = fmaxf(m, ws[((long long)s * rows_total + row) * (r + 2) + r]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* w = ws + ((long long)s * rows_total + row) * (r + 2);
      const float f = exp2f(w[r] - m);
      l = l + w[r + 1] * f;
      a = a + w[d] * f;
    }
    out[e] = a / fmaxf(l, 1e-30f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The rows of a block on the main path: the (c, h) rows of a slot,
// rounded up to whole m16 tiles, at most kRows.
long long block_rows(long long C, long long H) {
  const long long r16 = (C * H + 15) / 16 * 16;
  return r16 < kRows ? r16 : kRows;
}

// Blocks of one launch without a split, and the split that brings a
// launch with few blocks to at most two blocks an SM, one wave (a decode
// block of 16 rows takes 112,896 bytes of shared memory; each run at
// least two tiles of the table's width, at most 32 runs).
long long units_of(long long B, long long C, long long H) {
  const long long rows = block_rows(C, H);
  return B * ((C * H + rows - 1) / rows);
}

int splits_for(long long units, long long P, long long M) {
  const long long target = 132 * 2;
  if (units <= 0 || units * 2 >= target) return 1;
  long long s = target / units;
  const long long by_ctx = (M * P) / (2 * kTile);
  if (s > by_ctx) s = by_ctx;
  if (s > 32) s = 32;
  return s < 1 ? 1 : (int)s;
}

template <typename TQR, typename TKV, bool VEC>
int launch_one(const float* qa, const TQR* qr, const TKV* ckv, const TKV* kr,
               const int* table, const int* start, const int* q_lens,
               float* out, float* ws, long long B, long long C, long long H,
               long long r, long long rr, long long P, long long M,
               long long window, float scale, int splits, cudaStream_t s) {
  // the most rows the shared memory holds
  int rows = (int)block_rows(C, H);
  while (rows > 16 &&
         layout<TQR, TKV>(rows, (int)r, (int)rr).total > kMaxShared)
    rows -= 16;
  const size_t smem = layout<TQR, TKV>(rows, (int)r, (int)rr).total;
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  static size_t opted_in = 48 << 10;     // per instantiation
  if (smem > opted_in) {
    const int err = (int)cudaFuncSetAttribute(
        paged_mla_kernel<TQR, TKV, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    opted_in = smem;
  }
  const long long units_per_slot = (C * H + rows - 1) / rows;
  const long long units = B * units_per_slot * splits;
  const int threads = rows / 16 * 2 * 32;
  const float scale2 = (float)(scale * kLog2e);   // scores in base 2
  paged_mla_kernel<TQR, TKV, VEC><<<(unsigned)units, threads, smem, s>>>(
      qa, qr, ckv, kr, table, start, q_lens, out, ws, (int)C, (int)H, (int)r,
      (int)rr, (int)P, (int)M, (int)window, scale2, rows,
      (int)units_per_slot, splits, units, B * C * H,
      aligned16(qa) && aligned16(qr) &&
          rr % (long long)(16 / sizeof(TQR)) == 0);
  return 0;
}

template <typename TQR, typename TKV>
int launch(const float* qa, const void* qr, const void* ckv, const void* kr,
           const int* table, const int* start, const int* q_lens, float* out,
           float* ws, long long B, long long C, long long H, long long r,
           long long rr, long long P, long long M, long long window,
           float scale, int splits, cudaStream_t s) {
  constexpr long long vw = (long long)(16 / sizeof(TKV));
  const bool vec = r % vw == 0 && rr % vw == 0 && aligned16(ckv) &&
                   aligned16(kr);
  const auto* q2 = static_cast<const TQR*>(qr);
  const auto* c2 = static_cast<const TKV*>(ckv);
  const auto* k2 = static_cast<const TKV*>(kr);
  const int err =
      vec ? launch_one<TQR, TKV, true>(qa, q2, c2, k2, table, start, q_lens,
                                       out, ws, B, C, H, r, rr, P, M, window,
                                       scale, splits, s)
          : launch_one<TQR, TKV, false>(qa, q2, c2, k2, table, start, q_lens,
                                        out, ws, B, C, H, r, rr, P, M, window,
                                        scale, splits, s);
  if (err != 0) return err;
  if (splits > 1) {
    const int launched = (int)cudaGetLastError();
    if (launched != 0) return launched;
    const long long rows_total = B * C * H;
    long long blocks = (rows_total * r + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    paged_mla_merge_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        ws, out, rows_total, (int)r, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of runs paged_mla_attention splits each block's walk into;
// with more than one it needs a float32 workspace of splits x B C H x
// (r + 2).
int paged_mla_attention_splits(long long B, long long C, long long H,
                               long long P, long long M) {
  return splits_for(units_of(B, C, H), P, M);
}

// q_abs (B, C, H, r) float32, q_rope (B, C, H, rope) float32 or bf16
// (qr_bf16), the c_kv (NP, P, r) and k_rope (NP, P, rope) pages float32
// or bf16 (pages_bf16), table (B, M) / start (B,) / q_lens (B,) int32,
// out (B, C, H, r) float32, ws the workspace (unused with one split);
// window <= 0 means none.  r <= 512, and r and rope multiples of 4 (the
// wrapper checks).  Returns
// cudaGetLastError() after the launches (0 = ok); `stream` is a
// cudaStream_t.
int paged_mla_attention(const float* q_abs, const void* q_rope, int qr_bf16,
                        const void* ckv, const void* kr, int pages_bf16,
                        const int* table, const int* start,
                        const int* q_lens, float* out, float* ws,
                        long long B, long long C, long long H, long long r,
                        long long rr, long long P, long long M,
                        long long window, float scale, int splits,
                        void* stream) {
  if (B * C * H == 0) return 0;
  if (r > kMaxRank || r < 1 || rr < 0 || r % 4 || rr % 4)
    return (int)cudaErrorInvalidValue;
  if (splits < 1) splits = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qr_bf16 && pages_bf16)
    return launch<uint16_t, uint16_t>(q_abs, q_rope, ckv, kr, table, start,
                                      q_lens, out, ws, B, C, H, r, rr, P, M,
                                      window, scale, splits, s);
  if (qr_bf16)
    return launch<uint16_t, float>(q_abs, q_rope, ckv, kr, table, start,
                                   q_lens, out, ws, B, C, H, r, rr, P, M,
                                   window, scale, splits, s);
  if (pages_bf16)
    return launch<float, uint16_t>(q_abs, q_rope, ckv, kr, table, start,
                                   q_lens, out, ws, B, C, H, r, rr, P, M,
                                   window, scale, splits, s);
  return launch<float, float>(q_abs, q_rope, ckv, kr, table, start, q_lens,
                              out, ws, B, C, H, r, rr, P, M, window, scale,
                              splits, s);
}

const char* paged_mla_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
