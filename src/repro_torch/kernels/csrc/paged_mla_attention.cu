// Absorbed-form paged MLA attention for Hopper, sm_90a.  Plain C
// interface, loaded with ctypes by src/repro_torch/kernels/build.py;
// wrapper in kernels/paged_attention.py (paged_mla_attention).
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
// never reads them): the kernel writes 0 there.  q_rope and the pages
// come in float32 or bf16 and are widened to float32 as they are read;
// all arithmetic is float32.
//
// Design.  Every head reads the same latent rows, so the work is an MQA:
// C H query rows of width r + rope against one key of that width and a
// value of width r per position.  One block of 256 threads serves a tile
// of up to 16 consecutive (c, h) rows of one slot (at H = 16 one query
// position and its 16 heads), so each latent tile is read once per tile
// of rows, not once per head.  The block stages its rows' [q_abs | q_rope]
// in shared memory and walks the slot's positions in tiles of 32 tokens:
//   1. its threads stage the tile's [c_kv | k_rope] rows (a page table
//      lookup per token, 16-byte loads) in shared memory as float32, rows
//      padded to an odd number of 16-byte words so that the 16 tokens a
//      half warp scores spread over the banks;
//   2. 16 threads score one row (two tokens each, reading the query and
//      the keys 16 bytes at a time), take the tile's max and sum by
//      shuffles within the half warp, and keep the row's online-softmax
//      (m, l) in registers; the probabilities and the rescale
//      exp(m_old - m_new) go to shared memory;
//   3. for p.c_kv each thread owns two of the r = 512 latent dims of all
//      16 rows: a 16 x 2 float32 accumulator in registers.
// The walk covers only [the first position the block's rows can attend,
// the last valid query's position]: a tile wholly outside a row's mask
// adds exactly nothing once a valid tile has been seen (its rescale is
// exp(-1e30 - m) = 0), as in the Pallas body, so skipping it is exact.
// With -1e30, not -inf, an all-masked tile gives p = 1 rows that the
// first valid tile's rescale erases, never exp(-inf + inf) = NaN.  The
// final division is acc / max(l, 1e-30), as at :348.  The shared memory
// (114,624 bytes at r = 512, rope = 64) is past the 48 KB default, so the
// launcher opts in with cudaFuncSetAttribute; two blocks fit an SM.
//
// Split context.  A decode pass has H rows a slot: 16 slots make 16
// blocks, far too few for 132 SMs.  So when the blocks are few the
// launcher splits each block's walk into `splits` contiguous runs of
// tiles, one block each; each writes its rows' partial (acc, m, l) to a
// workspace, and a second kernel of the same call merges them:
// m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m).  A
// run with no valid position gives m_s = -1e30 and weighs exactly 0
// beside a valid one.
//
// Bound on this card.  Per (valid row, attended position) the work is
// (r + rope) multiply-adds for the score and r for p.c_kv: 2,176 float32
// operations at r = 512, rope = 64.  A decode pass reads each slot's live
// latent rows once (1,152 bytes a token in bf16) and does 2,176 H ctx
// operations a slot: bound by operations at 67 TFLOP/s, not by bytes,
// which makes the scores and p.c_kv the natural candidates for bf16
// tensor-core tiles (mma / wgmma) in a later kernel.  This first kernel
// is plain SIMT float32 and runs its phases one after another between
// barriers: the tile's loads (not overlapped with the previous tile's
// work), the scores (fed by shared-memory reads: a thread's 16-byte
// reads of its query and two keys give 8 multiply-adds) and p.c_kv, so
// it sits above its bound.  r and rope are multiples of 4.
//
// The host build of the tests compiles this file with a stub header that
// makes one thread play the whole grid: MLA_THREADS 1 and MLA_ROW_LANES 1
// (one thread scores every token of every row) and MLA_SHARED a static
// array in place of the dynamic shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifndef MLA_THREADS
#define MLA_THREADS 256
#endif
#ifndef MLA_ROW_LANES
#define MLA_ROW_LANES 16
#endif
#ifndef MLA_SHARED
#define MLA_SHARED extern __shared__ float mla_smem[]
#endif

namespace {

constexpr int kThreads = MLA_THREADS;
constexpr int kRowLanes = MLA_ROW_LANES;       // threads that score a row
constexpr int kRows = 16;                      // query rows of a block
constexpr int kTile = 32;                      // tokens a tile
constexpr int kMaxRank = 512;                  // r, at most
constexpr int kTpt = kTile / kRowLanes;        // tokens a thread scores
constexpr int kRowsPerPass = kThreads / kRowLanes;
constexpr int kRowsPerThread = (kRows + kRowsPerPass - 1) / kRowsPerPass;
constexpr int kDpt = kMaxRank / kThreads;      // latent dims a thread owns
constexpr int kPStride = 48;                   // probabilities' row stride
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxRank % kThreads == 0, "threads must divide the rank");
static_assert(kTile % kRowLanes == 0 && kTile % 4 == 0, "tile layout");

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

// Max and sum over the kRowLanes threads of a row (aligned groups of a
// warp, so the xor partners stay inside the group).
__device__ __forceinline__ float row_max(float x) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

// VEC: 16-byte loads of the pages (r and rope multiples of
// 16 / sizeof(TKV), both pools 16-byte aligned); else one element a load.
template <typename TQR, typename TKV, bool VEC>
__global__ void __launch_bounds__(kThreads) paged_mla_kernel(
    const float* __restrict__ qa, const TQR* __restrict__ qr,
    const TKV* __restrict__ ckv, const TKV* __restrict__ kr,
    const int* __restrict__ table, const int* __restrict__ start,
    const int* __restrict__ q_lens, float* __restrict__ out,
    float* __restrict__ ws, int C, int H, int r, int rr, int P, int M,
    int window, float scale, int stride, int rows, int units_per_slot,
    int splits, long long units, long long rows_total) {
  MLA_SHARED;
  const int width = r + rr;
  float* ks = mla_smem;                  // kTile x stride
  float* qs = ks + kTile * stride;       // kRows x stride
  float* ps = qs + kRows * stride;       // kRows x kPStride
  float* corr_s = ps + kRows * kPStride;
  float* m_s = corr_s + kRows;
  float* l_s = m_s + kRows;
  constexpr int kVw = VEC ? (int)(16 / sizeof(TKV)) : 1;
  const int tid = (int)threadIdx.x;
  const int r_vecs = r / kVw;
  const int row_vecs = r_vecs + rr / kVw;

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int split = (int)(unit % splits);
    const long long cell = unit / splits;
    const int tile_r = (int)(cell % units_per_slot);
    const int b = (int)(cell / units_per_slot);
    const int r0 = tile_r * rows;
    const int nrows = rows < C * H - r0 ? rows : C * H - r0;
    const long long s0 = start[b];
    const int c_lo = r0 / H;
    const int c_hi = (r0 + nrows - 1) / H;
    const int c_last = c_hi < q_lens[b] - 1 ? c_hi : q_lens[b] - 1;
    // the positions some valid row of the block attends: [kv_lo, kv_hi)
    long long kv_lo = 0, kv_hi = 0;
    if (c_last >= c_lo) {
      kv_hi = s0 + c_last + 1;
      if (kv_hi > (long long)M * P) kv_hi = (long long)M * P;
      if (window > 0 && s0 + c_lo - window + 1 > 0)
        kv_lo = s0 + c_lo - window + 1;
    }
    const long long row0 = (long long)b * C * H + r0;   // (b, c, h) rows

    __syncthreads();                     // the last unit is done with qs
    for (int e = tid; e < nrows * width; e += kThreads) {
      const int i = e / width, d = e % width;
      qs[i * stride + d] = d < r ? qa[(row0 + i) * r + d]
                                 : to_float(qr[(row0 + i) * rr + d - r]);
    }

    float m[kRowsPerThread], l[kRowsPerThread], acc[kRows][kDpt];
    for (int k = 0; k < kRowsPerThread; ++k) {
      m[k] = kMasked;
      l[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      for (int k = 0; k < kDpt; ++k) acc[i][k] = 0.0f;

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
      for (int e = tid; e < kTile * row_vecs; e += kThreads) {
        const int j = e / row_vecs, v = e % row_vecs;
        const bool rope = v >= r_vecs;
        const int d0 = (rope ? v - r_vecs : v) * kVw;
        const long long pos = t0 + j;
        float vals[kVw];
        if (pos >= kv_lo && pos < kv_hi) {
          const int p32 = (int)pos;      // < M P: 32-bit division
          const long long page = table[(long long)b * M + p32 / P];
          const long long tok = page * P + p32 % P;
          const TKV* src = rope ? kr + tok * rr + d0 : ckv + tok * r + d0;
          if constexpr (VEC) {
            unpack(*reinterpret_cast<const Vec16*>(src), vals, TKV());
          } else {
            for (int i = 0; i < kVw; ++i) vals[i] = to_float(src[i]);
          }
        } else {
          for (int i = 0; i < kVw; ++i) vals[i] = 0.0f;
        }
        float* dst = ks + j * stride + (rope ? r : 0) + d0;
        for (int i = 0; i < kVw; ++i) dst[i] = vals[i];
      }
      __syncthreads();

      // scores and the online softmax; every lane of a warp runs the
      // shuffles, rows past nrows among them (their results are dropped)
      const int jj = tid % kRowLanes;
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int i = tid / kRowLanes + k * kRowsPerPass;
        const bool live = i < nrows;
        const int c = (r0 + i) / H;
        const long long qpos = s0 + c;
        const bool row_valid = live && c <= c_last;
        // 16-byte words of the row's query and of the thread's keys
        const float4* q4 = reinterpret_cast<const float4*>(qs + i * stride);
        const float4* k4[kTpt];
        float s[kTpt], sr[kTpt];
        for (int t = 0; t < kTpt; ++t) {
          k4[t] = reinterpret_cast<const float4*>(
              ks + (jj + t * kRowLanes) * stride);
          s[t] = sr[t] = 0.0f;
        }
        // the thread's tokens side by side: independent sums
        for (int d = 0; d < r / 4; ++d) {
          const float4 qd = q4[d];
          for (int t = 0; t < kTpt; ++t) {
            const float4 kd = k4[t][d];
            s[t] = fmaf(qd.x, kd.x, s[t]);
            s[t] = fmaf(qd.y, kd.y, s[t]);
            s[t] = fmaf(qd.z, kd.z, s[t]);
            s[t] = fmaf(qd.w, kd.w, s[t]);
          }
        }
        for (int d = r / 4; d < width / 4; ++d) {
          const float4 qd = q4[d];
          for (int t = 0; t < kTpt; ++t) {
            const float4 kd = k4[t][d];
            sr[t] = fmaf(qd.x, kd.x, sr[t]);
            sr[t] = fmaf(qd.y, kd.y, sr[t]);
            sr[t] = fmaf(qd.z, kd.z, sr[t]);
            sr[t] = fmaf(qd.w, kd.w, sr[t]);
          }
        }
        float tmax = kMasked;
        for (int t = 0; t < kTpt; ++t) {
          const long long pos = t0 + jj + t * kRowLanes;
          const bool valid = row_valid && pos <= qpos && pos < kv_hi &&
                             (window <= 0 || pos > qpos - window);
          s[t] = valid ? (s[t] + sr[t]) * scale : kMasked;
          tmax = fmaxf(tmax, s[t]);
        }
        tmax = row_max(tmax);
        const float m_new = fmaxf(m[k], tmax);
        const float corr = expf(m[k] - m_new);
        float psum = 0.0f;
        for (int t = 0; t < kTpt; ++t) {
          s[t] = expf(s[t] - m_new);
          psum = psum + s[t];
        }
        psum = row_sum(psum);
        if (live) {
          l[k] = l[k] * corr + psum;
          m[k] = m_new;
          for (int t = 0; t < kTpt; ++t)
            ps[i * kPStride + jj + t * kRowLanes] = s[t];
          if (jj == 0) corr_s[i] = corr;
        }
      }
      __syncthreads();

      // p . c_kv: the thread's latent dims d = tid + k kThreads
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nrows) {
          const float corr = corr_s[i];
          for (int k = 0; k < kDpt; ++k) acc[i][k] = acc[i][k] * corr;
        }
      }
      for (int j = 0; j < kTile; j += 4) {
        float kv[4][kDpt];
        for (int u = 0; u < 4; ++u)
          for (int k = 0; k < kDpt; ++k) {
            const int d = tid + k * kThreads;
            kv[u][k] = d < r ? ks[(j + u) * stride + d] : 0.0f;
          }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i < nrows) {
            const float4 p =
                *reinterpret_cast<const float4*>(ps + i * kPStride + j);
            for (int k = 0; k < kDpt; ++k) {
              float a = acc[i][k];
              a = fmaf(p.x, kv[0][k], a);
              a = fmaf(p.y, kv[1][k], a);
              a = fmaf(p.z, kv[2][k], a);
              a = fmaf(p.w, kv[3][k], a);
              acc[i][k] = a;
            }
          }
        }
      }
    }

    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = tid / kRowLanes + k * kRowsPerPass;
      if (i < nrows && tid % kRowLanes == 0) {
        m_s[i] = m[k];
        l_s[i] = l[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nrows) continue;
      const bool valid = (r0 + i) / H <= c_last;
      const long long row = row0 + i;
      if (splits == 1) {
        const float den = fmaxf(l_s[i], 1e-30f);
        for (int k = 0; k < kDpt; ++k) {
          const int d = tid + k * kThreads;
          if (d < r) out[row * r + d] = valid ? acc[i][k] / den : 0.0f;
        }
      } else {
        // the partial (acc, m, l); a garbage row's is (0, -1e30, 0)
        float* w = ws + ((long long)split * rows_total + row) * (r + 2);
        for (int k = 0; k < kDpt; ++k) {
          const int d = tid + k * kThreads;
          if (d < r) w[d] = valid ? acc[i][k] : 0.0f;
        }
        if (tid == 0) {
          w[r] = valid ? m_s[i] : kMasked;
          w[r + 1] = valid ? l_s[i] : 0.0f;
        }
      }
    }
  }
}

// out[row, d] from the `splits` partials of every row.
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
      const float f = expf(w[r] - m);
      l = l + w[r + 1] * f;
      a = a + w[d] * f;
    }
    out[e] = a / fmaxf(l, 1e-30f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks of one launch without a split, and the split that brings a
// launch with few blocks to about two blocks an SM (each run at least
// two tiles of the table's width, at most 32 runs).
long long units_of(long long B, long long C, long long H) {
  const long long ch = C * H;
  const long long rows = ch < kRows ? ch : kRows;
  return B * ((ch + rows - 1) / rows);
}

int splits_for(long long units, long long P, long long M) {
  const long long target = 132 * 2;
  if (units <= 0 || units * 2 >= target) return 1;
  long long s = (target + units - 1) / units;
  const long long by_ctx = (M * P) / (2 * kTile);
  if (s > by_ctx) s = by_ctx;
  if (s > 32) s = 32;
  return s < 1 ? 1 : (int)s;
}

// A staged row's stride in floats: an odd number of 16-byte words, so
// that 8 consecutive tokens' words start in 8 distinct groups of 4 banks.
int row_stride(long long r, long long rr) {
  const int w4 = (int)((r + rr + 3) / 4);
  return 4 * (w4 % 2 ? w4 + 2 : w4 + 1);
}

size_t shared_bytes(int stride) {
  return ((size_t)(kTile + kRows) * (size_t)stride +
          (size_t)kRows * (kPStride + 3)) * sizeof(float);
}

template <typename TQR, typename TKV, bool VEC>
int launch_one(const float* qa, const void* qr, const void* ckv,
               const void* kr, const int* table, const int* start,
               const int* q_lens, float* out, float* ws, long long C,
               long long H, long long r, long long rr, long long P,
               long long M, long long window, float scale, int rows,
               long long units_per_slot, int splits, long long units,
               long long rows_total, cudaStream_t s) {
  const int stride = row_stride(r, rr);
  const size_t smem = shared_bytes(stride);
  static size_t opted_in = 0;            // per instantiation
  if (smem > opted_in) {
    const int err = (int)cudaFuncSetAttribute(
        paged_mla_kernel<TQR, TKV, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    opted_in = smem;
  }
  paged_mla_kernel<TQR, TKV, VEC><<<(unsigned)units, kThreads, smem, s>>>(
      qa, static_cast<const TQR*>(qr), static_cast<const TKV*>(ckv),
      static_cast<const TKV*>(kr), table, start, q_lens, out, ws, (int)C,
      (int)H, (int)r, (int)rr, (int)P, (int)M, (int)window, scale, stride,
      rows, (int)units_per_slot, splits, units, rows_total);
  return 0;
}

template <typename TQR, typename TKV>
int launch(const float* qa, const void* qr, const void* ckv, const void* kr,
           const int* table, const int* start, const int* q_lens, float* out,
           float* ws, long long B, long long C, long long H, long long r,
           long long rr, long long P, long long M, long long window,
           float scale, int splits, cudaStream_t s) {
  const long long ch = C * H;
  const int rows = (int)(ch < kRows ? ch : kRows);
  const long long units_per_slot = (ch + rows - 1) / rows;
  const long long units = B * units_per_slot * splits;
  const long long rows_total = B * ch;
  constexpr long long vw = (long long)(16 / sizeof(TKV));
  const bool vec = r % vw == 0 && rr % vw == 0 && aligned16(ckv) &&
                   aligned16(kr);
  const int err =
      vec ? launch_one<TQR, TKV, true>(qa, qr, ckv, kr, table, start, q_lens,
                                       out, ws, C, H, r, rr, P, M, window,
                                       scale, rows, units_per_slot, splits,
                                       units, rows_total, s)
          : launch_one<TQR, TKV, false>(qa, qr, ckv, kr, table, start,
                                        q_lens, out, ws, C, H, r, rr, P, M,
                                        window, scale, rows, units_per_slot,
                                        splits, units, rows_total, s);
  if (err != 0) return err;
  if (splits > 1) {
    const int launched = (int)cudaGetLastError();
    if (launched != 0) return launched;
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
