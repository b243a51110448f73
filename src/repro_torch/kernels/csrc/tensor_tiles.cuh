// Warp-level bf16 tensor-core tiles of the paged-attention kernels
// (paged_attention.cu, paged_mla_attention.cu), sm_90a.
//
// A warp multiplies a 16 x 16 tile A by a 16 x 8 tile B into a 16 x 8
// float32 accumulator C with mma.sync.aligned.m16n8k16.row.col.f32.bf16
// .bf16.f32; ldmatrix feeds bf16 operands from shared memory.  mma.sync
// and not wgmma: these kernels are bound by the bytes of their pages
// (GQA) or come within a few times of the tensor cores with 16-row warp
// tiles (MLA), and the accumulator of p.v is built from the score
// accumulator in registers (the FlashAttention-2 form), which mma.sync's
// fragment layouts allow directly.
//
// Precision.  A product of two bf16 values is exact in float32, so bf16
// operands go in as they are.  A float32 operand x is split into
// kTerms = 3 bf16 terms, each rounded (to nearest even) from the
// remainder of the last: x = hi + mid + lo to float32's 24 bits.
// mma_tiles runs one MMA per pair of terms (i, j) with i + j < 3, all
// into the same float32 accumulator: the pairs left out weigh at most
// 2^-24 of the product.  Tiles keep their own type in shared memory:
// bf16 tiles are never widened, float32 tiles are split as their
// fragments are loaded.
//
// Shared tiles are swizzled, not padded: element (row, col) of a tile of
// row stride ld sits at tile_at<T>(row, col, ld).  bf16: the 16-byte
// chunk index is XORed with row & 7 (ld a multiple of 64), so the eight
// rows an ldmatrix reads hit distinct banks; float32: the column is XORed
// with 8 (row & 3) (ld a multiple of 32), so the four rows of a half
// warp's 8-byte fragment loads do.  A 16-byte chunk stays whole.
//
// The kernels reach the fragments only through what this header defines
// after the portable part: the types FragA, FragB, FragC, the loads
// load_a, load_b2 (B from a tile stored [n][k]) and load_bt2 (stored
// [k][n]), a_from_c (the A operand from two accumulators), mma, the
// ownership of accumulator elements (c_row, c_col, c_slot, slot_row,
// slot_leader, kCElems, kSlots), quad_max / quad_sum over the lanes of a
// row, warp_id / num_warps / kTasksPerWarp, cp_async16 / cp_async_commit
// / cp_async_wait_all and dyn_smem.  A host build of the tests defines
// TC_HOST_FRAGMENTS, the name of a header that implements them as plain
// loops in which one lane owns the whole fragment.
#pragma once

#include <stdint.h>

namespace tc {

constexpr int kTerms = 3;              // bf16 terms of a float32 operand
constexpr float kMasked = -1e30f;      // a masked score, never -inf
constexpr double kLog2e = 1.4426950408889634;

// The bf16 terms an operand stored as T enters the MMAs as.
template <typename T> struct Terms { static constexpr int n = kTerms; };
template <> struct Terms<uint16_t> { static constexpr int n = 1; };

template <typename T>
__device__ __forceinline__ int tile_at(int row, int col, int ld);
template <>
__device__ __forceinline__ int tile_at<uint16_t>(int row, int col, int ld) {
  return row * ld + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}
template <>
__device__ __forceinline__ int tile_at<float>(int row, int col, int ld) {
  return row * ld + (col ^ ((row & 3) << 3));
}

// The row stride of a shared tile `width` elements wide.
template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int width) {
  const int q = sizeof(T) == 2 ? 64 : 32;
  return (width + q - 1) / q * q;
}

#ifdef TC_HOST_FRAGMENTS
#include TC_HOST_FRAGMENTS
#else

struct FragA { uint32_t x[4]; };       // 16 x 16 bf16, row major
struct FragB { uint32_t x[2]; };       // 16 x 8 bf16 (k x n), col major
struct FragC { float x[4]; };          // 16 x 8 float32

constexpr int kCElems = 4;             // accumulator elements of a lane
constexpr int kSlots = 2;              // accumulator rows of a lane
constexpr int kTasksPerWarp = 1;       // row tiles (tasks) of a warp

__device__ __forceinline__ int lane_id() { return (int)threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return (int)threadIdx.x >> 5; }
__device__ __forceinline__ int num_warps() { return (int)blockDim.x >> 5; }

// Element e of a lane's accumulator: row lane/4 (+8 for e >= 2), column
// 2 (lane % 4) + e % 2; its row slot is e / 2.
__device__ __forceinline__ int c_row(int e) {
  return (lane_id() >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int c_col(int e) {
  return ((lane_id() & 3) << 1) | (e & 1);
}
__device__ __forceinline__ int c_slot(int e) { return e >> 1; }
__device__ __forceinline__ int slot_row(int s) {
  return (lane_id() >> 2) + (s << 3);
}
// one lane of the four that hold a row
__device__ __forceinline__ bool slot_leader() { return (lane_id() & 3) == 0; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// bf16x2 of (lo, hi), each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The kTerms bf16x2 terms of the pair (x0, x1).
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    t[i] = pack_bf16(x0, x1);
    x0 = x0 - __uint_as_float(t[i] << 16);
    x1 = x1 - __uint_as_float(t[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// A: the 16 x 16 tile at (row0, col0) of a shared tile.
__device__ __forceinline__ void load_a(FragA (&a)[1], const uint16_t* s,
                                       int ld, int row0, int col0) {
  const int l = lane_id();
  ldsm_x4(a[0].x[0], a[0].x[1], a[0].x[2], a[0].x[3],
          s + tile_at<uint16_t>(row0 + (l & 15), col0 + ((l >> 4) << 3), ld));
}
__device__ __forceinline__ void load_a(FragA (&a)[kTerms], const float* s,
                                       int ld, int row0, int col0) {
  const int l = lane_id(), g = l >> 2, t = (l & 3) << 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(
        s + tile_at<float>(row0 + g + ((k & 1) << 3),
                           col0 + t + ((k >> 1) << 3), ld));
    uint32_t p[kTerms];
    split_pair(v.x, v.y, p);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) a[i].x[k] = p[i];
  }
}

// B of the n8 tiles n0 and n0 + 8 at k0, the shared tile stored [n][k]
// (K rows: the scores' q.k).
__device__ __forceinline__ void load_b2(FragB (&b0)[1], FragB (&b1)[1],
                                        const uint16_t* s, int ld, int n0,
                                        int k0) {
  const int l = lane_id();
  ldsm_x4(b0[0].x[0], b0[0].x[1], b1[0].x[0], b1[0].x[1],
          s + tile_at<uint16_t>(n0 + (l & 7) + ((l >> 4) << 3),
                                k0 + (((l >> 3) & 1) << 3), ld));
}
__device__ __forceinline__ void load_b2(FragB (&b0)[kTerms],
                                        FragB (&b1)[kTerms], const float* s,
                                        int ld, int n0, int k0) {
  const int l = lane_id(), g = l >> 2, t = (l & 3) << 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(
        s + tile_at<float>(n0 + g + ((k >> 1) << 3), k0 + t + ((k & 1) << 3),
                           ld));
    uint32_t p[kTerms];
    split_pair(v.x, v.y, p);
    FragB (&b)[kTerms] = k >> 1 ? b1 : b0;
#pragma unroll
    for (int i = 0; i < kTerms; ++i) b[i].x[k & 1] = p[i];
  }
}

// B of the n8 tiles n0 and n0 + 8 at k0, the shared tile stored [k][n]
// (V or latent rows: p.v).
__device__ __forceinline__ void load_bt2(FragB (&b0)[1], FragB (&b1)[1],
                                         const uint16_t* s, int ld, int n0,
                                         int k0) {
  const int l = lane_id();
  ldsm_x4_t(b0[0].x[0], b0[0].x[1], b1[0].x[0], b1[0].x[1],
            s + tile_at<uint16_t>(k0 + (l & 7) + (((l >> 3) & 1) << 3),
                                  n0 + ((l >> 4) << 3), ld));
}
__device__ __forceinline__ void load_bt2(FragB (&b0)[kTerms],
                                         FragB (&b1)[kTerms], const float* s,
                                         int ld, int n0, int k0) {
  const int l = lane_id(), g = l >> 2, t = (l & 3) << 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = n0 + g + ((k >> 1) << 3), kk = k0 + t + ((k & 1) << 3);
    uint32_t p[kTerms];
    split_pair(s[tile_at<float>(kk, n, ld)], s[tile_at<float>(kk + 1, n, ld)],
               p);
    FragB (&b)[kTerms] = k >> 1 ? b1 : b0;
#pragma unroll
    for (int i = 0; i < kTerms; ++i) b[i].x[k & 1] = p[i];
  }
}

// The A terms of the 16 x 16 tile whose columns 0-7 are the accumulator
// lo and 8-15 the accumulator hi (the probabilities of p.v).
__device__ __forceinline__ void a_from_c(FragA (&a)[kTerms], const FragC& lo,
                                         const FragC& hi) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const FragC& c = k >> 1 ? hi : lo;
    uint32_t p[kTerms];
    split_pair(c.x[(k & 1) << 1], c.x[((k & 1) << 1) + 1], p);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) a[i].x[k] = p[i];
  }
}

__device__ __forceinline__ void mma(FragC& c, const FragA& a,
                                    const FragB& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c.x[0]), "+f"(c.x[1]), "+f"(c.x[2]), "+f"(c.x[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// 16 bytes from global to shared memory, asynchronously; zeros unless
// `valid` (src is then not read).  No memory clobber, so that the loads
// of the addresses around it overlap; cp_async_wait_all and the barrier
// after it order the copies before the tile is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  return tc_smem;
}

#endif  // TC_HOST_FRAGMENTS

// c[n] += a . b[n] for the first `live` of N accumulator tiles, one MMA
// per pair of terms that matters: for each pair the tiles' MMAs are
// independent, so they issue back to back instead of each waiting on the
// last (a pair's terms accumulate into one tile).
template <int TA, int TB, int N>
__device__ __forceinline__ void mma_tiles(FragC* c, const FragA (&a)[TA],
                                          const FragB (&b)[N][TB],
                                          int live = N) {
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      if (i + j < kTerms) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          if (n < live) mma(c[n], a[i], b[n][j]);
      }
}

template <int N>
__device__ __forceinline__ void zero(FragC (&c)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < kCElems; ++e) c[j].x[e] = 0.0f;
}

// The pool row (page * P + pos % P) of each position of the tile
// [t0, t0 + n), -1 outside [kv_lo, kv_hi): one page-table lookup per
// token, read back by every 16-byte copy of the token's row.
__device__ __forceinline__ void tile_rows(int* rows, const int* table_b,
                                          int t0, int n, int kv_lo,
                                          int kv_hi, int P) {
  for (int j = (int)threadIdx.x; j < n; j += (int)blockDim.x) {
    const int pos = t0 + j;
    rows[j] = pos >= kv_lo && pos < kv_hi ? table_b[pos / P] * P + pos % P
                                          : -1;
  }
}

// Rows [0, rows) of a shared tile of T, stride ld, `width` wide: row
// i < nrows holds row_ptr(i)[0, n), zeros past n; rows past nrows are
// zeros.  VEC: 16-byte asynchronous copies (n a multiple of
// 16 / sizeof(T), the rows 16-byte aligned); else one element a load.
template <bool VEC, typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, int ld, int rows,
                                           int width, int nrows, int n,
                                           RowPtr row_ptr) {
  constexpr int kVw = VEC ? (int)(16 / sizeof(T)) : 1;
  const int per_row = width / kVw;
  for (int e = (int)threadIdx.x; e < rows * per_row; e += (int)blockDim.x) {
    const int i = e / per_row, d0 = (e - i * per_row) * kVw;
    const bool valid = i < nrows && d0 < n;
    const T* src = row_ptr(valid ? i : 0) + (valid ? d0 : 0);
    T* to = dst + tile_at<T>(i, d0, ld);
    if constexpr (VEC) {
      cp_async16(to, src, valid);
    } else {
      *to = valid ? *src : T(0);
    }
  }
}

// One step of the online softmax (FlashAttention-2) for a warp's row
// tile, in base 2: s holds a token tile's scores times log2(e) (masked
// ones kMasked), m and l the lane's rows' running max and sum.  The rows'
// max and sum are taken over the lanes of each row; o is rescaled by
// 2^(m_old - m_new); on return s holds the probabilities 2^(s - m_new),
// which are exp() of the scores less their max.  With kMasked, not -inf,
// an all-masked tile gives p = 1 rows that the first valid tile's rescale
// 2^(-1e30 - m) = 0 erases, never 2^(-inf + inf) = NaN.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(FragC (&s)[NS],
                                               float (&m)[kSlots],
                                               float (&l)[kSlots],
                                               FragC (&o)[NO]) {
  float mx[kSlots], ps[kSlots], corr[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) mx[q] = kMasked;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < kCElems; ++e)
      mx[c_slot(e)] = fmaxf(mx[c_slot(e)], s[j].x[e]);
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const float m_new = fmaxf(m[q], quad_max(mx[q]));
    corr[q] = exp2f(m[q] - m_new);
    m[q] = m_new;
    ps[q] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < kCElems; ++e) {
      const float p = exp2f(s[j].x[e] - m[c_slot(e)]);
      s[j].x[e] = p;
      ps[c_slot(e)] = ps[c_slot(e)] + p;
    }
  bool moved = false;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    l[q] = l[q] * corr[q] + quad_sum(ps[q]);
    moved = moved || corr[q] != 1.0f;
  }
  if (moved) {         // most tiles of a long walk leave every max alone
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < kCElems; ++e)
        o[j].x[e] = o[j].x[e] * corr[c_slot(e)];
  }
}

}  // namespace tc
