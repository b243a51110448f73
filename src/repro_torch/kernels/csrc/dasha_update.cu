// Fused DASHA-PP control-variate updates (Algorithm 1, lines 9-11) for
// Hopper, sm_90a.  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/build.py; wrappers in kernels/dasha_update.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dasha_update.py:
//
//   dasha_update_batched       <- dasha_update_batched_pallas       (:168)
//       k = gn - go - b (h - go); h_new = h + mask k/pa;
//       payload = k/pa - (a/pa)(gi - h)                  (Algs. 2 and 5)
//   dasha_page_update_batched  <- dasha_page_update_batched_pallas  (:220)
//       k = coin (gn - go - (b/p_page)(h - go)) + (1 - coin)(bn - bo),
//       then the same tail                               (Alg. 3)
//   dasha_tail_batched         <- dasha_tail_batched_pallas         (:267)
//       the tail alone, given k                          (Alg. 4)
//   buffered_commit            <- buffered_commit_pallas            (:405)
//       out = g + (1/n) sum_k w[k] m[k]     (the async server step,
//       src/repro/fl/server.py:136-139)
//
// All arrays are node-major (n, d) float32, contiguous; mask is (n,)
// float32 on the device; the PAGE coin is a float32 read through a
// device pointer, so neither coin value costs a host sync or a rebuild.
//
// Bound on this card: memory.  Each launch must read every input once
// and write every output once: 7, 9 and 5 transfers of n*d*4 bytes,
// 58.7 MB, 75.4 MB and 41.9 MB at the real-sim width (n = 100,
// d = 20958), 17.5, 22.5 and 12.5 us at 3.35 TB/s.  The arithmetic is
// 4-9 float operations per element, far below the card's float32 rate.
// What the design does about it: one streaming pass over the flat n*d
// buffer, 16-byte float4 loads and stores (the flat buffer is aligned
// even where a row start is not: d = 20958 is not a multiple of 4), no
// intermediate ever written, and the TPU's (rows, 128) lane padding
// dropped.  A thread finds the row of its elements (for the mask) by
// division once per float4 chunk.
//
// buffered_commit is a short reduction over the K rows of a (K, d)
// buffer, bound by memory too: (K d + 2 d + K) 4 bytes, 1.01 MB at
// K = 10 and 8.55 MB at K = 100 (d = 20958), 0.30 and 2.55 us at the
// H100 SXM's 3.35 TB/s (700 W), at or below the cost of a launch.  One
// thread per column j walks k = 0..K-1 in order, so a warp's loads are
// coalesced along the row and the sum is taken in the plain version's
// order.  No float4 here: a row of (K, d) starts on a 16-byte boundary
// only when d mod 4 == 0, and d = 20958 is not.  Blocks of 128 threads
// put 164 blocks on the 132 SMs at d = 20958.
//
// Rounding: build with --fmad=false.  Every operation then rounds on
// its own, in the order of the plain PyTorch versions in
// kernels/ref.py, and the two agree exactly on the card.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 132 * 16;  // then grid-stride

__device__ __forceinline__ void load4(const float* __restrict__ p, size_t q,
                                      float v[4]) {
  const float4 t = reinterpret_cast<const float4*>(p)[q];
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store4(float* __restrict__ p, size_t q,
                                       const float v[4]) {
  reinterpret_cast<float4*>(p)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

// The mask values of flat elements i0 .. i0+3; a chunk may cross rows.
__device__ __forceinline__ void row_parts(const float* __restrict__ mask,
                                          size_t i0, size_t d, float part[4]) {
  size_t r = i0 / d;
  size_t next = (r + 1) * d;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j >= next) {
      ++r;
      next += d;
    }
    part[j] = mask[r];
  }
}

// Lines 10-11 of Algorithm 1 for one element.
__device__ __forceinline__ void tail(float k, float h, float gi, float part,
                                     float inv_pa, float a_inv_pa,
                                     float& h_new, float& payload) {
  const float k_pa = k * inv_pa;
  h_new = h + part * k_pa;
  payload = k_pa - a_inv_pa * (gi - h);
}

__device__ __forceinline__ float k_same_sample(float gn, float go, float h,
                                               float b) {
  return gn - go - b * (h - go);
}

__device__ __forceinline__ float k_page(float gn, float go, float bn,
                                        float bo, float h, float coin,
                                        float b_over_p) {
  const float k_full = gn - go - b_over_p * (h - go);
  const float k_mini = bn - bo;
  return coin * k_full + (1.0f - coin) * k_mini;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) dasha_update_kernel(
    const float* __restrict__ gn, const float* __restrict__ go,
    const float* __restrict__ h, const float* __restrict__ gi,
    const float* __restrict__ mask, float* __restrict__ k_out,
    float* __restrict__ h_out, float* __restrict__ p_out, size_t total,
    size_t d, float b, float inv_pa, float a_inv_pa) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t done = 0;
  if (VEC) {
    const size_t nvec = total / 4;
    for (size_t q = t; q < nvec; q += stride) {
      float vgn[4], vgo[4], vh[4], vgi[4], part[4], vk[4], vhn[4], vp[4];
      load4(gn, q, vgn);
      load4(go, q, vgo);
      load4(h, q, vh);
      load4(gi, q, vgi);
      row_parts(mask, 4 * q, d, part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vk[j] = k_same_sample(vgn[j], vgo[j], vh[j], b);
        tail(vk[j], vh[j], vgi[j], part[j], inv_pa, a_inv_pa, vhn[j], vp[j]);
      }
      store4(k_out, q, vk);
      store4(h_out, q, vhn);
      store4(p_out, q, vp);
    }
    done = nvec * 4;
  }
  for (size_t i = done + t; i < total; i += stride) {
    const float k = k_same_sample(gn[i], go[i], h[i], b);
    k_out[i] = k;
    tail(k, h[i], gi[i], mask[i / d], inv_pa, a_inv_pa, h_out[i], p_out[i]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) dasha_page_update_kernel(
    const float* __restrict__ gn, const float* __restrict__ go,
    const float* __restrict__ bn, const float* __restrict__ bo,
    const float* __restrict__ h, const float* __restrict__ gi,
    const float* __restrict__ mask, const float* __restrict__ coin_ptr,
    float* __restrict__ k_out, float* __restrict__ h_out,
    float* __restrict__ p_out, size_t total, size_t d, float b_over_p,
    float inv_pa, float a_inv_pa) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float coin = *coin_ptr;
  size_t done = 0;
  if (VEC) {
    const size_t nvec = total / 4;
    for (size_t q = t; q < nvec; q += stride) {
      float vgn[4], vgo[4], vbn[4], vbo[4], vh[4], vgi[4], part[4];
      float vk[4], vhn[4], vp[4];
      load4(gn, q, vgn);
      load4(go, q, vgo);
      load4(bn, q, vbn);
      load4(bo, q, vbo);
      load4(h, q, vh);
      load4(gi, q, vgi);
      row_parts(mask, 4 * q, d, part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vk[j] = k_page(vgn[j], vgo[j], vbn[j], vbo[j], vh[j], coin, b_over_p);
        tail(vk[j], vh[j], vgi[j], part[j], inv_pa, a_inv_pa, vhn[j], vp[j]);
      }
      store4(k_out, q, vk);
      store4(h_out, q, vhn);
      store4(p_out, q, vp);
    }
    done = nvec * 4;
  }
  for (size_t i = done + t; i < total; i += stride) {
    const float k = k_page(gn[i], go[i], bn[i], bo[i], h[i], coin, b_over_p);
    k_out[i] = k;
    tail(k, h[i], gi[i], mask[i / d], inv_pa, a_inv_pa, h_out[i], p_out[i]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) dasha_tail_kernel(
    const float* __restrict__ k, const float* __restrict__ h,
    const float* __restrict__ gi, const float* __restrict__ mask,
    float* __restrict__ h_out, float* __restrict__ p_out, size_t total,
    size_t d, float inv_pa, float a_inv_pa) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t done = 0;
  if (VEC) {
    const size_t nvec = total / 4;
    for (size_t q = t; q < nvec; q += stride) {
      float vk[4], vh[4], vgi[4], part[4], vhn[4], vp[4];
      load4(k, q, vk);
      load4(h, q, vh);
      load4(gi, q, vgi);
      row_parts(mask, 4 * q, d, part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tail(vk[j], vh[j], vgi[j], part[j], inv_pa, a_inv_pa, vhn[j], vp[j]);
      }
      store4(h_out, q, vhn);
      store4(p_out, q, vp);
    }
    done = nvec * 4;
  }
  for (size_t i = done + t; i < total; i += stride) {
    tail(k[i], h[i], gi[i], mask[i / d], inv_pa, a_inv_pa, h_out[i], p_out[i]);
  }
}

constexpr int kCommitThreads = 128;

__global__ void __launch_bounds__(kCommitThreads) buffered_commit_kernel(
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ w, float* __restrict__ out, size_t kk,
    size_t d, float inv_n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.0f;
#pragma unroll 4
    for (size_t k = 0; k < kk; ++k) {
      acc = acc + w[k] * m[k * d + j];
    }
    out[j] = g[j] + inv_n * acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks for `work` items of one thread each, capped; the kernels
// grid-stride over the rest.
unsigned grid_for(size_t work) {
  size_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks == 0) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = ok).
// `stream` is a cudaStream_t; the float4 path is taken when every
// pointer is 16-byte aligned, the scalar path otherwise.

int dasha_update_batched(const float* gn, const float* go, const float* h,
                         const float* gi, const float* mask, float* k,
                         float* h_new, float* payload, long long n,
                         long long d, float b, float inv_pa, float a_inv_pa,
                         void* stream) {
  const size_t total = (size_t)n * (size_t)d;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(gn) && aligned16(go) && aligned16(h) &&
                   aligned16(gi) && aligned16(k) && aligned16(h_new) &&
                   aligned16(payload);
  if (vec) {
    dasha_update_kernel<true><<<grid_for(total / 4), kThreads, 0, s>>>(
        gn, go, h, gi, mask, k, h_new, payload, total, (size_t)d, b, inv_pa,
        a_inv_pa);
  } else {
    dasha_update_kernel<false><<<grid_for(total), kThreads, 0, s>>>(
        gn, go, h, gi, mask, k, h_new, payload, total, (size_t)d, b, inv_pa,
        a_inv_pa);
  }
  return (int)cudaGetLastError();
}

int dasha_page_update_batched(const float* gn, const float* go,
                              const float* bn, const float* bo,
                              const float* h, const float* gi,
                              const float* mask, const float* coin, float* k,
                              float* h_new, float* payload, long long n,
                              long long d, float b_over_p, float inv_pa,
                              float a_inv_pa, void* stream) {
  const size_t total = (size_t)n * (size_t)d;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(gn) && aligned16(go) && aligned16(bn) &&
                   aligned16(bo) && aligned16(h) && aligned16(gi) &&
                   aligned16(k) && aligned16(h_new) && aligned16(payload);
  if (vec) {
    dasha_page_update_kernel<true><<<grid_for(total / 4), kThreads, 0, s>>>(
        gn, go, bn, bo, h, gi, mask, coin, k, h_new, payload, total,
        (size_t)d, b_over_p, inv_pa, a_inv_pa);
  } else {
    dasha_page_update_kernel<false><<<grid_for(total), kThreads, 0, s>>>(
        gn, go, bn, bo, h, gi, mask, coin, k, h_new, payload, total,
        (size_t)d, b_over_p, inv_pa, a_inv_pa);
  }
  return (int)cudaGetLastError();
}

int dasha_tail_batched(const float* k, const float* h, const float* gi,
                       const float* mask, float* h_new, float* payload,
                       long long n, long long d, float inv_pa,
                       float a_inv_pa, void* stream) {
  const size_t total = (size_t)n * (size_t)d;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(k) && aligned16(h) && aligned16(gi) &&
                   aligned16(h_new) && aligned16(payload);
  if (vec) {
    dasha_tail_kernel<true><<<grid_for(total / 4), kThreads, 0, s>>>(
        k, h, gi, mask, h_new, payload, total, (size_t)d, inv_pa, a_inv_pa);
  } else {
    dasha_tail_kernel<false><<<grid_for(total), kThreads, 0, s>>>(
        k, h, gi, mask, h_new, payload, total, (size_t)d, inv_pa, a_inv_pa);
  }
  return (int)cudaGetLastError();
}

// The async server step: out = g + inv_n * sum_k w[k] m[k * d + .],
// g and out (d,), m (K, d), w (K,) on the device.  K = 0 gives g.
int buffered_commit(const float* g, const float* m, const float* w,
                    float* out, long long k, long long d, float inv_n,
                    void* stream) {
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t blocks = ((size_t)d + kCommitThreads - 1) / kCommitThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  buffered_commit_kernel<<<(unsigned)blocks, kCommitThreads, 0, s>>>(
      g, m, w, out, (size_t)k, (size_t)d, inv_n);
  return (int)cudaGetLastError();
}

const char* dasha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
