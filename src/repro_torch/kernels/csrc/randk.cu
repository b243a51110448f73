// BlockRandK's block gather and block scatter for Hopper, sm_90a.  Plain
// C interface, loaded with ctypes by src/repro_torch/kernels/build.py;
// wrappers in kernels/randk.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/randk.py:
//
//   block_gather   <- block_gather_pallas   (:39, pallas_call :51)
//       out[i, j, :] = x[i, idx[i, j] bs .. + bs) * scale, zero past the
//       end of row i (the reference's _pad_to before it cuts the row in
//       blocks, src/repro/core/variants.py:488)
//   block_scatter  <- block_scatter_pallas  (:66, pallas_call :82)
//       base[rows[k], :] += vals[k, :] in place, the rows distinct
//
// The TPU kernels are flat: one node's (nb, bs) blocks and (kb,) indices
// per call, the index map of the grid doing the gather.  block_gather
// here takes the n nodes' (n, d) rows and (n, kb) int64 indices, so one
// launch serves a leaf for all nodes (the finite-MVR sparse wire:
// payload rows after the tail -> the wire's selected blocks).
// block_scatter takes the flat (R, bs) base and (K,) int64 rows; the
// sharded engine's block_scatter_rows calls it with base the zero
// (n nb, bs) rows of all nodes and rows = idx + nb * node, distinct
// because each node draws its blocks without replacement.
//
// Bound on this card: memory.  Each kernel reads the selected elements
// once and writes them once, plus the indices: at the finite-MVR run's
// w_gate leaf (n = 4, kb = 16,384 blocks of 128) that is 33.5 MB in and
// 33.5 MB out for the gather, 0.02 ms at 3.35 TB/s, and for the scatter
// the base rows read and written besides (3 x 33.5 MB).  The arithmetic
// is one multiply or one add per element.  What the design does about
// it: one warp per selected block, its lanes on consecutive elements,
// so each load is whole 128-byte lines; the block's index is read once
// per warp; float4 loads and stores where the block starts on a 16-byte
// boundary (bs and d multiples of 4, the pointers aligned), so a warp
// moves a 128-element block in one instruction each way.  A block that
// runs past the end of its row writes zeros there and reads nothing.
//
// Rounding: x * scale is one float multiply and base + vals one add, as
// in the plain versions (kernels/ref.py); the two agree exactly.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr size_t kMaxBlocks = 132 * 16;  // then grid-stride

// Warps of the grid take the `pairs` selected blocks in turn; a
// one-thread block (the host build of the tests) is one warp of one lane.
struct WarpLoop {
  size_t lanes, first, stride, lane;
  __device__ WarpLoop() {
    lanes = blockDim.x < kWarp ? blockDim.x : kWarp;
    const size_t per_block = blockDim.x / lanes;
    first = (size_t)blockIdx.x * per_block + threadIdx.x / lanes;
    stride = (size_t)gridDim.x * per_block;
    lane = threadIdx.x % lanes;
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads) block_gather_kernel(
    const float* __restrict__ x, const long long* __restrict__ idx,
    float* __restrict__ out, size_t pairs, size_t d, size_t kb, size_t bs,
    float scale) {
  const WarpLoop wl;
  for (size_t w = wl.first; w < pairs; w += wl.stride) {
    const float* row = x + (w / kb) * d;
    const long long blk = idx[w];
    float* o = out + w * bs;
    if (VEC) {
      // bs and d multiples of 4: a float4 chunk is wholly in or out
      for (size_t j = 4 * wl.lane; j < bs; j += 4 * wl.lanes) {
        const long long e = blk * (long long)bs + (long long)j;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (blk >= 0 && e < (long long)d) {
          v = *reinterpret_cast<const float4*>(row + e);
          v.x = v.x * scale;
          v.y = v.y * scale;
          v.z = v.z * scale;
          v.w = v.w * scale;
        }
        *reinterpret_cast<float4*>(o + j) = v;
      }
    } else {
      for (size_t j = wl.lane; j < bs; j += wl.lanes) {
        const long long e = blk * (long long)bs + (long long)j;
        o[j] = (blk >= 0 && e < (long long)d) ? row[e] * scale : 0.0f;
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) block_scatter_kernel(
    float* __restrict__ base, const float* __restrict__ vals,
    const long long* __restrict__ rows, size_t r, size_t k, size_t bs) {
  const WarpLoop wl;
  for (size_t w = wl.first; w < k; w += wl.stride) {
    const long long row = rows[w];
    if (row < 0 || row >= (long long)r) continue;  // in range by contract
    float* b = base + (size_t)row * bs;
    const float* v = vals + w * bs;
    if (VEC) {
      for (size_t j = 4 * wl.lane; j < bs; j += 4 * wl.lanes) {
        float4 t = *reinterpret_cast<const float4*>(b + j);
        const float4 a = *reinterpret_cast<const float4*>(v + j);
        t.x = t.x + a.x;
        t.y = t.y + a.y;
        t.z = t.z + a.z;
        t.w = t.w + a.w;
        *reinterpret_cast<float4*>(b + j) = t;
      }
    } else {
      for (size_t j = wl.lane; j < bs; j += wl.lanes) {
        b[j] = b[j] + v[j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks for `warps` warps of work, capped; the kernels grid-stride over
// the rest.
unsigned grid_for_warps(size_t warps) {
  const size_t per_block = kThreads / kWarp;
  size_t blocks = (warps + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks == 0) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = ok);
// `stream` is a cudaStream_t.

// x (n, d) float32, idx (n, kb) int64 block numbers, out (n, kb, bs).
int block_gather(const float* x, const long long* idx, float* out,
                 long long n, long long d, long long kb, long long bs,
                 float scale, void* stream) {
  const size_t pairs = (size_t)n * (size_t)kb;
  if (pairs == 0 || bs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bs % 4 == 0 && d % 4 == 0 && aligned16(x) &&
                   aligned16(out);
  if (vec) {
    block_gather_kernel<true><<<grid_for_warps(pairs), kThreads, 0, s>>>(
        x, idx, out, pairs, (size_t)d, (size_t)kb, (size_t)bs, scale);
  } else {
    block_gather_kernel<false><<<grid_for_warps(pairs), kThreads, 0, s>>>(
        x, idx, out, pairs, (size_t)d, (size_t)kb, (size_t)bs, scale);
  }
  return (int)cudaGetLastError();
}

// base (r, bs) float32 updated in place, vals (k, bs), rows (k,) int64
// distinct row numbers in [0, r).
int block_scatter(float* base, const float* vals, const long long* rows,
                  long long r, long long k, long long bs, void* stream) {
  if (k == 0 || bs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bs % 4 == 0 && aligned16(base) && aligned16(vals);
  if (vec) {
    block_scatter_kernel<true><<<grid_for_warps((size_t)k), kThreads, 0, s>>>(
        base, vals, rows, (size_t)r, (size_t)k, (size_t)bs);
  } else {
    block_scatter_kernel<false>
        <<<grid_for_warps((size_t)k), kThreads, 0, s>>>(
            base, vals, rows, (size_t)r, (size_t)k, (size_t)bs);
  }
  return (int)cudaGetLastError();
}

const char* randk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
