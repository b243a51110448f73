"""The paged-attention CUDA sources compiled for the host (not collected).

``csrc/paged_attention.cu`` and ``csrc/paged_mla_attention.cu`` reach
their tensor-core tiles only through the fragment layer of
``csrc/tensor_tiles.cuh``.  Here g++ compiles each source with a stub
``cuda_runtime.h`` in which one thread plays the whole grid (a block of
one warp of one lane) and with :data:`HOST_FRAGMENTS` in place of the
layer's CUDA part: plain loops in which the one lane owns the whole
fragment (a 16 x 8 accumulator, row slot = row), the same split of
float32 operands into three bf16 terms and the same products of pairs
of terms, exact bf16 products summed in float32.  The real fragment
layouts, ldmatrix, mma.sync, the shuffles and cp.async run only on the
card (``chip_smoke.py``'s kernel phases); the host build checks the index
math, the tiling, the walk, the masks, the online softmax and the terms.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from repro_torch.kernels import build

STUB = r"""
#pragma once
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct dim3 { unsigned x; };
static const dim3 blockIdx = {0}, threadIdx = {0}, blockDim = {1},
                  gridDim = {1};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "ok"; }
template <typename F> inline int cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline void __syncthreads() {}
#define TC_HOST_FRAGMENTS "tc_host.h"
"""

# Included inside namespace tc, after its portable part (tile_at,
# kTerms).
HOST_FRAGMENTS = r"""
inline float bits_to_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

inline float to_float(float x) { return x; }
// bf16 is the upper half of a float32
inline float to_float(uint16_t x) { return bits_to_float((uint32_t)x << 16); }

// x rounded to bf16 (to nearest even), as a float32; x finite
inline float round_bf16(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return bits_to_float(u & 0xffff0000u);
}

struct FragA { float x[16][16]; };     // [row][k], bf16 values
struct FragB { float x[16][8]; };      // [k][n], bf16 values
struct FragC { float x[128]; };        // [row * 8 + col]

constexpr int kCElems = 128;
constexpr int kSlots = 16;
constexpr int kTasksPerWarp = 8;

inline int warp_id() { return 0; }
inline int num_warps() { return 1; }
inline int c_row(int e) { return e >> 3; }
inline int c_col(int e) { return e & 7; }
inline int c_slot(int e) { return e >> 3; }
inline int slot_row(int s) { return s; }
inline bool slot_leader() { return true; }
inline float quad_max(float x) { return x; }
inline float quad_sum(float x) { return x; }

// the T bf16 terms of x, each rounded from the remainder of the last
template <int T> inline void split(float x, float (&t)[T]) {
  for (int i = 0; i < T; ++i) {
    t[i] = round_bf16(x);
    x = x - t[i];
  }
}

template <int T, typename S>
inline void load_a(FragA (&a)[T], const S* s, int ld, int row0, int col0) {
  for (int r = 0; r < 16; ++r)
    for (int k = 0; k < 16; ++k) {
      float t[T];
      split(to_float(s[tile_at<S>(row0 + r, col0 + k, ld)]), t);
      for (int i = 0; i < T; ++i) a[i].x[r][k] = t[i];
    }
}

template <int T, typename S>
inline void load_b2(FragB (&b0)[T], FragB (&b1)[T], const S* s, int ld,
                    int n0, int k0) {
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < 8; ++n) {
      float t0[T], t1[T];
      split(to_float(s[tile_at<S>(n0 + n, k0 + k, ld)]), t0);
      split(to_float(s[tile_at<S>(n0 + 8 + n, k0 + k, ld)]), t1);
      for (int i = 0; i < T; ++i) {
        b0[i].x[k][n] = t0[i];
        b1[i].x[k][n] = t1[i];
      }
    }
}

template <int T, typename S>
inline void load_bt2(FragB (&b0)[T], FragB (&b1)[T], const S* s, int ld,
                     int n0, int k0) {
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < 8; ++n) {
      float t0[T], t1[T];
      split(to_float(s[tile_at<S>(k0 + k, n0 + n, ld)]), t0);
      split(to_float(s[tile_at<S>(k0 + k, n0 + 8 + n, ld)]), t1);
      for (int i = 0; i < T; ++i) {
        b0[i].x[k][n] = t0[i];
        b1[i].x[k][n] = t1[i];
      }
    }
}

inline void a_from_c(FragA (&a)[kTerms], const FragC& lo, const FragC& hi) {
  for (int r = 0; r < 16; ++r)
    for (int k = 0; k < 16; ++k) {
      float t[kTerms];
      split(k < 8 ? lo.x[r * 8 + k] : hi.x[r * 8 + k - 8], t);
      for (int i = 0; i < kTerms; ++i) a[i].x[r][k] = t[i];
    }
}

inline void mma(FragC& c, const FragA& a, const FragB& b) {
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 8; ++n) {
      float s = 0.0f;
      for (int k = 0; k < 16; ++k) s = s + a.x[r][k] * b.x[k][n];
      c.x[r * 8 + n] = c.x[r * 8 + n] + s;
    }
}

inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) memcpy(dst, src, 16);
  else memset(dst, 0, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}

inline unsigned char* dyn_smem() {
  alignas(16) static unsigned char buf[1 << 20];
  return buf;
}
"""


def host_library(tmp: Path, source: str) -> ctypes.CDLL:
    """``csrc/<source>.cu`` compiled for the host into ``tmp``, its
    launches ``<<<...>>>`` stripped; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "tc_host.h").write_text(HOST_FRAGMENTS)
    src = (build.CSRC / f"{source}.cu").read_text()
    (tmp / "host.cpp").write_text(re.sub(r"<<<[^>]*>>>", "", src))
    lib = tmp / "libhost.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(tmp), "-I",
                    str(build.CSRC), "-o", str(lib), str(tmp / "host.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))
