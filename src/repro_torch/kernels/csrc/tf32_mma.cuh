// 3xTF32 tensor-core products and cp.async staging, shared by the SSD
// chunk kernel (ssd_chunk.cu) and its backward (ssd_chunk_bwd.cu).
//
// A product runs on `mma.sync.m16n8k8` with TF32 operands and fp32
// accumulators.  One TF32 pass keeps 10 mantissa bits of each operand and
// misses the 1e-4 row limit the SSD kernels are held to, so each fp32
// operand is split into hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi)
// (round to nearest, ties away) and the product is summed as lo.hi + hi.lo
// + hi.hi (the lo.lo term, ~2^-22 of each product, is dropped).
#pragma once

#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Copy rows [0, rows) x columns [0, cols) of a tile whose element (r, c)
// is src[r * ld + c] into dst (rows dld floats apart); elements with
// r >= rows_ok or c >= cols_ok are zero-filled and not read.  cols is a
// multiple of 8.  vec: 16-byte copies (src and ld 16-byte aligned, cols_ok
// a multiple of 4), else 4-byte ones.  THREADS threads take part.
template <int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, int dld,
                                           const float* src, int64_t ld,
                                           int rows, int rows_ok, int cols,
                                           int cols_ok, bool vec, int tid) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = tid; i < rows * c4; i += THREADS) {
      const int r = i / c4;
      const int c = (i - r * c4) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * dld + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += THREADS) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(dst + r * dld + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

// The ring: stage(i, slot) issues step i's copies into a slot; run() keeps
// SLOTS - 1 steps in flight and calls compute(i, slot) once step i has
// landed.  Every thread commits one group a step (empty past the end), so
// the wait counts hold.  The caller puts a barrier before prefetch() when
// the slots were in use.
template <int SLOTS, typename Stage>
__device__ __forceinline__ void prefetch(int n, Stage&& stage) {
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {
    if (i < n) stage(i, i);
    cp_async_commit();
  }
}

template <int SLOTS, typename Stage, typename Compute>
__device__ __forceinline__ void run(int n, Stage&& stage,
                                    Compute&& compute) {
  for (int i = 0; i < n; ++i) {
    cp_async_wait<SLOTS - 2>();
    __syncthreads();  // step i visible; step i - 1's slot is free
    const int next = i + SLOTS - 1;
    if (next < n) stage(next, next % SLOTS);
    cp_async_commit();
    compute(i, i % SLOTS);
  }
}

// a = hi + lo, each rounded to TF32 (cvt.rna: to nearest, ties away)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo)
      : "f"(a - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 (m x k) operand fragment split into its TF32 parts.  Element i
// of `v` is the fragment's register i: (row g, col t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) for lane = 4 g + t.
struct FragA {
  uint32_t hi[4], lo[4];
  FragA() = default;
  __device__ __forceinline__ explicit FragA(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
  }
};

// d += a . b in 3xTF32, b the 8 x 8 (k x n) fragment (row t, col g) and
// (t + 4, g); the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

}  // namespace repro_torch
