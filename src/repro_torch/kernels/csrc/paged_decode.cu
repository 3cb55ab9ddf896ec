// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `_paged_call`
// (src/repro/kernels/flash_decode.py, entry `flash_decode_paged_native`):
// one query token per sequence attends over that sequence's KV pages, read
// through its block-table row from the kernel-native pools
// [P, Hkv, page, D].  Query head h reads KV head h / group.  Positions
// outside [start, len) are masked and pages wholly outside the window are
// never read; optional tanh softcap; fp32 online softmax; len == 0 gives 0.
//
// What bounds it on an H100: bytes.  Each live K/V page must cross device
// memory once (2 * page * D * sizeof(T) per KV head per page) and the work
// per byte is ~group FMAs, far below the card's ~295 operations per byte.
// The design therefore reads every page once per KV head rather than once
// per query head: one CTA per (sequence, KV head) serves all `group` query
// heads, stages the page's K and V in shared memory with 16-byte loads and
// keeps fp32 m / l / acc for its query heads in shared memory (the loop is
// `decode_group` in decode_group.cuh, shared with the dense decode kernel;
// here a tile is a page).  The Pallas grid (B, Hq, pages) is not carried
// over.  This first version loads one
// page at a time with no copy/compute overlap and no split across pages;
// split-K for long contexts at small batch, cp.async/TMA pipelining and
// wgmma are later work.
#include "decode_group.cuh"

namespace repro_torch {
namespace {

// A tile is one page, found through the sequence's block-table row.
struct PagedRows {
  const int* row;
  int Hkv;
  int kvh;
  int64_t page_elems;
  int64_t row_stride;  // D
  __device__ int64_t tile_base(int j) const {
    return (static_cast<int64_t>(row[j]) * Hkv + kvh) * page_elems;
  }
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lens,
                    const int* __restrict__ starts, T* __restrict__ out,
                    int Hq, int Hkv, int page, int D, int n_pages,
                    float softcap, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  // the group's query heads kvh * G .. kvh * G + G - 1 are contiguous
  const int64_t qo = (static_cast<int64_t>(b) * Hq + kvh * G) * D;
  const PagedRows rows{table + static_cast<int64_t>(b) * n_pages, Hkv, kvh,
                       static_cast<int64_t>(page) * D, D};
  const int limit = min(lens[b], n_pages * page);
  decode_group<T>(q + qo, k_pages, v_pages, out + qo, rows, G, D, page,
                  starts[b], limit, softcap, scale);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* lens, const int* starts, void* out,
           int B, int Hq, int Hkv, int page, int D, int n_pages,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T>(Hq / Hkv, page, D);
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<dim3(B, Hkv), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lens, starts,
      static_cast<T*>(out), Hq, Hkv, page, D, n_pages, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q [B, Hq, D]; k_pages/v_pages [P, Hkv, page, D]; table [B, n_pages];
// lens/starts [B]; out [B, Hq, D].  All contiguous, on one device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode(int dtype, const void* q, const void* k_pages,
                            const void* v_pages, const void* table,
                            const void* lens, const void* starts, void* out,
                            int B, int Hq, int Hkv, int page, int D,
                            int n_pages, float softcap, float scale,
                            void* stream) {
  using namespace repro_torch;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const int* sb = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k_pages, v_pages, tb, ln, sb, out, B, Hq, Hkv,
                         page, D, n_pages, softcap, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, sb, out, B, Hq,
                                 Hkv, page, D, n_pages, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
