// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `flash_decode`
// (src/repro/kernels/flash_decode.py; padding entry `ops.flash_decode`):
// one query token per sequence attends over that sequence's dense cache
// k/v [B, S, Hkv, D] (a layer's slice of the gathered [L, B, S, Hkv, D]
// cache).  Query head h reads KV head h / group.  Positions outside
// [start, min(len, S)) are masked; optional tanh softcap; fp32 online
// softmax; a row with len == 0 gives 0 (the Pallas kernel gives the mean
// of V there, see ROADMAP.md Queue C; the engine never asks for it).  The
// Pallas kernel has no `start`: with start = 0 this is its function, and
// `start` lets gemma2's local layers run here too.  S is not padded to a
// tile multiple nor D to 128 lanes: the ragged tail is masked and never
// read.
//
// What bounds it on an H100: bytes.  Each live K/V row must cross device
// memory once (2 * D * sizeof(T) per KV head per position) for ~group FMAs
// per element, far below the card's ~295 operations per byte.  The design
// is the paged kernel's: one CTA per (sequence, KV head) serves all `group`
// query heads, so each live row is read once per KV head; it walks the
// positions in 32-row tiles through `decode_group` (decode_group.cuh), the
// loop the paged kernel runs over pages.  Tiles wholly before `start` or
// at or past `len` are never read.  No split across tiles and no
// copy/compute overlap yet: at small batch few CTAs are in flight (B * Hkv
// of them), which later work (split-K, cp.async/TMA) addresses.
#include "decode_group.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;  // positions per staged tile

// A tile is kTile consecutive positions of one sequence and KV head.
struct DenseRows {
  int64_t seq_base;    // element offset of (b, position 0, kvh, 0)
  int64_t row_stride;  // Hkv * D
  __device__ int64_t tile_base(int j) const {
    return seq_base + static_cast<int64_t>(j) * kTile * row_stride;
  }
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    const int* __restrict__ starts, T* __restrict__ out,
                    int S, int Hq, int Hkv, int D, float softcap,
                    float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  // the group's query heads kvh * G .. kvh * G + G - 1 are contiguous
  const int64_t qo = (static_cast<int64_t>(b) * Hq + kvh * G) * D;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const DenseRows rows{static_cast<int64_t>(b) * S * row_stride +
                           static_cast<int64_t>(kvh) * D,
                       row_stride};
  const int limit = min(lens[b], S);
  decode_group<T>(q + qo, k, v, out + qo, rows, G, D, kTile, starts[b],
                  limit, softcap, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens,
           const int* starts, void* out, int B, int S, int Hq, int Hkv,
           int D, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T>(Hq / Hkv, kTile, D);
  cudaError_t err = allow_smem(flash_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T><<<dim3(B, Hkv), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, starts, static_cast<T*>(out), S, Hq,
      Hkv, D, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q [B, Hq, D]; k/v [B, S, Hkv, D]; lens/starts [B]; out [B, Hq, D].  All
// contiguous, on one device, K and V 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode(int dtype, const void* q, const void* k,
                            const void* v, const void* lens,
                            const void* starts, void* out, int B, int S,
                            int Hq, int Hkv, int D, float softcap,
                            float scale, void* stream) {
  using namespace repro_torch;
  const int* ln = static_cast<const int*>(lens);
  const int* sb = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, ln, sb, out, B, S, Hq, Hkv, D, softcap,
                         scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, ln, sb, out, B, S, Hq, Hkv, D,
                                 softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
