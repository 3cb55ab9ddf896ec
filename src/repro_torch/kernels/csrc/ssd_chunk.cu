// SSD (Mamba2) within-chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_chunk`
// (src/repro/kernels/ssd_scan.py).  For every (batch, chunk) and head h,
// with cs = the inclusive cumsum over the chunk of dt * A[h]:
//   y[t, :] = sum_{s <= t} (C_t . B_s) * exp(cs_t - cs_s) * dt_s * x[s, :]
//   S[:, n] = sum_s exp(cs_{Q-1} - cs_s) * dt_s * B_s[n] * x[s, :]
// all in fp32.  x [B, Nc, Q, H, P], dt [B, Nc, Q, H], A [H]; B and C come
// per group, [B, Nc, Q, G, N], and head h reads group h / (H / G) in the
// index arithmetic (as the prefill kernel resolves GQA), so nothing is
// broadcast to heads: at mamba2's shapes that would multiply the B/C bytes
// by 32.  The decay is always exp of a difference of cs, never a quotient
// of two exps (which overflows).  The cross-chunk recurrence stays outside
// (`repro_torch.models.ssm.ssd_chunked`).
//
// What bounds it on an H100: bytes at the serving shapes (x in, y out and
// S out dominate; ~2 x Q^2 / 2 x (N + P) FLOPs a head and chunk is below
// the card's operations-per-byte line at the TF32 rate).  This first
// version is written to be right, on the CUDA cores in fp32: a Q = 256
// chunk does not fit one CTA's shared memory (the Q x Q score matrix alone
// is 256 KB), so the work is tiled in 64-row tiles.  One launch holds two
// kinds of CTA, picked by blockIdx.x:
//   - a row CTA (blockIdx.x < ceil(Q / 64)) owns y rows [64 r, 64 r + 64):
//     it stages those rows of C once, then for each column tile c <= r
//     stages B and dt * x of that tile, forms the 64 x 64 score tile in
//     shared memory (decay, causal mask on the diagonal tile) and adds
//     score @ (dt x) into registers; tiles above the diagonal are never
//     visited;
//   - a state CTA (the next ceil(N / 64) values) owns S[:, 64 j, 64 j + 64)
//     and walks the chunk in 64-row tiles, weighting B by
//     exp(cs_{Q-1} - cs_s) * dt_s as it stages it.
// Every CTA recomputes cs for its (chunk, head) with one warp scan (at most
// Q / 32 serial adds a lane).  A ragged Q (any length) is masked here:
// rows and columns >= Q are zero-filled in shared memory and never stored,
// so the caller pads nothing.  256 threads = 16 x 16; each thread holds a
// 4 x (P / 16) tile of y or a (P / 16) x 4 tile of S.  Tensor cores
// (TF32 mma / wgmma), TMA staging and fusing the cross-chunk pass are later
// work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;         // rows (or columns) per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxN = 256;

inline size_t smem_floats(int Q, int P, int N) {
  const int ldb = (N > kT ? N : kT) + 1;
  return static_cast<size_t>(2 * Q) + static_cast<size_t>(kT) * (N + 1) +
         static_cast<size_t>(kT) * ldb + static_cast<size_t>(kT) * (P + 1) +
         static_cast<size_t>(kT) * (kT + 1);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ S, int Q, int H, int G, int N) {
  constexpr int PJ = P / 16;
  const int ldc = N + 1;
  const int ldb = (N > kT ? N : kT) + 1;
  constexpr int ldx = P + 1;
  constexpr int lds = kT + 1;
  const int h = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n_row_tiles = (Q + kT - 1) / kT;

  extern __shared__ float sm[];
  float* css = sm;              // [Q] inclusive cumsum of dt * A
  float* dts = css + Q;         // [Q] dt
  float* Cs = dts + Q;          // [64][N + 1] C rows of this row tile
  float* Bs = Cs + kT * ldc;    // [64][ldb] B (or weighted B) of a tile
  float* Xs = Bs + kT * ldb;    // [64][P + 1] x (or dt * x) of a tile
  float* Sc = Xs + kT * ldx;    // [64][65] score tile

  // row strides of the [.., Q, H, P] and [.., Q, G, N] layouts
  const int64_t x_row = static_cast<int64_t>(H) * P;
  const int64_t b_row = static_cast<int64_t>(G) * N;
  const float* xb = x + bc * Q * x_row + static_cast<int64_t>(h) * P;
  const float* Bb = Bm + bc * Q * b_row + static_cast<int64_t>(g) * N;
  const float* Cb = Cm + bc * Q * b_row + static_cast<int64_t>(g) * N;
  const float* dtb = dt + bc * Q * H + h;

  if (tid < 32) {
    // warp scan: each lane sums a contiguous segment, then the lanes
    // exchange their segment totals
    const float a = A[h];
    const int seg = (Q + 31) / 32;
    const int s0 = min(lane * seg, Q);
    const int s1 = min(s0 + seg, Q);
    float run = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float d = dtb[static_cast<int64_t>(s) * H];
      dts[s] = d;
      run += d * a;
      css[s] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const float offset = incl - run;
    for (int s = s0; s < s1; ++s) css[s] += offset;
  }
  __syncthreads();

  if (blockIdx.x < n_row_tiles) {
    // ---- y rows [t0, t0 + 64) -------------------------------------------
    const int t0 = blockIdx.x * kT;
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      const int t = t0 + r;
      Cs[r * ldc + n] = t < Q ? Cb[t * b_row + n] : 0.f;
    }
    float acc[4][PJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < PJ; ++b) acc[a][b] = 0.f;

    for (int ct = 0; ct <= static_cast<int>(blockIdx.x); ++ct) {
      const int s0 = ct * kT;
      __syncthreads();  // the previous tile is consumed; C is visible
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        const int s = s0 + r;
        Bs[r * ldb + n] = s < Q ? Bb[s * b_row + n] : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P;
        const int p = i - r * P;
        const int s = s0 + r;
        Xs[r * ldx + p] = s < Q ? xb[s * x_row + p] * dts[s] : 0.f;
      }
      __syncthreads();

      // score tile: thread (ty, tx) owns rows ty + 16 a, columns tx + 16 b
      float dot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dot[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * ldc + n];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = Bs[(tx + 16 * b) * ldb + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) dot[a][b] += cv[a] * bv[b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = t0 + ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int s = s0 + tx + 16 * b;
          const bool live = t < Q && s <= t;
          Sc[(ty + 16 * a) * lds + tx + 16 * b] =
              live ? dot[a][b] * expf(css[t] - css[s]) : 0.f;
        }
      }
      __syncthreads();

      // y += score @ (dt x)
      for (int s = 0; s < kT; ++s) {
        float xv[PJ];
#pragma unroll
        for (int b = 0; b < PJ; ++b) xv[b] = Xs[s * ldx + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float sv = Sc[(ty + 16 * a) * lds + s];
#pragma unroll
          for (int b = 0; b < PJ; ++b) acc[a][b] += sv * xv[b];
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = t0 + ty + 16 * a;
      if (t < Q) {
        float* yr = y + (bc * Q + t) * x_row + static_cast<int64_t>(h) * P;
#pragma unroll
        for (int b = 0; b < PJ; ++b) yr[tx + 16 * b] = acc[a][b];
      }
    }
    return;
  }

  // ---- S[:, n0 : n0 + 64) ---------------------------------------------
  const int n0 = (blockIdx.x - n_row_tiles) * kT;
  const float cs_end = css[Q - 1];
  float acc[PJ][4];
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int s0 = 0; s0 < Q; s0 += kT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i / kT;
      const int n = i - r * kT;
      const int s = s0 + r;
      float v = 0.f;
      if (s < Q && n0 + n < N)
        v = Bb[s * b_row + n0 + n] * (expf(cs_end - css[s]) * dts[s]);
      Bs[r * ldb + n] = v;
    }
    for (int i = tid; i < kT * P; i += kThreads) {
      const int r = i / P;
      const int p = i - r * P;
      const int s = s0 + r;
      Xs[r * ldx + p] = s < Q ? xb[s * x_row + p] : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < kT; ++s) {
      float bv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[s * ldb + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < PJ; ++a) {
        const float xv = Xs[s * ldx + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += xv * bv[b];
      }
    }
  }

  // S [B, Nc, H, P, N]
  float* Sb = S + (bc * H + h) * static_cast<int64_t>(P) * N;
#pragma unroll
  for (int a = 0; a < PJ; ++a) {
    const int p = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tx + 16 * b;
      if (n < N) Sb[static_cast<int64_t>(p) * N + n] = acc[a][b];
    }
  }
}

template <int P>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* S, int BNc, int Q, int H, int G,
           int N, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = allow_smem(ssd_chunk_kernel<P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Q + kT - 1) / kT + (N + kT - 1) / kT;
  const dim3 grid(tiles, H, BNc);
  ssd_chunk_kernel<P><<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, y,
                                                         S, Q, H, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x [BNc, Q, H, P], dt [BNc, Q, H], A [H], B/C [BNc, Q, G, N] (BNc = batch
// x chunks), fp32, contiguous, one device; y [BNc, Q, H, P] and
// S [BNc, H, P, N] are written.  P in {16, 32, 64, 128}, 1 <= N <= 256,
// H % G == 0, Q <= 1024.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, void* S,
                         int BNc, int Q, int H, int G, int P, int N,
                         void* stream) {
  using namespace repro_torch;
  if (N < 1 || N > kMaxN || G < 1 || H % G != 0 || Q < 1 || Q > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(S);
  switch (P) {
    case 16:
      return launch<16>(xf, df, af, bf, cf, yf, sf, BNc, Q, H, G, N, s);
    case 32:
      return launch<32>(xf, df, af, bf, cf, yf, sf, BNc, Q, H, G, N, s);
    case 64:
      return launch<64>(xf, df, af, bf, cf, yf, sf, BNc, Q, H, G, N, s);
    case 128:
      return launch<128>(xf, df, af, bf, cf, yf, sf, BNc, Q, H, G, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
