// Backward of the SSD (Mamba2) within-chunk kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain
// `ssd_chunked` (src/repro/models/ssm.py) with XLA's autodiff; this is the
// port's counterpart of that autodiff for the SSD chunk kernel
// (csrc/ssd_chunk.cu).  For every (batch, chunk) and head h of group g,
// with cs the inclusive cumsum of dt * A[h] over the chunk,
// L_ts = exp(cs_t - cs_s) for t >= s, CB_ts = C_t . B_s, W_ts = CB_ts L_ts
// dt_s and w_s = exp(cs_{Q-1} - cs_s) dt_s (the forward is y = W x and
// S = sum_s w_s x_s B_s^T), from dy and dS:
//   dW_ts = dy_t . x_s (t >= s),  dCB = dW L dt_s,  R = dW W,
//   dx_s  = sum_{t >= s} W_ts dy_t + w_s (dS B_s)
//   dC_t  = sum_{s <= t} dCB_ts B_s
//   dB_s  = sum_{t >= s} dCB_ts C_t + w_s (dS^T x_s)
//   dw_s  = x_s . (dS B_s),  Z = dw w
//   dcs_t = sum_{s <= t} R_ts - sum_{t' >= t} R_t't - Z_t (+ sum Z at Q-1)
//   ddt_s = sum_{t >= s} dW_ts CB_ts L_ts + dw_s exp(cs_{Q-1} - cs_s)
//           + A sum_{t >= s} dcs_t
//   dA    = sum over batch, chunks and s of dt_s sum_{t >= s} dcs_t
// dB and dC of a group sum over its heads.  fp32 in and out, on the CUDA
// cores (fp32 FMA; one TF32 pass would miss the 1e-4 row limit the forward
// is held to, and this first kernel is the simple one).
//
// What bounds it on an H100: operations.  Per (chunk, head) it forms the
// two Q x Q products C.B^T and dy.x^T and three more of the same size (dC,
// dx, dB), against x, dt, B, C, dy, dS read and dx, ddt, dB, dC written
// once; at Q = 256 that is far above the card's operations-per-byte line
// for fp32.  The design keeps it simple and deterministic instead:
//   - launch 1: for each (batch x chunk, head) and 64-row tile, a row CTA
//     (rows t of the tile: dC and sum_s R_ts) and a column CTA (columns s
//     of the tile: dx, dB, sum_t dW CB L and sum_t R_ts, and the state's
//     terms).  Each walks the other index's tiles on its side of the
//     diagonal in a fixed order, forming the 64 x 64 tiles of C.B^T and
//     dy.x^T from 32-wide slices staged in shared memory, then the output
//     products from the masked tile, with accumulators in shared memory
//     (each element owned by one thread).  C.B^T and dy.x^T are formed
//     twice, once by each kind of CTA: the price of writing every output
//     from one CTA with no atomics.  dB and dC go to per-head partials.
//   - launch 2: for each head, the suffix sum of dcs, ddt and dA, one warp
//     a (batch x chunk), dA summed over the warps in a fixed order.
//   - launch 3: dB and dC summed over each group's heads in head order.
// So no output depends on the order in which CTAs run: the same inputs
// give the same bits.  A sum over t >= s is taken over exactly those
// terms (the masked ones are exact zeros), never as a total less a
// prefix, so row s of dx, ddt, dB and dC (and row t of dC) does not move
// with dy in rows before it.  A ragged Q (any length <= 1024) is masked
// here: rows >= Q read as zeros and are never written.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;          // rows and columns of a tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 elements each
constexpr int kKC = 32;         // depth of a staged slice
constexpr int kLdK = kKC + 1;   // staged slice row (odd: no bank conflicts)
constexpr int kLdT = kT + 1;    // tile row
constexpr int kStage = 2 * kT * kLdK;  // two slices, or one 64 x 64 tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 256;
constexpr int kMaxQ = 1024;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kT * kLdT <= kStage, "a 64-wide tile fits the stage");

// exp(x) as 2^(x log2 e) on the SFU, as the forward kernel takes it
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// One warp: cs[s] = sum_{u <= s} dts[u] * a for s < Q, zeros (and zero
// dts) on [Q, Qpad); the forward kernel's scan, so cs has its bits.  A
// segment's offset is the previous lane's inclusive sum, never this lane's
// inclusive sum less its own total.
__device__ __forceinline__ void scan_head(float a, int Q, int Qpad,
                                          float* cs, float* dts, int lane) {
  const int seg = (Q + 31) / 32;
  const int s0 = min(lane * seg, Q);
  const int s1 = min(s0 + seg, Q);
  float run = 0.f;
  for (int s = s0; s < s1; ++s) {
    run += dts[s] * a;
    cs[s] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float offset = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) offset = 0.f;
  for (int s = s0; s < s1; ++s) cs[s] += offset;
  for (int s = Q + lane; s < Qpad; s += 32) {
    cs[s] = 0.f;
    dts[s] = 0.f;
  }
}

// One warp: v[s] = sum_{s <= u < Q} v[u], a true suffix sum: a lane sums
// its segment from the end and adds the inclusive sum of the lanes after
// it, so v[s] reads no term before s.
__device__ __forceinline__ void suffix_scan(int Q, float* v, int lane) {
  const int seg = (Q + 31) / 32;
  const int s0 = min(lane * seg, Q);
  const int s1 = min(s0 + seg, Q);
  float run = 0.f;
  for (int s = s1 - 1; s >= s0; --s) {
    run += v[s];
    v[s] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += u;
  }
  float offset = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) offset = 0.f;
  for (int s = s0; s < s1; ++s) v[s] += offset;
}

// sum over the 16 threads of a half-warp (tx), in a fixed order
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r * dld + c] = src[r * ld + c] for r < ROWS, c < COLS; zero where
// r >= rows_ok or c >= cols_ok (those are not read)
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int64_t ld, int rows_ok, int cols_ok) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
    const int r = i / COLS;
    const int c = i - r * COLS;
    dst[r * dld + c] =
        (r < rows_ok && c < cols_ok) ? __ldg(src + r * ld + c) : 0.f;
  }
}

// acc[i][j] += sum_{k < K} A(4 ty + i, k) B(k, tx + 16 j), with
// A(m, k) = AT ? A[k * lda + m] : A[m * lda + k] and
// B(k, n) = BT ? B[n * ldb + k] : B[k * ldb + n]
template <bool AT, bool BT>
__device__ __forceinline__ void tile_mac(float (&acc)[4][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int K) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = AT ? A[k * lda + 4 * ty + i] : A[(4 * ty + i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = BT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = a . b^T of two 64-row blocks (rows a_ok / b_ok real) over `depth`
// columns, by slices of kKC staged in `st`
__device__ __forceinline__ void product_abt(float (&acc)[4][4],
                                            const float* a, int64_t lda,
                                            int a_ok, const float* b,
                                            int64_t ldb, int b_ok, int depth,
                                            float* st) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += kKC) {
    __syncthreads();  // the stage's last readers are done
    stage<kT, kKC>(st, kLdK, a + k0, lda, a_ok, depth - k0);
    stage<kT, kKC>(st + kT * kLdK, kLdK, b + k0, ldb, b_ok, depth - k0);
    __syncthreads();
    tile_mac<false, true>(acc, st, kLdK, st + kT * kLdK, kLdK, kKC);
  }
}

// out[m][n] += sum_k T(m, k) src[k][n] for the 64 x 64 tile T in shared
// memory (T(m, k) = AT ? T[k][m] : T[m][k]) and the 64 rows of src
// (src_ok real) over `width` columns, 64 at a time; out has rows ld_out
// floats apart and each element belongs to one thread
template <bool AT>
__device__ __forceinline__ void product_tile(float* out, int ld_out,
                                             const float* T, const float* src,
                                             int64_t ld_src, int src_ok,
                                             int width, float* st) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  for (int n0 = 0; n0 < width; n0 += kT) {
    __syncthreads();  // T is written; the stage's last readers are done
    stage<kT, kT>(st, kLdT, src + n0, ld_src, src_ok, width - n0);
    __syncthreads();
    float o[4][4] = {};
    tile_mac<AT, false>(o, T, kLdT, st, kLdT, kT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < width) out[(4 * ty + i) * ld_out + n] += o[i][j];
      }
  }
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *dS;
  float *dx, *ddt, *dA, *dB, *dC;
  // workspace: per-head dB and dC [BNc, Q, H, N]; rowR, colR, K and dw
  // [BNc, H, Q]
  float *dBh, *dCh, *rowR, *colR, *K, *dw;
};

struct Shapes {
  int Q, H, G, P, N, Qpad, n_rt;
  int64_t BNc, x_row, b_row;  // row strides of [.., Q, H, P], [.., Q, G, N]
};

// Shared memory of a launch-1 CTA, in floats: cs and dt, the stage, two
// tiles, the N-wide and P-wide accumulators.
inline size_t tile_smem_floats(int Qpad, int P, int N) {
  return 2 * static_cast<size_t>(Qpad) + kStage + 2 * kT * kLdT +
         kT * static_cast<size_t>(N) + kT * static_cast<size_t>(P);
}

// ---- launch 1 ----------------------------------------------------------
// One CTA: (batch x chunk bc, head h) and tile `tile`, as a row CTA (rows
// t of the tile, column tiles c <= tile) or a column CTA (columns s of the
// tile, row tiles r >= tile).
__device__ void tile_cta(const Args& a, const Shapes& sh, int64_t bc, int h,
                         int tile, bool row, float* sm) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int Q = sh.Q, N = sh.N, P = sh.P, Qpad = sh.Qpad;
  float* cs = sm;
  float* dts = sm + Qpad;
  float* st = sm + 2 * Qpad;
  float* T1 = st + kStage;
  float* T2 = T1 + kT * kLdT;
  float* accN = T2 + kT * kLdT;  // row: dC [64][N]; column: dB [64][N]
  float* accP = accN + kT * N;   // column: dx [64][P]

  for (int s = tid; s < Q; s += kThreads)
    dts[s] = __ldg(a.dt + (bc * Q + s) * sh.H + h);
  for (int i = tid; i < kT * (N + P); i += kThreads) accN[i] = 0.f;
  __syncthreads();
  if (tid < 32) scan_head(__ldg(a.A + h), Q, Qpad, cs, dts, tid);
  // (product_abt's first barrier publishes cs and the zeroed accumulators)

  const int g = h / (sh.H / sh.G);
  const float* Cg = a.Cm + bc * Q * sh.b_row + static_cast<int64_t>(g) * N;
  const float* Bg = a.Bm + bc * Q * sh.b_row + static_cast<int64_t>(g) * N;
  const float* dyh = a.dy + bc * Q * sh.x_row + static_cast<int64_t>(h) * P;
  const float* xh = a.x + bc * Q * sh.x_row + static_cast<int64_t>(h) * P;
  const int64_t hq = (bc * sh.H + h) * static_cast<int64_t>(Q);
  const int base = tile * kT;
  float cb[4][4], dw[4][4];

  if (row) {
    const int t0 = base;
    float rs[4] = {};  // sum_s R_ts of this thread's rows
    for (int c = 0; c <= tile; ++c) {
      const int s0 = c * kT;
      product_abt(cb, Cg + t0 * sh.b_row, sh.b_row, Q - t0,
                  Bg + s0 * sh.b_row, sh.b_row, Q - s0, N, st);
      product_abt(dw, dyh + t0 * sh.x_row, sh.x_row, Q - t0,
                  xh + s0 * sh.x_row, sh.x_row, Q - s0, P, st);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + 4 * ty + i;
          const int s = s0 + tx + 16 * j;
          float dcb = 0.f;
          if (t < Q && s <= t) {
            dcb = dw[i][j] * exp_fast(cs[t] - cs[s]) * dts[s];
            rs[i] += dcb * cb[i][j];
          }
          T1[(4 * ty + i) * kLdT + tx + 16 * j] = dcb;
        }
      // dC_t += sum_s dCB_ts B_s
      product_tile<false>(accN, N, T1, Bg + s0 * sh.b_row, sh.b_row, Q - s0,
                          N, st);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = half_warp_sum(rs[i]);
      const int t = t0 + 4 * ty + i;
      if (tx == 0 && t < Q) a.rowR[hq + t] = v;
    }
    __syncthreads();
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      if (t0 + r < Q)
        a.dCh[((bc * Q + t0 + r) * sh.H + h) * static_cast<int64_t>(N) + n] =
            accN[i];
    }
    return;
  }

  // column CTA
  const int s0 = base;
  float ks[4] = {}, rc[4] = {};  // this thread's columns: sum_t dW CB L, R
  for (int r = tile; r < sh.n_rt; ++r) {
    const int t0 = r * kT;
    product_abt(cb, Cg + t0 * sh.b_row, sh.b_row, Q - t0,
                Bg + s0 * sh.b_row, sh.b_row, Q - s0, N, st);
    product_abt(dw, dyh + t0 * sh.x_row, sh.x_row, Q - t0,
                xh + s0 * sh.x_row, sh.x_row, Q - s0, P, st);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * ty + i;
        const int s = s0 + tx + 16 * j;
        float wv = 0.f, dcb = 0.f;
        if (t < Q && s <= t) {
          const float L = exp_fast(cs[t] - cs[s]);
          const float kv = dw[i][j] * cb[i][j] * L;
          wv = cb[i][j] * L * dts[s];
          dcb = dw[i][j] * L * dts[s];
          ks[j] += kv;
          rc[j] += dcb * cb[i][j];
        }
        T1[(4 * ty + i) * kLdT + tx + 16 * j] = wv;
        T2[(4 * ty + i) * kLdT + tx + 16 * j] = dcb;
      }
    // dx_s += sum_t W_ts dy_t; dB_s += sum_t dCB_ts C_t
    product_tile<true>(accP, P, T1, dyh + t0 * sh.x_row, sh.x_row, Q - t0,
                       P, st);
    product_tile<true>(accN, N, T2, Cg + t0 * sh.b_row, sh.b_row, Q - t0, N,
                       st);
  }

  // the state's terms: dx_s += w_s (dS B_s), dB_s += w_s (dS^T x_s),
  // dw_s = x_s . (dS B_s)
  const float* dSh = a.dS + (bc * sh.H + h) * static_cast<int64_t>(P) * N;
  const float end = cs[Q - 1];
  float wrow[4], dwrow[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    wrow[i] = s < Q ? exp_fast(end - cs[s]) * dts[s] : 0.f;
  }
  for (int p0 = 0; p0 < P; p0 += kT) {
    float o[4][4];
    product_abt(o, Bg + s0 * sh.b_row, sh.b_row, Q - s0, dSh + p0 * N, N,
                P - p0, N, st);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 4 * ty + i;
        const int p = p0 + tx + 16 * j;
        if (s < Q && p < P) {
          accP[(4 * ty + i) * P + p] += wrow[i] * o[i][j];
          dwrow[i] += __ldg(xh + s * sh.x_row + p) * o[i][j];
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = half_warp_sum(dwrow[i]);
    const int s = s0 + 4 * ty + i;
    if (tx == 0 && s < Q) a.dw[hq + s] = v;
  }
  for (int n0 = 0; n0 < N; n0 += kT) {
    float o[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kKC) {
      __syncthreads();
      stage<kT, kKC>(st, kLdK, xh + s0 * sh.x_row + p0, sh.x_row, Q - s0,
                     P - p0);
      stage<kKC, kT>(st + kT * kLdK, kLdT, dSh + p0 * N + n0, N, P - p0,
                     N - n0);
      __syncthreads();
      tile_mac<false, false>(o, st, kLdK, st + kT * kLdK, kLdT, kKC);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) accN[(4 * ty + i) * N + n] += wrow[i] * o[i][j];
      }
  }

  // column sums over the 16 row groups, in order (T1 is free now)
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    T1[ty * kT + tx + 16 * j] = ks[j];
    T1[16 * kT + ty * kT + tx + 16 * j] = rc[j];
  }
  __syncthreads();
  if (tid < kT && s0 + tid < Q) {
    float k = 0.f, rsum = 0.f;
    for (int y = 0; y < 16; ++y) {
      k += T1[y * kT + tid];
      rsum += T1[16 * kT + y * kT + tid];
    }
    a.K[hq + s0 + tid] = k;
    a.colR[hq + s0 + tid] = rsum;
  }
  for (int i = tid; i < kT * P; i += kThreads) {
    const int r = i / P;
    const int p = i - r * P;
    if (s0 + r < Q) a.dx[(bc * Q + s0 + r) * sh.x_row + h * P + p] = accP[i];
  }
  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N;
    const int n = i - r * N;
    if (s0 + r < Q)
      a.dBh[((bc * Q + s0 + r) * sh.H + h) * static_cast<int64_t>(N) + n] =
          accN[i];
  }
}

// The grid: levels of equal work, heaviest first; level k holds the row
// CTAs of tile n_rt - 1 - k and the column CTAs of tile k (n_rt - k tile
// pairs each), each (kind, head, batch x chunk).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tiles_kernel(Args a, Shapes sh) {
  extern __shared__ __align__(16) float sm[];
  const int64_t per_level = 2 * static_cast<int64_t>(sh.H) * sh.BNc;
  int64_t i = blockIdx.x;
  const int level = static_cast<int>(i / per_level);
  i %= per_level;
  const bool row = (i & 1) == 0;
  i >>= 1;
  const int h = static_cast<int>(i % sh.H);
  const int64_t bc = i / sh.H;
  tile_cta(a, sh, bc, h, row ? sh.n_rt - 1 - level : level, row, sm);
}

// ---- launch 2: ddt and dA, one CTA a head, one warp a (batch x chunk) ---
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(Args a, Shapes sh) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Q = sh.Q, Qpad = sh.Qpad;
  float* cs = sm + warp * 3 * Qpad;
  float* dts = cs + Qpad;
  float* dcs = dts + Qpad;
  float* part = sm + kWarps * 3 * Qpad;
  const float A = __ldg(a.A + h);
  float acc = 0.f;  // this lane's share of dA
  for (int64_t bc = warp; bc < sh.BNc; bc += kWarps) {
    for (int s = lane; s < Q; s += 32)
      dts[s] = __ldg(a.dt + (bc * Q + s) * sh.H + h);
    __syncwarp();
    scan_head(A, Q, Qpad, cs, dts, lane);
    __syncwarp();
    const int64_t hq = (bc * sh.H + h) * static_cast<int64_t>(Q);
    const float end = cs[Q - 1];
    float zsum = 0.f;
    for (int s = lane; s < Q; s += 32) {
      const float z = a.dw[hq + s] * exp_fast(end - cs[s]) * dts[s];
      zsum += z;
      dcs[s] = a.rowR[hq + s] - a.colR[hq + s] - z;
    }
    zsum = warp_sum(zsum);
    __syncwarp();
    if (lane == 0) dcs[Q - 1] += zsum;
    __syncwarp();
    suffix_scan(Q, dcs, lane);
    __syncwarp();
    for (int s = lane; s < Q; s += 32) {
      a.ddt[(bc * Q + s) * sh.H + h] =
          a.K[hq + s] + a.dw[hq + s] * exp_fast(end - cs[s]) + A * dcs[s];
      acc += dts[s] * dcs[s];
    }
    __syncwarp();
  }
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float dA = 0.f;
    for (int w = 0; w < kWarps; ++w) dA += part[w];
    a.dA[h] = dA;
  }
}

// ---- launch 3: dB and dC summed over each group's heads, in order ------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_kernel(Args a, Shapes sh) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = sh.BNc * sh.Q * sh.G * static_cast<int64_t>(sh.N);
  if (i >= total) return;
  const int n = static_cast<int>(i % sh.N);
  const int64_t rg = i / sh.N;
  const int g = static_cast<int>(rg % sh.G);
  const int64_t row = rg / sh.G;  // bc * Q + t
  const int rep = sh.H / sh.G;
  const float* src = blockIdx.y == 0 ? a.dBh : a.dCh;
  const float* p = src + (row * sh.H + static_cast<int64_t>(g) * rep) * sh.N +
                   n;
  float v = 0.f;
  for (int k = 0; k < rep; ++k) v += p[static_cast<int64_t>(k) * sh.N];
  (blockIdx.y == 0 ? a.dB : a.dC)[i] = v;
}

}  // namespace
}  // namespace repro_torch

// Floats of workspace `ssd_chunk_bwd` needs: per-head dB and dC
// [BNc, Q, H, N] and four [BNc, H, Q] vectors.
extern "C" int64_t ssd_chunk_bwd_workspace(int BNc, int Q, int H, int N) {
  const int64_t bqh = static_cast<int64_t>(BNc) * Q * H;
  return 2 * bqh * N + 4 * bqh;
}

// x, dy [BNc, Q, H, P], dt [BNc, Q, H], A [H], B/C [BNc, Q, G, N],
// dS [BNc, H, P, N] (BNc = batch x chunks), fp32, contiguous, one device;
// writes dx, ddt, dA [H], dB and dC [BNc, Q, G, N]; `ws` holds
// `ssd_chunk_bwd_workspace` floats.  P in {16, 32, 64, 128},
// 1 <= N <= 256, H % G == 0, 1 <= Q <= 1024.  Three launches; returns the
// first nonzero cudaGetLastError() (0 on success).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* dy,
                             const void* dS, void* dx, void* ddt, void* dA,
                             void* dB, void* dC, void* ws, int BNc, int Q,
                             int H, int G, int P, int N, void* stream) {
  using namespace repro_torch;
  if (N < 1 || N > kMaxN || G < 1 || H < 1 || H % G != 0 || Q < 1 ||
      Q > kMaxQ || BNc < 1 || !(P == 16 || P == 32 || P == 64 || P == 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shapes sh{};
  sh.Q = Q;
  sh.H = H;
  sh.G = G;
  sh.P = P;
  sh.N = N;
  sh.n_rt = (Q + kT - 1) / kT;
  sh.Qpad = sh.n_rt * kT;
  sh.BNc = BNc;
  sh.x_row = static_cast<int64_t>(H) * P;
  sh.b_row = static_cast<int64_t>(G) * N;
  Args a{};
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.dy = static_cast<const float*>(dy);
  a.dS = static_cast<const float*>(dS);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  const int64_t bqh = static_cast<int64_t>(BNc) * Q * H;
  a.dBh = static_cast<float*>(ws);
  a.dCh = a.dBh + bqh * N;
  a.rowR = a.dCh + bqh * N;
  a.colR = a.rowR + bqh;
  a.K = a.colR + bqh;
  a.dw = a.K + bqh;

  const int64_t ctas1 = 2 * static_cast<int64_t>(sh.n_rt) * H * BNc;
  if (ctas1 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = sizeof(float) * tile_smem_floats(sh.Qpad, P, N);
  cudaError_t err = allow_smem(ssd_bwd_tiles_kernel, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tiles_kernel<<<static_cast<unsigned>(ctas1), kThreads, smem1, s>>>(
      a, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem2 =
      sizeof(float) * (static_cast<size_t>(kWarps) * 3 * sh.Qpad + kWarps);
  err = allow_smem(ssd_bwd_dt_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dt_kernel<<<H, kThreads, smem2, s>>>(a, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n3 = static_cast<int64_t>(BNc) * Q * G * N;
  const int64_t ctas3 = (n3 + kThreads - 1) / kThreads;
  if (ctas3 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_group_kernel<<<dim3(static_cast<unsigned>(ctas3), 2), kThreads, 0,
                         s>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}
